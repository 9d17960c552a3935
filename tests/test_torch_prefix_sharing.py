"""Copy-on-write prefix sharing in the port against the JAX package.

- The refcount allocator: random walks of alloc / release / fork / CoW
  (``tests/test_prefix_sharing.py``'s walk) driven through both packages
  on the same inputs, ``refcount`` and ``block_table`` bitwise equal after
  every op, and JAX's invariants checked on the port's state; the CoW,
  fork and sizing cases of that file, bitwise.
- The model: a decode write into a forked page privatizes it, and
  ``prefill(shared_prefix_len=)`` (the paged prefill with its chunk pass)
  matches JAX's — logits within atol 1e-4 at fp32, pools within atol 1e-5,
  the allocator state bitwise.
- The engine with ``share_prefix=True`` at fp32, greedy and sampled with
  JAX's noise, on tictactoe and bandit: tokens, masks, rewards and context
  lengths equal to JAX's sharing engine, log-probs within atol 1e-5; and
  greedy streams equal between the port's shared, unshared and dense
  engines, with a strictly lower page peak when shared.
- Three ``EarlTrainer`` steps on bandit with sharing and int8 pages
  against JAX's: the reference pass runs ExpPrep's standalone route on
  both sides (sharing unfolds it, with one warning). ``mean_return``,
  ``mean_context_len`` equal; ``loss`` and ``kl`` within atol 1e-4 (the
  behaviour log-probs come from int8 pages whose scales differ from JAX's
  in the last f32 bit, measured ~4e-5 apart)."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core.stages import EarlTrainer as JaxTrainer
from repro.models import paging as jpaging
from repro.models.registry import build_model as jax_build_model
from repro.optim.adamw import adamw as jax_adamw
from repro.rl.envs import make_env as jax_make_env
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core.stages import EarlTrainer
from repro_torch.models import paging as tpaging
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import adamw
from repro_torch.rl.engine import CompiledRolloutEngine
from repro_torch.rl.envs import make_env
from test_torch_envs import assert_same_rollout, jax_noise, run_both

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small eager ops: one intra-op thread per test worker, so parallel
    workers do not oversubscribe the cores (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


P, B, NP = 12, 4, 3


def _t(a, dtype=None):
    return torch.from_numpy(np.asarray(a)).to(dtype) if dtype else \
        torch.from_numpy(np.asarray(a))


def _same(trc, tbt, jrc, jbt):
    np.testing.assert_array_equal(trc.numpy(), np.asarray(jrc))
    np.testing.assert_array_equal(tbt.numpy(), np.asarray(jbt))


def _check_invariants(rc, bt):
    rc, bt = rc.numpy(), bt.numpy()
    assert (rc >= 0).all(), rc
    mapped, counts = np.unique(bt[bt >= 0], return_counts=True)
    assert (rc[mapped] > 0).all(), (rc, bt)
    ref = np.zeros_like(rc)
    ref[mapped] = counts
    np.testing.assert_array_equal(rc, ref)


@pytest.mark.parametrize("seed", range(8))
def test_allocator_random_walk_matches_jax(seed):
    """A random legal op sequence against a small pool (exhaustion
    reachable): both packages' state bitwise equal after every op, and the
    CoW outputs equal."""
    rr = np.random.RandomState(seed)
    jrc, jbt = jnp.zeros((P,), jnp.int32), jnp.full((B, NP), -1, jnp.int32)
    trc = torch.zeros((P,), dtype=torch.int32)
    tbt = torch.full((B, NP), -1, dtype=torch.int32)
    for _ in range(30):
        op = rr.choice(["alloc", "alloc", "release", "fork", "cow"])
        if op == "alloc":
            rows = rr.rand(B) < 0.6
            bt = tbt.numpy()
            entry = np.argmax(bt < 0, axis=1)
            need = rows & (bt < 0).any(axis=1)
            jp, jrc = jpaging.alloc_pages(jrc, jnp.asarray(need))
            tp, trc = tpaging.alloc_pages(trc, _t(need))
            np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
            ok = need & (tp.numpy() < P)
            jbt = jbt.at[jnp.arange(B), jnp.where(
                jnp.asarray(ok), jnp.asarray(entry), NP)].set(
                    jp, mode="drop")
            tbt = tbt.clone()
            r = np.nonzero(ok)[0]
            tbt[r, entry[r]] = tp[r]
        elif op == "release":
            rows = rr.rand(B) < 0.5
            jrc, jbt = jpaging.release_pages(jrc, jbt, jnp.asarray(rows))
            trc, tbt = tpaging.release_pages(trc, tbt, _t(rows))
        elif op == "fork":
            src = rr.randint(B)
            k = rr.randint(1, NP + 1)
            tgt = (rr.rand(B) < 0.5) & (tbt.numpy()[:, :k] < 0).all(axis=1)
            tgt[src] = False
            jrc, jbt = jpaging.fork_pages(jrc, jbt, jbt[src, :k],
                                          jnp.asarray(tgt))
            trc, tbt = tpaging.fork_pages(trc, tbt, tbt[src, :k].clone(),
                                          _t(tgt))
        else:
            entry = rr.randint(0, NP, B)
            rows = rr.rand(B) < 0.5
            jout = jpaging.cow_pages(jrc, jbt, jnp.asarray(entry),
                                     jnp.asarray(rows))
            tout = tpaging.cow_pages(trc, tbt, _t(entry), _t(rows))
            for a, b in zip(tout[:3], jout[:3]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            jrc, jbt = jout[3:]
            trc, tbt = tout[3:]
            d = tout[1].numpy()
            assert (trc.numpy()[d[d < P]] == 1).all()
            assert not (tout[2].numpy() & (d < P)).any()
        _same(trc, tbt, jrc, jbt)
        _check_invariants(trc, tbt)


def test_fork_release_conserve_refcount():
    """Fork a 2-page run into two rows, release the owner: the run stays
    live through the forks, then the last release frees it."""
    rc = torch.zeros((P,), dtype=torch.int32)
    pages, rc = tpaging.alloc_pages(rc, torch.ones(2, dtype=torch.bool))
    bt = torch.full((B, NP), -1, dtype=torch.int32)
    bt[0, :2] = pages
    rows = torch.tensor([False, True, True, False])
    rc, bt = tpaging.fork_pages(rc, bt, pages, rows)
    assert rc[pages].tolist() == [3, 3]
    rc, bt = tpaging.release_pages(rc, bt, torch.tensor([True, False,
                                                          False, False]))
    assert rc[pages].tolist() == [2, 2]
    rc, bt = tpaging.release_pages(rc, bt, rows)
    assert int(tpaging.pages_in_use(rc)) == 0 and (bt < 0).all()


@pytest.mark.parametrize("free", [True, False])
def test_cow_privatizes_or_blocks_like_jax(free):
    """A row writing into a refcount-2 page gets a private copy (src ->
    dst, refcounts 1/1), or, with the pool exhausted, is blocked and keeps
    its shared mapping."""
    rc = np.zeros((4,), np.int32) if free else np.ones((4,), np.int32)
    rc[0] = 2
    bt = np.array([[0, -1], [0, -1]], np.int32)
    entry, rows = np.array([0, 0], np.int32), np.array([True, False])
    jout = jpaging.cow_pages(jnp.asarray(rc), jnp.asarray(bt),
                             jnp.asarray(entry), jnp.asarray(rows))
    tout = tpaging.cow_pages(_t(rc), _t(bt), _t(entry), _t(rows))
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    src, dst, blocked, rc2, bt2 = (t.numpy() for t in tout)
    if free:
        assert src[0] == 0 and dst[0] == 1 and not blocked.any()
        assert rc2[:2].tolist() == [1, 1] and bt2[:, 0].tolist() == [1, 0]
    else:
        assert blocked.tolist() == [True, False] and (bt2 == bt).all()


@pytest.mark.parametrize("batch,s_max,prefix,ps", [
    (4, 96, 16, 4), (4, 96, 13, 4), (32, 256, 96, 16), (8, 64, 200, 16),
    (3, 50, 0, 8)])
def test_pool_pages_needed_shared_matches_jax(batch, s_max, prefix, ps):
    assert (tpaging.pool_pages_needed_shared(batch, s_max, prefix, ps)
            == jpaging.pool_pages_needed_shared(batch, s_max, prefix, ps))
    assert (tpaging.pool_pages_needed_shared(batch, s_max, prefix, ps)
            <= tpaging.pool_pages_needed(batch, s_max, ps))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jmodel = jax_build_model(jax_smoke_config("qwen2-0.5b"))
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    tmodel = build_model(get_smoke_config("qwen2-0.5b"))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, tmodel, tparams


def _prompt(model_vocab, Bn, S, seed=3, common=None):
    rs = np.random.RandomState(seed)
    toks = rs.randint(8, model_vocab, (Bn, S)).astype(np.int32)
    if common:
        toks[:, :common] = toks[0, :common]
    return toks


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("shared", [0, 12, 17])
def test_paged_prefill_with_shared_prefix_matches_jax(models, kv_dtype,
                                                      shared):
    jmodel, jparams, tmodel, tparams = models
    S, CAP, ps = 21, 48, 8
    toks = _prompt(jmodel.cfg.vocab_size, 3, S, common=max(shared, 1))
    jl, jc = jmodel.prefill(jparams, jnp.asarray(toks), jmodel.init_cache(
        3, CAP, layout="paged", page_size=ps, kv_dtype=kv_dtype),
        shared_prefix_len=shared)
    tl, tc = tmodel.prefill(tparams, torch.from_numpy(toks),
                            tmodel.init_cache(3, CAP, layout="paged",
                                              page_size=ps,
                                              kv_dtype=kv_dtype,
                                              device="cpu"),
                            shared_prefix_len=shared)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for f in ("block_table", "refcount", "pos"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)))
    n = tc.n_pages
    if shared >= ps:                       # the run is forked B ways
        assert int(tc.refcount[tc.block_table[0, 0]]) == 3
    if kv_dtype == "int8":
        for a, b in zip((tc.kv.k_scale, tc.kv.v_scale),
                        (jc.kv.k_scale, jc.kv.v_scale)):
            np.testing.assert_allclose(a[:, :n].numpy(), np.asarray(b),
                                       rtol=1e-5, atol=0)
        # the int8 values: equal but where a rounding tie moved by an ulp
        agree = (tc.kv.k[:, :n].numpy() == np.asarray(jc.kv.k)).mean()
        assert agree > 0.999
    else:
        np.testing.assert_allclose(tc.kv.k[:, :n].numpy(),
                                   np.asarray(jc.kv.k), atol=1e-5)


def test_decode_write_into_forked_page_copies(models):
    """``tests/test_prefix_sharing.py``'s case on the port: row 0's partial
    page aliased into row 1 (refcount 2); both rows decode at offset 4 of
    it, so both privatize it. The source page is untouched, each copy
    holds the source below the fill line, the rows' new entries differ,
    and the allocator state is JAX's bitwise."""
    jmodel, jparams, tmodel, tparams = models
    Bn, S, CAP, ps = 2, 12, 32, 8
    toks = _prompt(jmodel.cfg.vocab_size, 1, CAP).repeat(Bn, 0)
    _, jc = jmodel.prefill(jparams, jnp.asarray(toks[:, :S]),
                           jmodel.init_cache(Bn, CAP, layout="paged",
                                             page_size=ps),
                           shared_prefix_len=S)
    _, tc = tmodel.prefill(tparams, torch.from_numpy(toks[:, :S]),
                           tmodel.init_cache(Bn, CAP, layout="paged",
                                             page_size=ps, device="cpu"),
                           shared_prefix_len=S)
    page0, page1 = int(tc.block_table[0, 1]), int(tc.block_table[1, 1])
    assert page0 != page1
    jc = jc._replace(refcount=jc.refcount.at[page1].add(-1).at[page0].add(1),
                     block_table=jc.block_table.at[1, 1].set(page0))
    rc = tc.refcount.clone()
    rc[page1] -= 1
    rc[page0] += 1
    bt = tc.block_table.clone()
    bt[1, 1] = page0
    tc = tc._replace(refcount=rc, block_table=bt)
    k_before = tc.kv.k[:, page0].float().clone()
    step = np.array([9, 10], np.int32)
    _, jc2 = jmodel.decode_step(jparams, jnp.asarray(step), jc)
    _, tc2 = tmodel.decode_step(tparams, torch.from_numpy(step), tc)
    for f in ("block_table", "refcount", "pos"):
        np.testing.assert_array_equal(getattr(tc2, f).numpy(),
                                      np.asarray(getattr(jc2, f)))
    p0, p1 = int(tc2.block_table[0, 1]), int(tc2.block_table[1, 1])
    assert page0 not in (p0, p1) and p0 != p1
    rc2 = tc2.refcount.numpy()
    assert rc2[p0] == rc2[p1] == 1 and rc2[page0] == 0
    k = tc2.kv.k.float()
    assert torch.equal(k[:, p0, :4], k_before[:, :4])
    assert torch.equal(k[:, p1, :4], k_before[:, :4])
    assert torch.equal(k[:, page0], k_before)
    assert not torch.equal(k[:, p0, 4], k[:, p1, 4])
    n = tc2.n_pages
    np.testing.assert_allclose(tc2.kv.k[:, :n].float().numpy(),
                               np.asarray(jc2.kv.k, np.float32), atol=0.02)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

ENGINE_KW = dict(max_turns=3, max_turn_tokens=4, max_context=96,
                 cache_layout="paged", page_size=4, kv_dtype="fp32",
                 sampling="reference")


def _env_case(env_name):
    if env_name == "bandit":
        return {"prompt_len": 16}, dict(ENGINE_KW, max_turns=1)
    return {}, ENGINE_KW


@pytest.mark.parametrize("env_name", ["tictactoe", "bandit"])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_shared_engine_matches_jax(models, env_name, temperature):
    env_kw, kw = _env_case(env_name)
    j, t, teng = run_both(models, env_name, env_kw, 4, 9,
                          jax.random.PRNGKey(11), share_prefix=True,
                          temperature=temperature, **kw)
    assert teng.shared_pages > 0
    assert_same_rollout(j, t)
    assert t[1].shared_prefix_len == teng.shared_len > 0


@pytest.mark.parametrize("env_name", ["tictactoe", "bandit"])
def test_greedy_shared_equals_unshared_and_dense(models, env_name):
    """Sharing is invisible to the trajectories: on plain attention (JAX's
    contract) the port's shared, unshared and dense greedy engines commit
    the same tokens, log-probs, rewards and context lengths, and on the
    paged kernel's route shared equals unshared; sharing lowers the page
    peak."""
    _, _, tmodel, tparams = models
    env_kw, kw = _env_case(env_name)
    kw = dict(kw, temperature=0.0, sampling="fused")
    env = make_env(env_name, **env_kw)
    out = {}
    for name, extra in (("dense", dict(cache_layout="dense",
                                       attn_impl="xla")),
                        ("off", dict(attn_impl="xla")),
                        ("on", dict(share_prefix=True, attn_impl="xla")),
                        ("off_kernel", {}),
                        ("on_kernel", dict(share_prefix=True))):
        eng = CompiledRolloutEngine(tmodel, env, device="cpu",
                                    **dict(kw, **extra))
        # equally seeded: the opponent's draws come from the generator
        out[name] = eng.run(tparams, 3, 5,
                            generator=torch.Generator().manual_seed(5))
    (e2, s2) = out["on"]
    for name, e2 in (("dense", e2), ("off", e2),
                     ("off_kernel", out["on_kernel"][0])):
        e1 = out[name][0]
        for f in ("tokens", "gen_mask", "logprobs", "rewards",
                  "context_len"):
            assert torch.equal(getattr(e1, f), getattr(e2, f)), (name, f)
    assert s2.episodes_returned == 5 and s2.kv_dropped_writes == 0
    assert s2.pages_in_use < out["off"][1].pages_in_use


def test_default_pool_sizing_never_drops(models):
    """Without cache_pages, sharing sizes the pool by
    pool_pages_needed_shared: below full provisioning, and no write
    dropped through heavy churn."""
    _, _, tmodel, tparams = models
    eng = CompiledRolloutEngine(tmodel, make_env("bandit", prompt_len=16),
                                device="cpu", max_turns=1,
                                max_turn_tokens=2, max_context=64,
                                temperature=1.0, page_size=4,
                                share_prefix=True)
    _, st = eng.run(tparams, 4, 16, generator=torch.Generator().manual_seed(
        5))
    assert st.page_capacity == tpaging.pool_pages_needed_shared(
        4, 64, eng.shared_len, 4) < tpaging.pool_pages_needed(4, 64, 4)
    assert st.kv_dropped_writes == 0 and st.episodes_returned == 16


def test_share_prefix_requires_paged_and_rejects_folded_ref(models):
    _, _, tmodel, tparams = models
    with pytest.raises(ValueError, match="share_prefix"):
        CompiledRolloutEngine(tmodel, make_env("tictactoe"), device="cpu",
                              cache_layout="dense", share_prefix=True)
    eng = CompiledRolloutEngine(tmodel, make_env("tictactoe"), device="cpu",
                                page_size=4, share_prefix=True, **{
                                    k: ENGINE_KW[k] for k in
                                    ("max_turns", "max_turn_tokens",
                                     "max_context")})
    with pytest.raises(ValueError, match="ref_params"):
        eng.run(tparams, 2, ref_params=tparams)


def test_prefix_len_overrides_the_env(models):
    """``prefix_len`` caps the shared run below the env's declaration."""
    tmodel = models[2]
    env = make_env("bandit", prompt_len=16)
    eng = CompiledRolloutEngine(tmodel, env, device="cpu", page_size=4,
                                share_prefix=True, prefix_len=9,
                                max_turns=1, max_turn_tokens=2,
                                max_context=64)
    assert (eng.shared_pages, eng.shared_len) == (2, 8)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def test_three_steps_bandit_shared_int8_match_jax_trainer(models):
    jmodel, jparams, tmodel, tparams = models
    settings = dict(batch_size=4, rollout_episodes=6, max_turns=1,
                    max_turn_tokens=4, max_context=64, kl_coef=0.05,
                    clip_eps=0.2, temperature=1.0, rollout_backend="compiled",
                    cache_layout="paged", page_size=8, sampling="reference",
                    kv_dtype="int8", share_prefix=True)
    steps, seed, lr = 3, 7, 3e-4
    jtr = JaxTrainer(model=jmodel, env=jax_make_env("bandit", prompt_len=16),
                     optimizer=jax_adamw(lr, weight_decay=0.0), seed=seed,
                     **settings)
    assert not jtr.ref_folded
    # the reference is a copy: ExpPrep's standalone pass runs every step
    jref = jax.tree.map(lambda a: a + 0, jparams)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        _, _, jhist = jtr.train(steps, params=jparams,
                                opt_state=jtr.optimizer.init(jparams),
                                ref_params=jref)
    rng, keys = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        keys.append(sub)
    env = make_env("bandit", prompt_len=16)
    ttr = EarlTrainer(model=tmodel, env=env,
                      optimizer=adamw(lr, weight_decay=0.0), seed=seed,
                      noise=lambda step: jax_noise(keys[step], env),
                      device="cpu", **settings)
    assert not ttr.ref_folded and ttr.rollout.shared_len == 16
    tref = {k: v.clone() for k, v in tparams.items()}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, _, thist = ttr.train(steps, params=tparams,
                                opt_state=ttr.optimizer.init(tparams),
                                ref_params=tref)
    warned = [w for w in caught if issubclass(w.category, RuntimeWarning)
              and "share_prefix" in str(w.message)]
    assert len(warned) == 1
    for j, t in zip(jhist, thist):
        assert t.mean_return == j.mean_return, t.step
        assert t.mean_context_len == j.mean_context_len, t.step
        assert t.kv_dropped_writes == j.kv_dropped_writes == 0
        np.testing.assert_allclose(t.loss, j.loss, atol=1e-4)
        np.testing.assert_allclose(t.kl, j.kl, atol=1e-4)
    assert thist[-1].kl != 0                      # the reference pass ran
