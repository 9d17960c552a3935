"""The moe family of the port (``models/moe.py``) against the JAX package
on the CPU, at the smoke configs of granite-moe-3b-a800m (4 experts,
top 2, capacity factor 2.0) and grok-1-314b (the same routing over wider
experts), on JAX's params bridged and numpy-seeded inputs, at fp32.

- The bridge carries the moe tree (``layers.moe.{router,w_gate,w_up,
  w_down}`` stacked on the layer axis) bitwise both ways.
- ``_route``: ``gate_idx``, ``slot`` and ``in_cap`` bitwise equal to
  JAX's, ``gate_vals`` within 1e-6 and ``aux`` within rtol 1e-6, in a
  case with room for every token, one that drops tokens (capacity factor
  0.5) and one with planted ties (equal router columns: the lower expert
  index comes first, as ``lax.top_k`` puts it).
- Both grouped dispatches and ``moe_mlp_dense`` within 1e-5 of the output
  scale, through ``moe_mlp``'s regrouping: per-row groups (``B*S`` not a
  multiple of 512) and cross-row groups of 512 tokens (``B*S % 512 ==
  0``), with and without drops.
- ``forward`` (logits and aux loss), ``prefill`` and ``decode_step`` with
  ``advance`` within 1e-5 of the logit scale, for both configs; the
  advance mask freezes a row's position (``tests/test_archs_smoke.py``).
- The compiled engine against JAX's (dense cache, f32 caches on both
  sides, B=4 slots, N=8 episodes, the folded reference on): greedy and
  sampled with JAX's draws, tokens token for token, log-probs within
  1e-5.
- One ``EarlTrainer`` step against JAX's, and one update step on the
  same batch: loss, ``aux_loss``, KL and every updated parameter within
  the stated tolerances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core.stages import EarlTrainer as JaxTrainer
from repro.core.train_step import make_rl_train_step as jax_train_step
from repro.models import moe as jmoe
from repro.models.registry import build_model as jax_build_model
from repro.optim.adamw import adamw as jax_adamw
from repro.rl.engine import CompiledRolloutEngine as JaxEngine
from repro.rl.envs import make_env
from repro.rl.experience import ExperienceBatch as JaxBatch
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core.stages import EarlTrainer
from repro_torch.core.train_step import make_rl_train_step
from repro_torch.models import moe
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import layer_params
from repro_torch.optim.adamw import adamw
from repro_torch.rl.engine import CompiledRolloutEngine
from repro_torch.rl.envs import TicTacToe
from repro_torch.rl.experience import ExperienceBatch

from test_torch_mamba import jax_noise

ARCHS = ["granite-moe-3b-a800m", "grok-1-314b"]
SETTINGS = dict(max_turns=3, max_turn_tokens=4, max_context=96)
B, N = 4, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jmodel = jax_build_model(jax_smoke_config(request.param))
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    tmodel = build_model(get_smoke_config(request.param))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, tmodel, tparams


def f32_caches(jmodel, tmodel):
    """Both models with f32 KV rings (the fp32 comparison's caches)."""
    j = dataclasses.replace(jmodel, _init_cache=lambda cfg, b, s, dtype=None:
                            jmoe.init_cache(cfg, b, s, jnp.float32))
    t = dataclasses.replace(
        tmodel, _init_cache=lambda cfg, b, s, dtype=None, *, device=None:
        moe.init_cache(cfg, b, s, torch.float32, device=device))
    return j, t


def layer0(jparams, tparams):
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["moe"])
    return jp, layer_params(tparams, 0)["moe"]


def with_capacity(cfg, factor):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))


def scale_of(a):
    return float(np.abs(np.asarray(a)).max())


def test_bridge_round_trip(models):
    jmodel, jparams, tmodel, tparams = models
    assert {k: tuple(v.shape) for k, v in tparams.items()} == {
        k: d.shape for k, d in tmodel.defs.items()}
    assert tparams["layers.moe.w_gate"].shape[:2] == (
        tmodel.cfg.n_layers, tmodel.cfg.moe.n_experts)
    back = params_to_numpy(tparams)
    for path, a in jax.tree_util.tree_leaves_with_path(jparams):
        leaf = back
        for k in path:
            leaf = leaf[k.key]
        np.testing.assert_array_equal(leaf, np.asarray(a))


@pytest.mark.parametrize("case", ["room", "drops", "ties"])
def test_route_bitwise(models, case):
    jmodel, jparams, tmodel, tparams = models
    jp, tp = layer0(jparams, tparams)
    factor = 0.5 if case == "drops" else 2.0
    jcfg = with_capacity(jmodel.cfg, factor)
    tcfg = with_capacity(tmodel.cfg, factor)
    if case == "ties":       # experts 1 and 2 score alike on every token
        r = np.asarray(jp["router"]).copy()
        r[:, 2] = r[:, 1]
        jp = dict(jp, router=jnp.asarray(r))
        tp = dict(tp, router=torch.from_numpy(r))
    x = np.random.default_rng(3).standard_normal((3, 24, 128)).astype(
        np.float32)
    jr = jmoe._route(jcfg, jp, jnp.asarray(x))
    tr = moe._route(tcfg, tp, torch.from_numpy(x))
    assert jr[4] == tr[4]                                     # capacity
    for i, name in ((1, "gate_idx"), (2, "slot"), (3, "in_cap")):
        np.testing.assert_array_equal(tr[i].numpy(), np.asarray(jr[i]),
                                      err_msg=name)
    np.testing.assert_allclose(tr[0].numpy(), np.asarray(jr[0]), atol=1e-6)
    np.testing.assert_allclose(float(tr[5]), float(jr[5]), rtol=1e-6)
    dropped = int((~tr[3]).sum())
    assert (dropped > 0) == (case == "drops"), dropped
    if case == "ties":
        idx = tr[1].numpy()
        both = (idx == 1).any(-1) & (idx == 2).any(-1)
        assert both.any()
        pos1 = np.argmax(idx == 1, -1)[both]
        pos2 = np.argmax(idx == 2, -1)[both]
        assert (pos1 < pos2).all()


@pytest.mark.parametrize("shape", [(2, 24), (4, 256)],
                         ids=["row-groups", "cross-row-groups"])
@pytest.mark.parametrize("factor", [2.0, 0.5], ids=["room", "drops"])
@pytest.mark.parametrize("dispatch", ["onehot", "scatter", "dense"])
def test_dispatches_match_jax(models, dispatch, factor, shape):
    jmodel, jparams, tmodel, tparams = models
    jp, tp = layer0(jparams, tparams)
    jcfg = dataclasses.replace(with_capacity(jmodel.cfg, factor),
                               moe_dispatch=dispatch)
    tcfg = dataclasses.replace(with_capacity(tmodel.cfg, factor),
                               moe_dispatch=dispatch)
    x = np.random.default_rng(4).standard_normal(shape + (128,)).astype(
        np.float32)
    fn_j = jmoe.moe_mlp_dense if dispatch == "dense" else jmoe.moe_mlp
    fn_t = moe.moe_mlp_dense if dispatch == "dense" else moe.moe_mlp
    oj, aj = fn_j(jcfg, jp, jnp.asarray(x))
    ot, at = fn_t(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj),
                               atol=1e-5 * scale_of(oj), rtol=0)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6, atol=0)


def test_forward_logits_and_aux_match_jax(models):
    jmodel, jparams, tmodel, tparams = models
    toks = np.random.default_rng(0).integers(0, 512, (2, 40)).astype(
        np.int32)
    lj, aj = jmodel.forward(jparams, jnp.asarray(toks))
    lt, at = tmodel.forward(tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                               atol=1e-5 * scale_of(lj), rtol=0)
    np.testing.assert_allclose(float(at["aux_loss"]),
                               float(aj["aux_loss"]), rtol=1e-6)
    assert float(at["aux_loss"]) > 0


def test_prefill_then_decode_match_jax(models):
    jmodel, jparams, tmodel, tparams = models
    jm, tm = f32_caches(jmodel, tmodel)
    toks = np.random.default_rng(1).integers(0, 512, (3, 30)).astype(
        np.int32)
    adv = np.array([True, False, True])
    jc = jm.init_cache(3, 64)
    tc = tm.init_cache(3, 64, device="cpu")
    jl, jc = jm.prefill(jparams, jnp.asarray(toks[:, :20]), jc)
    tl, tc = tm.prefill(tparams, torch.from_numpy(toks[:, :20]), tc)
    tol = 1e-5 * scale_of(jl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)
    for t in range(20, 30):
        a = adv if t % 3 == 0 else np.ones(3, bool)
        jl, jc = jm.decode_step(jparams, jnp.asarray(toks[:, t]), jc,
                                advance=jnp.asarray(a))
        tl, tc = tm.decode_step(tparams, torch.from_numpy(toks[:, t]), tc,
                                advance=torch.from_numpy(a))
        np.testing.assert_allclose(tl.numpy()[a], np.asarray(jl)[a],
                                   atol=tol, err_msg=f"step {t}")
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    for f in ("k", "v"):
        np.testing.assert_allclose(getattr(tc.kv, f).numpy(),
                                   np.asarray(getattr(jc.kv, f)), atol=1e-5,
                                   err_msg=f)


def test_decode_advance_mask_freezes_rows(models):
    _, _, tmodel, tparams = models
    cache = tmodel.init_cache(2, 24, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, 512, (2, 8)))
    _, cache = tmodel.prefill(tparams, toks, cache)
    _, cache2 = tmodel.decode_step(tparams, torch.tensor([3, 5]), cache,
                                   advance=torch.tensor([True, False]))
    assert cache2.pos.tolist() == [9, 8]


@pytest.mark.parametrize("sampling,temperature", [("fused", 0.0),
                                                  ("fused", 1.0)])
def test_engine_matches_jax_compiled_engine(models, sampling, temperature):
    jmodel, jparams, tmodel, tparams = models
    jm, tm = f32_caches(jmodel, tmodel)
    rng = jax.random.PRNGKey(42)
    kw = dict(cache_layout="dense", sampling=sampling,
              temperature=temperature, **SETTINGS)
    e1, s1 = JaxEngine(jm, make_env("tictactoe"), **kw).run(
        jparams, rng, B, n_episodes=N, ref_params=jparams)
    e2, s2 = CompiledRolloutEngine(tm, TicTacToe(), device="cpu",
                                   **kw).run(tparams, B, N,
                                             noise=jax_noise(rng),
                                             ref_params=tparams)
    for f in ("tokens", "gen_mask", "rewards", "context_len", "truncated"):
        np.testing.assert_array_equal(getattr(e2, f).numpy(),
                                      np.asarray(getattr(e1, f)), err_msg=f)
    for f in ("logprobs", "ref_logprobs"):
        np.testing.assert_allclose(getattr(e2, f).numpy(),
                                   np.asarray(getattr(e1, f)), atol=1e-5,
                                   err_msg=f)
    assert s2.episodes_started == s2.episodes_returned == N
    np.testing.assert_array_equal(s2.turn_lengths, s1.turn_lengths)


def test_sync_step_matches_jax_trainer(models):
    """One folded sync step: return, context length and truncation equal;
    loss and KL within 1e-6 absolute + 1e-4 relative."""
    jmodel, jparams, tmodel, tparams = models
    jm, tm = f32_caches(jmodel, tmodel)
    seed, lr = 7, 3e-4
    settings = dict(batch_size=B, rollout_episodes=N, kl_coef=0.05,
                    clip_eps=0.2, temperature=1.0, rollout_backend="compiled",
                    cache_layout="dense", sampling="fused", **SETTINGS)
    jtr = JaxTrainer(model=jm, env=make_env("tictactoe"),
                     optimizer=jax_adamw(lr, weight_decay=0.0), seed=seed,
                     **settings)
    _, _, jhist = jtr.train(1, params=jparams,
                            opt_state=jtr.optimizer.init(jparams),
                            ref_params=jparams)
    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    ttr = EarlTrainer(model=tm, env=TicTacToe(),
                      optimizer=adamw(lr, weight_decay=0.0), seed=seed,
                      noise=lambda step: jax_noise(sub), device="cpu",
                      **settings)
    assert ttr.ref_folded and ttr.cache_layout == "dense"
    tp = {k: v.clone() for k, v in tparams.items()}
    _, _, thist = ttr.train(1, params=tp, opt_state=ttr.optimizer.init(tp),
                            ref_params=tp)
    j, t = jhist[0], thist[0]
    assert t.mean_return == j.mean_return
    assert t.mean_context_len == j.mean_context_len
    assert t.truncated_frac == j.truncated_frac
    np.testing.assert_allclose(t.loss, j.loss, atol=1e-6, rtol=1e-4)
    np.testing.assert_allclose(t.kl, j.kl, atol=1e-6, rtol=1e-4)


def test_update_step_matches_jax(models):
    """The Update on one batch (KL 0.05, clip 0.2): loss, aux_loss and KL
    within 1e-6 absolute + 1e-5 relative, every updated leaf within 1e-6.
    AdamW runs with eps 1e-3 on both sides: its first step moves a leaf
    by lr g / (|g| + eps), which at the default eps 1e-8 turns the last
    bits of a gradient near eps into up to 1e-5 of movement, so the
    default would hold the optimizer's conditioning, not the gradients."""
    jmodel, jparams, tmodel, tparams = models
    rng = np.random.default_rng(6)
    Bb, T = 4, 32
    tokens = rng.integers(0, 512, (Bb, T)).astype(np.int32)
    mask = rng.random((Bb, T)) < 0.6
    lp = -rng.random((Bb, T)).astype(np.float32) * 3
    batch = dict(tokens=tokens, gen_mask=mask, loss_mask=mask,
                 logprobs=np.where(mask, lp, 0).astype(np.float32),
                 ref_logprobs=np.where(mask, lp - 0.1, 0).astype(np.float32),
                 rewards=rng.standard_normal(Bb).astype(np.float32),
                 returns=rng.standard_normal(Bb).astype(np.float32),
                 advantages=rng.standard_normal(Bb).astype(np.float32),
                 context_len=np.full(Bb, T, np.int32),
                 truncated=np.zeros(Bb, bool))
    kw = dict(clip_eps=0.2, kl_coef=0.05)
    jopt = jax_adamw(1e-3, eps=1e-3, weight_decay=0.0)
    jstep = jax_train_step(jmodel, jopt, **kw)
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in batch.items()})
    jp2, _, jmet = jstep(jparams, jopt.init(jparams), jb)
    topt = adamw(1e-3, eps=1e-3, weight_decay=0.0)
    tstep = make_rl_train_step(tmodel, topt, **kw)
    tb = ExperienceBatch(**{k: torch.from_numpy(np.asarray(v))
                            for k, v in batch.items()})
    tp2, _, tmet = tstep(tparams, topt.init(tparams), tb)
    for k in ("loss", "aux_loss", "kl"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   atol=1e-6, rtol=1e-5, err_msg=k)
    assert float(tmet["aux_loss"]) > 0
    jflat = params_from_numpy(jax.tree.map(np.asarray, jp2))
    for k, v in tp2.items():
        np.testing.assert_allclose(v.numpy(), jflat[k].numpy(), atol=1e-6,
                                   rtol=0, err_msg=k)


def test_paged_layout_refused(models):
    with pytest.raises(ValueError, match="does not support"):
        models[2].init_cache(2, 16, device="cpu", layout="paged")
    with pytest.raises(ValueError, match="cache_layout='dense'"):
        CompiledRolloutEngine(models[2], TicTacToe(), device="cpu")
