"""The ssm slice (mamba2) of the port against the JAX package on the CPU,
at the smoke config (2 layers, d_model 128, 8 SSM heads x 32, state 16,
chunk 32), with JAX's params bridged and JAX's Gumbel draws injected.

- The bridge round-trips the mamba params bitwise.
- ``forward`` logits at fp32, "xla" (the chunked form) and "pallas" (the
  SSD scan wrapper: the kernel's plain version on CPU; JAX's Pallas kernel
  interpreted) on both sides: within 2e-5 absolute of a 0.95 scale (the
  same f32 math in another summation order; measured 4e-6).
- ``prefill`` then ``decode_step`` with ``advance`` against JAX: logits
  within 2e-5, conv and SSM states within 1e-5 / 1e-4.
- The compiled engine (dense layout, B=4 slots, N=8 episodes, so slots
  refill; the folded reference stream on) against JAX's compiled engine,
  greedy and sampled (fused, and the reference sampler with top_p 0.9):
  tokens, gen_mask, rewards, context lengths and truncation equal,
  log-probs and reference log-probs within 1e-5 (measured 1e-6). At
  fp32 both sides run the model on f32 caches: JAX's compiled engine
  cannot carry an fp32 model on its default bf16 cache (its decode
  returns an f32 conv window and the scan carry's dtype changes), so a
  test-side ``init_cache`` gives both engines f32 caches. At bf16 (params
  and caches, JAX's defaults) the streams are held token for token too,
  log-probs within 2e-2 (bf16 GEMMs in another order; measured 8e-3).
  Not against JAX's python engine: the two JAX engines disagree on mamba2
  (ROADMAP Queue 3).
- The port's python engine against its compiled engine (B=N=4).
- Three ``EarlTrainer`` steps against JAX's on the compiled backend
  (fp32, f32 caches, KL 0.05, clip 0.2): return, context length and
  truncation equal, loss and KL within 1e-6 absolute + 1e-4 relative.
- The trainer's ssm routing: ExpPrep's standalone pass through the SSD
  scan wrapper once per layer, the Update through the chunked form; the
  paged layout refused; refill zeroing every conv and SSM row; the CLI.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core.stages import EarlTrainer as JaxTrainer
from repro.models import mamba as jmamba
from repro.models.registry import build_model as jax_build_model
from repro.optim.adamw import adamw as jax_adamw
from repro.rl.engine import CompiledRolloutEngine as JaxEngine
from repro.rl.engine import common as jcommon
from repro.rl.envs import make_env
from repro_torch.bridge import params_from_numpy, params_to_numpy, to_torch
from repro_torch.configs import get_smoke_config
from repro_torch.core.stages import EarlTrainer, ExpPrepStage
from repro_torch.kernels.fused_sample import ops as fs_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import train as train_cli
from repro_torch.models import mamba
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import adamw
from repro_torch.rl.engine import CompiledRolloutEngine
from repro_torch.rl.engine.compiled import _reset_cache_rows
from repro_torch.rl.envs import TicTacToe
from repro_torch.rl.rollout import RolloutEngine

ARCH = "mamba2-370m"
SETTINGS = dict(max_turns=3, max_turn_tokens=4, max_context=96)
B, N = 4, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small eager ops: one intra-op thread per test worker (restored
    afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32_caches(jmodel, tmodel):
    """Both models with ``init_cache`` giving f32 conv windows (the SSM
    state is f32 anyway): the fp32 comparison's caches."""
    j = dataclasses.replace(jmodel, _init_cache=lambda cfg, b, s, dtype=None:
                            jmamba.init_cache(cfg, b, s, jnp.float32))
    t = dataclasses.replace(
        tmodel, _init_cache=lambda cfg, b, s, dtype=None, *, device=None:
        mamba.init_cache(cfg, b, s, torch.float32, device=device))
    return j, t


@pytest.fixture(scope="module")
def models():
    jmodel = jax_build_model(jax_smoke_config(ARCH))
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    tmodel = build_model(get_smoke_config(ARCH))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, tmodel, tparams


def jax_noise(rng):
    """The JAX engine's draws for one rollout keyed by ``rng`` (see
    tests/test_torch_engine.py)."""
    base = jax.random.fold_in(rng, 1)

    def noise(kind, m, index, shape):
        trng = jcommon.turn_rng(base, m)
        key = (jcommon.sample_rng(trng, index) if kind == "sample"
               else jcommon.env_rng(trng))
        return to_torch(np.asarray(jax.random.gumbel(key, shape,
                                                     jnp.float32)))
    return noise


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_bridge_round_trip(models, dtype):
    jmodel, _, tmodel, _ = models
    jp = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(1),
                                              dtype=dtype))
    tp = params_from_numpy(jp)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: d.shape for k, d in tmodel.defs.items()}
    back = params_to_numpy(tp)
    for path, a in jax.tree_util.tree_leaves_with_path(jp):
        leaf = back
        for k in path:
            leaf = leaf[k.key]
        assert leaf.dtype == a.dtype
        np.testing.assert_array_equal(leaf.view(np.uint8), a.view(np.uint8))


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_forward_logits_match_jax(models, attn_impl):
    jmodel, jparams, tmodel, tparams = models
    toks = np.random.default_rng(0).integers(0, 512, (2, 70)).astype(
        np.int32)                   # 70 = two chunks of 32 and a ragged 6
    lj, _ = jmodel.forward(jparams, jnp.asarray(toks), attn_impl=attn_impl)
    lt, aux = tmodel.forward(tparams, torch.from_numpy(toks),
                             attn_impl=attn_impl)
    assert aux == {}
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-5,
                               rtol=0)


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
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5)
    for t in range(20, 30):
        a = adv if t % 3 == 0 else np.ones(3, bool)
        jl, jc = jm.decode_step(jparams, jnp.asarray(toks[:, t]), jc,
                                advance=jnp.asarray(a))
        tl, tc = tm.decode_step(tparams, torch.from_numpy(toks[:, t]), tc,
                                advance=torch.from_numpy(a))
        np.testing.assert_allclose(tl.numpy()[a], np.asarray(jl)[a],
                                   atol=2e-5, err_msg=f"step {t}")
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    for f in ("conv", "ssm"):
        np.testing.assert_allclose(getattr(tc, f).numpy(),
                                   np.asarray(getattr(jc, f)), atol=1e-5,
                                   rtol=1e-4, err_msg=f)


@pytest.mark.parametrize("sampling,temperature,top_p", [
    ("fused", 0.0, 1.0), ("fused", 1.0, 1.0), ("reference", 1.0, 0.9)])
def test_engine_matches_jax_compiled_engine(models, sampling, temperature,
                                            top_p):
    jmodel, jparams, tmodel, tparams = models
    jm, tm = f32_caches(jmodel, tmodel)
    rng = jax.random.PRNGKey(42)
    kw = dict(cache_layout="dense", sampling=sampling,
              temperature=temperature, top_p=top_p, **SETTINGS)
    e1, s1 = JaxEngine(jm, make_env("tictactoe"), **kw).run(
        jparams, rng, B, n_episodes=N, ref_params=jparams)
    n0 = (ssd_ops.launches, fs_ops.launches)
    e2, s2 = CompiledRolloutEngine(tm, TicTacToe(), device="cpu",
                                   **kw).run(tparams, B, N,
                                             noise=jax_noise(rng),
                                             ref_params=tparams)
    assert (ssd_ops.launches, fs_ops.launches) == n0   # plain on CPU
    for f in ("tokens", "gen_mask", "rewards", "context_len", "truncated"):
        np.testing.assert_array_equal(getattr(e2, f).numpy(),
                                      np.asarray(getattr(e1, f)), err_msg=f)
    for f in ("logprobs", "ref_logprobs"):
        np.testing.assert_allclose(getattr(e2, f).numpy(),
                                   np.asarray(getattr(e1, f)), atol=1e-5,
                                   err_msg=f)
    assert s2.episodes_started == s2.episodes_returned == N
    np.testing.assert_array_equal(s2.n_turns, s1.n_turns)
    np.testing.assert_array_equal(s2.turn_lengths, s1.turn_lengths)
    assert s2.pages_in_use == s2.page_capacity == 0
    assert (e2.ref_logprobs.numpy() != 0).any()


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_engine_matches_jax_compiled_engine_bf16(models, temperature):
    """JAX's defaults: bf16 params, bf16 conv caches."""
    jmodel, _, tmodel, _ = models
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    rng = jax.random.PRNGKey(43)
    kw = dict(cache_layout="dense", sampling="fused",
              temperature=temperature, **SETTINGS)
    e1, _ = JaxEngine(jmodel, make_env("tictactoe"), **kw).run(
        jparams, rng, B, n_episodes=N, ref_params=jparams)
    e2, _ = CompiledRolloutEngine(tmodel, TicTacToe(), device="cpu",
                                  **kw).run(tparams, B, N,
                                            noise=jax_noise(rng),
                                            ref_params=tparams)
    for f in ("tokens", "gen_mask", "rewards", "context_len"):
        np.testing.assert_array_equal(getattr(e2, f).numpy(),
                                      np.asarray(getattr(e1, f)), err_msg=f)
    for f in ("logprobs", "ref_logprobs"):
        np.testing.assert_allclose(getattr(e2, f).numpy(),
                                   np.asarray(getattr(e1, f)), atol=2e-2,
                                   err_msg=f)


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_python_engine_matches_compiled_engine(models, temperature):
    """The python loop (prefill through the chunked form with the cache's
    initial state, then recurrent decode) against the compiled engine's
    all-recurrent feed: tokens equal, log-probs within 1e-5 (measured
    5e-7)."""
    _, _, tmodel, tparams = models
    _, tm = f32_caches(jax_build_model(jax_smoke_config(ARCH)), tmodel)
    kw = dict(temperature=temperature, **SETTINGS)
    noise = jax_noise(jax.random.PRNGKey(44))
    e1, s1 = RolloutEngine(tm, TicTacToe(), device="cpu", **kw).run(
        tparams, B, noise=noise)
    e2, s2 = CompiledRolloutEngine(tm, TicTacToe(), device="cpu",
                                   cache_layout="dense",
                                   sampling="reference", **kw).run(
        tparams, B, B, noise=noise)
    for f in ("tokens", "gen_mask", "rewards", "context_len"):
        assert torch.equal(getattr(e1, f), getattr(e2, f)), f
    torch.testing.assert_close(e1.logprobs, e2.logprobs, atol=1e-5, rtol=0)
    assert s1.episodes_returned == s2.episodes_returned == B


def test_three_sync_steps_match_jax_trainer(models):
    jmodel, jparams, tmodel, tparams = models
    jm, tm = f32_caches(jmodel, tmodel)
    steps, seed, lr = 3, 7, 3e-4
    settings = dict(batch_size=B, rollout_episodes=N, kl_coef=0.05,
                    clip_eps=0.2, temperature=1.0, rollout_backend="compiled",
                    cache_layout="dense", sampling="fused", **SETTINGS)
    jtr = JaxTrainer(model=jm, env=make_env("tictactoe"),
                     optimizer=jax_adamw(lr, weight_decay=0.0), seed=seed,
                     **settings)
    assert jtr.ref_folded
    _, _, jhist = jtr.train(steps, params=jparams,
                            opt_state=jtr.optimizer.init(jparams),
                            ref_params=jparams)
    rng, keys = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        keys.append(sub)
    ttr = EarlTrainer(model=tm, env=TicTacToe(),
                      optimizer=adamw(lr, weight_decay=0.0), seed=seed,
                      noise=lambda step: jax_noise(keys[step]),
                      device="cpu", **settings)
    assert ttr.ref_folded
    tp = {k: v.clone() for k, v in tparams.items()}
    _, _, thist = ttr.train(steps, params=tp,
                            opt_state=ttr.optimizer.init(tp), ref_params=tp)
    assert len(thist) == len(jhist) == steps
    for j, t in zip(jhist, thist):
        assert t.mean_return == j.mean_return, t.step
        assert t.mean_context_len == j.mean_context_len, t.step
        assert t.truncated_frac == j.truncated_frac, t.step
        np.testing.assert_allclose(t.loss, j.loss, atol=1e-6, rtol=1e-4)
        np.testing.assert_allclose(t.kl, j.kl, atol=1e-6, rtol=1e-4)
    assert thist[1].kl > 0


def test_trainer_routes_ssm_passes(models, monkeypatch):
    """attn_impl="paged" on ssm: the layout resolves to "dense"; ExpPrep's
    standalone pass goes through the SSD scan wrapper once per layer (and
    matches the fold within 0.05: the fold decodes recurrently on a bf16
    conv cache); the Update runs the chunked form under autograd; an
    explicit paged layout raises."""
    _, _, tmodel, _ = models
    tr = EarlTrainer(model=tmodel, env=TicTacToe(), device="cpu",
                     batch_size=B, kl_coef=0.05, clip_eps=0.2, **SETTINGS)
    assert (tr.cache_layout, tr.sampling, tr.ref_folded) == ("dense",
                                                             "fused", True)
    calls = []
    scan = ssd_ops.ssd_scan
    monkeypatch.setattr(ssd_ops, "ssd_scan",
                        lambda *a, **k: calls.append(1) or scan(*a, **k))
    params = tmodel.init(torch.Generator().manual_seed(0),
                         dtype=torch.float32)
    exp, _ = tr.rollout.run(params, B, noise=tr.rollout.default_noise(
        torch.Generator().manual_seed(1)), ref_params=params)
    alone = tr.expprep_stage(exp, ref_params=params, ref_folded=False)
    assert len(calls) == tmodel.cfg.n_layers
    fed = exp.ref_logprobs != 0
    assert int(fed.sum()) > 0
    torch.testing.assert_close(alone.ref_logprobs[fed],
                               exp.ref_logprobs[fed], atol=0.05, rtol=0)
    _, _, metrics = tr.update_stage(params, tr.optimizer.init(params),
                                    alone)
    assert len(calls) == tmodel.cfg.n_layers and torch.isfinite(
        metrics["loss"])
    with pytest.raises(ValueError, match="cache_layout='dense'"):
        EarlTrainer(model=tmodel, env=TicTacToe(), device="cpu",
                    cache_layout="paged")


def test_kernel_route_raises_under_autograd(models):
    """The SSD scan has no backward in either package: the "pallas"
    forward refuses autograd, the "xla" one trains."""
    _, _, tmodel, tparams = models
    p = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    toks = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(RuntimeError, match="no backward"):
        tmodel.forward(p, toks, attn_impl="pallas")
    logits, _ = tmodel.forward(p, toks, attn_impl="xla")
    logits.sum().backward()
    assert p["layers.mixer.in_proj"].grad is not None
    stage = ExpPrepStage(tmodel, attn_impl="pallas")   # runs under no_grad
    assert stage._ref_step(p, toks).shape == (1, 8)


@pytest.mark.parametrize("kw", [dict(layout="paged"), dict(kv_dtype="fp32"),
                                dict(page_size=16)])
def test_cache_layout_options_raise(models, kw):
    with pytest.raises(ValueError, match="does not support"):
        models[2].init_cache(2, 16, device="cpu", **kw)


def test_engine_refuses_the_paged_pool(models):
    with pytest.raises(ValueError, match="cache_layout='dense'"):
        CompiledRolloutEngine(models[2], TicTacToe(), device="cpu")


def test_refill_zeroes_conv_and_ssm_rows(models):
    """A stale SSM state corrupts every later token: a refilled row is
    zeroed in every leaf, pos included; other rows are untouched."""
    cache = models[2].init_cache(3, 16, device="cpu")
    cache.conv.normal_()
    cache.ssm.normal_()
    cache = cache._replace(pos=torch.tensor([5, 6, 7], dtype=torch.int32))
    conv0, ssm0 = cache.conv.clone(), cache.ssm.clone()
    out = _reset_cache_rows(cache, torch.tensor([False, True, False]))
    assert isinstance(out, mamba.MambaCache)
    assert out.pos.tolist() == [5, 0, 7]
    assert not out.conv[:, 1].any() and not out.ssm[:, 1].any()
    assert torch.equal(out.conv[:, [0, 2]], conv0[:, [0, 2]])
    assert torch.equal(out.ssm[:, [0, 2]], ssm0[:, [0, 2]])


def test_cli_runs_mamba_smoke_steps(tmp_path):
    log = tmp_path / "train.jsonl"
    assert train_cli.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
        "--batch", "4", "--max-turns", "2", "--max-turn-tokens", "3",
        "--max-context", "96", "--log", str(log)]) == 0
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["loss"]) and r["page_capacity"] == 0
               for r in rows)
    assert rows[1]["kl"] > 0
    with pytest.raises(ValueError, match="cache_layout='dense'"):
        train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--cache-layout", "paged"])
