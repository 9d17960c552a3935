"""The speculative-decoding slice of the port against the JAX package.

- ``spec_verify_step`` against JAX's on bridged smoke qwen2 params: logits
  within 1e-5 of the logit scale at fp32 (the same f32 math in another
  summation order; 5% at bf16, the tolerance of the card's branch
  phases), block table, refcounts and positions equal. And against K
  sequential port ``decode_step``s from the same cache, within 1e-5 of
  the scale at fp32: the GEMMs see M = B*K rows against M = B, so the
  port does not promise the bitwise equality the CUDA kernel gives per
  query (held on the card in tests/test_torch_cuda.py).
- The port's speculative engine (``"self"``, and ``"draft"`` with a
  one-layer smoke draft model; ``attn_impl="paged"``, so the kernels'
  plain versions) against the JAX speculative engine (``attn_impl="xla"``)
  on TicTacToe at fp32, B=4 slots, N=8 episodes (slots refill), greedy and
  sampled with ``top_p`` 0.9, with JAX's Gumbel draws injected: tokens,
  gen_mask, rewards and context lengths equal, log-probs within 1e-6, and
  the three spec counters equal.
- Speculation on against off in the port: the same committed tokens.
- The JAX engine's bad-config ValueErrors, the counters reaching
  ``StepRecord``, the one-time warning when the reference pass cannot
  fold, and the CLI flags.
"""
import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import transformer as jtf
from repro.models.registry import build_model as jax_build_model
from repro.rl.engine import CompiledRolloutEngine as JaxEngine
from repro.rl.engine import common as jcommon
from repro.rl.envs import make_env
from repro_torch.bridge import params_from_numpy, to_numpy, to_torch
from repro_torch.configs import get_smoke_config
from repro_torch.core.stages import EarlTrainer
from repro_torch.kernels.spec_verify import ops as sv_ops
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as ttf
from repro_torch.models.registry import build_model
from repro_torch.rl.engine import CompiledRolloutEngine
from repro_torch.rl.envs import TicTacToe

SETTINGS = dict(max_turns=2, max_turn_tokens=6, max_context=96,
                cache_layout="paged", page_size=8, kv_dtype="fp32",
                sampling="reference")
B, N = 4, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small eager ops: one intra-op thread per test worker (restored)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config("qwen2-0.5b")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    tmodel = build_model(get_smoke_config("qwen2-0.5b"))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, tmodel, tparams


@pytest.fixture(scope="module")
def draft_models():
    """A one-layer smoke draft model on both sides, the same weights."""
    jd = jax_build_model(dataclasses.replace(
        jax_smoke_config("qwen2-0.5b"), n_layers=1))
    jdp = jd.init(jax.random.PRNGKey(5), dtype=jnp.float32)
    td = build_model(dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                                         n_layers=1))
    return jd, jdp, td, params_from_numpy(jax.tree.map(np.asarray, jdp))


def jax_noise(rng):
    """The JAX engine's draws (see tests/test_torch_engine.py)."""
    base = jax.random.fold_in(rng, 1)

    def noise(kind, m, index, shape):
        trng = jcommon.turn_rng(base, m)
        key = (jcommon.sample_rng(trng, index) if kind == "sample"
               else jcommon.env_rng(trng))
        return to_torch(np.asarray(jax.random.gumbel(key, shape,
                                                     jnp.float32)))
    return noise


# ---------------------------------------------------------------------------
# spec_verify_step
# ---------------------------------------------------------------------------

PS, T = 4, 32
PREFIX = 5                    # mid-page fill line: the chunk maps a new page


def _prefilled(cfg, params, decode_step, init_cache, prefix):
    cache = init_cache()
    for t in range(prefix.shape[1]):
        _, cache = decode_step(cfg, params, prefix[:, t], cache)
    return cache


def _streams(cfg, batch, k, seed=3):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, cfg.vocab_size, (batch, PREFIX)).astype(np.int32),
            rs.randint(0, cfg.vocab_size, (batch, k)).astype(np.int32))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_spec_verify_step_matches_jax(models, dtype):
    """Rows: a full chunk; a chunk cut by eff_k; a row that does not
    advance. Logits (of the written positions), block table, refcounts and
    positions against JAX's ``spec_verify_step`` (``cow=False``: nothing is
    shared)."""
    jmodel, jparams, tmodel, tparams = models
    K = 4
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    if dtype == "bf16":
        jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jdt)
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    prefix, chunk = _streams(jmodel.cfg, 3, K)
    advance = np.array([True, True, False])
    eff_k = np.array([K, 2, 0], np.int32)

    jcache = _prefilled(
        jmodel.cfg, jparams, jtf.decode_step,
        lambda: jmodel.init_cache(3, T, layout="paged", page_size=PS,
                                  kv_dtype=dtype), jnp.asarray(prefix))
    jl, jc = jtf.spec_verify_step(jmodel.cfg, jparams, jnp.asarray(chunk),
                                  jcache, advance=jnp.asarray(advance),
                                  eff_k=jnp.asarray(eff_k), cow=False)
    tcache = _prefilled(
        tmodel.cfg, tparams, ttf.decode_step,
        lambda: tmodel.init_cache(3, T, layout="paged", page_size=PS,
                                  kv_dtype=dtype, device="cpu"),
        torch.from_numpy(prefix))
    tl, tc = ttf.spec_verify_step(tmodel.cfg, tparams,
                                  torch.from_numpy(chunk), tcache,
                                  attn_impl="paged",
                                  advance=torch.from_numpy(advance),
                                  eff_k=torch.from_numpy(eff_k))
    np.testing.assert_array_equal(tc.block_table.numpy(),
                                  np.asarray(jc.block_table))
    np.testing.assert_array_equal(tc.refcount.numpy(),
                                  np.asarray(jc.refcount))
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    assert (tc.pos.numpy() == PREFIX).all()       # not advanced
    jl = np.asarray(jl, np.float32)
    tl = to_numpy(tl.float())
    rel = 1e-5 if dtype == "fp32" else 0.05
    for b, k in enumerate(eff_k):
        scale = float(np.abs(jl[b, :k]).max(initial=0.0))
        np.testing.assert_allclose(tl[b, :k], jl[b, :k], atol=rel * scale,
                                   rtol=0, err_msg=f"row {b}")


@pytest.mark.parametrize("attn_impl", ["paged", "xla"])
def test_spec_verify_step_matches_sequential_decode(models, attn_impl):
    _, _, tmodel, tparams = models
    cfg, K = tmodel.cfg, 4
    prefix, chunk = (torch.from_numpy(a) for a in _streams(cfg, 2, K, 7))
    init = lambda: tmodel.init_cache(2, T, layout="paged", page_size=PS,
                                     kv_dtype="fp32", device="cpu")
    cache = _prefilled(cfg, tparams, ttf.decode_step, init, prefix)
    n0 = sv_ops.launches
    vlogits, vc = ttf.spec_verify_step(cfg, tparams, chunk, cache,
                                       attn_impl=attn_impl)
    assert sv_ops.launches == n0          # CPU tensors: the plain version
    cache = _prefilled(cfg, tparams, ttf.decode_step, init, prefix)
    for j in range(K):
        lj, cache = ttf.decode_step(cfg, tparams, chunk[:, j], cache,
                                    attn_impl=attn_impl)
        torch.testing.assert_close(
            vlogits[:, j], lj, rtol=0,
            atol=1e-5 * float(lj.abs().max()), msg=f"position {j}")
    # the same pages, and the commit brings the fill line to the same place
    assert torch.equal(vc.block_table, cache.block_table)
    assert torch.equal(ttf.spec_commit(vc, torch.full((2,), K)).pos,
                       cache.pos)


def test_draft_params_view_shares_storage(models):
    tparams = models[3]
    view = ttf.draft_params_view(tparams, 1)
    assert view["layers.attn.wq"].shape[0] == 1
    assert view["layers.attn.wq"].data_ptr() == \
        tparams["layers.attn.wq"].data_ptr()
    assert view["embedding"] is tparams["embedding"]


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["self", "draft"])
@pytest.mark.parametrize("temperature,top_p", [(0.0, 1.0), (1.0, 0.9)])
def test_spec_engine_matches_jax(models, draft_models, mode, temperature,
                                 top_p):
    jmodel, jparams, tmodel, tparams = models
    jd, jdp, td, tdp = draft_models
    rng = jax.random.PRNGKey(42)
    kw = dict(temperature=temperature, top_p=top_p, speculation=mode,
              spec_k=4, **SETTINGS)
    jkw = dict(draft_layers=1) if mode == "self" else dict(draft_model=jd)
    tkw = dict(draft_layers=1) if mode == "self" else dict(draft_model=td)
    jeng = JaxEngine(jmodel, make_env("tictactoe"), attn_impl="xla", **kw,
                     **jkw)
    e1, s1 = jeng.run(jparams, rng, B, n_episodes=N,
                      draft_params=jdp if mode == "draft" else None)
    teng = CompiledRolloutEngine(tmodel, TicTacToe(), attn_impl="paged",
                                 device="cpu", **kw, **tkw)
    e2, s2 = teng.run(tparams, B, N, noise=jax_noise(rng),
                      draft_params=tdp if mode == "draft" else None)
    for f in ("tokens", "gen_mask", "rewards", "context_len", "truncated"):
        np.testing.assert_array_equal(getattr(e2, f).numpy(),
                                      np.asarray(getattr(e1, f)), err_msg=f)
    np.testing.assert_allclose(e2.logprobs.numpy(), np.asarray(e1.logprobs),
                               atol=1e-6, rtol=0)
    assert (s2.spec_proposed, s2.spec_accepted, s2.spec_rounds) == (
        s1.spec_proposed, s1.spec_accepted, s1.spec_rounds)
    assert s2.spec_rounds > 0 and s2.spec_accepted <= s2.spec_proposed
    assert s2.episodes_started == s2.episodes_returned == N
    assert s2.kv_dropped_writes == s1.kv_dropped_writes == 0
    assert s2.pages_in_use == s1.pages_in_use


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_spec_on_commits_the_off_stream(models, temperature):
    """The draft only changes how many full-model passes a stream costs:
    speculation on and off commit the same tokens at equal noise. The
    log-probs come from the verify pass's logits, which the CPU GEMMs
    round differently at M = B*K (within 1e-5)."""
    _, _, tmodel, tparams = models
    rng = jax.random.PRNGKey(9)
    kw = dict(temperature=temperature, device="cpu", **SETTINGS)
    off = CompiledRolloutEngine(tmodel, TicTacToe(), **kw)
    on = CompiledRolloutEngine(tmodel, TicTacToe(), speculation="self",
                               spec_k=3, **kw)
    assert on.draft_layers == tmodel.cfg.n_layers // 2
    e0, s0 = off.run(tparams, B, N, noise=jax_noise(rng))
    e1, s1 = on.run(tparams, B, N, noise=jax_noise(rng))
    for f in ("tokens", "gen_mask", "rewards", "context_len"):
        assert torch.equal(getattr(e0, f), getattr(e1, f)), f
    torch.testing.assert_close(e1.logprobs, e0.logprobs, atol=1e-5, rtol=0)
    assert s0.spec_rounds == 0 and s1.spec_rounds > 0


@pytest.mark.parametrize("kw,match", [
    (dict(speculation="maybe"), "speculation must be"),
    (dict(speculation="self", cache_layout="dense"), "cache_layout='paged'"),
    (dict(speculation="self", sampling="fused"), "sampling='fused'"),
    (dict(speculation="self", spec_k=1), "spec_k must be >= 2"),
    (dict(speculation="self", draft_layers=0), "draft_layers"),
    (dict(speculation="self", draft_layers=2), "draft_layers"),
    (dict(speculation="draft"), "requires a draft_model"),
])
def test_bad_configs_raise(models, kw, match):
    base = dict(sampling="reference", device="cpu")
    with pytest.raises(ValueError, match=match):
        CompiledRolloutEngine(models[2], TicTacToe(), **dict(base, **kw))


def test_bad_draft_model_and_run_arguments_raise(models):
    tmodel, tparams = models[2], models[3]
    other = build_model(dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                                            n_layers=1, vocab_size=256))
    with pytest.raises(ValueError, match="must match"):
        CompiledRolloutEngine(tmodel, TicTacToe(), speculation="draft",
                              draft_model=other, sampling="reference",
                              device="cpu")
    same = build_model(dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                                           n_layers=1))
    eng = CompiledRolloutEngine(tmodel, TicTacToe(), speculation="draft",
                                draft_model=same, sampling="reference",
                                device="cpu")
    with pytest.raises(ValueError, match="draft_params"):
        eng.run(tparams, 2)
    eng = CompiledRolloutEngine(tmodel, TicTacToe(), speculation="self",
                                sampling="reference", device="cpu")
    with pytest.raises(ValueError, match="folded reference pass"):
        eng.run(tparams, 2, ref_params=tparams)


# ---------------------------------------------------------------------------
# The trainer and the CLI
# ---------------------------------------------------------------------------

def _trainer(**kw):
    return EarlTrainer(model=build_model(get_smoke_config("qwen2-0.5b")),
                       env=TicTacToe(), device="cpu", batch_size=4,
                       max_turns=2, max_turn_tokens=4, max_context=96,
                       kl_coef=0.05, **kw)


def test_trainer_counters_reach_the_step_record():
    """Speculation unfolds the reference pass (ExpPrep takes its standalone
    route), resolves an unset sampling to "reference" and warns once."""
    tr = _trainer(speculation="self", spec_k=3, draft_layers=1)
    assert (tr.sampling, tr.ref_folded) == ("reference", False)
    assert (tr.rollout.spec_k, tr.rollout.draft_layers) == (3, 1)
    params, opt_state, ref = tr.init_state()
    with pytest.warns(RuntimeWarning, match="speculation='self'"):
        params, opt_state, rec = tr.run_step(0, params, opt_state, ref)
    assert rec.spec_rounds > 0
    assert 0 <= rec.spec_accepted <= rec.spec_proposed
    with warnings.catch_warnings():
        warnings.simplefilter("error")            # warned only once
        _, _, rec1 = tr.run_step(1, params, opt_state, ref)
    assert rec1.spec_rounds > 0 and rec1.kl > 0   # the standalone ref ran


def test_trainer_rejects_fused_sampling_with_speculation():
    with pytest.raises(ValueError, match="sampling='fused'"):
        _trainer(speculation="self", sampling="fused")
    with pytest.raises(ValueError, match="rollout_backend='compiled'"):
        _trainer(speculation="self", rollout_backend="python")


def test_cli_speculation_flags(tmp_path):
    log = tmp_path / "train.jsonl"
    assert train_cli.main([
        "--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
        "--max-turns", "2", "--max-turn-tokens", "3", "--max-context", "96",
        "--speculation", "self", "--spec-k", "4", "--draft-layers", "1",
        "--log", str(log)]) == 0
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1]
    for r in rows:
        assert r["spec_rounds"] > 0
        assert 0 <= r["spec_accepted"] <= r["spec_proposed"]
    with pytest.raises(ValueError, match="requires a draft_model"):
        train_cli.main(["--smoke", "--device", "cpu", "--steps", "1",
                        "--speculation", "draft",
                        "--log", str(tmp_path / "t.jsonl")])
