"""The hybrid family of the port (``models/hybrid.py``: a Mamba2 backbone
with one shared attention block after every ``attn_every`` layers) against
the JAX package on the CPU, at zamba2-1.2b's smoke config (2 layers, a
site after each) and a 3-layer variant with ``attn_every=2`` (one site,
then a last group with none), on JAX's params bridged and numpy-seeded
inputs, at fp32 with f32 caches on both sides.

- The bridge carries the tree across: ``layers`` stacked, ``shared_attn``
  unstacked.
- ``forward`` ("xla" and "flash" at the sites: the kernel's plain version
  on CPU), ``prefill`` and ``decode_step`` with ``advance``: logits within
  1e-5 of the logit scale; conv and SSM states and every site's K/V
  within 1e-5 (SSM 1e-4 relative); the advance mask freezes a row
  (``tests/test_archs_smoke.py``).
- No pass reaches the SSD scan: the Mamba layers take the plain chunked
  form on every route, as in JAX.
- The compiled engine against JAX's compiled engine (dense cache, B=4
  slots, N=8 episodes, folded reference): greedy and sampled with JAX's
  draws, tokens token for token, log-probs within 1e-5; the python engine
  against JAX's python engine, greedy (JAX's two engines agree on this
  family, ``tests/test_engine_parity.py``), log-probs within 1e-5.
- One ``EarlTrainer`` step against JAX's: return, context length and
  truncation equal, loss and KL within 1e-6 absolute + 1e-4 relative,
  every updated leaf within 1e-6 (AdamW eps 1e-3 on both sides, see
  ``tests/test_torch_moe.py``).
- A slot refill zeroes every leaf of the nested cache for that row.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core.stages import EarlTrainer as JaxTrainer
from repro.models import hybrid as jhyb
from repro.models.registry import build_model as jax_build_model
from repro.optim.adamw import adamw as jax_adamw
from repro.rl.engine import CompiledRolloutEngine as JaxEngine
from repro.rl.envs import make_env
from repro.rl.rollout import RolloutEngine as JaxRolloutEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core.stages import EarlTrainer
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import hybrid
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import adamw
from repro_torch.rl.engine import CompiledRolloutEngine
from repro_torch.rl.engine.compiled import _reset_cache_rows
from repro_torch.rl.envs import TicTacToe
from repro_torch.rl.rollout import RolloutEngine

from test_torch_mamba import jax_noise

ARCH = "zamba2-1.2b"
SETTINGS = dict(max_turns=3, max_turn_tokens=4, max_context=96)
B, N = 4, 8
# the smoke config, and 3 layers in groups of 2: a site, then none
VARIANTS = {"smoke": {}, "tail-group": dict(n_layers=3, attn_every=2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(variant):
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), **VARIANTS[variant])
    tcfg = dataclasses.replace(get_smoke_config(ARCH), **VARIANTS[variant])
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    tmodel = build_model(tcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return f32_caches(jmodel, tmodel) + (jparams, tparams)


def f32_caches(jmodel, tmodel):
    """Both models with f32 conv windows and site K/V."""
    j = dataclasses.replace(jmodel, _init_cache=lambda cfg, b, s, dtype=None:
                            jhyb.init_cache(cfg, b, s, jnp.float32))
    t = dataclasses.replace(
        tmodel, _init_cache=lambda cfg, b, s, dtype=None, *, device=None:
        hybrid.init_cache(cfg, b, s, torch.float32, device=device))
    return j, t


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def models(request):
    return _build(request.param)


@pytest.fixture(scope="module")
def smoke():
    return _build("smoke")


def scale_of(a):
    return float(np.abs(np.asarray(a)).max())


def test_bridge_carries_the_tree(models):
    jm, tm, jparams, tparams = models
    assert {k: tuple(v.shape) for k, v in tparams.items()} == {
        k: d.shape for k, d in tm.defs.items()}
    nl = tm.cfg.n_layers
    assert tparams["layers.mixer.in_proj"].shape[0] == nl
    assert tparams["shared_attn.attn.wq"].dim() == 2
    np.testing.assert_array_equal(tparams["shared_attn.mlp.w_up"].numpy(),
                                  np.asarray(jparams["shared_attn"]["mlp"]
                                             ["w_up"]))
    assert hybrid.n_attn_sites(tm.cfg) == jhyb.n_attn_sites(jm.cfg)
    assert hybrid._group_bounds(tm.cfg) == jhyb._group_bounds(jm.cfg)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_forward_logits_match_jax(models, attn_impl):
    jm, tm, jparams, tparams = models
    toks = np.random.default_rng(0).integers(0, 512, (2, 70)).astype(
        np.int32)
    lj, _ = jm.forward(jparams, jnp.asarray(toks),
                       attn_impl="pallas" if attn_impl == "flash" else "xla")
    n0 = ssd_ops.launches
    lt, aux = tm.forward(tparams, torch.from_numpy(toks),
                         attn_impl=attn_impl)
    assert aux == {} and ssd_ops.launches == n0
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                               atol=1e-5 * scale_of(lj), rtol=0)


def test_prefill_then_decode_match_jax(models, monkeypatch):
    jm, tm, jparams, tparams = models
    monkeypatch.setattr(ssd_ops, "ssd_scan", None)     # never reached
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
                                advance=torch.from_numpy(a),
                                attn_impl="pallas")
        np.testing.assert_allclose(tl.numpy()[a], np.asarray(jl)[a],
                                   atol=tol, err_msg=f"step {t}")
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    np.testing.assert_array_equal(tc.mamba.pos.numpy(),
                                  np.asarray(jc.mamba.pos))
    np.testing.assert_allclose(tc.mamba.conv.numpy(),
                               np.asarray(jc.mamba.conv), atol=1e-5)
    np.testing.assert_allclose(tc.mamba.ssm.numpy(),
                               np.asarray(jc.mamba.ssm), atol=1e-5,
                               rtol=1e-4)
    for f in ("k", "v"):
        np.testing.assert_allclose(getattr(tc.attn_kv, f).numpy(),
                                   np.asarray(getattr(jc.attn_kv, f)),
                                   atol=1e-5, err_msg=f)


def test_decode_advance_mask_freezes_rows(smoke):
    _, tm, _, tparams = smoke
    cache = tm.init_cache(2, 24, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, 512, (2, 8)))
    _, cache = tm.prefill(tparams, toks, cache)
    ssm1 = cache.mamba.ssm[:, 1].clone()
    _, cache2 = tm.decode_step(tparams, torch.tensor([3, 5]), cache,
                               advance=torch.tensor([True, False]))
    assert cache2.pos.tolist() == [9, 8]
    assert cache2.mamba.pos.tolist() == [9, 8]
    assert torch.equal(cache2.mamba.ssm[:, 1], ssm1)


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_engine_matches_jax_compiled_engine(smoke, temperature):
    jm, tm, jparams, tparams = smoke
    rng = jax.random.PRNGKey(42)
    kw = dict(cache_layout="dense", sampling="fused",
              temperature=temperature, **SETTINGS)
    e1, s1 = JaxEngine(jm, make_env("tictactoe"), **kw).run(
        jparams, rng, B, n_episodes=N, ref_params=jparams)
    n0 = ssd_ops.launches
    e2, s2 = CompiledRolloutEngine(tm, TicTacToe(), device="cpu",
                                   **kw).run(tparams, B, N,
                                             noise=jax_noise(rng),
                                             ref_params=tparams)
    assert ssd_ops.launches == n0
    for f in ("tokens", "gen_mask", "rewards", "context_len", "truncated"):
        np.testing.assert_array_equal(getattr(e2, f).numpy(),
                                      np.asarray(getattr(e1, f)), err_msg=f)
    for f in ("logprobs", "ref_logprobs"):
        np.testing.assert_allclose(getattr(e2, f).numpy(),
                                   np.asarray(getattr(e1, f)), atol=1e-5,
                                   err_msg=f)
    assert s2.episodes_started == s2.episodes_returned == N
    np.testing.assert_array_equal(s2.turn_lengths, s1.turn_lengths)


def test_python_engine_matches_jax_python_engine(smoke):
    jm, tm, jparams, tparams = smoke
    rng = jax.random.PRNGKey(11)
    kw = dict(temperature=0.0, **SETTINGS)
    e1, s1 = JaxRolloutEngine(jm, make_env("tictactoe"), **kw).run(
        jparams, rng, B)
    e2, s2 = RolloutEngine(tm, TicTacToe(), device="cpu", **kw).run(
        tparams, B, noise=jax_noise(rng))
    for f in ("tokens", "gen_mask", "rewards", "context_len", "truncated"):
        np.testing.assert_array_equal(getattr(e2, f).numpy(),
                                      np.asarray(getattr(e1, f)), err_msg=f)
    np.testing.assert_allclose(e2.logprobs.numpy(), np.asarray(e1.logprobs),
                               atol=1e-5)
    np.testing.assert_array_equal(s2.n_turns, s1.n_turns)


def test_sync_step_matches_jax_trainer(smoke):
    jm, tm, jparams, tparams = smoke
    seed, lr = 7, 3e-4
    settings = dict(batch_size=B, rollout_episodes=N, kl_coef=0.05,
                    clip_eps=0.2, temperature=1.0, rollout_backend="compiled",
                    cache_layout="dense", sampling="fused", **SETTINGS)
    jtr = JaxTrainer(model=jm, env=make_env("tictactoe"),
                     optimizer=jax_adamw(lr, eps=1e-3, weight_decay=0.0),
                     seed=seed, **settings)
    jp2, _, jhist = jtr.train(1, params=jparams,
                            opt_state=jtr.optimizer.init(jparams),
                            ref_params=jparams)
    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    ttr = EarlTrainer(model=tm, env=TicTacToe(),
                      optimizer=adamw(lr, eps=1e-3, weight_decay=0.0),
                      seed=seed, noise=lambda step: jax_noise(sub),
                      device="cpu", **settings)
    assert ttr.ref_folded and ttr.cache_layout == "dense"
    tp = {k: v.clone() for k, v in tparams.items()}
    tp2, _, thist = ttr.train(1, params=tp,
                              opt_state=ttr.optimizer.init(tp), ref_params=tp)
    j, t = jhist[0], thist[0]
    assert t.mean_return == j.mean_return
    assert t.mean_context_len == j.mean_context_len
    assert t.truncated_frac == j.truncated_frac
    np.testing.assert_allclose(t.loss, j.loss, atol=1e-6, rtol=1e-4)
    np.testing.assert_allclose(t.kl, j.kl, atol=1e-6, rtol=1e-4)
    jflat = params_from_numpy(jax.tree.map(np.asarray, jp2))
    for k, v in tp2.items():
        np.testing.assert_allclose(v.numpy(), jflat[k].numpy(), atol=1e-6,
                                   rtol=0, err_msg=k)


def test_refill_zeroes_every_leaf_of_a_row(smoke):
    _, tm, _, _ = smoke
    cache = tm.init_cache(3, 16, device="cpu")
    for t in (cache.mamba.conv, cache.mamba.ssm, cache.attn_kv.k,
              cache.attn_kv.v):
        t.normal_()
    pos = torch.tensor([5, 6, 7], dtype=torch.int32)
    cache = cache._replace(pos=pos, mamba=cache.mamba._replace(pos=pos))
    before = [t.clone() for t in (cache.mamba.conv, cache.mamba.ssm,
                                  cache.attn_kv.k, cache.attn_kv.v)]
    out = _reset_cache_rows(cache, torch.tensor([False, True, False]))
    assert isinstance(out, hybrid.HybridCache)
    assert out.pos.tolist() == out.mamba.pos.tolist() == [5, 0, 7]
    for t, t0 in zip((out.mamba.conv, out.mamba.ssm, out.attn_kv.k,
                      out.attn_kv.v), before):
        assert not t[:, 1].any()
        assert torch.equal(t[:, [0, 2]], t0[:, [0, 2]])


def test_trainer_routes_and_refuses_the_paged_pool(smoke):
    _, tm, _, _ = smoke
    tr = EarlTrainer(model=tm, env=TicTacToe(), device="cpu",
                     batch_size=B, kl_coef=0.05, **SETTINGS)
    assert (tr.cache_layout, tr.ref_folded) == ("dense", True)
    assert tr.rollout.attn_impl == "pallas"
    with pytest.raises(ValueError, match="cache_layout='dense'"):
        EarlTrainer(model=tm, env=TicTacToe(), device="cpu",
                    cache_layout="paged")
