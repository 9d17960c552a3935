"""The whole slice: the PyTorch port's rollout engine (paged KV pool with
``attn_impl="paged"``, or the dense cache with ``attn_impl="pallas"``: the
kernels' plain versions on CPU; ``sampling="fused"``) against the JAX
``CompiledRolloutEngine`` (the same layout, ``attn_impl="xla"``) on
TicTacToe with fp32 params and fp32 KV, B=4 slots and N=8 episodes (so
slots refill). Greedy, and at temperature 1.0 with JAX's own Gumbel draws
fed through ``noise``: tokens, gen_mask, rewards, context lengths and
truncation are equal; log-probs within atol 1e-5.

The folded reference pass (``run(ref_params=...)``) is held against the
JAX engine's: the reference decodes on its own dense bf16 cache on both
sides, so the harvested ``ref_logprobs`` agree within atol 1e-4 (the same
bf16 roundings of f32 K/V that differ in their last bits)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro.rl.engine import CompiledRolloutEngine as JaxEngine
from repro.rl.engine import common as jcommon
from repro.rl.envs import make_env
from repro_torch.bridge import params_from_numpy, to_torch
from repro_torch.configs import get_smoke_config
from repro_torch.core.resharding import MeshConfig
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.fused_sample import ops as fs_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models.registry import build_model
from repro_torch.rl.engine import CompiledRolloutEngine
from repro_torch.rl.envs import TicTacToe

# tests/test_engine_parity.py's ENV_SETTINGS["tictactoe"]
SETTINGS = dict(max_turns=3, max_turn_tokens=4, max_context=96)
B, N = 4, 8


@pytest.fixture(scope="module")
def models():
    jmodel = jax_build_model(jax_smoke_config("qwen2-0.5b"))
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    tmodel = build_model(get_smoke_config("qwen2-0.5b"))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, tmodel, tparams


def jax_noise(rng):
    """The JAX engine's draws: token t of macro-step m samples with
    gumbel(sample_rng(turn_rng(fold_in(rng, 1), m), t)); the opponent
    with gumbel(env_rng(turn_rng(fold_in(rng, 1), m)))."""
    base = jax.random.fold_in(rng, 1)

    def noise(kind, m, index, shape):
        trng = jcommon.turn_rng(base, m)
        key = (jcommon.sample_rng(trng, index) if kind == "sample"
               else jcommon.env_rng(trng))
        return to_torch(np.asarray(jax.random.gumbel(key, shape,
                                                     jnp.float32)))
    return noise


@pytest.mark.parametrize("layout,attn_impl", [("paged", "paged"),
                                              ("dense", "pallas"),
                                              ("dense", "xla")])
@pytest.mark.parametrize("sampling,temperature,top_p", [
    ("fused", 0.0, 1.0), ("fused", 1.0, 1.0),
    # the reference sampler (jax.random.categorical is Gumbel-argmax over
    # the same draw) with a nucleus filter in the loop
    ("reference", 1.0, 0.9)])
def test_trajectories_match_jax_engine(models, sampling, temperature, top_p,
                                       layout, attn_impl):
    jmodel, jparams, tmodel, tparams = models
    rng = jax.random.PRNGKey(42)
    kw = dict(cache_layout=layout, sampling=sampling, kv_dtype="fp32",
              page_size=16, temperature=temperature, top_p=top_p, **SETTINGS)
    jeng = JaxEngine(jmodel, make_env("tictactoe"), attn_impl="xla", **kw)
    e1, s1 = jeng.run(jparams, rng, B, n_episodes=N)
    teng = CompiledRolloutEngine(tmodel, TicTacToe(), attn_impl=attn_impl,
                                 device="cpu", **kw)
    n0 = (pa_ops.launches, fs_ops.launches, da_ops.launches)
    e2, s2 = teng.run(tparams, B, N, noise=jax_noise(rng))
    # CPU tensors take the plain versions: no kernel launched
    assert (pa_ops.launches, fs_ops.launches, da_ops.launches) == n0
    for f in ("tokens", "gen_mask", "rewards", "context_len", "truncated"):
        np.testing.assert_array_equal(getattr(e2, f).numpy(),
                                      np.asarray(getattr(e1, f)), err_msg=f)
    np.testing.assert_allclose(e2.logprobs.numpy(), np.asarray(e1.logprobs),
                               atol=1e-5)
    np.testing.assert_allclose(e2.advantages.numpy(),
                               np.asarray(e1.advantages), atol=1e-6)
    assert s2.episodes_started == s2.episodes_returned == N
    assert (s1.episodes_started, s1.episodes_returned) == (N, N)
    np.testing.assert_array_equal(s2.n_turns, s1.n_turns)
    np.testing.assert_array_equal(s2.turn_lengths, s1.turn_lengths)
    assert s2.kv_dropped_writes == s1.kv_dropped_writes == 0
    assert s2.pages_in_use == s1.pages_in_use
    assert s2.page_capacity == s1.page_capacity
    assert (s2.pages_in_use > 0) == (layout == "paged")
    assert not e2.ref_logprobs.any()              # no reference stream


@pytest.mark.parametrize("layout,temperature", [("paged", 1.0),
                                                ("dense", 0.0)])
def test_folded_ref_logprobs_match_jax_engine(models, layout, temperature):
    """The policy at fp32 (paged or dense fp32 KV) with the reference
    stream folded in on its dense bf16 cache; the reference is the policy
    itself, as in the trainer's first step."""
    jmodel, jparams, tmodel, tparams = models
    rng = jax.random.PRNGKey(3)
    kw = dict(cache_layout=layout, sampling="fused", kv_dtype="fp32",
              temperature=temperature, **SETTINGS)
    jeng = JaxEngine(jmodel, make_env("tictactoe"), attn_impl="xla", **kw)
    e1, _ = jeng.run(jparams, rng, B, n_episodes=N, ref_params=jparams)
    teng = CompiledRolloutEngine(tmodel, TicTacToe(), device="cpu", **kw)
    assert teng.ref_attn_impl == "pallas"
    e2, s2 = teng.run(tparams, B, N, noise=jax_noise(rng),
                      ref_params=tparams)
    np.testing.assert_array_equal(e2.tokens.numpy(), np.asarray(e1.tokens))
    ref1 = np.asarray(e1.ref_logprobs)
    np.testing.assert_allclose(e2.ref_logprobs.numpy(), ref1, atol=1e-4)
    # scored exactly at the fed positions 1 .. context_len-1
    T = ref1.shape[1]
    fed = ((np.arange(T)[None, :] >= 1)
           & (np.arange(T)[None, :] < e2.context_len.numpy()[:, None]))
    assert (e2.ref_logprobs.numpy()[~fed] == 0).all()
    assert (e2.ref_logprobs.numpy()[fed] < 0).all()
    # the reference IS the policy: on generated tokens its log-probs are
    # the behaviour log-probs, up to the bf16 rounding of its cache
    gen = e2.gen_mask.numpy()
    np.testing.assert_allclose(e2.ref_logprobs.numpy()[gen],
                               e2.logprobs.numpy()[gen], atol=0.05)
    assert s2.episodes_returned == N


def test_dense_refill_zeroes_rows(models):
    """A refilled dense row is zeroed in every leaf, pos included, and the
    other rows are untouched."""
    from repro_torch.rl.engine.compiled import _reset_cache_rows
    tmodel = models[2]
    cache = tmodel.init_cache(3, 16, kv_dtype="fp32", device="cpu")
    cache.kv.k.normal_()
    cache.kv.v.normal_()
    cache = cache._replace(pos=torch.tensor([5, 6, 7], dtype=torch.int32))
    k0 = cache.kv.k.clone()
    refill = torch.tensor([False, True, False])
    out = _reset_cache_rows(cache, refill)
    assert out.pos.tolist() == [5, 0, 7]
    assert not out.kv.k[:, 1].any() and not out.kv.v[:, 1].any()
    assert torch.equal(out.kv.k[:, [0, 2]], k0[:, [0, 2]])


def test_small_pool_counts_or_raises(models):
    """A pool too small for the batch drops KV writes: "count" records
    them, "raise" fails at the once-per-turn check."""
    _, _, tmodel, tparams = models
    kw = dict(attn_impl="paged", sampling="fused", kv_dtype="fp32",
              page_size=4, cache_pages=6, temperature=0.0, device="cpu",
              **SETTINGS)
    _, st = CompiledRolloutEngine(tmodel, TicTacToe(), on_exhaust="count",
                                  **kw).run(tparams, B, N)
    assert st.kv_dropped_writes > 0
    assert st.episodes_started == st.episodes_returned == N
    with pytest.raises(RuntimeError, match="pool exhausted"):
        CompiledRolloutEngine(tmodel, TicTacToe(), on_exhaust="raise",
                              **kw).run(tparams, B, N)


@pytest.mark.parametrize("option,value,error,item", [
    ("mesh_config", MeshConfig("dp2", dp=2, tp=1), ValueError, "ranks 0..1"),
    ("mesh_config", MeshConfig("tp2", dp=1, tp=2), ValueError, "ranks 0..1"),
    ("share_prefix", dict(share_prefix=True), ValueError, "ranks 0..1"),
    ("on_exhaust", dict(on_exhaust="preempt"), ValueError, "ranks 0..1"),
    ("pool_growth", dict(pool_growth="double"), ValueError, "ranks 0..1"),
    ("speculation", dict(speculation="self", sampling="reference"),
     ValueError, "ranks 0..1"),
])
def test_unported_options_raise(models, option, value, error, item):
    """dp and tp above 1 run the data-parallel and the tensor-parallel
    rollouts with every paged-pool option (tests/test_torch_dp.py,
    tests/test_torch_dp_options.py, tests/test_torch_tp_options.py): in
    this world of one rank a config of two ranks stops at the world check,
    which names the mesh, whatever option it carries."""
    tmodel = models[2]
    kw = ({option: value} if option == "mesh_config"
          else dict(value, mesh_config=MeshConfig("dp2", dp=2, tp=1)))
    with pytest.raises(error, match=item) as e:
        CompiledRolloutEngine(tmodel, TicTacToe(), device="cpu",
                              kv_dtype="int8", **kw)
    name = kw["mesh_config"].name
    assert f"mesh_config {name!r}" in str(e.value)


@pytest.mark.parametrize("layout,attn_impl", [("dense", "paged"),
                                              ("paged", "pallas"),
                                              ("paged", "flash")])
def test_attn_impl_must_fit_the_layout(models, layout, attn_impl):
    with pytest.raises(ValueError, match="attn_impl"):
        CompiledRolloutEngine(models[2], TicTacToe(), device="cpu",
                              cache_layout=layout, attn_impl=attn_impl)

