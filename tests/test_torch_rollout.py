"""The port's python reference ``RolloutEngine`` (prefill, then one
``decode_step`` per host step on a dense bf16 cache, plain attention)
against JAX's ``RolloutEngine`` and against the port's compiled engine on
the dense layout, on TicTacToe with fp32 params and B=4 episodes.

Against JAX: greedy, and sampled at temperature 1.0 with JAX's per-turn
Gumbel draws injected through ``noise`` (the reference sampler is
Gumbel-argmax over the same draw): tokens, gen_mask, rewards, context
lengths, truncation and turn counts are equal; log-probs within atol 1e-5
(f32 math in another order over the same bf16 K/V); with ``ref_params``
the reference log-probs (one full-sequence pass on each side) within
atol 1e-5.

Against the compiled engine (dense bf16 cache, greedy, the split-K
kernel's plain version, the same opponent draws): the same trajectories,
log-probs within atol 1e-4 + rtol 1e-3, the tolerance with which JAX's
``tests/test_engine_parity.py`` holds its two engines (the prefill attends
over the prompt's own f32 K/V, token-by-token feeding over the bf16 cache;
measured at most 5.6e-4 on log-probs near -5.6), and the folded
reference log-probs against the python engine's full-sequence pass within
atol 0.05 (the fold scores from a bf16 cache).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro.rl.envs import make_env
from repro.rl.rollout import RolloutEngine as JaxRolloutEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models.registry import build_model
from repro_torch.rl.engine import CompiledRolloutEngine
from repro_torch.rl.envs import TicTacToe
from repro_torch.rl.rollout import RolloutEngine

from test_torch_engine import jax_noise

SETTINGS = dict(max_turns=3, max_turn_tokens=4, max_context=96)
B = 4
FIELDS = ("tokens", "gen_mask", "rewards", "context_len", "truncated")


@pytest.fixture(scope="module")
def models():
    jmodel = jax_build_model(jax_smoke_config("qwen2-0.5b"))
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    tmodel = build_model(get_smoke_config("qwen2-0.5b"))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, tmodel, tparams


def _same(e_t, e_j, atol, rtol=1e-7):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(e_t, f)),
                                      np.asarray(getattr(e_j, f)), err_msg=f)
    np.testing.assert_allclose(np.asarray(e_t.logprobs),
                               np.asarray(e_j.logprobs), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_python_engine_matches_jax(models, temperature):
    jmodel, jparams, tmodel, tparams = models
    rng = jax.random.PRNGKey(42)
    kw = dict(temperature=temperature, **SETTINGS)
    e1, s1 = JaxRolloutEngine(jmodel, make_env("tictactoe"), **kw).run(
        jparams, rng, B, ref_params=jparams)
    eng = RolloutEngine(tmodel, TicTacToe(), device="cpu", **kw)
    e2, s2 = eng.run(tparams, B, noise=jax_noise(rng), ref_params=tparams)
    _same(e2, e1, 1e-5)
    np.testing.assert_allclose(e2.ref_logprobs.numpy(),
                               np.asarray(e1.ref_logprobs), atol=1e-5)
    np.testing.assert_array_equal(s2.n_turns, s1.n_turns)
    np.testing.assert_array_equal(s2.turn_lengths, s1.turn_lengths)
    assert s2.episodes_started == s2.episodes_returned == B


def test_python_engine_matches_compiled_dense_engine(models):
    """Both engines take the same opponent draws."""
    _, _, tmodel, tparams = models
    kw = dict(temperature=0.0, **SETTINGS)
    noise = jax_noise(jax.random.PRNGKey(7))
    e1, s1 = RolloutEngine(tmodel, TicTacToe(), device="cpu", **kw).run(
        tparams, B, noise=noise, ref_params=tparams)
    eng = CompiledRolloutEngine(tmodel, TicTacToe(), device="cpu",
                                cache_layout="dense", **kw)
    assert eng.attn_impl == "pallas"
    e2, s2 = eng.run(tparams, B, noise=noise, ref_params=tparams)
    _same(e2, e1, 1e-4, rtol=1e-3)
    np.testing.assert_allclose(e2.ref_logprobs.numpy(),
                               e1.ref_logprobs.numpy(), atol=0.05)
    np.testing.assert_array_equal(s2.n_turns, s1.n_turns)
    np.testing.assert_array_equal(s2.turn_lengths, s1.turn_lengths)


def test_python_engine_has_no_refill(models):
    eng = RolloutEngine(models[2], TicTacToe(), device="cpu", **SETTINGS)
    with pytest.raises(ValueError, match="no slot refill"):
        eng.run(models[3], B, n_episodes=2 * B)
