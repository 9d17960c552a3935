"""The async one-step-off pipeline of the port against the JAX schedule
(port of ``tests/test_pipeline.py``'s parity and tagging tests).

- Three async steps at ``max_policy_lag`` 1 with the truncated-IS cap 2.0,
  on the compiled engine's paged pool (the settings of
  ``test_torch_trainer.py``: fp32 weights, B=4 slots, N=8 episodes, fused
  sampling, KL 0.05, clip 0.2), the port against the JAX
  ``EarlTrainer(pipeline="async")`` on the same bridged params, with JAX's
  per-step keys injected through ``noise``. ``policy_lag``,
  ``params_version``, returns, context lengths and truncated fractions are
  equal; ``loss``, ``kl`` and ``is_weight_mean`` agree within 1e-6
  absolute + 1e-4 relative (the same f32 math in another summation
  order).
- Async at lag 0 against sync in the port: the final params are bitwise
  equal, on the compiled and python backends (the update on the worker
  thread runs the same ops in the same order).
- ``history`` comes back in step order, and sync steps record lag 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core.stages import EarlTrainer as JaxTrainer
from repro.models.registry import build_model as jax_build_model
from repro.optim.adamw import adamw as jax_adamw
from repro.rl.envs import make_env as jax_make_env
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core.stages import EarlTrainer
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import adamw
from repro_torch.rl.envs import make_env
from test_torch_trainer import SETTINGS, jax_noise


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STEPS, SEED, LR = 3, 7, 3e-4


def test_async_lag1_matches_jax_async_trainer():
    settings = SETTINGS["compiled-paged"]
    jmodel = jax_build_model(jax_smoke_config("qwen2-0.5b"))
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    jtr = JaxTrainer(model=jmodel, env=jax_make_env("tictactoe"),
                     optimizer=jax_adamw(LR, weight_decay=0.0), seed=SEED,
                     pipeline="async", max_policy_lag=1, is_rho_max=2.0,
                     **settings)
    _, _, jhist = jtr.train(STEPS, params=jparams,
                            opt_state=jtr.optimizer.init(jparams),
                            ref_params=jparams)

    # the JAX trainer's per-step keys: the rollouts draw them in step order
    rng, keys = jax.random.PRNGKey(SEED), []
    for _ in range(STEPS):
        rng, sub = jax.random.split(rng)
        keys.append(sub)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    ttr = EarlTrainer(model=build_model(get_smoke_config("qwen2-0.5b")),
                      env=make_env("tictactoe"),
                      optimizer=adamw(LR, weight_decay=0.0), seed=SEED,
                      pipeline="async", max_policy_lag=1, is_rho_max=2.0,
                      noise=lambda step: jax_noise(keys[step]),
                      device="cpu", **settings)
    ref = {k: v.clone() for k, v in tparams.items()}
    _, _, thist = ttr.train(STEPS, params=tparams,
                            opt_state=ttr.optimizer.init(tparams),
                            ref_params=tparams)
    assert [r.policy_lag for r in thist] == [r.policy_lag for r in jhist] \
        == [0, 1, 1]
    assert [r.params_version for r in thist] == \
        [r.params_version for r in jhist] == [0, 0, 1]
    for j, t in zip(jhist, thist):
        assert t.step == j.step
        assert t.mean_return == j.mean_return, t.step
        assert t.mean_context_len == j.mean_context_len, t.step
        assert t.truncated_frac == j.truncated_frac, t.step
        for f in ("loss", "kl", "is_weight_mean"):
            np.testing.assert_allclose(getattr(t, f), getattr(j, f),
                                       atol=1e-6, rtol=1e-4, err_msg=f)
    # the correction ran: the lagged steps' weights moved off 1
    assert thist[0].is_weight_mean == pytest.approx(1.0, abs=1e-5)
    assert any(abs(r.is_weight_mean - 1.0) > 1e-4 for r in thist[1:])
    for k in ref:                                 # the reference was kept
        assert torch.equal(tparams[k], ref[k]), k


def _trainer(backend, **kw):
    env_kw = (dict(env=make_env("bandit"), max_turns=1, max_turn_tokens=2,
                   max_context=32)
              if backend == "compiled" else
              dict(env=make_env("tictactoe"), max_turns=2,
                   max_turn_tokens=3, max_context=64))
    return EarlTrainer(model=build_model(get_smoke_config("qwen2-0.5b")),
                       optimizer=adamw(1e-3, weight_decay=0.0),
                       batch_size=4, kl_coef=0.05, clip_eps=0.2, seed=0,
                       rollout_backend=backend, device="cpu",
                       **env_kw, **kw)


@pytest.mark.parametrize("backend", ["compiled", "python"])
def test_async_lag0_equals_sync_bitwise(backend):
    n = 3
    ps, _, hs = _trainer(backend).train(n)
    pa, _, ha = _trainer(backend, pipeline="async", max_policy_lag=0).train(n)
    assert [r.step for r in ha] == list(range(n))
    assert [r.policy_lag for r in ha] == [0] * n
    for a, b in zip(hs, ha):
        assert (a.loss, a.kl, a.mean_return, a.params_version) == \
            (b.loss, b.kl, b.mean_return, b.params_version)
    assert ps.keys() == pa.keys()
    for k in ps:
        assert torch.equal(ps[k], pa[k]), k


def test_history_in_step_order_and_sync_lag_zero():
    _, _, hist = _trainer("compiled", pipeline="async", max_policy_lag=1,
                          is_rho_max=2.0).train(4)
    assert [r.step for r in hist] == [0, 1, 2, 3]
    assert [r.params_version for r in hist] == [0, 0, 1, 2]
    assert [r.policy_lag for r in hist] == [0, 1, 1, 1]
    _, _, hist = _trainer("compiled").train(3)
    assert [r.params_version for r in hist] == [0, 1, 2]
    assert all(r.policy_lag == 0 for r in hist)
