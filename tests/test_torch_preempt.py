"""Preemption and pool growth in the port against the JAX package.

- ``pressure_plan``, ``admission_plan`` and ``grow_pool`` bitwise against
  JAX on ``tests/test_robustness.py``'s cases and on random inputs.
- The engine with ``on_exhaust="preempt"`` on an undersized pool against
  JAX's at fp32, with JAX's per-episode draws (``episode_env_rng`` /
  ``episode_reset_rng``) fed in: tokens, masks, rewards and context
  lengths equal, log-probs within atol 1e-5, and the preemption and
  requeue counters equal. Greedy and sampled (the sampled stream stays
  keyed by macro-step on both sides, so it is schedule-dependent but
  equal).
- A half-size pool's greedy trajectories equal the unpressured run's; the
  minimum pool drains with real preemptions; a pool below it raises.
- ``pool_growth="double"``: the port grows, drains and stays under
  ``pool_growth_max``, with JAX's counters (drops, growths)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro.rl.engine import paging as jepaging
from repro.rl.engine import slots as jslots
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models import paging as tpaging
from repro_torch.models.registry import build_model
from repro_torch.rl.engine import CompiledRolloutEngine
from repro_torch.rl.engine import paging as tepaging
from repro_torch.rl.engine import slots as tslots
from repro_torch.rl.envs import make_env
from test_torch_envs import assert_same_rollout, run_both


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small eager ops: one intra-op thread per test worker, so parallel
    workers do not oversubscribe the cores (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plan_both(refcount, bt, eligible, pos, demand):
    i32 = lambda a: np.asarray(a, np.int32)
    jr, jv = jepaging.pressure_plan(
        jnp.asarray(i32(refcount)), jnp.asarray(i32(bt)),
        jnp.asarray(np.asarray(eligible)), jnp.asarray(i32(pos)),
        jnp.asarray(i32(demand)))
    tr, tv = tepaging.pressure_plan(
        torch.from_numpy(i32(refcount)), torch.from_numpy(i32(bt)),
        torch.from_numpy(np.asarray(eligible)), torch.from_numpy(i32(pos)),
        torch.from_numpy(i32(demand)))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    return tr.numpy(), tv.numpy()


# tests/test_robustness.py's TestPressurePlan cases, with their outcomes
PLAN_CASES = [
    ([0, 0, 0, 0], [[-1], [-1]], [True, True], [5, 3], [1, 1],
     [True, True], [False, False]),
    ([1, 1, 0], [[0, -1], [1, -1]], [True, True], [5, 3], [1, 1],
     [False, True], [False, False]),
    ([1, 1], [[0, -1], [1, -1]], [True, True], [9, 2], [0, 1],
     [True, False], [False, False]),
    ([1, 1], [[0, -1], [1, -1]], [True, True], [8, 2], [1, 1],
     [False, True], [True, False]),
    ([1, 1, 1], [[0], [1], [2]], [True, True, True], [9, 1, 7], [1, 1, 1],
     [False, True, False], [True, False, False]),
    ([2, 2], [[0, 1], [0, 1]], [True, True], [8, 2], [1, 1],
     [False, False], [False, False]),
]


@pytest.mark.parametrize("case", range(len(PLAN_CASES)))
def test_pressure_plan_matches_jax(case):
    *args, run, victims = PLAN_CASES[case]
    r, v = _plan_both(*args)
    assert r.tolist() == run and v.tolist() == victims


@pytest.mark.parametrize("seed", range(6))
def test_pressure_plan_random_matches_jax(seed):
    rs = np.random.RandomState(seed)
    B, NP, P = 8, 4, 12
    rc = rs.randint(0, 3, P)
    bt = np.where(rs.rand(B, NP) < 0.5, rs.randint(0, P, (B, NP)), -1)
    elig = rs.rand(B) < 0.7
    pos = rs.randint(0, 60, B)
    demand = np.where(elig, rs.randint(0, 3, B), 0)
    _plan_both(rc, bt, elig, pos, demand)


def _admit_both(free_slots, requeue, launched, n, quota):
    ja = jslots.admission_plan(jnp.asarray(free_slots), jnp.asarray(requeue),
                               jnp.asarray(launched, jnp.int32), n,
                               jnp.asarray(quota, jnp.int32))
    ta = tslots.admission_plan(torch.tensor(free_slots),
                               torch.tensor(requeue),
                               torch.tensor(launched, dtype=torch.int32), n,
                               torch.tensor(quota, dtype=torch.int32))
    for a, b in zip(ta, ja):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return [a.numpy() for a in ta]


ADMIT_CASES = [
    ([True, False, True, False], [False, False, True, False, True, False],
     6, 6, 2),
    ([True, False, True, False], [False, False, True, False, True, False],
     6, 6, 1),
    ([True, True, False, False], [False] * 6, 3, 6, 5),
    ([True, True, True, False], [False] * 5 + [True] + [False] * 2, 2, 8, 3),
    ([True, True, False, False], [False] * 4, 3, 4, 5),
]


@pytest.mark.parametrize("case", range(len(ADMIT_CASES)))
def test_admission_plan_matches_jax(case):
    admit, ids, launched, rq = _admit_both(*ADMIT_CASES[case])
    if case == 0:     # requeued episodes first, ascending; queue drained
        assert admit.tolist() == [True, False, True, False]
        assert (ids[0], ids[2], int(launched)) == (2, 4, 6)
        assert not rq.any()
    if case == 3:     # requeued first, then fresh ids; only fresh counted
        assert ids[:3].tolist() == [5, 2, 3] and int(launched) == 4


@pytest.mark.parametrize("seed", range(4))
def test_admission_plan_random_matches_jax(seed):
    rs = np.random.RandomState(seed)
    B, N = 6, 10
    _admit_both((rs.rand(B) < 0.6).tolist(), (rs.rand(N) < 0.3).tolist(),
                int(rs.randint(0, N + 1)), N, int(rs.randint(0, 5)))


@pytest.fixture(scope="module")
def models():
    jmodel = jax_build_model(jax_smoke_config("qwen2-0.5b"))
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    tmodel = build_model(get_smoke_config("qwen2-0.5b"))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, tmodel, tparams


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_grow_pool_matches_jax(models, kv_dtype):
    """Growth keeps every mapping and page, appends zeroed free pages (and
    scales), and moves the port's trash page to the new last index."""
    jmodel, jparams, tmodel, tparams = models
    toks = np.ones((2, 12), np.int32)
    _, jc = jmodel.prefill(jparams, jnp.asarray(toks), jmodel.init_cache(
        2, 32, layout="paged", page_size=8, kv_dtype=kv_dtype))
    _, tc = tmodel.prefill(tparams, torch.from_numpy(toks),
                           tmodel.init_cache(2, 32, layout="paged",
                                             page_size=8, kv_dtype=kv_dtype,
                                             device="cpu"))
    P = tc.n_pages
    tc.kv.k[:, P] = 1                                  # the trash page
    jg, tg = jepaging.grow_pool(jc, 2 * P), tepaging.grow_pool(tc, 2 * P)
    assert tg.n_pages == 2 * P
    for f in ("refcount", "block_table", "pos"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)))
    for t, j, old in zip((x for x in tg.kv if x is not None),
                         jax.tree.leaves(jg.kv),
                         (x for x in tc.kv if x is not None)):
        assert t.shape[1] == 2 * P + 1
        np.testing.assert_array_equal(t[:, :P].numpy(), old[:, :P].numpy())
        assert not t[:, P:2 * P].float().any()
        np.testing.assert_allclose(t[:, :2 * P].float().numpy(),
                                   np.asarray(j, np.float32), atol=1e-5)
    assert (tg.kv.k[:, 2 * P] == 1).all()              # trash moved last
    assert tepaging.grow_pool(tc, P) is tc


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

PRESSURE = dict(max_turns=3, max_turn_tokens=4, max_context=96,
                cache_layout="paged", page_size=8, kv_dtype="fp32",
                sampling="reference", share_prefix=True)


def _env_kw(env_name):
    return {"prompt_len": 24} if env_name == "bandit" else {}


def _half_pool(tmodel, env_name, B=4):
    eng = CompiledRolloutEngine(tmodel, make_env(env_name,
                                                 **_env_kw(env_name)),
                                device="cpu", on_exhaust="preempt",
                                **PRESSURE)
    full = tpaging.pool_pages_needed_shared(B, 96, eng.shared_len, 8)
    return max(full // 2, eng.min_pool_pages(B)), full


@pytest.mark.parametrize("env_name", ["tictactoe", "bandit"])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_preempt_engine_matches_jax(models, env_name, temperature):
    half, full = _half_pool(models[2], env_name)
    assert half < full
    j, t, _ = run_both(models, env_name, _env_kw(env_name), 4, 8,
                       jax.random.PRNGKey(0), on_exhaust="preempt",
                       cache_pages=half, temperature=temperature, **PRESSURE)
    assert_same_rollout(j, t)
    assert t[1].kv_dropped_writes == 0 and t[1].episodes_returned == 8


@pytest.mark.parametrize("env_name", ["tictactoe", "bandit"])
def test_half_pool_equals_unpressured(models, env_name):
    """Preemption only reorders work: at half the shared pool the greedy
    trajectories equal the right-sized run's, with no dropped write."""
    tmodel, tparams = models[2], models[3]
    half, _ = _half_pool(tmodel, env_name)
    out = []
    for pages in (None, half):
        eng = CompiledRolloutEngine(
            tmodel, make_env(env_name, **_env_kw(env_name)), device="cpu",
            on_exhaust="preempt", cache_pages=pages, temperature=0.0,
            **PRESSURE)
        out.append(eng.run(tparams, 4, 8,
                           generator=torch.Generator().manual_seed(3)))
    (e1, s1), (e2, s2) = out
    for f in ("tokens", "gen_mask", "logprobs", "rewards", "context_len"):
        assert torch.equal(getattr(e1, f), getattr(e2, f)), f
    assert s1.kv_dropped_writes == s2.kv_dropped_writes == 0
    assert s2.episodes_returned == 8 and s2.page_capacity == half


def test_minimum_pool_drains_and_below_it_raises(models):
    tmodel, tparams = models[2], models[3]
    eng = CompiledRolloutEngine(tmodel, make_env("tictactoe"), device="cpu",
                                on_exhaust="preempt", temperature=0.0,
                                **PRESSURE)
    eng.cache_pages = eng.min_pool_pages(4)
    _, st = eng.run(tparams, 4, 6)
    assert st.kv_dropped_writes == 0 and st.episodes_returned == 6
    assert st.preemptions > 0 and st.requeue_depth > 0
    eng.cache_pages -= 1
    with pytest.raises(ValueError, match="minimum viable pool"):
        eng.run(tparams, 4, 6)


@pytest.mark.parametrize("option,value", [("on_exhaust", "preempt"),
                                          ("pool_growth", "double")])
def test_pool_options_require_paged_layout(models, option, value):
    with pytest.raises(ValueError, match="requires cache_layout='paged'"):
        CompiledRolloutEngine(models[2], make_env("tictactoe"), device="cpu",
                              cache_layout="dense", **{option: value})


@pytest.mark.parametrize("on_exhaust", ["count", "preempt"])
def test_pool_growth_matches_jax(models, on_exhaust):
    """From a small pool, growth doubles between macro-steps up to
    ``pool_growth_max``; the port's counters (drops, growths, capacity)
    and trajectories are JAX's."""
    kw = dict(PRESSURE, share_prefix=False, temperature=0.0,
              on_exhaust=on_exhaust, pool_growth="double",
              pool_growth_max=40)
    tmodel = models[2]
    eng = CompiledRolloutEngine(tmodel, make_env("tictactoe"), device="cpu",
                                **kw)
    kw["cache_pages"] = (eng.min_pool_pages(4) if on_exhaust == "preempt"
                         else 4)
    j, t, _ = run_both(models, "tictactoe", {}, 4, 6, jax.random.PRNGKey(1),
                       **kw)
    assert_same_rollout(j, t)
    assert t[1].pool_grows >= 1 and t[1].page_capacity <= 40
    assert t[1].episodes_returned == 6
