"""The port's Parallelism Selector against JAX's (port of
``tests/test_selector.py``, but its cost-model test, which moves with the
HLO tooling to ROADMAP Queue 1 item 12; of
``test_core_system.py::test_selector_hook_fires_in_loop``; and of
``test_pipeline.py::TestPerStageSelector``).

- Under the same synthetic ``measure_fn`` the port's policy table, score
  grid, Eq. 1 speedups and switch log equal JAX's, on the paper-like
  Fig. 3 selector and on random observation sequences.
- In the loop: the port's trainer switches at step 1 and binds its
  compiled engine to the selector's current config; on the python
  backend with JAX's draws injected, the port's records carry the same
  ``selector_switch`` and ``dispatch`` rows as JAX's trainer, in the sync
  and the async schedule.
- The engine: a one-device ``mesh_config`` binds; data and tensor
  parallelism raise naming their ROADMAP items; re-binding between two
  one-device configs leaves fp32 greedy tokens bitwise unchanged.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core import parallelism_selector as jsel
from repro.core.resharding import MeshConfig as JaxMeshConfig
from repro.core.stages import EarlTrainer as JaxTrainer
from repro.models.registry import build_model as jax_build_model
from repro.optim.adamw import adamw as jax_adamw
from repro.rl.envs import make_env
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core.parallelism_selector import (ContextBuckets,
                                                   ParallelismSelector,
                                                   ProfileEntry,
                                                   device_memory_bytes,
                                                   H100_HBM_BYTES)
from repro_torch.core.resharding import MeshConfig, replicated
from repro_torch.core.stages import EarlTrainer
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import adamw
from repro_torch.rl.engine import CompiledRolloutEngine
from repro_torch.rl.envs import TicTacToe
from repro_torch.rl.experience import ExperienceBatch
from test_torch_trainer import SETTINGS, jax_noise

TP4 = MeshConfig("tp4", dp=2, tp=4)
TP8 = MeshConfig("tp8", dp=1, tp=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def synth_measure(tgs_table, oom=(), entry=ProfileEntry):
    """tgs_table: {(name, ctx): tgs}; oom: set of (name, ctx) pairs."""

    def measure(cfg, ctx):
        return entry(cfg, ctx, tgs_table.get((cfg.name, ctx), 1.0),
                     feasible=(cfg.name, ctx) not in oom)

    return measure


def paper_table():
    table = {}
    for ctx in (4096, 8192, 16384, 32768, 65536):
        table[("tp4", ctx)] = 131.0 if ctx < 16384 else 95.0
        table[("tp8", ctx)] = 100.0
    return table, {("tp4", 32768), ("tp4", 65536)}


def paperlike_selector(**kw):
    """Mirrors paper Fig. 3: TP4 wins short contexts, TP8 wins >=16K, and
    TP4 OOMs at 32K (the #responses=128 cell)."""
    table, oom = paper_table()
    return ParallelismSelector([TP4, TP8], synth_measure(table, oom),
                               ContextBuckets((4096, 8192, 16384, 32768)),
                               **kw)


def jax_paperlike_selector(**kw):
    table, oom = paper_table()
    return jsel.ParallelismSelector(
        [JaxMeshConfig("tp4", dp=2, tp=4), JaxMeshConfig("tp8", dp=1, tp=8)],
        synth_measure(table, oom, jsel.ProfileEntry),
        jsel.ContextBuckets((4096, 8192, 16384, 32768)), **kw)


class TestContextBuckets:
    def test_bucketing(self):
        b = ContextBuckets((4096, 8192, 16384, 32768))
        assert b.bucket(0) == 0
        assert b.bucket(4095) == 0
        assert b.bucket(4096) == 1
        assert b.bucket(16384) == 3
        assert b.bucket(1_000_000) == 4
        assert b.n_buckets == 5
        jb = jsel.ContextBuckets((4096, 8192, 16384, 32768))
        assert [b.label(i) for i in range(5)] == \
            [jb.label(i) for i in range(5)]
        assert [b.representative(i) for i in range(5)] == \
            [jb.representative(i) for i in range(5)]

    def test_bucket_is_monotone_total(self):
        pytest.importorskip("hypothesis")
        from hypothesis import given, settings, strategies as st

        @settings(max_examples=200, deadline=None)
        @given(st.integers(min_value=0, max_value=10**9))
        def prop(ctx):
            b = ContextBuckets((1024, 2048, 65536))
            i = b.bucket(ctx)
            assert 0 <= i < b.n_buckets
            assert b.bucket(ctx + 1) >= i
            assert i == jsel.ContextBuckets((1024, 2048, 65536)).bucket(ctx)

        prop()


class TestProfiling:
    def test_policy_prefers_tp4_short_tp8_long(self):
        pol = paperlike_selector().profile()
        assert pol.best(1000).name == "tp4"
        assert pol.best(9000).name == "tp8"
        assert pol.best(20000).name == "tp8"
        assert pol.best(40000).name == "tp8"     # tp4 OOMs there

    def test_oom_config_never_selected(self):
        pol = paperlike_selector().profile()
        for b, cfg in pol.table.items():
            ctx = pol.buckets.representative(b)
            assert pol.grid()[(cfg.name, ctx)].feasible

    def test_speedup_eq1_sign_matches_paper(self):
        pol = paperlike_selector().profile()
        assert pol.speedup_pct("tp8", "tp4", 4096) == pytest.approx(31.0)
        assert pol.speedup_pct("tp4", "tp8", 16384) > 0
        assert pol.speedup_pct("tp4", "tp8", 32768) == float("inf")

    def test_all_oom_bucket_raises(self):
        sel = ParallelismSelector(
            [TP4], synth_measure({}, oom={("tp4", c) for c in
                                          (4096, 8192, 16384, 32768, 65536)}),
            ContextBuckets((4096, 8192, 16384, 32768)))
        with pytest.raises(RuntimeError):
            sel.profile()

    def test_policy_table_grid_and_eq1_equal_jax(self):
        pol = paperlike_selector().profile()
        jpol = jax_paperlike_selector().profile()
        assert {b: c.name for b, c in pol.table.items()} == \
            {b: c.name for b, c in jpol.table.items()}
        row = lambda e: (e.config.name, e.context_len, e.tgs, e.feasible,
                         e.peak_bytes, e.step_time_s)
        assert [row(e) for e in pol.entries] == [row(e) for e in jpol.entries]
        for a, b in (("tp4", "tp8"), ("tp8", "tp4")):
            for ctx in (4096, 8192, 16384, 32768, 65536):
                got, want = pol.speedup_pct(a, b, ctx), \
                    jpol.speedup_pct(a, b, ctx)
                assert got == want or (np.isnan(got) and np.isnan(want))


class TestRuntimeSwitching:
    def test_switch_fires_on_bucket_crossing(self):
        sel = paperlike_selector(ema_alpha=1.0)
        sel.profile()
        assert sel.current.name == "tp4"
        sel.observe(2000)
        assert sel.maybe_switch(0) is None
        sel.observe(20000)
        sw = sel.maybe_switch(1)
        assert sw is not None and sw[1].name == "tp8"
        assert sel.current.name == "tp8"
        assert sel.maybe_switch(2) is None

    def test_ema_smoothing_delays_switch(self):
        sel = paperlike_selector(ema_alpha=0.1)
        sel.profile()
        sel.observe(1000)
        for _ in range(3):
            sel.observe(20000)
        assert sel.ema_context < 16384
        assert sel.maybe_switch() is None

    def test_switch_log_records_transition(self):
        sel = paperlike_selector(ema_alpha=1.0)
        sel.profile()
        sel.observe(33000)
        sel.maybe_switch(step=7)
        assert sel.switch_log[0]["step"] == 7
        assert sel.switch_log[0]["from"] == "tp4"
        assert sel.switch_log[0]["to"] == "tp8"

    def test_current_config_always_feasible_for_ema(self):
        pytest.importorskip("hypothesis")
        from hypothesis import given, settings, strategies as st

        @settings(max_examples=50, deadline=None)
        @given(st.lists(st.integers(min_value=0, max_value=10**6),
                        min_size=1, max_size=50))
        def prop(contexts):
            sel = paperlike_selector(ema_alpha=0.7)
            pol = sel.profile()
            for c in contexts:
                sel.observe(c)
                sel.maybe_switch()
                assert sel.current == pol.best(sel.ema_context)

        prop()

    def test_switch_log_equals_jax(self):
        """Random context sequences through both selectors, both stages:
        the EMA, every switch and the whole log agree exactly."""
        rng = np.random.default_rng(0)
        for alpha in (0.3, 0.7, 1.0):
            sel = paperlike_selector(ema_alpha=alpha)
            jsel_ = jax_paperlike_selector(ema_alpha=alpha)
            sel.profile()
            jsel_.profile()
            for step, c in enumerate(rng.integers(0, 20000, size=40)):
                sel.observe(int(c))
                jsel_.observe(int(c))
                assert sel.ema_context == jsel_.ema_context
                for stage in ("rollout", "update") if step % 3 else \
                        ("rollout",):
                    got = sel.maybe_switch(step, stage=stage)
                    want = jsel_.maybe_switch(step, stage=stage)
                    assert (got is None) == (want is None)
            assert sel.switch_log == jsel_.switch_log
            assert len(sel.switch_log) > 3


class TestPerStageSelector:
    def _selector(self):
        a = MeshConfig("a", dp=1, tp=1)
        b = MeshConfig("b", dp=1, tp=1, fsdp=False)
        measure = lambda cfg, ctx: ProfileEntry(
            cfg, ctx, tgs=(2.0 if (cfg.name == "b") == (ctx > 8) else 1.0),
            feasible=True)
        sel = ParallelismSelector([a, b], measure, ContextBuckets((8,)),
                                  ema_alpha=1.0)
        sel.profile()
        return sel

    def test_stages_switch_independently(self):
        sel = self._selector()
        assert sel.current.name == "a"
        assert sel.current_for("update").name == "a"
        sel.observe(100.0)
        sw = sel.maybe_switch(0, stage="rollout")
        assert sw is not None and sw[1].name == "b"
        assert sel.current_for("rollout").name == "b"
        assert sel.current_for("update").name == "a"
        sw2 = sel.maybe_switch(1, stage="update")
        assert sw2 is not None and sw2[1].name == "b"
        assert sel.current_for("update").name == "b"
        assert [row["stage"] for row in sel.switch_log] == ["rollout",
                                                            "update"]

    def test_default_stage_is_rollout(self):
        sel = self._selector()
        sel.observe(100.0)
        assert sel.maybe_switch(0) is not None
        assert sel.current.name == "b"


def test_memory_budget_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device_memory_bytes() == H100_HBM_BYTES == 80 * 10**9
    assert device_memory_bytes("cpu") == H100_HBM_BYTES


# ---------------------------------------------------------------------------
# The selector and the dispatcher in the trainer's loop
# ---------------------------------------------------------------------------

def _two_configs(mesh_config=MeshConfig, profile=ProfileEntry,
                 selector=ParallelismSelector, buckets=ContextBuckets):
    """test_core_system.py's selector: a and b are both one device; b wins
    above 8 tokens."""
    a = mesh_config("a", dp=1, tp=1)
    b = mesh_config("b", dp=1, tp=1, fsdp=False)
    measure = lambda cfg, ctx: profile(
        cfg, ctx, tgs=(2.0 if (cfg.name == "b") == (ctx > 8) else 1.0),
        feasible=True)
    sel = selector([a, b], measure, buckets((8,)), ema_alpha=1.0)
    sel.profile()
    return sel


def test_selector_hook_fires_in_loop():
    sel = _two_configs()
    tr = EarlTrainer(model=build_model(get_smoke_config("qwen2-0.5b")),
                     env=TicTacToe(), selector=sel, batch_size=2,
                     max_turns=1, max_turn_tokens=2, max_context=64,
                     device="cpu")
    assert tr.rollout.mesh_config.name == "a"     # profiled: bound at start
    _, _, hist = tr.train(2)
    assert hist[0].selector_switch is None
    assert hist[1].selector_switch is not None
    assert hist[1].selector_switch["to"] == "b"
    assert tr.rollout.mesh_config == sel.current
    assert [r["stage"] for r in sel.switch_log] == ["update", "rollout"]


@pytest.mark.parametrize("pipeline", ["sync", "async"])
def test_trainer_rows_equal_jax(pipeline):
    """Two steps on the python backend, JAX's draws injected: the same
    switch rows, switch log and dispatch rows (plans and bytes) as JAX's
    trainer routed to a one-device destination layout."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.rl.experience import ExperienceBatch as JaxBatch
    steps, seed = 2, 7
    kw = dict(SETTINGS["python"], pipeline=pipeline, max_policy_lag=1,
              is_rho_max=2.0 if pipeline == "async" else 0.0)
    jmodel = jax_build_model(jax_smoke_config("qwen2-0.5b"))
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    jselector = _two_configs(JaxMeshConfig, jsel.ProfileEntry,
                             jsel.ParallelismSelector, jsel.ContextBuckets)
    jtr = JaxTrainer(model=jmodel, env=make_env("tictactoe"),
                     optimizer=jax_adamw(3e-4, weight_decay=0.0), seed=seed,
                     selector=jselector, **kw)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    _, _, jhist = jtr.train(steps, params=jparams,
                            opt_state=jtr.optimizer.init(jparams),
                            ref_params=jparams,
                            dst_shardings=JaxBatch(
                                *([NamedSharding(mesh, P())] * 10)))

    rng, keys = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        keys.append(sub)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    selector = _two_configs()
    ttr = EarlTrainer(model=build_model(get_smoke_config("qwen2-0.5b")),
                      env=TicTacToe(), optimizer=adamw(3e-4,
                                                       weight_decay=0.0),
                      seed=seed, selector=selector,
                      noise=lambda step: jax_noise(keys[step]), device="cpu",
                      **kw)
    _, _, thist = ttr.train(
        steps, params=tparams, opt_state=ttr.optimizer.init(tparams),
        ref_params=tparams,
        dst_shardings=ExperienceBatch(
            *([replicated(MeshConfig("m", 1, 1))] * 10)))
    keys_ = ("strategy", "n_leaves", "total_bytes", "moved_bytes",
             "bottleneck_bytes", "est_latency_ethernet_s")
    for j, t in zip(jhist, thist):
        assert t.mean_context_len == j.mean_context_len
        assert t.selector_switch == j.selector_switch
        assert {k: t.dispatch[k] for k in keys_} == \
            {k: j.dispatch[k] for k in keys_}
    assert thist[1].selector_switch["to"] == "b"
    assert thist[0].dispatch["strategy"] == (
        "direct-async" if pipeline == "async" else "direct")
    assert selector.switch_log == jselector.switch_log


# ---------------------------------------------------------------------------
# The engine's mesh binding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg,item", [
    (MeshConfig("dp2", dp=2, tp=1), "item 13"),
    (MeshConfig("pods2", dp=1, tp=1, pods=2), "item 13"),
    (MeshConfig("tp2", dp=1, tp=2), "item 14"),
])
def test_engine_mesh_config_beyond_one_device_raises(cfg, item):
    model = build_model(get_smoke_config("qwen2-0.5b"))
    with pytest.raises(NotImplementedError, match=item):
        CompiledRolloutEngine(model, TicTacToe(), device="cpu",
                              mesh_config=cfg)
    eng = CompiledRolloutEngine(model, TicTacToe(), device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        eng.bind_mesh(cfg)
    with pytest.raises(ValueError, match="rank 3"):
        eng.bind_mesh(MeshConfig("far", 1, 1, device_offset=3))


def test_bind_mesh_keeps_greedy_tokens_bitwise():
    model = build_model(get_smoke_config("qwen2-0.5b"))
    params = model.init(torch.Generator().manual_seed(0),
                        dtype=torch.float32)
    a = MeshConfig("a", dp=1, tp=1)
    b = MeshConfig("b", dp=1, tp=1, fsdp=False)
    eng = CompiledRolloutEngine(model, TicTacToe(), device="cpu",
                                mesh_config=a, temperature=0.0,
                                kv_dtype="fp32", max_turns=2,
                                max_turn_tokens=3, max_context=96)
    run = lambda: eng.run(params, 4, 6,
                          generator=torch.Generator().manual_seed(1))[0]
    exp_a = run()
    assert eng.experience_shardings.tokens.mesh_config == a
    eng.bind_mesh(b)
    exp_b = run()
    assert eng.mesh_config == b
    assert eng.experience_shardings.tokens.mesh_config == b
    assert torch.equal(exp_a.tokens, exp_b.tokens)
    assert torch.equal(exp_a.logprobs, exp_b.logprobs)
