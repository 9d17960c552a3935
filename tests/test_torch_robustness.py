"""Fault injection, checkpoints, retries, resume and crash restart of the
port (port of ``tests/test_robustness.py``'s harness and recovery tests).

- ``FaultSpec``/``FaultInjector`` of both packages parse, reject and fire
  alike on the same strings; ``undersize_pool`` and the trainer's
  undersized pool are JAX's for the same settings, and a preempt run at
  pressure 0.5 drops no KV write.
- Checkpoints round-trip fp32 and bf16 leaves, the optimizer state and the
  generator state bitwise; a ``like`` that disagrees raises.
- Sync retries recover; exhausted retries propagate. Resume skips the
  saved steps, and resuming past the end is a no-op. A resumed run equals
  the uninterrupted run bitwise, on the trainer's own generator (so the
  saved generator state is what is tested). An async crash at lag 0
  restarts from the checkpoint and ends bitwise equal to a clean run; at
  lag 1 it recovers the step count; at lag 2 the updates queued behind a
  failed one neither run nor save, so the restart resumes at the failed
  step; without a checkpoint it propagates and leaves no worker thread.
- The CLI runs the async pipeline and an injected fault with retries and
  checkpoints for two smoke steps on the CPU.
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core.stages import EarlTrainer as JaxTrainer
from repro.models.registry import build_model as jax_build_model
from repro.rl.envs import make_env as jax_make_env
from repro.utils import faults as jfaults
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_smoke_config
from repro_torch.core.stages import EarlTrainer
from repro_torch.launch import train as train_cli
from repro_torch.models.paging import pool_pages_needed
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import OptState, adamw
from repro_torch.rl.envs import make_env
from repro_torch.utils import faults as tfaults


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return build_model(get_smoke_config("qwen2-0.5b"))


# ---------------------------------------------------------------------------
# Fault-injection harness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", ["update@3", "rollout@1*2", " dispatch@0",
                                  "update@-1"])
def test_fault_spec_parses_as_jax(text):
    j, t = jfaults.FaultSpec.parse(text), tfaults.FaultSpec.parse(text)
    assert (t.site, t.step, t.times, t.fired) == \
        (j.site, j.step, j.times, j.fired)


@pytest.mark.parametrize("bad", ["update", "update@", "@3", "u@x",
                                 "update@1*y"])
def test_fault_spec_rejects_as_jax(bad):
    msgs = []
    for pkg in (jfaults, tfaults):
        with pytest.raises(ValueError, match="bad fault spec") as e:
            pkg.FaultSpec.parse(bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_fault_injector_rejects_unknown_site_as_jax():
    msgs = []
    for pkg in (jfaults, tfaults):
        with pytest.raises(ValueError, match="unknown fault site") as e:
            pkg.FaultInjector.parse(["frobnicate@1"])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_fault_injector_fires_as_jax():
    """The same specs and the same sequence of checks fire at the same
    calls, with the same messages and counts."""
    specs = ["update@2*2", "rollout@0", "dispatch@1"]
    calls = [("update", 0), ("dispatch", 2), ("rollout", 0), ("update", 2),
             ("update", 2), ("update", 2), ("dispatch", 1), ("rollout", 0)]
    seen = {}
    for name, pkg in (("jax", jfaults), ("torch", tfaults)):
        inj, out = pkg.FaultInjector.parse(specs, pool_pressure=0.25), []
        for site, step in calls:
            try:
                inj.check(site, step)
                out.append(None)
            except pkg.FaultInjected as e:
                assert isinstance(e, RuntimeError)
                out.append(str(e))
        seen[name] = (out, inj.fired(), inj.fired("update"),
                      inj.fired("rollout"), inj.pool_pressure)
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][1:4] == (4, 2, 1)


@pytest.mark.parametrize("full,fraction,floor", [
    (48, 0.5, 1), (45, 0.5, 1), (45, 0.1, 12), (7, 1.0, 1), (96, 0.3, 40)])
def test_undersize_pool_as_jax(full, fraction, floor):
    assert tfaults.undersize_pool(full, fraction, floor) == \
        jfaults.undersize_pool(full, fraction, floor)


POOL = dict(batch_size=4, max_turns=1, max_turn_tokens=2, max_context=32,
            rollout_backend="compiled", cache_layout="paged", page_size=8,
            seed=0)


@pytest.mark.parametrize("env,share,on_exhaust,pressure", [
    ("bandit", False, "preempt", 0.5),
    ("tictactoe", False, "count", 0.5),
    ("tictactoe", True, "preempt", 0.3)])
def test_trainer_undersizes_pool_as_jax(model, env, share, on_exhaust,
                                        pressure):
    kw = dict(POOL, on_exhaust=on_exhaust, share_prefix=share,
              max_context=64 if env == "tictactoe" else 32)
    jtr = JaxTrainer(model=jax_build_model(jax_smoke_config("qwen2-0.5b")),
                     env=jax_make_env(env),
                     faults=jfaults.FaultInjector.parse(
                         [], pool_pressure=pressure), **kw)
    ttr = EarlTrainer(model=model, env=make_env(env), device="cpu",
                      faults=tfaults.FaultInjector.parse(
                          [], pool_pressure=pressure), **kw)
    assert ttr.rollout.cache_pages == jtr.rollout_stage.engine.cache_pages
    assert ttr.rollout.cache_pages < pool_pages_needed(4, kw["max_context"],
                                                       8)


def test_pool_pressure_preempt_run_drops_nothing(model):
    faults = tfaults.FaultInjector.parse([], pool_pressure=0.5)
    tr = EarlTrainer(model=model, env=make_env("bandit"), device="cpu",
                     on_exhaust="preempt", faults=faults, **POOL)
    assert tr.rollout.min_pool_pages(4) <= tr.rollout.cache_pages \
        < pool_pages_needed(4, 32, 8)
    _, _, hist = tr.train(2)
    assert [r.kv_dropped_writes for r in hist] == [0, 0]
    assert all(r.page_capacity == tr.rollout.cache_pages for r in hist)


def test_pool_pressure_requires_paged_compiled(model):
    faults = tfaults.FaultInjector.parse([], pool_pressure=0.5)
    with pytest.raises(ValueError, match="pool_pressure"):
        EarlTrainer(model=model, env=make_env("bandit"), device="cpu",
                    cache_layout="dense", faults=faults)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _state(dtype):
    g = torch.Generator().manual_seed(3)
    params = {"embedding": torch.randn(11, 4, generator=g).to(dtype),
              "layers.attn.wq": torch.randn(2, 4, 4, generator=g).to(dtype)}
    opt = adamw(1e-3).init(params)
    opt = OptState(step=opt.step + 5,
                   mu={k: torch.randn(v.shape, generator=g)
                       for k, v in opt.mu.items()},
                   nu={k: torch.rand(v.shape, generator=g)
                       for k, v in opt.nu.items()})
    gen = torch.Generator().manual_seed(9)
    torch.rand(17, generator=gen)                   # a used generator
    return params, opt, gen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_round_trip_is_bitwise(tmp_path, dtype):
    params, opt, gen = _state(dtype)
    tree = {"params": params, "opt_state": opt._asdict(),
            "rng": gen.get_state()}
    d = str(tmp_path / "ck")
    assert latest_step(d) is None
    save_checkpoint(d, 3, tree)
    save_checkpoint(d, 12, tree)
    assert latest_step(d) == 12
    like = {"params": {k: torch.zeros_like(v) for k, v in params.items()},
            "opt_state": OptState(
                step=torch.zeros_like(opt.step),
                mu={k: torch.zeros_like(v) for k, v in opt.mu.items()},
                nu={k: torch.zeros_like(v) for k, v in opt.nu.items()}
            )._asdict(),
            "rng": torch.Generator().get_state()}
    got = restore_checkpoint(d, 12, like)
    for k, v in params.items():
        assert got["params"][k].dtype == dtype
        assert torch.equal(got["params"][k], v), k
    o = OptState(**got["opt_state"])
    assert torch.equal(o.step, opt.step) and o.step.dtype == torch.int32
    for k in params:
        assert torch.equal(o.mu[k], opt.mu[k]) and torch.equal(o.nu[k],
                                                                opt.nu[k])
    g2 = torch.Generator()
    g2.set_state(got["rng"])
    assert torch.equal(torch.rand(5, generator=g2), torch.rand(5,
                                                               generator=gen))


@pytest.mark.parametrize("change", ["shape", "dtype", "missing"])
def test_checkpoint_mismatched_like_raises(tmp_path, change):
    params, _, _ = _state(torch.float32)
    d = str(tmp_path / "ck")
    save_checkpoint(d, 1, {"params": params})
    like = {"params": {k: v.clone() for k, v in params.items()}}
    if change == "shape":
        like["params"]["embedding"] = torch.zeros(12, 4)
    elif change == "dtype":
        like["params"]["embedding"] = like["params"]["embedding"].bfloat16()
    else:
        like["params"]["lm_head"] = torch.zeros(4, 11)
    err = KeyError if change == "missing" else ValueError
    with pytest.raises(err):
        restore_checkpoint(d, 1, like)


def test_latest_step_ignores_partial_directories(tmp_path):
    d = tmp_path / "ck"
    (d / "step_00000007").mkdir(parents=True)       # no state file
    (d / "other").mkdir()
    assert latest_step(str(d)) is None
    save_checkpoint(str(d), 2, {"x": torch.ones(1)})
    assert latest_step(str(d)) == 2
    assert latest_step(str(tmp_path / "absent")) is None


# ---------------------------------------------------------------------------
# Retries, resume, crash restart
# ---------------------------------------------------------------------------

def _trainer(model, *, pipeline="sync", lag=0, **kw):
    base = dict(batch_size=4, max_turns=1, max_turn_tokens=2,
                max_context=32, kl_coef=0.05, clip_eps=0.2, seed=0)
    base.update(kw)
    return EarlTrainer(model=model, env=make_env("bandit"),
                       optimizer=adamw(1e-3, weight_decay=0.0),
                       pipeline=pipeline, max_policy_lag=lag, device="cpu",
                       **base)


def _assert_params_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_sync_retry_recovers_from_injected_fault(model):
    faults = tfaults.FaultInjector.parse(["rollout@1", "update@2"])
    tr = _trainer(model, faults=faults, max_retries=1, retry_backoff_s=0.0)
    _, _, hist = tr.train(3)
    assert faults.fired("rollout") == 1 and faults.fired("update") == 1
    assert [r.step for r in hist] == [0, 1, 2]


def test_sync_retries_exhausted_propagate(model):
    faults = tfaults.FaultInjector.parse(["update@1*3"])
    tr = _trainer(model, faults=faults, max_retries=1, retry_backoff_s=0.0)
    with pytest.raises(tfaults.FaultInjected):
        tr.train(3)
    assert faults.fired("update") == 2


def test_checkpoint_and_resume_skip_done_steps(model, tmp_path):
    d = str(tmp_path / "ck")
    _trainer(model, checkpoint_dir=d, checkpoint_every=1).train(2)
    assert latest_step(d) == 2
    t2 = _trainer(model, checkpoint_dir=d, checkpoint_every=1, resume=True)
    _, _, hist = t2.train(4)
    assert [r.step for r in hist] == [2, 3]          # steps 0-1 skipped
    assert latest_step(d) == 4
    t3 = _trainer(model, checkpoint_dir=d, resume=True)
    _, _, hist = t3.train(4)                          # past the end
    assert hist == []


@pytest.mark.parametrize("pipeline", ["sync", "async"])
def test_resumed_run_equals_uninterrupted_run(model, tmp_path, pipeline):
    """Two steps, a checkpoint, then a new trainer that resumes to four:
    the params equal a clean four-step run's bitwise. Both draw from the
    trainer's own generator, so the resume must restore its state."""
    d = str(tmp_path / "ck")
    _trainer(model, pipeline=pipeline, checkpoint_dir=d,
             checkpoint_every=2).train(2)
    p_r, o_r, hist = _trainer(model, pipeline=pipeline, checkpoint_dir=d,
                              resume=True).train(4)
    assert [r.step for r in hist] == [2, 3]
    clean = _trainer(model, pipeline=pipeline)
    p_c, o_c, hist_c = clean.train(4)
    _assert_params_equal(p_r, p_c)
    _assert_params_equal(o_r.mu, o_c.mu)
    assert int(o_r.step) == int(o_c.step) == 4
    assert [r.loss for r in hist] == [r.loss for r in hist_c[2:]]


def test_async_crash_restarts_from_checkpoint(model, tmp_path):
    """An injected worker crash at step 1 restarts from the latest
    checkpoint; at lag 0 the final params equal a clean run's bitwise."""
    d = str(tmp_path / "ck")
    faults = tfaults.FaultInjector.parse(["update@1"])
    tr = _trainer(model, pipeline="async", lag=0, faults=faults,
                  max_retries=1, retry_backoff_s=0.0, checkpoint_dir=d,
                  checkpoint_every=1)
    p_f, _, hist = tr.train(4)
    assert faults.fired("update") == 1
    assert [r.step for r in hist] == [0, 1, 2, 3]
    assert latest_step(d) == 4
    p_c, _, hist_c = _trainer(model, pipeline="async", lag=0).train(4)
    assert [r.loss for r in hist] == [r.loss for r in hist_c]
    _assert_params_equal(p_f, p_c)


def test_async_crash_with_lag_recovers_step_count(model, tmp_path):
    d = str(tmp_path / "ck")
    faults = tfaults.FaultInjector.parse(["update@2"])
    tr = _trainer(model, pipeline="async", lag=1, faults=faults,
                  max_retries=1, retry_backoff_s=0.0, checkpoint_dir=d,
                  checkpoint_every=1, is_rho_max=2.0)
    _, _, hist = tr.train(5)
    assert faults.fired("update") == 1
    assert [r.step for r in hist] == [0, 1, 2, 3, 4]
    # the restart at step 2 rolls out on the restored version
    assert [r.policy_lag for r in hist] == [0, 1, 0, 1, 1]
    assert latest_step(d) == 5


def test_async_failed_update_stops_the_updates_queued_behind_it(model,
                                                                 tmp_path):
    """At lag 2 the updates of steps 3 and 4 are queued behind the failing
    update of step 2 when it raises, whatever the timing: none of them may
    run or save, or the restart would resume from params that lack update
    2. The newest checkpoint is then step 2's (the state after updates 0
    and 1)."""
    d = str(tmp_path / "ck")
    faults = tfaults.FaultInjector.parse(["update@2"])
    tr = _trainer(model, pipeline="async", lag=2, faults=faults,
                  max_retries=0, retry_backoff_s=0.0, checkpoint_dir=d,
                  checkpoint_every=1)
    with pytest.raises(tfaults.FaultInjected):
        tr.train(5)
    assert latest_step(d) == 2
    assert sorted(os.listdir(d)) == ["step_00000001", "step_00000002"]

    # with a retry the restart resumes at step 2 on version 2: rollout k
    # samples with version max(start, k - 2), so steps 0 and 1 ran at lags
    # 0 and 1 (versions 0, 0), and steps 2, 3, 4 after the restart at
    # start = 2 run on version 2 at lags 0, 1, 2
    d2 = str(tmp_path / "ck2")
    faults = tfaults.FaultInjector.parse(["update@2"])
    tr = _trainer(model, pipeline="async", lag=2, faults=faults,
                  max_retries=1, retry_backoff_s=0.0, checkpoint_dir=d2,
                  checkpoint_every=1)
    _, _, hist = tr.train(5)
    assert faults.fired("update") == 1
    assert [r.step for r in hist] == [0, 1, 2, 3, 4]
    assert [r.policy_lag for r in hist] == [0, 1, 0, 1, 2]
    assert latest_step(d2) == 5


def test_async_crash_without_checkpoint_propagates(model):
    faults = tfaults.FaultInjector.parse(["update@0"])
    tr = _trainer(model, pipeline="async", lag=1, faults=faults,
                  max_retries=1, retry_backoff_s=0.0)
    with pytest.raises(tfaults.FaultInjected):
        tr.train(3)
    assert faults.fired("update") == 1
    assert not [t for t in threading.enumerate()
                if t.name.startswith("earl-update")]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [
    ["--pipeline", "async", "--max-policy-lag", "1"],
    ["--inject-fault", "update@1", "--max-retries", "1",
     "--checkpoint-every", "1"]])
def test_cli_runs_async_and_fault_recovery(tmp_path, capsys, flags):
    log = tmp_path / "train.jsonl"
    if "--checkpoint-every" in flags:
        flags = flags + ["--checkpoint-dir", str(tmp_path / "ck")]
    assert train_cli.main([
        "--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
        "--max-turns", "2", "--max-turn-tokens", "3", "--max-context", "96",
        "--retry-backoff", "0", "--log", str(log), *flags]) == 0
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in rows)
    if "async" in flags:
        assert [r["policy_lag"] for r in rows] == [0, 1]
        assert rows[1]["is_weight_mean"] > 0
    else:
        assert [r["policy_lag"] for r in rows] == [0, 0]
        assert latest_step(str(tmp_path / "ck")) == 2
    assert "lag 1" in capsys.readouterr().out or "async" not in flags
