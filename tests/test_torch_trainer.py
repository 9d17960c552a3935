"""The whole slice: three sync ``EarlTrainer`` steps of the port against
the JAX ``EarlTrainer`` at fp32 weights, B=4 slots, temperature 1.0, KL
0.05 and PPO clip 0.2, with JAX's per-step Gumbel draws injected through
``noise``. Both trainers fold the reference pass into the rollout: the
engine decodes every fed token a second time through the reference (the
policy's own params, aliased) on a dense bf16 cache.

- ``rollout_backend="compiled"`` (N=8 episodes, so slots refill;
  ``sampling="fused"``, fp32 KV), on the paged pool and on the dense
  layout: the port runs ``attn_impl="paged"``, so every kernel's plain
  version on the CPU (paged or split-K decode attention, fused sampling,
  flash attention), against JAX's plain attention.
- ``rollout_backend="python"`` (the reference loop, B=N=4, dense bf16
  cache, the reference sampler): the port's python engine against JAX's.

Per step, ``mean_return``, ``mean_context_len`` and ``truncated_frac``
are equal. ``loss`` and ``kl`` agree within 1e-6 absolute + 1e-4
relative: the same f32 math in another summation order, on the same bf16
roundings of the reference's K/V (measured on the compiled backend: loss
within 2.4e-8, KL within 6e-8, on both layouts). Then: the python backend's
settings are checked, the options of the async pipeline and of fault
tolerance act, a selector config beyond one device raises naming its
ROADMAP item, and the CLI runs two smoke steps on the CPU on each
backend."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core.stages import EarlTrainer as JaxTrainer
from repro.models.registry import build_model as jax_build_model
from repro.optim.adamw import adamw as jax_adamw
from repro.rl.engine import common as jcommon
from repro.rl.envs import make_env
from repro_torch.bridge import params_from_numpy, to_torch
from repro_torch.checkpoint import latest_step
from repro_torch.configs import get_smoke_config
from repro_torch.core.resharding import MeshConfig, replicated
from repro_torch.core.stages import EarlTrainer, ExpPrepStage
from repro_torch.launch import train as train_cli
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import adamw
from repro_torch.rl.engine import CompiledRolloutEngine
from repro_torch.rl.envs import TicTacToe
from repro_torch.utils.faults import FaultInjector


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small eager ops: one intra-op thread per test worker, so parallel
    workers do not oversubscribe the cores (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


COMMON = dict(batch_size=4, max_turns=3, max_turn_tokens=4, max_context=96,
              kl_coef=0.05, clip_eps=0.2, temperature=1.0)
SETTINGS = {
    "compiled-paged": dict(COMMON, rollout_episodes=8,
                           rollout_backend="compiled", cache_layout="paged",
                           sampling="fused", kv_dtype="fp32"),
    "compiled-dense": dict(COMMON, rollout_episodes=8,
                           rollout_backend="compiled", cache_layout="dense",
                           sampling="fused", kv_dtype="fp32"),
    "python": dict(COMMON, rollout_backend="python", cache_layout="dense",
                   sampling="reference"),
}
STEPS, SEED, LR = 3, 7, 3e-4


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


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_three_sync_steps_match_jax_trainer(setting):
    settings = SETTINGS[setting]
    jmodel = jax_build_model(jax_smoke_config("qwen2-0.5b"))
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    jtr = JaxTrainer(model=jmodel, env=make_env("tictactoe"),
                     optimizer=jax_adamw(LR, weight_decay=0.0), seed=SEED,
                     **settings)
    assert jtr.ref_folded
    jopt = jtr.optimizer.init(jparams)
    _, _, jhist = jtr.train(STEPS, params=jparams, opt_state=jopt,
                            ref_params=jparams)

    # the JAX trainer's per-step keys: split of PRNGKey(seed), step by step
    rng, keys = jax.random.PRNGKey(SEED), []
    for _ in range(STEPS):
        rng, sub = jax.random.split(rng)
        keys.append(sub)
    tmodel = build_model(get_smoke_config("qwen2-0.5b"))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    ttr = EarlTrainer(model=tmodel, env=TicTacToe(),
                      optimizer=adamw(LR, weight_decay=0.0), seed=SEED,
                      noise=lambda step: jax_noise(keys[step]),
                      device="cpu", **settings)
    assert ttr.attn_impl == "paged" and ttr.ref_folded
    ref = {k: v.clone() for k, v in tparams.items()}
    _, _, thist = ttr.train(STEPS, params=tparams,
                            opt_state=ttr.optimizer.init(tparams),
                            ref_params=tparams)
    assert len(thist) == len(jhist) == STEPS
    for j, t in zip(jhist, thist):
        assert t.step == j.step and t.params_version == j.params_version
        assert t.mean_return == j.mean_return, t.step
        assert t.mean_context_len == j.mean_context_len, t.step
        assert t.truncated_frac == j.truncated_frac, t.step
        assert t.kv_dropped_writes == j.kv_dropped_writes == 0
        np.testing.assert_allclose(t.loss, j.loss, atol=1e-6, rtol=1e-4)
        np.testing.assert_allclose(t.kl, j.kl, atol=1e-6, rtol=1e-4)
    assert thist[1].kl > 0                        # the reference pass ran
    for k in ref:                                 # and was never written
        assert torch.equal(tparams[k], ref[k]), k


def test_expprep_standalone_route_matches_the_fold():
    """ExpPrep leaves folded reference log-probs alone; its standalone
    route (kept for prefix sharing and speculation) recomputes them with
    one full-sequence forward, within 0.05 of the fold at the fed
    positions (the fold reads a bf16 cache), or takes the behaviour
    log-probs at generated positions."""
    model = build_model(get_smoke_config("qwen2-0.5b"))
    params = model.init(torch.Generator().manual_seed(0),
                        dtype=torch.float32)
    eng = CompiledRolloutEngine(model, TicTacToe(), device="cpu",
                                max_turns=3, max_turn_tokens=4,
                                max_context=96, temperature=1.0)
    exp, _ = eng.run(params, 4, generator=torch.Generator().manual_seed(1),
                     ref_params=params)
    stage = ExpPrepStage(model)
    assert torch.equal(stage(exp, ref_params=params).ref_logprobs,
                       exp.ref_logprobs)
    alone = stage(exp, ref_params=params, ref_folded=False).ref_logprobs
    fed = exp.ref_logprobs != 0
    assert int(fed.sum()) > 0
    torch.testing.assert_close(alone[fed], exp.ref_logprobs[fed], atol=0.05,
                               rtol=0)
    reuse = stage(exp, ref_params=params, ref_folded=False,
                  reuse_behavior_lp=True).ref_logprobs
    assert torch.equal(reuse, torch.where(exp.gen_mask, exp.logprobs, 0.0))


@pytest.mark.parametrize("option,value", [
    ("rollout_episodes", 8), ("cache_layout", "paged"),
    ("sampling", "fused"), ("kv_dtype", "fp32")])
def test_python_backend_takes_its_own_settings(option, value):
    """The python loop decodes a dense bf16 cache with the reference
    sampler and has no slot refill: other settings raise (as in JAX);
    left unset, layout and sampling default to its own."""
    model = build_model(get_smoke_config("qwen2-0.5b"))
    tr = EarlTrainer(model=model, env=TicTacToe(), device="cpu",
                     rollout_backend="python")
    assert (tr.cache_layout, tr.sampling) == ("dense", "reference")
    with pytest.raises(ValueError, match="rollout_backend='compiled'"):
        EarlTrainer(model=model, env=TicTacToe(), device="cpu",
                    rollout_backend="python", **{option: value})


def _selector_of(cfg):
    """A profiled selector whose only candidate is ``cfg``."""
    from repro_torch.core.parallelism_selector import (ParallelismSelector,
                                                       ProfileEntry)
    sel = ParallelismSelector(
        [cfg], lambda c, ctx: ProfileEntry(c, ctx, 1.0, True))
    sel.profile()
    return sel


@pytest.mark.parametrize("option,value,item", [
    ("selector", _selector_of(MeshConfig("dp2", dp=2, tp=1)), "item 13"),
    ("selector", _selector_of(MeshConfig("tp2", dp=1, tp=2)), "item 14"),
])
def test_unported_options_raise(option, value, item):
    """The selector is ported; a config it starts the engine on that needs
    more than one device is not yet."""
    with pytest.raises(NotImplementedError, match=item):
        EarlTrainer(model=build_model(get_smoke_config("qwen2-0.5b")),
                    env=TicTacToe(), device="cpu", **{option: value})


SMOKE = dict(batch_size=4, max_turns=2, max_turn_tokens=3, max_context=96,
             kl_coef=0.05, device="cpu")


@pytest.mark.parametrize("option", ["pipeline", "checkpoint_dir", "resume",
                                    "faults", "max_retries", "is_rho_max"])
def test_fault_tolerance_and_async_options_take_effect(option, tmp_path):
    """Each option of the async pipeline and of fault tolerance runs smoke
    steps, and its record or directory shows that it acted."""
    ck = str(tmp_path / "ck")
    kw, steps = {}, 1
    if option == "pipeline":
        kw, steps = dict(pipeline="async", max_policy_lag=1), 2
    elif option == "checkpoint_dir":
        kw = dict(checkpoint_dir=ck, checkpoint_every=1)
    elif option == "resume":
        EarlTrainer(model=build_model(get_smoke_config("qwen2-0.5b")),
                    env=TicTacToe(), checkpoint_dir=ck, checkpoint_every=1,
                    **SMOKE).train(1)
        kw, steps = dict(checkpoint_dir=ck, resume=True), 2
    elif option == "faults":
        kw = dict(faults=FaultInjector.parse(["rollout@0"]), max_retries=1,
                  retry_backoff_s=0.0)
    elif option == "max_retries":
        kw = dict(faults=FaultInjector.parse(["update@0*2"]), max_retries=2,
                  retry_backoff_s=0.0)
    else:
        kw = dict(is_rho_max=2.0)
    tr = EarlTrainer(model=build_model(get_smoke_config("qwen2-0.5b")),
                     env=TicTacToe(), **SMOKE, **kw)
    _, _, hist = tr.train(steps)
    assert all(np.isfinite(r.loss) for r in hist)
    if option == "pipeline":
        assert [r.policy_lag for r in hist] == [0, 1]
    elif option == "checkpoint_dir":
        assert latest_step(ck) == 1
    elif option == "resume":
        assert [r.step for r in hist] == [1]           # step 0 was saved
    elif option in ("faults", "max_retries"):
        assert kw["faults"].fired() == (1 if option == "faults" else 2)
        assert [r.step for r in hist] == [0]
    else:
        assert hist[0].is_weight_mean == pytest.approx(1.0, abs=1e-3)


def test_dispatch_destination_raises():
    """No destination: the batch passes as it is. A destination on another
    rank needs a process group, which a single process has not."""
    tr = EarlTrainer(model=build_model(get_smoke_config("qwen2-0.5b")),
                     env=TicTacToe(), device="cpu")
    exp = object()
    assert tr.dispatch_stage(exp) == (exp, None)
    batch = {"x": torch.ones(4, 2)}
    with pytest.raises(RuntimeError, match="process group"):
        tr.dispatch_stage(batch, dst_shardings={"x": replicated(
            MeshConfig("r1", dp=1, tp=1, device_offset=1))})


def test_trainer_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EarlTrainer(model=build_model(get_smoke_config("qwen2-0.5b")),
                    env=TicTacToe())


def test_cli_runs_two_smoke_steps_on_cpu(tmp_path, capsys):
    log = tmp_path / "train.jsonl"
    assert train_cli.main([
        "--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
        "--max-turns", "2", "--max-turn-tokens", "3", "--max-context", "96",
        "--log", str(log)]) == 0
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["loss"]) and r["kv_dropped_writes"] == 0
               for r in rows)
    assert rows[1]["kl"] > 0
    assert "step    1" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [["--cache-layout", "dense"],
                                   ["--rollout-backend", "python"]])
def test_cli_runs_the_dense_layout_and_python_backend(tmp_path, flags):
    log = tmp_path / "train.jsonl"
    assert train_cli.main([
        "--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
        "--max-turns", "2", "--max-turn-tokens", "3", "--max-context", "96",
        "--log", str(log), *flags]) == 0
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["loss"]) and r["page_capacity"] == 0
               for r in rows)
    assert rows[1]["kl"] > 0


@pytest.mark.parametrize("flag,value,item", [
    ("--dispatch", "centralized", "item 9"),
    ("--dispatch", "direct", "item 9"),
])
def test_cli_flags_of_unported_features_raise(tmp_path, monkeypatch, flag,
                                              value, item):
    """The flags that raised while unported (``item``: the ROADMAP item
    that ported each) no longer raise: each reaches the trainer and one
    smoke step runs."""
    del item
    seen = {}
    real = EarlTrainer.__post_init__

    def spy(self):
        seen["strategy"] = self.dispatch_strategy
        real(self)
    monkeypatch.setattr(EarlTrainer, "__post_init__", spy)
    log = tmp_path / "t.jsonl"
    assert train_cli.main([
        "--smoke", "--device", "cpu", "--steps", "1", "--batch", "2",
        "--max-turns", "1", "--max-turn-tokens", "2", "--max-context", "64",
        "--log", str(log), flag, value]) == 0
    assert seen["strategy"] == value
    assert [json.loads(x)["step"] for x in log.read_text().splitlines()] \
        == [0]


@pytest.mark.parametrize("flags,lags,is_weight", [
    (["--pipeline", "async", "--max-policy-lag", "0"], [0, 0], False),
    (["--pipeline", "async", "--is-rho-max", "2.0"], [0, 1], True),
    (["--inject-fault", "rollout@1", "--max-retries", "1",
      "--retry-backoff", "0.01"], [0, 0], False),
    (["--inject-fault", "update@0*2", "--max-retries", "2",
      "--retry-backoff", "0"], [0, 0], False),
])
def test_cli_async_and_retry_flags_take_effect(tmp_path, flags, lags,
                                               is_weight):
    """The async and retry flags run two smoke steps: the lag shows in the
    rows, the IS weights only where the lag is above 0, and the injected
    faults are retried."""
    log = tmp_path / "t.jsonl"
    assert train_cli.main([
        "--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
        "--max-turns", "2", "--max-turn-tokens", "3", "--max-context", "96",
        "--log", str(log), *flags]) == 0
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1]
    assert [r["policy_lag"] for r in rows] == lags
    assert all((r["is_weight_mean"] > 0) == is_weight for r in rows)
