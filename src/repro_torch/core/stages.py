"""The EARL RL stage graph (paper Fig. 2) in sync mode (port of
``repro/core/stages.py``).

    ┌─► Rollout (policy decode, multi-turn env loop, and the reference
    │        │    pass folded into the same decode steps)
    │   Experience Preparation (advantages; the standalone reference pass
    │        │    only when the rollout could not fold it)
    │   Dispatch (the identity on one GPU)
    │        ▼
    └── Model Update (policy-gradient step, AdamW)

As in the JAX trainer, the reference log-probs come from the rollout
(``ref_folded``, ``stages.py:397-399``): the engine decodes every fed token
a second time through the reference model on a dense cache. Speculation
unfolds it (the folded decode consumes one token per step and cannot
consume drafted chunks; prefix sharing would too, and is not ported):
ExpPrep then takes JAX's standalone route, a full-sequence reference
forward, or the behaviour log-probs when the reference IS the sampling
policy, and the trainer warns once that it does.

``attn_impl="paged"`` (the default) is the production path: every stream
runs its family's kernel (``_ATTN``); ``attn_impl="xla"`` runs the plain
paths everywhere. ``rollout_backend="python"`` runs the reference loop of
``rl/rollout.py`` (dense cache, plain attention). Randomness is injected
like the engine's: ``noise(step)`` returns the step's ``NoiseFn``; without
it the trainer draws from a ``torch.Generator`` seeded with ``seed`` on
its device.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch.core.train_step import (make_ref_logprob_step,
                                         make_rl_train_step)
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import Optimizer, adamw
from repro_torch.rl.algo import (group_relative_advantages,
                                 reinforce_advantages)
from repro_torch.rl.engine import CompiledRolloutEngine, RolloutStats
from repro_torch.rl.engine.compiled import NoiseFn, _unported
from repro_torch.rl.experience import ExperienceBatch
from repro_torch.rl.rollout import RolloutEngine

# per model family, the trainer's attn_impl -> each stream's attention:
# the policy's decode on either cache layout, the folded reference decode
# (always on a dense cache), ExpPrep's standalone reference pass and the
# Update. The ssm decode has no attention and ignores its value (JAX's
# decode_step drops it); ssm's ExpPrep pass runs the SSD scan kernel, and
# its Update the plain chunked form under autograd, as JAX's does: the
# kernel has no backward in either package.
_ATTN = {
    "dense": {
        "paged": {"paged": "paged", "dense": "pallas", "ref": "pallas",
                  "expprep": "flash", "update": "flash"},
        "xla": {"paged": "xla", "dense": "xla", "ref": "xla",
                "expprep": "xla", "update": "xla"}},
    "ssm": {
        "paged": {"dense": "pallas", "ref": "pallas", "expprep": "pallas",
                  "update": "xla"},
        "xla": {"dense": "xla", "ref": "xla", "expprep": "xla",
                "update": "xla"}},
}


@dataclass
class StepRecord:
    step: int
    mean_return: float
    mean_context_len: float
    mean_turn_len: float
    truncated_frac: float
    loss: float
    kl: float = 0.0
    selector_switch: Optional[dict] = None
    dispatch: Optional[dict] = None
    wall_time_s: float = 0.0
    params_version: int = -1
    policy_lag: int = 0
    rollout_wall_s: float = 0.0
    update_wall_s: float = 0.0
    is_weight_mean: float = 0.0          # truncated-IS mean (1.0 on-policy)
    # paged-pool telemetry
    pages_in_use: int = 0
    page_capacity: int = 0
    kv_dropped_writes: int = 0
    # graceful-degradation telemetry: 0 until those engine features are
    # ported (ROADMAP Queue 1 item 8)
    preemptions: int = 0
    requeue_depth: int = 0
    pool_grows: int = 0
    # speculative decoding (0 unless speculation is on): draft tokens
    # proposed and accepted, (row, verify round) pairs; the mean accepted
    # length per round is (spec_accepted + spec_rounds) / spec_rounds
    spec_proposed: int = 0
    spec_accepted: int = 0
    spec_rounds: int = 0


# ---------------------------------------------------------------------------
# Stage implementations
# ---------------------------------------------------------------------------

class RolloutStage:
    """Fig. 2 ①: rolls out through the engine, with the reference pass
    folded in when ``ref_params`` is given. Returns ``(exp, stats)``. The
    selector hook of the JAX stage is not ported (item 9)."""

    def __init__(self, engine):
        self.engine = engine

    def __call__(self, step: int, params, batch: int, *,
                 n_episodes: Optional[int] = None,
                 noise: Optional[NoiseFn] = None, params_version: int = -1,
                 ref_params=None):
        del step
        return self.engine.run(params, batch, n_episodes, noise=noise,
                               params_version=params_version,
                               ref_params=ref_params)


class ExpPrepStage:
    """Fig. 2 ②: advantage estimation, and the standalone reference pass
    for rollouts that did not fold it (``ref_folded=False``)."""

    def __init__(self, model, *, advantage: str = "reinforce",
                 group_size: int = 4, attn_impl: str = "xla"):
        if advantage not in ("reinforce", "group"):
            raise ValueError(f"advantage must be 'reinforce' or 'group', "
                             f"got {advantage!r}")
        self.advantage = advantage
        self.group_size = group_size
        self._ref_step = make_ref_logprob_step(model, attn_impl=attn_impl)

    def __call__(self, exp: ExperienceBatch, *, ref_params=None,
                 ref_folded: bool = True,
                 reuse_behavior_lp: bool = False) -> ExperienceBatch:
        if ref_params is not None and not ref_folded:
            if reuse_behavior_lp:
                # the reference IS the params that sampled the batch and
                # sampling was unbiased: the behaviour log-probs are the
                # reference log-probs at every loss position
                exp = exp.with_(ref_logprobs=torch.where(
                    exp.gen_mask, exp.logprobs, 0.0))
            else:
                exp = exp.with_(ref_logprobs=self._ref_step(ref_params,
                                                            exp.tokens))
        if self.advantage == "group":
            adv = group_relative_advantages(exp.rewards, self.group_size)
        else:
            adv = reinforce_advantages(exp.rewards)
        return exp.with_(advantages=adv)


class DispatchStage:
    """Fig. 2 ③④⑤: the identity on one GPU. A requested destination
    layout needs the dispatcher, which is not ported (item 9)."""

    def __call__(self, exp: ExperienceBatch, dst_shardings=None):
        """Returns ``(exp, None)``."""
        if dst_shardings is not None:
            raise _unported("dispatch to dst_shardings (the data "
                            "dispatcher)", "9")
        return exp, None


class UpdateStage:
    """Fig. 2 Model Update: the policy-gradient step. Params are not
    updated in place (the reference params may alias them)."""

    def __init__(self, model, optimizer: Optimizer, *,
                 clip_eps: float = 0.0, kl_coef: float = 0.0,
                 attn_impl: str = "xla"):
        self._step = make_rl_train_step(model, optimizer, clip_eps=clip_eps,
                                        kl_coef=kl_coef, attn_impl=attn_impl)

    def __call__(self, params, opt_state, exp: ExperienceBatch):
        return self._step(params, opt_state, exp)


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

@dataclass
class EarlTrainer:
    """End-to-end agentic RL trainer wiring the Fig. 2 stage graph, sync
    schedule. Defaults are the port's production path: the compiled
    engine on the paged pool with fused sampling, the reference pass folded
    into the rollout, and every kernel on the card (``device=None`` means
    the GPU and raises without one). ``cache_layout`` and ``sampling``
    default to the backend's own: "paged" and "fused" for the compiled
    engine, "dense" and "reference" for the python one; the ssm family's
    layout is "dense" (its recurrent cache; "paged" raises). With
    ``speculation`` ("self" or "draft", with ``spec_k`` and
    ``draft_layers``) an unset ``sampling`` is "reference", JAX's default,
    and the reference pass is not folded. The JAX trainer's options whose
    features are not ported raise ``NotImplementedError`` naming their
    ROADMAP Queue 1 item, among them step retries (``max_retries > 0``)
    and the truncated-IS reweighting of the lagged async pipeline
    (``is_rho_max > 0``); the settings that only those features read
    (``prefix_len``, ``pool_growth_max``, ``admit_watermark``,
    ``max_policy_lag``, ``dispatch_strategy``, ``retry_backoff_s``) are not
    fields. As in JAX, the trainer passes no ``draft_model``, so
    ``speculation="draft"`` raises from the engine."""

    model: Any                              # repro_torch Model
    env: Any
    optimizer: Optional[Optimizer] = None
    selector: Optional[Any] = None
    dispatcher: Optional[Any] = None
    batch_size: int = 8
    max_turns: int = 3
    max_turn_tokens: int = 6
    max_context: int = 192
    kl_coef: float = 0.0
    clip_eps: float = 0.0
    advantage: str = "reinforce"            # "reinforce" | "group"
    group_size: int = 4
    temperature: float = 1.0
    top_p: float = 1.0
    sampling: Optional[str] = None          # "fused" | "reference"
    rollout_backend: str = "compiled"       # "compiled" | "python"
    rollout_episodes: Optional[int] = None  # episodes per rollout
    cache_layout: Optional[str] = None      # "paged" | "dense"
    page_size: int = 16
    cache_pages: Optional[int] = None       # None = full provisioning
    kv_dtype: str = "bf16"                  # "fp32" | "bf16"
    share_prefix: bool = False
    on_exhaust: str = "count"               # "count" | "raise"
    pool_growth: str = "off"
    speculation: str = "off"                # "off" | "self" | "draft"
    spec_k: int = 4                         # speculative chunk length
    draft_layers: Optional[int] = None      # "self": draft depth (L // 2)
    pipeline: str = "sync"
    is_rho_max: float = 0.0                 # > 0 raises (item 8)
    max_retries: int = 0                    # > 0 raises (item 8)
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    resume: bool = False
    faults: Optional[Any] = None
    seed: int = 0
    attn_impl: str = "paged"                # "paged" (kernels) | "xla"
    noise: Optional[Callable[[int], NoiseFn]] = None
    device: Any = None

    history: List[StepRecord] = field(default_factory=list)

    def __post_init__(self):
        self._check_unported()
        if self.attn_impl not in ("paged", "xla"):
            raise ValueError(f"attn_impl must be 'paged' or 'xla', got "
                             f"{self.attn_impl!r}")
        python = self.rollout_backend == "python"
        if self.cache_layout is None:
            # the dense family's engine default is the paged pool; the
            # ssm family decodes on its recurrent cache (JAX's default)
            self.cache_layout = ("dense" if python
                                 or self.model.cfg.family != "dense"
                                 else "paged")
        if self.sampling is None:
            self.sampling = ("reference" if python or self.speculation != "off"
                             else "fused")
        self.device = resolve_device(self.device)
        self.optimizer = self.optimizer or adamw(3e-4, weight_decay=0.0)
        attn = _ATTN[self.model.cfg.family][self.attn_impl]
        kw = dict(max_turns=self.max_turns,
                  max_turn_tokens=self.max_turn_tokens,
                  max_context=self.max_context, temperature=self.temperature,
                  top_p=self.top_p, device=self.device)
        if python:
            self._check_python_backend()
            self.rollout = RolloutEngine(self.model, self.env, **kw)
        else:
            self.rollout = CompiledRolloutEngine(
                self.model, self.env, sampling=self.sampling,
                attn_impl=attn.get(self.cache_layout),
                ref_attn_impl=attn["ref"],
                cache_layout=self.cache_layout, page_size=self.page_size,
                cache_pages=self.cache_pages, kv_dtype=self.kv_dtype,
                on_exhaust=self.on_exhaust, share_prefix=self.share_prefix,
                pool_growth=self.pool_growth, speculation=self.speculation,
                spec_k=self.spec_k, draft_layers=self.draft_layers, **kw)
        # JAX folds the reference pass into the rollout unless prefix
        # sharing (unported: it raises above) or speculation is on
        self.ref_folded = not self.share_prefix and self.speculation == "off"
        self._warned_ref_fallback = False
        self.rollout_stage = RolloutStage(self.rollout)
        self.expprep_stage = ExpPrepStage(
            self.model, advantage=self.advantage,
            group_size=self.group_size, attn_impl=attn["expprep"])
        self.dispatch_stage = DispatchStage()
        self.update_stage = UpdateStage(
            self.model, self.optimizer, clip_eps=self.clip_eps,
            kl_coef=self.kl_coef, attn_impl=attn["update"])
        self._gen = torch.Generator(device=self.device).manual_seed(
            self.seed)

    def _check_python_backend(self) -> None:
        """The python reference engine decodes against a dense bf16 cache
        with the reference sampler and has no slot refill (as in JAX)."""
        for what, bad in (
                ("rollout_episodes", self.rollout_episodes is not None),
                (f"cache_layout={self.cache_layout!r}",
                 self.cache_layout != "dense"),
                (f"sampling={self.sampling!r}",
                 self.sampling != "reference"),
                (f"kv_dtype={self.kv_dtype!r}", self.kv_dtype != "bf16"),
                (f"speculation={self.speculation!r}",
                 self.speculation != "off")):
            if bad:
                raise ValueError(f"{what} requires rollout_backend="
                                 f"'compiled' (the python reference engine "
                                 f"decodes a dense bf16 cache with the "
                                 f"reference sampler, without slot refill)")

    def _check_unported(self) -> None:
        if self.rollout_backend not in ("compiled", "python"):
            raise ValueError(f"unknown rollout_backend "
                             f"{self.rollout_backend!r}")
        if self.pipeline == "async":
            raise _unported("pipeline='async'", "8")
        if self.pipeline != "sync":
            raise ValueError(f"pipeline must be 'sync', got "
                             f"{self.pipeline!r}")
        unported = [
            ("checkpoint_dir / checkpoint_every / resume",
             self.checkpoint_dir is not None or self.checkpoint_every > 0
             or self.resume, "8"),
            ("fault injection (faults)", self.faults is not None, "8"),
            ("step retries (max_retries > 0)", self.max_retries > 0, "8"),
            ("truncated-IS reweighting (is_rho_max > 0)",
             self.is_rho_max > 0, "8"),
            ("the parallelism selector", self.selector is not None, "9"),
            ("the data dispatcher", self.dispatcher is not None, "9"),
        ]
        for what, requested, item in unported:
            if requested:
                raise _unported(what, item)

    # ------------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None):
        """Random bf16 params from ``generator`` (default: one seeded with
        ``seed`` on the trainer's device), their optimizer state, and the
        reference params: the same tensors, aliased, when ``kl_coef > 0``
        (the update never writes them in place)."""
        gen = generator or torch.Generator(device=self.device).manual_seed(
            self.seed)
        params = self.model.init(gen, device=self.device)
        opt_state = self.optimizer.init(params)
        ref_params = params if self.kl_coef > 0 else None
        return params, opt_state, ref_params

    def make_record(self, step: int, stats: RolloutStats, metrics, *,
                    dispatch_row=None, wall_time_s=0.0, rollout_wall_s=0.0,
                    update_wall_s=0.0) -> StepRecord:
        """The per-step observability row; ``metrics`` holds host
        floats."""
        rec = StepRecord(
            step=step,
            mean_return=stats.mean_return,
            mean_context_len=stats.mean_context_len,
            mean_turn_len=stats.mean_turn_len,
            truncated_frac=float(np.mean(stats.truncated)),
            loss=metrics["loss"],
            kl=metrics.get("kl", 0.0),
            dispatch=dispatch_row,
            wall_time_s=wall_time_s,
            params_version=stats.params_version,
            rollout_wall_s=rollout_wall_s,
            update_wall_s=update_wall_s,
            is_weight_mean=metrics.get("is_weight_mean", 0.0),
            pages_in_use=stats.pages_in_use,
            page_capacity=stats.page_capacity,
            kv_dropped_writes=stats.kv_dropped_writes,
            spec_proposed=stats.spec_proposed,
            spec_accepted=stats.spec_accepted,
            spec_rounds=stats.spec_rounds)
        self.history.append(rec)
        return rec

    def _maybe_warn_ref_fallback(self, ref_params) -> None:
        """One-time RuntimeWarning when a reference pass is requested but
        the rollout cannot fold it: the switch to ExpPrep's standalone
        route names its reason instead of just happening."""
        if ref_params is None or self.ref_folded or self._warned_ref_fallback:
            return
        self._warned_ref_fallback = True
        warnings.warn(
            f"EarlTrainer: reference log-probs will come from ExpPrep's "
            f"standalone route, not the rollout fold (reason: "
            f"speculation={self.speculation!r}: the folded reference pass "
            f"consumes tokens one decode step at a time and cannot consume "
            f"the drafted chunks the speculative loop commits). The "
            f"reference pass re-runs each harvested context per step.",
            RuntimeWarning, stacklevel=3)

    # ------------------------------------------------------------------
    def run_step(self, step: int, params, opt_state, ref_params=None,
                 dst_shardings=None):
        """One full Fig. 2 iteration: Rollout → ExpPrep → Dispatch →
        Update. Returns (params, opt_state, record)."""
        self._maybe_warn_ref_fallback(ref_params)
        t0 = time.perf_counter()
        noise = (self.noise(step) if self.noise is not None
                 else self.rollout.default_noise(self._gen))
        exp, stats = self.rollout_stage(
            step, params, self.batch_size, n_episodes=self.rollout_episodes,
            noise=noise, params_version=step,
            ref_params=ref_params if self.ref_folded else None)
        t_roll = time.perf_counter() - t0

        # the standalone reference pass runs only when the rollout did not
        # fold it, and is skipped when the reference IS the behaviour
        # params and sampling recorded unbiased model log-probs
        # (temperature 1 or greedy, top_p off)
        reuse_lp = (ref_params is params and self.top_p == 1.0
                    and (self.temperature <= 0.0
                         or self.temperature == 1.0))
        exp = self.expprep_stage(exp, ref_params=ref_params,
                                 ref_folded=self.ref_folded,
                                 reuse_behavior_lp=reuse_lp)
        exp, dispatch_row = self.dispatch_stage(exp, dst_shardings)

        t1 = time.perf_counter()
        params, opt_state, metrics = self.update_stage(params, opt_state,
                                                       exp)
        # the update's one host sync: every metric in one copy
        metrics = dict(zip(metrics, torch.stack(
            [v.float() for v in metrics.values()]).tolist()))
        t2 = time.perf_counter()
        rec = self.make_record(step, stats, metrics,
                               dispatch_row=dispatch_row,
                               wall_time_s=t2 - t0, rollout_wall_s=t_roll,
                               update_wall_s=t2 - t1)
        return params, opt_state, rec

    # ------------------------------------------------------------------
    def train(self, n_steps: int, *, params=None, opt_state=None,
              ref_params=None, dst_shardings=None, verbose: bool = False):
        """Train for ``n_steps`` sync steps. Returns ``(params, opt_state,
        history)``."""
        from repro_torch.core.scheduler import PipelineSchedule
        if params is None:
            params, opt_state, ref_params = self.init_state()
        sched = PipelineSchedule(self, mode=self.pipeline)
        return sched.run(n_steps, params=params, opt_state=opt_state,
                         ref_params=ref_params, dst_shardings=dst_shardings,
                         verbose=verbose)
