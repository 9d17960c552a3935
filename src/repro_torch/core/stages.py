"""The EARL RL stage graph (paper Fig. 2) (port of
``repro/core/stages.py``).

    ┌─► [selector hook ①] Rollout (policy decode, multi-turn env loop,
    │        │    and the reference pass folded into the same decode steps)
    │   Experience Preparation (advantages; the standalone reference pass
    │        │    only when the rollout could not fold it)
    │   [dispatcher ③④⑤] layout-aware move to the Update layout
    │   [selector hook ②]
    │        ▼
    └── Model Update (policy-gradient step, AdamW)

``pipeline="sync"`` runs the stages back to back per step;
``pipeline="async"`` hands them to ``core/scheduler.PipelineSchedule``,
which overlaps Update(k), on a worker thread and its own CUDA stream, with
Rollout(k+1) under ``max_policy_lag`` and the truncated-IS correction
(``is_rho_max``). Both schedules retry, checkpoint, resume and take
injected faults (``utils/faults.FaultInjector``).

A profiled ``ParallelismSelector`` (``core/parallelism_selector.py``)
switches each stage's ``MeshConfig`` as the EMA context length crosses its
buckets: hook ① re-binds the engine before the rollout, hook ② tracks the
update's config. ``train(dst_shardings=...)`` routes every step's batch
through the ``DataDispatcher`` (``core/data_dispatcher.py``) from the
engine's ``experience_shardings`` to those layouts, with
``dispatch_strategy`` "direct" or "centralized"; the async schedule hands
off through ``dispatch_async``. The records carry ``selector_switch`` and
``dispatch`` as JAX's do.

**Across ranks** (a process group of more than one rank), the trainer is
SPMD: every rank runs ``run_step`` with the same arguments, and every
collective is called by every rank of its group in the same order. The
rollout runs on the selector's current rollout config (a
tensor-parallel, data-parallel or dp x tp mesh, or one rank; a rank
outside it takes no part). The update runs on every rank of the update
mesh, as GSPMD runs JAX's ``UpdateStage`` where its inputs lie: the
update stage's config (``current_for("update")`` of a profiled
selector), else the one mesh that ``dst_shardings`` names, else rank 0.
The batch reaches it in JAX's ``_batch_spec`` layouts, its rows split
over the data rows where they divide and replicated where they do not;
each rank computes on its rows and the gradients are summed over the
data rows (``core/train_step.py``), so every rank of the mesh takes the
same AdamW step and holds the same params and optimizer state
(``UpdateParams``). The params given to ``train`` need be real only on
the update mesh's first rank; before the first update, and when hook ②
switches the update mesh, the params and optimizer state move to it
through the data dispatcher's direct executor, on the main thread.
Before each rollout the params go from the first rank of the mesh they
lie on to the rollout ranks in the tp plan's layouts
(``core.resharding.tp_plan``; the reference params once per mesh: whole
heads within a data row, the same shards on every row), and the batch
goes to the update mesh the same way, from the rows each rank holds of
a data-parallel rollout's batch (ExpPrep's advantages read the global
rewards first). The rollout's stats and the update's metrics are
broadcast, so every rank keeps the same records, selector EMA and
switches. Ranks outside the update mesh hold meta tensors of the params'
shapes after an update (a new tree each step). As in JAX, the python
engine is never bound to a mesh: it rolls out on the first rank of the
params' mesh with that rank's whole params, its stats are broadcast
from there, and no params handoff runs for it. The async schedule runs
the rollout on the main thread of every rank and the update on each
update rank's worker thread, whose gradient sums use groups of their
own (``models.tensor_parallel.update_group``); every other collective
stays on the main thread (``core/scheduler.py``).

As in the JAX trainer, the reference log-probs come from the rollout
(``ref_folded``, ``stages.py:397-399``): the engine decodes every fed token
a second time through the reference model on a dense cache. Speculation
unfolds it (the folded decode consumes one token per step and cannot
consume drafted chunks), and so does prefix sharing (the reference's dense
cache cannot fork the shared prefix pages): ExpPrep then takes JAX's
standalone route, a full-sequence reference forward, or the behaviour
log-probs when the reference IS the sampling policy, and the trainer warns
once that it does.

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
import torch.distributed as dist

from repro_torch.core.data_dispatcher import DataDispatcher
from repro_torch.core.parallelism_selector import ParallelismSelector
from repro_torch.core.resharding import (MeshConfig, NamedLayout,
                                         current_rank, finish_shards,
                                         replicated, tp_plan)
from repro_torch.core.train_step import (make_ref_logprob_step,
                                         make_rl_train_step)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import _batch_spec
from repro_torch.models.paging import (pool_pages_needed,
                                       pool_pages_needed_shared)
from repro_torch.models.tensor_parallel import update_group
from repro_torch.optim.adamw import Optimizer, adamw
from repro_torch.rl.algo import (group_relative_advantages,
                                 reinforce_advantages)
from repro_torch.rl.engine import CompiledRolloutEngine, RolloutStats
from repro_torch.rl.engine.common import check_no_modality_inputs
from repro_torch.rl.engine.compiled import NoiseFn
from repro_torch.rl.experience import ExperienceBatch, zeros_like_experience
from repro_torch.rl.rollout import RolloutEngine
from repro_torch.utils.faults import undersize_pool
from repro_torch.utils.tree import tree_leaves, tree_map

# per model family, the trainer's attn_impl -> each stream's attention:
# the policy's decode on either cache layout, the folded reference decode
# (always on a dense cache), ExpPrep's standalone reference pass and the
# Update. The ssm decode has no attention and ignores its value (JAX's
# decode_step drops it); ssm's ExpPrep pass runs the SSD scan kernel, and
# its Update the plain chunked form under autograd, as JAX's does: the
# kernel has no backward in either package. moe decodes on its dense KV
# ring (the decode kernel once per layer) and its full-sequence passes
# take the flash kernels. In the hybrid the value reaches the shared-
# attention sites only: its Mamba layers run the plain chunked form on
# every pass, as JAX's forward and prefill do, so no hybrid pass launches
# the SSD scan.
_XLA = {"dense": "xla", "ref": "xla", "expprep": "xla", "update": "xla"}
_ATTN = {
    "dense": {
        "paged": {"paged": "paged", "dense": "pallas", "ref": "pallas",
                  "expprep": "flash", "update": "flash"},
        "xla": dict(_XLA, paged="xla")},
    "ssm": {
        "paged": {"dense": "pallas", "ref": "pallas", "expprep": "pallas",
                  "update": "xla"},
        "xla": _XLA},
    "moe": {
        "paged": {"dense": "pallas", "ref": "pallas", "expprep": "flash",
                  "update": "flash"},
        "xla": _XLA},
    "hybrid": {
        "paged": {"dense": "pallas", "ref": "pallas", "expprep": "flash",
                  "update": "flash"},
        "xla": _XLA},
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
    # pool-pressure telemetry: slots preempted, peak re-admission queue
    # depth, pool doublings
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

def _broadcast(obj, src: int):
    """``obj`` from rank ``src`` on every rank of the default group."""
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def _spmd() -> bool:
    """Whether the trainer runs across ranks (a group of more than one)."""
    return dist.is_initialized() and dist.get_world_size() > 1


class RolloutStage:
    """Fig. 2 ①: runs the selector's rollout-stage hook, binds the engine
    to the stage's current MeshConfig, rolls out (with the reference pass
    folded in when ``ref_params`` is given) and feeds the context-length
    monitor. Returns ``(exp, stats, switch_row)``. ``place(params,
    ref_params)``, when set, gives the params the bound engine runs on
    (the SPMD trainer's handoff to the rollout ranks); across ranks the
    stats come from the rollout mesh's first rank."""

    def __init__(self, engine,
                 selector: Optional[ParallelismSelector] = None,
                 place: Optional[Callable] = None):
        self.engine = engine
        self.selector = selector
        self.place = place
        # across ranks, for an engine that is never bound to a mesh (the
        # python one): the rank it rolls out on, asked of the params before
        # each rollout; the others get a meta batch of the global shapes
        self.home: Optional[Callable[[Any], int]] = None
        self.home_rank: Optional[int] = None

    def __call__(self, step: int, params, batch: int, *,
                 n_episodes: Optional[int] = None,
                 noise: Optional[NoiseFn] = None, params_version: int = -1,
                 ref_params=None):
        switch = None
        sel = self.selector
        if sel is not None and sel.policy is not None:
            sw = sel.maybe_switch(step, stage="rollout")
            if sw is not None:
                switch = {"from": sw[0].name, "to": sw[1].name,
                          "ema_context": sel.ema_context}
            # checked every step, not only on a switch: a selector profiled
            # after the trainer was built binds here too
            cur = sel.current_for("rollout")
            if (hasattr(self.engine, "bind_mesh")
                    and self.engine.mesh_config != cur):
                self.engine.bind_mesh(cur)
        if self.place is not None:
            params, ref_params = self.place(params, ref_params)
        run = lambda: self.engine.run(params, batch, n_episodes, noise=noise,
                                      params_version=params_version,
                                      ref_params=ref_params)
        if self.home is not None:
            self.home_rank = self.home(params)
            if current_rank() == self.home_rank:
                exp, stats = run()
            else:
                exp, stats = zeros_like_experience(
                    batch, self.engine.max_context, device="meta"), None
            stats = _broadcast(stats, self.home_rank)
        else:
            exp, stats = run()
            if _spmd():
                mesh = getattr(self.engine, "mesh_config", None)
                stats = _broadcast(stats, mesh.device_offset if mesh else 0)
        if sel is not None:
            sel.observe(stats.mean_context_len)
        return exp, stats, switch


class ExpPrepStage:
    """Fig. 2 ②: advantage estimation, and the standalone reference pass
    for rollouts that did not fold it (``ref_folded=False``). The
    advantages are the global batch's: a rank that holds its rows of a
    data-parallel rollout's batch reads every row's rewards through the
    engine's ``gather_batch``."""

    def __init__(self, model, *, advantage: str = "reinforce",
                 group_size: int = 4, attn_impl: str = "xla", engine=None):
        if advantage not in ("reinforce", "group"):
            raise ValueError(f"advantage must be 'reinforce' or 'group', "
                             f"got {advantage!r}")
        self.advantage = advantage
        self.group_size = group_size
        self.engine = engine
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
        rewards, mine = exp.rewards, slice(None)
        gather = getattr(self.engine, "gather_batch", None)
        if gather is not None:
            rewards, mine = gather(rewards)
        if self.advantage == "group":
            adv = group_relative_advantages(rewards, self.group_size)
        else:
            adv = reinforce_advantages(rewards)
        return exp.with_(advantages=adv[mine])


class DispatchStage:
    """Fig. 2 ③④⑤: layout-aware move to the Update layout. The source
    layouts are the ones the engine reports for its harvested batch
    (``experience_shardings``; ExpPrep keeps them), or this rank alone for
    an engine that reports none. ``asynchronous=True`` posts the handoff
    and returns the dispatcher's handle, whose batch can feed the update
    at once."""

    def __init__(self, dispatcher: DataDispatcher, engine=None, *,
                 strategy: str = "direct"):
        self.dispatcher = dispatcher
        self.engine = engine
        self.strategy = strategy

    def source_shardings(self, exp: ExperienceBatch):
        del exp                  # ExpPrep's leaves keep the rollout layout
        return getattr(self.engine, "experience_shardings", None)

    def __call__(self, exp: ExperienceBatch, dst_shardings=None, *,
                 src_shardings=None, asynchronous: bool = False):
        """Returns ``(exp, report_row_or_handle)``; ``(exp, None)`` when no
        destination layouts were requested."""
        if dst_shardings is None:
            return exp, None
        if src_shardings is None:
            src_shardings = self.source_shardings(exp)
        if asynchronous:
            handle = self.dispatcher.dispatch_async(
                exp, dst_shardings, strategy=self.strategy,
                src_shardings=src_shardings)
            return handle.batch, handle
        exp, rep = self.dispatcher.dispatch(
            exp, dst_shardings, strategy=self.strategy,
            src_shardings=src_shardings)
        return exp, rep.row()


class UpdateParams(dict):
    """A params tree of an update mesh across ranks: the same tensors on
    each rank of ``mesh_config`` (the update keeps them bitwise equal),
    meta tensors of their shapes on the other ranks. The trainer reads
    from it where the tree lies: the rollout handoff sends from the
    mesh's first rank, and a switch of the update mesh moves it."""

    def __init__(self, tensors, mesh_config: MeshConfig):
        super().__init__(tensors)
        self.mesh_config = mesh_config


class UpdateStage:
    """Fig. 2 Model Update: the policy-gradient step. Params are not
    updated in place: the reference params may alias them, and under the
    async schedule a rollout may still read the version the update
    starts from. ``is_rho_max > 0`` arms the truncated importance-sampling
    correction for lagged experience."""

    def __init__(self, model, optimizer: Optimizer, *,
                 clip_eps: float = 0.0, kl_coef: float = 0.0,
                 is_rho_max: float = 0.0, attn_impl: str = "xla"):
        self._step = make_rl_train_step(model, optimizer, clip_eps=clip_eps,
                                        kl_coef=kl_coef,
                                        is_rho_max=is_rho_max,
                                        attn_impl=attn_impl)

    def __call__(self, params, opt_state, exp: ExperienceBatch,
                 group=None):
        """``group``: the update's data-axis group when ``exp`` is this
        rank's rows of a batch split over it (``core/train_step.py``)."""
        return self._step(params, opt_state, exp, group=group)


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
    engine, "dense" and "reference" for the python one; the ssm, moe and
    hybrid families' layout is "dense" (their own caches; "paged"
    raises). With
    ``speculation`` ("self" or "draft", with ``spec_k`` and
    ``draft_layers``) an unset ``sampling`` is "reference", JAX's default,
    and the reference pass is not folded. The paged pool's options reach
    the engine: ``kv_dtype="int8"``, ``share_prefix`` with ``prefix_len``
    (which unfolds the reference pass too), ``on_exhaust="preempt"`` with
    ``admit_watermark``, and ``pool_growth="double"`` with
    ``pool_growth_max``. ``pipeline="async"`` overlaps the update with
    the next rollout under ``max_policy_lag``; ``is_rho_max > 0`` arms the
    truncated-IS correction; ``max_retries`` with ``retry_backoff_s``,
    ``checkpoint_dir`` with ``checkpoint_every``, ``resume`` and ``faults``
    (a ``utils.faults.FaultInjector``, whose ``pool_pressure`` undersizes
    the paged pool at construction) are those of
    ``core/scheduler.PipelineSchedule``. ``selector`` (a
    ``ParallelismSelector``) runs hooks ① and ②, and the engine starts on
    its current config when it is profiled; ``dispatcher`` (default a
    ``DataDispatcher()``) with ``dispatch_strategy`` moves each batch to
    the ``dst_shardings`` given to ``train``/``run_step``. As in JAX, the
    trainer passes no ``draft_model``, so ``speculation="draft"`` raises
    from the engine. A model that takes modality inputs (audio, vlm) is
    refused with a ``ValueError``: neither package's rollout carries
    them."""

    model: Any                              # repro_torch Model
    env: Any
    optimizer: Optional[Optimizer] = None
    selector: Optional[ParallelismSelector] = None
    dispatcher: Optional[DataDispatcher] = None
    dispatch_strategy: str = "direct"       # "direct" | "centralized"
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
    kv_dtype: str = "bf16"                  # "fp32" | "bf16" | "int8" (paged)
    share_prefix: bool = False              # paged: fork shared-prompt pages
    prefix_len: Optional[int] = None        # None = env.prompt_prefix_len
    on_exhaust: str = "count"               # "count" | "raise" | "preempt"
    pool_growth: str = "off"                # paged: "off" | "double"
    pool_growth_max: Optional[int] = None   # growth cap (None = full)
    admit_watermark: Optional[int] = None   # preempt: free-page watermark
    speculation: str = "off"                # "off" | "self" | "draft"
    spec_k: int = 4                         # speculative chunk length
    draft_layers: Optional[int] = None      # "self": draft depth (L // 2)
    pipeline: str = "sync"                  # "sync" | "async"
    max_policy_lag: int = 1                 # async: bounded staleness
    is_rho_max: float = 0.0                 # truncated-IS cap (0 = off)
    # fault tolerance (core/scheduler.py): step retries with backoff,
    # periodic checkpoints and resume (checkpoint/checkpoint.py)
    max_retries: int = 0
    retry_backoff_s: float = 0.05
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    resume: bool = False
    # deterministic fault injection (utils/faults.FaultInjector): stage
    # exceptions at chosen steps and pool-pressure undersizing
    faults: Optional[Any] = None
    seed: int = 0
    attn_impl: str = "paged"                # "paged" (kernels) | "xla"
    noise: Optional[Callable[[int], NoiseFn]] = None
    device: Any = None

    history: List[StepRecord] = field(default_factory=list)

    def __post_init__(self):
        check_no_modality_inputs(self.model)
        self._check_modes()
        if self.attn_impl not in ("paged", "xla"):
            raise ValueError(f"attn_impl must be 'paged' or 'xla', got "
                             f"{self.attn_impl!r}")
        python = self.rollout_backend == "python"
        if self.cache_layout is None:
            # the dense family's engine default is the paged pool; the
            # other families decode on their own caches (JAX's default)
            self.cache_layout = ("dense" if python
                                 or self.model.cfg.family != "dense"
                                 else "paged")
        if self.sampling is None:
            self.sampling = ("reference" if python or self.speculation != "off"
                             else "fused")
        self.device = resolve_device(self.device)
        self.optimizer = self.optimizer or adamw(3e-4, weight_decay=0.0)
        self.dispatcher = self.dispatcher or DataDispatcher()
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
                prefix_len=self.prefix_len, pool_growth=self.pool_growth,
                pool_growth_max=self.pool_growth_max,
                admit_watermark=self.admit_watermark,
                speculation=self.speculation, spec_k=self.spec_k,
                draft_layers=self.draft_layers,
                # start on the selector's current config when profiled
                mesh_config=(self.selector.current
                             if self.selector is not None
                             and self.selector.policy is not None
                             else None), **kw)
        # JAX folds the reference pass into the rollout unless prefix
        # sharing or speculation is on: the folded reference decodes on a
        # dense cache, which can neither fork the shared prefix pages nor
        # consume drafted chunks
        self.ref_folded = (not getattr(self.rollout, "shared_pages", 0)
                           and self.speculation == "off")
        self._warned_ref_fallback = False
        self.rollout_stage = RolloutStage(self.rollout, self.selector)
        # across ranks: the mesh the last dst_shardings named, the rank
        # that holds the params given to train (set at the first step),
        # and whether the last batch handed to the update split its rows
        self._dst_mesh: Optional[MeshConfig] = None
        self._given_root: Optional[int] = None
        self._rows_split = False
        if _spmd():
            self._init_spmd(python)
        self.expprep_stage = ExpPrepStage(
            self.model, advantage=self.advantage,
            group_size=self.group_size, attn_impl=attn["expprep"],
            engine=self.rollout)
        self.dispatch_stage = DispatchStage(
            self.dispatcher, self.rollout, strategy=self.dispatch_strategy)
        self.update_stage = UpdateStage(
            self.model, self.optimizer, clip_eps=self.clip_eps,
            kl_coef=self.kl_coef, is_rho_max=self.is_rho_max,
            attn_impl=attn["update"])
        self._gen = torch.Generator(device=self.device).manual_seed(
            self.seed)
        if getattr(self.faults, "pool_pressure", 0) > 0:
            self._undersize_pool(self.faults.pool_pressure)

    # -- across ranks ---------------------------------------------------
    @property
    def spmd(self) -> bool:
        """Whether the trainer runs across ranks."""
        return _spmd()

    broadcast = staticmethod(_broadcast)

    def _init_spmd(self, python: bool) -> None:
        """The rollout stage's handoff across ranks: the compiled engine is
        bound to a mesh and takes its params through ``_place``; the python
        engine, never bound (as in JAX), rolls out on the first rank of the
        params' mesh."""
        self._handoff = DataDispatcher()   # params out, the batch back
        self._ref_placed = None
        if python:
            self.rollout_stage.home = self._root_of
            return
        if self.rollout.mesh_config is None:
            # no selector: the rollout runs where the update does
            self.rollout.bind_mesh(self.update_mesh())
        self.rollout_stage.place = self._place

    def update_mesh(self) -> MeshConfig:
        """The mesh the update runs on: the update stage's config of a
        profiled selector, else the one mesh every leaf of the last
        ``dst_shardings`` lies on (JAX's GSPMD runs the step where its
        inputs lie), else rank 0."""
        sel = self.selector
        if sel is not None and sel.policy is not None:
            return sel.current_for("update")
        if self._dst_mesh is not None:
            return self._dst_mesh
        return MeshConfig("update", dp=1, tp=1)

    def in_update_mesh(self) -> bool:
        """Whether this rank runs the update (every rank of one)."""
        return not _spmd() or current_rank() in self.update_mesh().ranks()

    def note_dst(self, dst_shardings) -> None:
        """Before each rollout, on every rank: the mesh ``dst_shardings``
        names when all of its leaves share one (see ``update_mesh``), and,
        the first time, the rank that holds the params given to ``train``:
        the update mesh's first rank."""
        meshes = ({lay.mesh_config for lay in tree_leaves(dst_shardings)}
                  if dst_shardings is not None else set())
        self._dst_mesh = meshes.pop() if len(meshes) == 1 else None
        if self._given_root is None:
            self._given_root = self.update_mesh().device_offset

    def _root_of(self, params=None) -> int:
        """The first rank of the mesh ``params`` lie on: an
        ``UpdateParams``' own, or the one that holds the given params (the
        update mesh's first rank before the first step)."""
        if isinstance(params, UpdateParams):
            return params.mesh_config.device_offset
        if self._given_root is not None:
            return self._given_root
        return self.update_mesh().device_offset

    def _rollout_root(self) -> int:
        """The rank whose rollout the others follow: the bound mesh's first
        rank, or the rank the python engine last rolled out on."""
        mesh = getattr(self.rollout, "mesh_config", None)
        if mesh is not None:
            return mesh.device_offset
        home = self.rollout_stage.home_rank
        return home if home is not None else self._root_of()

    def rolls_out(self) -> bool:
        """Whether this rank took part in the last rollout (every rank of
        a one-rank world)."""
        if not _spmd():
            return True
        if self.rollout_stage.home is not None:
            return current_rank() == self.rollout_stage.home_rank
        return self.rollout.in_mesh

    def sync_generator(self) -> None:
        """Across ranks, before a rollout: the last rollout's ranks advanced
        the trainer's generator, so every rank draws on from where the
        rollout's first rank stopped (a no-op on one rank or with injected
        noise)."""
        if _spmd() and self.noise is None:
            self._gen.set_state(_broadcast(self._gen.get_state(),
                                           self._rollout_root()))

    def stand_in(self, params, mesh: MeshConfig) -> "UpdateParams":
        """What a rank outside the update mesh ``mesh`` holds for the
        params after an update: meta tensors of their shapes, a new tree
        each time, so ``ref_params is params`` tests alike on every
        rank."""
        return UpdateParams(
            {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
             for k, v in params.items()}, mesh)

    def _batch_layouts(self, exp):
        """Where the harvested batch lies across ranks: the engine's
        layouts, or the rank the python engine rolled out on."""
        src = self.dispatch_stage.source_shardings(exp)
        if src is None:
            home = MeshConfig("rollout", dp=1, tp=1,
                              device_offset=self.rollout_stage.home_rank)
            src = ExperienceBatch(*(NamedLayout(home) for _ in exp))
        return src

    def _update_hook(self, step: int) -> None:
        """Hook ②: the update stage's config is tracked apart from the
        rollout's (the async schedule needs both at once)."""
        if self.selector is not None and self.selector.policy is not None:
            self.selector.maybe_switch(step, stage="update")

    def handoff(self, step: int, exp, dst_shardings):
        """Across ranks (every rank calls, on the main thread): the batch
        through the dispatch stage to ``dst_shardings`` when given, hook ②,
        then the batch to the update mesh. Returns ``(exp,
        dispatch_row)``; ``update_group()`` then says how the update sums
        over its rows."""
        src = self._batch_layouts(exp)
        exp, row = self.dispatch_stage(exp, dst_shardings, src_shardings=src)
        self._update_hook(step)
        exp = self._to_update_mesh(
            exp, dst_shardings if dst_shardings is not None else src)
        return exp, row

    def _to_rollout(self, params):
        """``params`` from the first rank of their mesh to the bound
        rollout mesh, each rank its local tensors under the tp plan (meta
        outside the mesh)."""
        mesh = self.rollout.mesh_config
        plan = tp_plan(self.model, mesh)
        src_cfg = MeshConfig("update", dp=1, tp=1,
                             device_offset=self._root_of(params))
        mine = current_rank() == src_cfg.device_offset
        src = {k: (v if mine else torch.empty(v.shape, dtype=v.dtype,
                                              device="meta"))
               for k, v in params.items()}
        out = self._handoff.dispatch_direct(
            src, plan.layouts,
            src_shardings={k: NamedLayout(src_cfg) for k in src})
        local = finish_shards(out, plan, device=self.device)
        return local if mesh.tp > 1 else dict(local)

    def _place(self, params, ref_params):
        """RolloutStage's handoff: the policy's params every step, the
        reference params once per (tree, mesh)."""
        mesh = self.rollout.mesh_config
        if ref_params is not None:
            key = (ref_params, mesh)
            if self._ref_placed is None or self._ref_placed[0][0] \
                    is not ref_params or self._ref_placed[0][1] != mesh:
                self._ref_placed = (key, self._to_rollout(ref_params))
            ref_params = self._ref_placed[1]
        return self._to_rollout(params), ref_params

    def _to_update_mesh(self, exp, src_shardings):
        """The harvested batch to the update mesh in ``_batch_spec``
        layouts: rows over (pod, data) where they divide, else replicated,
        and replicated over model (every rank calls)."""
        mesh = self.update_mesh()
        dst = ExperienceBatch(*(
            _batch_spec(mesh, tuple(x.shape) if x.is_meta
                        else lay.global_shape(x.shape))
            for x, lay in zip(exp, tree_leaves(src_shardings))))
        self._rows_split = dst.tokens.shards(0) > 1
        out, _ = self._handoff.dispatch(exp, dst, strategy="direct",
                                        src_shardings=src_shardings)
        # gloo hands a rank that held nothing its rows on the host
        return ExperienceBatch(*(x if x.is_meta else x.to(self.device)
                                 for x in out))

    def update_group(self):
        """The group the update on this rank sums over: the update mesh's
        data rows (``update_group``) when the last handed-off batch is
        split over them, else None (every rank computes the whole batch,
        as GSPMD's replicated program does)."""
        if not _spmd() or not self._rows_split:
            return None
        return update_group(self.update_mesh())

    def place_state(self, params, opt_state):
        """The params and optimizer state onto the update mesh, replicated
        on its ranks (every rank calls, on the main thread): from the rank
        that holds the given params, or from the mesh an ``UpdateParams``
        lies on after hook ② switched the update stage. Each block comes
        from its lowest holder (the direct executor). A no-op when they lie
        there already. Makes the update mesh's ``update_group``s, which
        are collective. Returns ``(UpdateParams, opt_state)``."""
        mesh = self.update_mesh()
        update_group(mesh)
        if isinstance(params, UpdateParams) and params.mesh_config == mesh:
            return params, opt_state
        src = (params.mesh_config if isinstance(params, UpdateParams)
               else MeshConfig("given", dp=1, tp=1,
                               device_offset=self._given_root))
        state = (dict(params), opt_state)
        if current_rank() not in src.ranks():
            state = tree_map(lambda v: torch.empty(
                v.shape, dtype=v.dtype, device="meta"), state)
        params, opt_state = self._handoff.dispatch_direct(
            state, tree_map(lambda _: replicated(mesh), state),
            src_shardings=tree_map(lambda _: replicated(src), state))
        # gloo hands a rank that held nothing its pieces on the host
        params, opt_state = tree_map(
            lambda v: v if v.is_meta else v.to(self.device),
            (params, opt_state))
        return UpdateParams(params, mesh), opt_state

    def _undersize_pool(self, fraction: float) -> None:
        """Injected pool pressure: the paged pool at ``fraction`` of its
        exhaustion-free size, never below the preemption governor's
        minimum viable pool, so the pressure stays recoverable."""
        if self.rollout_backend != "compiled" \
                or self.cache_layout != "paged":
            raise ValueError(
                "pool_pressure fault injection requires "
                "rollout_backend='compiled' with cache_layout='paged'")
        eng = self.rollout
        if eng.shared_pages > 0:
            full = pool_pages_needed_shared(self.batch_size, self.max_context,
                                            eng.shared_len, self.page_size)
        else:
            full = pool_pages_needed(self.batch_size, self.max_context,
                                     self.page_size)
        floor = (eng.min_pool_pages(self.batch_size)
                 if self.on_exhaust == "preempt" else 1)
        eng.cache_pages = undersize_pool(full, fraction, floor)

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
                ("share_prefix", self.share_prefix),
                (f"on_exhaust={self.on_exhaust!r}",
                 self.on_exhaust == "preempt"),
                (f"pool_growth={self.pool_growth!r}",
                 self.pool_growth != "off"),
                (f"speculation={self.speculation!r}",
                 self.speculation != "off")):
            if bad:
                raise ValueError(f"{what} requires rollout_backend="
                                 f"'compiled' (the python reference engine "
                                 f"decodes a dense bf16 cache with the "
                                 f"reference sampler, without slot refill)")

    def _check_modes(self) -> None:
        for name, value, allowed in (
                ("rollout_backend", self.rollout_backend,
                 ("compiled", "python")),
                ("pipeline", self.pipeline, ("sync", "async")),
                ("dispatch_strategy", self.dispatch_strategy,
                 ("direct", "centralized"))):
            if value not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got "
                                 f"{value!r}")

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

    def check_fault(self, site: str, step: int) -> None:
        """Stage-boundary hook for deterministic fault injection; a no-op
        without an injector."""
        if self.faults is not None:
            self.faults.check(site, step)

    def rollout_noise(self, step: int) -> NoiseFn:
        """The draws of step ``step``'s rollout: the injected ``noise(step)``
        or the engine's own from the trainer's generator. Both schedules
        take it just before the rollout, so they draw the same values in
        the same order."""
        if self.noise is not None:
            return self.noise(step)
        return self.rollout.default_noise(self._gen)

    @staticmethod
    def read_metrics(metrics) -> dict:
        """The update's one host sync: every metric in one copy. On CUDA
        it waits for the update's work on the current stream, the new
        params included (they are computed before the metrics are
        read)."""
        return dict(zip(metrics, torch.stack(
            [v.float() for v in metrics.values()]).tolist()))

    def make_record(self, step: int, stats: RolloutStats, metrics, *,
                    switch=None, dispatch_row=None, wall_time_s=0.0,
                    rollout_wall_s=0.0, update_wall_s=0.0,
                    policy_lag: int = 0) -> StepRecord:
        """The per-step observability row (shared by the sync step and the
        async schedule); ``metrics`` holds host floats."""
        rec = StepRecord(
            step=step,
            mean_return=stats.mean_return,
            mean_context_len=stats.mean_context_len,
            mean_turn_len=stats.mean_turn_len,
            truncated_frac=float(np.mean(stats.truncated)),
            loss=metrics["loss"],
            kl=metrics.get("kl", 0.0),
            selector_switch=switch,
            dispatch=dispatch_row,
            wall_time_s=wall_time_s,
            params_version=stats.params_version,
            policy_lag=policy_lag,
            rollout_wall_s=rollout_wall_s,
            update_wall_s=update_wall_s,
            is_weight_mean=metrics.get("is_weight_mean", 0.0),
            pages_in_use=stats.pages_in_use,
            page_capacity=stats.page_capacity,
            kv_dropped_writes=stats.kv_dropped_writes,
            preemptions=stats.preemptions,
            requeue_depth=stats.requeue_depth,
            pool_grows=stats.pool_grows,
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
        if self.speculation != "off":
            reason = (f"speculation={self.speculation!r}: the folded "
                      f"reference pass consumes tokens one decode step at a "
                      f"time and cannot consume the drafted chunks the "
                      f"speculative loop commits")
        else:
            reason = (f"share_prefix=True: the reference model's dense cache "
                      f"cannot fork the {self.rollout.shared_len}-token "
                      f"shared prefix run")
        warnings.warn(
            f"EarlTrainer: reference log-probs will come from ExpPrep's "
            f"standalone route, not the rollout fold (reason: {reason}). "
            f"The reference pass re-runs each harvested context per step.",
            RuntimeWarning, stacklevel=3)

    # ------------------------------------------------------------------
    def run_step(self, step: int, params, opt_state, ref_params=None,
                 dst_shardings=None):
        """One full Fig. 2 iteration: Rollout → ExpPrep → Dispatch →
        Update. Returns (params, opt_state, record)."""
        self._maybe_warn_ref_fallback(ref_params)
        t0 = time.perf_counter()
        self.check_fault("rollout", step)
        self.note_dst(dst_shardings)
        self.sync_generator()
        exp, stats, switch = self.rollout_stage(
            step, params, self.batch_size, n_episodes=self.rollout_episodes,
            noise=self.rollout_noise(step), params_version=step,
            ref_params=ref_params if self.ref_folded else None)
        t_roll = time.perf_counter() - t0

        # the standalone reference pass runs only when the rollout did not
        # fold it, and is skipped when the reference IS the behaviour
        # params and sampling recorded unbiased model log-probs
        # (temperature 1 or greedy, top_p off)
        reuse_lp = (ref_params is params and self.top_p == 1.0
                    and (self.temperature <= 0.0
                         or self.temperature == 1.0))
        spmd = _spmd()
        if self.rolls_out():
            exp = self.expprep_stage(exp, ref_params=ref_params,
                                     ref_folded=self.ref_folded,
                                     reuse_behavior_lp=reuse_lp)
        self.check_fault("dispatch", step)
        # the update runs on this rank alone, or across ranks on every rank
        # of the update mesh, which the batch, the params and the optimizer
        # state reach through the dispatcher
        if spmd:
            exp, dispatch_row = self.handoff(step, exp, dst_shardings)
            params, opt_state = self.place_state(params, opt_state)
        else:
            exp, dispatch_row = self.dispatch_stage(exp, dst_shardings)
            self._update_hook(step)
        t1 = time.perf_counter()
        self.check_fault("update", step)
        metrics, group = None, self.update_group()
        if self.in_update_mesh():
            params, opt_state, metrics = self.update_stage(
                params, opt_state, exp, group=group)
            metrics = self.read_metrics(metrics)
        if spmd:
            mesh = self.update_mesh()
            metrics = _broadcast(metrics, mesh.device_offset)
            params = (UpdateParams(params, mesh) if self.in_update_mesh()
                      else self.stand_in(params, mesh))
        t2 = time.perf_counter()
        rec = self.make_record(step, stats, metrics, switch=switch,
                               dispatch_row=dispatch_row,
                               wall_time_s=t2 - t0, rollout_wall_s=t_roll,
                               update_wall_s=t2 - t1)
        return params, opt_state, rec

    # ------------------------------------------------------------------
    def train(self, n_steps: int, *, params=None, opt_state=None,
              ref_params=None, dst_shardings=None, verbose: bool = False):
        """Train for ``n_steps`` steps under the configured schedule.
        ``dst_shardings`` (an ``ExperienceBatch`` of ``NamedLayout``s)
        routes every step's batch through the data dispatcher to those
        layouts. Returns ``(params, opt_state, history)``."""
        from repro_torch.core.scheduler import PipelineSchedule
        if params is None:
            params, opt_state, ref_params = self.init_state()
        sched = PipelineSchedule(self, mode=self.pipeline,
                                 max_policy_lag=self.max_policy_lag,
                                 max_retries=self.max_retries,
                                 retry_backoff_s=self.retry_backoff_s,
                                 checkpoint_dir=self.checkpoint_dir,
                                 checkpoint_every=self.checkpoint_every,
                                 resume=self.resume)
        return sched.run(n_steps, params=params, opt_state=opt_state,
                         ref_params=ref_params, dst_shardings=dst_shardings,
                         verbose=verbose)
