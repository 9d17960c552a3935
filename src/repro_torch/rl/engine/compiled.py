"""Slot-based rollout engine on the paged KV pool or the dense ring-buffer
cache, with the reference pass folded in (port of
``repro/rl/engine/compiled.py``).

One *macro-step* is one agent turn for every slot:

    [generate max_turn_tokens steps] -> [pool telemetry] ->
    [fallback actions] -> [env step] -> [harvest finished episodes] ->
    [slot refill: release pages + reset rows] -> [one combined obs feed]

The combined feed teacher-forces continuing rows' env observation and
refilled rows' reset observation in one loop over ``obs_len`` decode
steps. JAX compiles the macro-step into one XLA program; here it is a
Python loop over device tensors that enqueues work without waiting on the
GPU: ``lax.scan`` becomes a ``for`` loop and ``lax.cond`` becomes
unconditional masked work (``torch.where``), which computes the same
result. The host syncs ONCE per turn — it reads the ``returned`` counter
(and, with ``on_exhaust="raise"``, the dropped-write counter); nothing
inside a macro-step calls ``.item()``, branches on a tensor, or indexes
with a boolean mask, except the speculative round loop below.

**Speculative decoding** (``speculation="self"`` or ``"draft"``, paged
layout, ``sampling="reference"``): generation runs verify rounds instead
of single decode steps. Each round samples c0 exactly as sequential decode
would, lets a draft model (the policy's first ``draft_layers`` layers, or
a separate small model) propose up to ``spec_k - 1`` more tokens, scores
the whole chunk in ONE ``transformer.spec_verify_step``, and commits the
longest prefix whose tokens are what sequential decode would have sampled
from the same noise rows, capped at the first action token. The draft
decodes on its own dense cache in plain attention (as in JAX) and consumes
every fed column; rejecting proposals rolls its fill line back. JAX's
round loop is a ``lax.while_loop`` whose exit test runs on the device;
here the test is read back once per round (``_more_rounds``). So the
contract is one host read per turn plus one per verify round. A turn
always runs at least one round (masked no-op work when no row writes).

Randomness is a tensor argument: ``run(..., noise=fn)`` takes a callable
``fn(kind, macro_step, index, shape) -> Tensor`` (``kind`` "sample": the
Gumbel draw for token ``index`` of the turn, shape (B, V); "env": the env
step's draw, shape (B, env.step_noise_width); "reset": the env reset's
draw, shape (B, env.reset_noise_width), asked only of an env that takes
one, with macro-step -1 for the initial reset). Under
``on_exhaust="preempt"`` the "env" and "reset" draws are keyed by episode:
``macro_step`` is then the (B,) episode-id tensor and ``index`` the (B,)
env-step tensor (JAX's ``episode_env_rng``/``episode_reset_rng``), so a
preempted episode replays its draws. Sampled (non-greedy) runs under
preemption are NOT schedule-invariant, as in JAX: the "sample" draws stay
keyed by (macro-step, token). Without ``noise`` the engine draws from
``generator`` on its device (under preemption, from a hash of the episode
coordinates seeded once from ``generator``).

**Prefix sharing** (``share_prefix=True``, paged layout): the full pages of
the env's common prompt prefix (``env.prompt_prefix_len`` tokens, or
``prefix_len``) are decoded ONCE through slot 0 at init, pinned by an
engine-held reference, and forked into every slot's block table at init
and on every refill; refilled slots feed only the per-episode suffix.
Writes into shared pages are copy-on-write guarded. Greedy decode is
bitwise the unshared engine's: per-row math is row-independent, so a
forked page holds exactly the K/V the slot would have computed. Whether a
turn's feed needs the full observation (some row continues) or only the
refilled rows' suffix is JAX's ``lax.cond``; here it is a host decision,
so under sharing the turn's one host read moves before the feed and
carries the run loop's counters too (``SlotCarry.host``).

**Pool pressure.** ``kv_dtype="int8"`` stores pages in int8 with f32
scales (the kernels dequantize in registers). ``on_exhaust="preempt"``
runs the pressure governor before each turn writes (``paging.
pressure_plan``: throttle, then preempt longest-context victims, whose
episodes are re-admitted first by the watermark-gated ``slots.
admission_plan``), so an undersized pool runs slower instead of dropping
K/V. ``pool_growth="double"`` doubles the pool between macro-steps when it
shows distress, up to ``pool_growth_max``. The governor adds no host read:
its decisions stay on the device.

With ``run(..., ref_params=...)`` a second decode stream runs the
reference model over the same columns as the policy, on its own dense bf16
cache (whatever the policy's layout and dtype, as in JAX), and scores each
fed token from the reference logits before they advance: the harvested
``ref_logprobs`` are the ExpPrep reference log-probs, so the trainer needs
no separate reference forward.

**Tensor parallelism** (``mesh_config`` with tp above 1; the dense, moe,
ssm and hybrid families): every rank of the mesh runs the same
macro-step on its local shards of the params (``core.resharding.
tp_plan``/``shard_params``: whole heads, whole experts, whole SSM heads,
the MLP's and the vocab's slices) and its local kv heads and SSM heads in
every cache, with the model's all-reduces over the mesh's model axis
(``models/tensor_parallel.py``). Logits stay vocab-sharded: sampling
merges per-row partial states (the fused kernel's partial-state mode, or
the plain route's argmax, max and sums), the folded reference scores its
tokens the same way, and each rank takes its columns of the ``(B, V)``
noise draw, so a tp run samples what the one-rank run samples. Control
flow, slots, block tables and the env are replicated: every rank computes
the same, and the collectives return the same values on every rank. A
rank outside the bound mesh takes no part: ``run`` returns a batch of
meta tensors of the global shapes (the dispatcher's stand-in) and no
stats. The paged pool's options hold at tp above 1: int8 pages keep their
per-kv-head scales beside the rank's kv heads; the shared prefix run, the
block tables, the refcounts and the governor's, admission's and growth's
decisions are replicated, and pool growth grows each rank's shards. Under
speculation the draft decodes on the rank's shards (``"self"``: the view
of the rank's policy shards; ``"draft"``: the draft model's own tp plan)
into a dense cache of the rank's kv heads, the verify chunk runs on the
rank's heads, every judged token is the vocab-partial combine, and the
round loop's flag is reduced over the model axis.

**Data parallelism** (``mesh_config`` with dp or pods above 1, and dp x
tp; every family, both layouts, every pool option): the mesh's D = dp x
pods data rows each run a window of the global slots, row d slots
``[d B/D, (d+1) B/D)``, on their own dense cache rows or their own paged
pool; the ranks of one row are a tp group at tp above 1. Every row asks
its ``NoiseFn`` for the global batch's draws and takes its rows (draws
keyed by episode are the row's own), so the schedule is the one-rank
engine's.

The paged pool is JAX's one global pool as a COUNT, its pages kept
local: what decides the tokens is which writes land, stall, drop or get
preempted, not which page holds a slot's K/V (attention reads through
the block table). The global pool has ``cache_pages`` pages (full
provisioning by default; grown by pool growth; ``page_capacity``
reports it). A row's own pool holds ``min(global pool, the row's full
provisioning)`` pages and its trash page, the row's full provisioning
being ``pool_pages_needed_shared`` of its B/D slots (its own copy of the
shared run included): it never needs more, and every grant the global
count allows finds a page there. The global pages in use are the rows'
private pages plus the shared run ONCE (each row decodes the run through
its first slot at batch 1, and pins and forks its own copy), so
``pages_peak`` and the free count the allocator, the governor, admission
and growth read are JAX's. The collectives a turn makes over the rows
(``models.tensor_parallel.data_group``), by mode:

  - always ONE all-gather after the harvest (``_across_rows``): each
    row's finished count, private pages in use, new dropped writes and
    continuing slots, so the refill gives a finished slot the next
    episode id in the global slot order and ``launched``, ``returned``,
    ``pages_peak`` and ``kv_dropped`` are global on every row, and under
    sharing every row takes the global batch's feed branch;
  - preempt mode: that gather also carries each row's free slots,
    reserved pages and survivors after its finished slots released their
    pages, so every row plans JAX's admission on the global batch and
    takes its slots (a re-queued episode can land on another row); and
    ONE more gather before the turn writes (``_govern``): each slot's
    eligibility, position, demand, private pages and episode, so every
    row runs the governor on the global batch with the global free count
    and keeps its rows of the run set and the victims;
  - a pool below the global batch's full provisioning outside preempt
    mode (``"count"``/``"raise"``, growth from a small pool): ONE
    all-gather per allocation (a decode step, a verify chunk's page,
    ``_grant``) of the rows' need masks and private pages, so a slot
    gets a page iff its rank over the global batch is below the global
    free count (JAX's ``alloc_pages``). At full provisioning, or under
    the governor (which admits only what fits), no write can fail and no
    step adds a collective;
  - pool growth: ONE all-reduce of the rows' private pages before the
    turn's host read (the watermark test's global free count); every row
    grows in the same turn, its pool to ``min(grown global, its full
    provisioning)``;
  - speculation: the round loop's flag is a MAX over the model axis and
    then the data rows, one per verify round, so every row runs JAX's
    global round count (masked no-op rounds where its slots are done).

At the end of ``run`` ONE all-reduce of the episode stores' bytes gives
every row all ``N`` episodes (each was harvested on one row; the others
hold zeros there) and sums the rows' speculative counters; the stats are
global, and each rank keeps its rows of the batch where the data rows
divide ``N`` (JAX's ``_batch_spec``; ``experience_shardings`` says so).
Where the rows do not divide B, every row runs all B slots on the whole
pool, as JAX's layouts replicate such a batch, and nothing is exchanged.

The episode store and the slot token buffers carry one trash row/column
where JAX drops out-of-range writes (``slots.py``); the paged pools carry
one trash page (``models/layers.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.models import paging as pool_paging
from repro_torch.models import transformer
from repro_torch.rl.algo import reinforce_advantages
from repro_torch.rl.engine import common, paging, slots
from repro_torch.rl.engine.common import ACTION_BASE
from repro_torch.rl.envs.base import TOK_PAD, blend_rows
from repro_torch.rl.experience import ExperienceBatch

NoiseFn = Callable[[str, int, int, tuple], torch.Tensor]


class _RefStream(NamedTuple):
    """The folded reference pass: its decode body and its carry fields."""
    decode: Callable
    logits: torch.Tensor       # (B, V) f32 last reference logits
    cache: Any                 # dense bf16 decode cache
    logprobs: torch.Tensor     # (B, T+1) f32 ref log-prob of each fed token


class _DraftStream(NamedTuple):
    """The speculative draft: its dense decode body and its cache."""
    decode: Callable
    cache: Any                 # dense bf16 decode cache of the draft
    vocab: int                 # its logits' columns (the rank's under tp)


class DataRows:
    """This rank's place among the D = dp x pods data rows of a mesh (each
    row a tp group at tp above 1) and its data-axis group across them
    (``models.tensor_parallel.data_group``): the data-parallel rollout's
    slot windows and exchanges."""

    def __init__(self, mesh_cfg, group):
        from repro_torch.core.resharding import current_rank
        self.n = mesh_cfg.pods * mesh_cfg.dp
        rows = mesh_cfg.ranks().reshape(self.n, mesh_cfg.tp)
        self.index = int(np.argwhere(rows == current_rank())[0][0])
        self.group = group

    def window(self, batch: int):
        """This row's ``(lo, hi, batch)`` of ``batch`` global slots; None
        where the rows do not divide ``batch``: every row then runs all of
        them (JAX's layouts replicate a batch that does not divide)."""
        if batch % self.n:
            return None
        b = batch // self.n
        return self.index * b, (self.index + 1) * b, batch

    def gather(self, x):
        """``(n, *x.shape)``: every row's ``x``, row by row, by ONE
        all-reduce of a zero-padded buffer (adding zeros is exact)."""
        buf = x.new_zeros((self.n,) + tuple(x.shape))
        buf[self.index] = x
        return self.all_reduce_sum(buf)

    def gather_slots(self, slots, counts):
        """ONE gather of this row's per-slot ``slots`` (each (b,): bool or
        int) and 0-d ``counts``, as int32. Returns the global batch's
        ``slots`` (each (n b,), in the global slot order) and every row's
        ``counts`` ((n, len(counts)))."""
        parts = [torch.stack(counts).to(torch.int32)]
        if slots:
            parts.insert(0, torch.stack(slots).to(torch.int32).reshape(-1))
        b = slots[0].shape[0] if slots else 0
        g = self.gather(torch.cat(parts))
        per = g[:, :len(slots) * b].reshape(self.n, len(slots), b)
        return ([per[:, i].reshape(-1) for i in range(len(slots))],
                g[:, len(slots) * b:])

    def all_reduce_sum(self, x):
        """``x`` summed over the rows (in place; returned)."""
        dist.all_reduce(x, group=self.group)
        return x


def _exchange_store(store: slots.EpisodeStore, N: int, rows: DataRows,
                    sums: torch.Tensor):
    """Every row's harvest in every row's store: each episode id was
    harvested on one row and the others hold zero bytes there, so ONE
    all-reduce of the stores' bytes (as int32 words, whose sums carry
    nothing across bytes) gives each row all ``N`` episodes bitwise. The
    4-byte leaves go first, so every leaf starts at a word boundary; the
    row's int32 ``sums`` ride at the end and come back summed over the
    rows. Returns an ``EpisodeStore`` of ``N`` rows (no trash row) and the
    summed ``sums``."""
    order = sorted(range(len(store)), key=lambda i: -store[i].element_size())
    leaves = [store[i][:N].contiguous() for i in order]
    flat = torch.cat([x.reshape(-1).view(torch.uint8) for x in leaves])
    flat = torch.nn.functional.pad(flat, (0, -flat.numel() % 4))
    words = rows.all_reduce_sum(torch.cat([flat.view(torch.int32), sums]))
    flat = words[:flat.numel() // 4].view(torch.uint8)
    out, off = [None] * len(store), 0
    for i, x in zip(order, leaves):
        n = x.numel() * x.element_size()
        out[i] = flat[off:off + n].view(x.dtype).view(x.shape)
        off += n
    return slots.EpisodeStore(*out), words[flat.numel() // 4:]


def _local_noise(noise: NoiseFn, window) -> NoiseFn:
    """``noise`` asked for the global batch's draws, this data row's rows
    taken (``window`` = (lo, hi, B); ``noise`` itself when None). Draws
    keyed by episode (preempt mode: ``m`` and ``index`` are tensors of the
    row's slots) are the row's own already, and pass through."""
    if window is None:
        return noise
    lo, hi, B = window

    def draw(kind, m, index, shape):
        if isinstance(m, torch.Tensor):
            return noise(kind, m, index, shape)
        return noise(kind, m, index, (B,) + tuple(shape[1:]))[lo:hi]
    return draw


def _reset_cache_rows(cache, refill):
    """Reset a decode cache row-wise for refilled slots. Paged caches
    release the slots' pages back to the pool (no KV data touched). Other
    caches are zeroed generically over the families, as JAX's: ``pos``
    (rank 1) per row on dim 0, every other leaf (KV rings, conv windows,
    SSM states) on dim 1, with masked in-place writes. An SSM or conv
    state is not invalidated by position, so every leaf is zeroed."""
    if paging.is_paged(cache):
        return paging.release_slot_pages(cache, refill)

    def zero(leaf):
        if leaf is None:                           # an absent scale pool
            return None
        if isinstance(leaf, tuple):                # the nested KV pair
            return type(leaf)(*(zero(x) for x in leaf))
        if leaf.dim() == 1:
            return torch.where(refill, 0, leaf)
        return leaf.masked_fill_(
            refill.view((1, -1) + (1,) * (leaf.dim() - 2)), 0)

    return zero(cache)


class CompiledRolloutEngine:
    """Multi-turn generation with slot-based continuous batching.
    ``run(params, batch, n_episodes)`` returns ``(ExperienceBatch,
    RolloutStats)``; with ``n_episodes > batch`` finished episodes free
    their slot and a fresh episode is reset into it. ``device=None`` means
    the GPU and raises if none is present.

    Options ported so far: ``cache_layout`` ("paged", the default, or
    "dense"; the ssm, moe and hybrid families take only "dense", their own
    caches: ``MambaCache``, ``MoECache``, ``HybridCache``), ``attn_impl`` (paged layout: "paged" = the paged CUDA
    kernel, "xla" = gather + dense attention; dense layout: "pallas" = the
    split-K decode kernel, "xla" = masked dense attention; ``None`` = the
    layout's kernel; with speculation the verify pass takes "paged" = the
    spec-verify kernel; the ssm decode has no attention and ignores it, as
    JAX's; moe runs it once per layer, the hybrid once per attention
    site), ``ref_attn_impl`` (the reference stream's dense
    decode: "pallas" or "xla"), ``sampling`` ("fused" = the one-pass CUDA
    sampler, the default; "reference" = plain argmax + log-softmax),
    ``temperature``, ``top_p``,
    ``page_size``, ``cache_pages``, ``kv_dtype`` ("bf16", "fp32", or
    "int8" on the paged layout), ``share_prefix`` with ``prefix_len``,
    ``on_exhaust`` ("count", "raise" or "preempt" with
    ``admit_watermark``), ``pool_growth`` ("off" or "double" with
    ``pool_growth_max``) and ``speculation`` ("off", "self" or "draft",
    with ``spec_k``, ``draft_layers`` and ``draft_model``) and
    ``mesh_config``: a ``MeshConfig`` over ranks of the process group
    (``bind_mesh`` re-binds it on a selector switch); tp above 1 runs the
    tensor-parallel rollout of the dense, moe, ssm and hybrid families,
    dp or pods above 1 the data-parallel rollout (dp x tp both), with
    every option: the pool is JAX's one global page count over the data
    rows' own pools (the module docstring gives each mode's collectives
    a turn; ``rank_pool_pages`` is this rank's own pool after a run).
    After each ``run``, ``experience_shardings`` holds the harvested
    batch's layouts (an ``ExperienceBatch`` of ``NamedLayout``s, the batch
    over the (pod, data) axes where they divide it, JAX's
    ``_batch_spec``), the data dispatcher's source layouts: a rank holds
    its shard of each.
    Unlike the JAX engine, the defaults are the production path: the
    kernels on the card, and their plain versions for CPU tensors.
    """

    def __init__(self, model, env, *, max_turns: int = 4,
                 max_turn_tokens: int = 8, max_context: int = 256,
                 temperature: float = 1.0, top_p: float = 1.0,
                 sampling: str = "fused", attn_impl: Optional[str] = None,
                 ref_attn_impl: str = "pallas",
                 cache_layout: str = "paged", page_size: int = 16,
                 cache_pages: Optional[int] = None, kv_dtype: str = "bf16",
                 on_exhaust: str = "count", share_prefix: bool = False,
                 prefix_len: Optional[int] = None, pool_growth: str = "off",
                 pool_growth_max: Optional[int] = None,
                 admit_watermark: Optional[int] = None,
                 speculation: str = "off",
                 spec_k: int = 4, draft_layers: Optional[int] = None,
                 draft_model=None, mesh_config=None, device=None):
        common.check_no_modality_inputs(model)
        cfg = model.cfg
        if cache_layout not in ("dense", "paged"):
            raise ValueError(f"cache_layout must be 'dense' or 'paged', got "
                             f"{cache_layout!r}")
        if cache_layout == "paged" and cfg.family != "dense":
            raise ValueError(
                f"the paged KV pool is a dense-family layout; family "
                f"{cfg.family!r} decodes on its own cache: pass "
                f"cache_layout='dense'")
        self._check_pool_options(cache_layout, kv_dtype, on_exhaust,
                                 pool_growth, share_prefix)
        # the layouts of the last harvested batch (the dispatcher's source)
        self.experience_shardings: Optional[ExperienceBatch] = None
        if ACTION_BASE + env.n_actions > cfg.vocab_size:
            raise ValueError("the action tokens do not fit the vocabulary")
        if env.obs_len + max_turn_tokens + env.obs_len > max_context:
            raise ValueError("max_context cannot fit even one turn")
        kernel = "paged" if cache_layout == "paged" else "pallas"
        attn_impl = kernel if attn_impl is None else attn_impl
        if attn_impl not in (kernel, "xla"):
            raise ValueError(f"attn_impl must be {kernel!r} or 'xla' on the "
                             f"{cache_layout} layout, got {attn_impl!r}")
        if ref_attn_impl not in ("pallas", "xla"):
            raise ValueError(f"ref_attn_impl must be 'pallas' or 'xla', got "
                             f"{ref_attn_impl!r}")
        if sampling not in ("fused", "reference"):
            raise ValueError(f"sampling must be 'fused' or 'reference', got "
                             f"{sampling!r}")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        draft_layers = self._check_speculation(
            cfg, speculation, cache_layout, sampling, spec_k, draft_layers,
            draft_model)
        self.model = model
        self.env = env
        self.max_turns = max_turns
        self.max_turn_tokens = max_turn_tokens
        self.max_context = max_context
        self.temperature = temperature
        self.top_p = top_p
        self.sampling = sampling
        self.attn_impl = attn_impl
        self.ref_attn_impl = ref_attn_impl
        self.cache_layout = cache_layout
        self.page_size = page_size
        self.cache_pages = cache_pages      # None = full provisioning
        self.kv_dtype = kv_dtype
        self.on_exhaust = on_exhaust
        self.pool_growth = pool_growth
        self.pool_growth_max = pool_growth_max
        # admission low-watermark (preempt mode): free pages the refill
        # must leave after admitting; JAX's default is one turn of one slot
        self.admit_watermark = (
            admit_watermark if admit_watermark is not None
            else math.ceil((max_turn_tokens + env.obs_len) / page_size) + 1)
        # the shared run: FULL pages of the initial observation's common
        # prefix, never the whole observation (each slot's feed runs at
        # least one step, so its logits are its own)
        if prefix_len is None:
            prefix_len = int(getattr(env, "prompt_prefix_len", 0))
        self.share_prefix = share_prefix
        self.prefix_len = prefix_len
        self.shared_pages = (min(prefix_len, env.obs_len - 1) // page_size
                             if share_prefix else 0)
        self.shared_len = self.shared_pages * page_size
        self.speculation = speculation
        self.spec_k = spec_k
        self.draft_layers = draft_layers
        self.draft_model = draft_model if speculation == "draft" else None
        self._draft_cfg = (
            dataclasses.replace(cfg, n_layers=draft_layers)
            if speculation == "self" else
            draft_model.cfg if speculation == "draft" else None)
        self.device = resolve_device(device)
        self._tp = None               # this rank's TPContext at tp > 1
        self._draft_tp = None         # the draft's ("draft": its own plan)
        self._rows = None             # this rank's DataRows at dp x pods > 1
        self.rank_pool_pages = 0      # this rank's own pool in the last run
        self._in_mesh = True
        self._held = {}               # "params"/"ref"/"draft": (global, local)
        self._mesh_config = None
        self.bind_mesh(mesh_config)

    @staticmethod
    def _check_pool_options(cache_layout, kv_dtype, on_exhaust, pool_growth,
                            share_prefix):
        """JAX's checks of the paged-pool options (``compiled.py:
        150-176``)."""
        if on_exhaust not in ("count", "raise", "preempt"):
            raise ValueError(f"on_exhaust must be 'count', 'raise' or "
                             f"'preempt', got {on_exhaust!r}")
        if pool_growth not in ("off", "double"):
            raise ValueError(f"pool_growth must be 'off' or 'double', got "
                             f"{pool_growth!r}")
        if kv_dtype not in ("fp32", "bf16", "int8"):
            raise ValueError(f"kv_dtype must be 'fp32', 'bf16' or 'int8', "
                             f"got {kv_dtype!r}")
        if cache_layout == "paged":
            return
        for what, bad, why in (
                ("on_exhaust='preempt'", on_exhaust == "preempt",
                 "the pressure governor releases and re-admits pool pages"),
                ("pool_growth", pool_growth != "off",
                 "growth appends free pages to the shared pool"),
                ("share_prefix", share_prefix,
                 "sharing forks pool pages across slots' block tables"),
                ("kv_dtype='int8'", kv_dtype == "int8",
                 "the scales are a second page pool sharing the block-table"
                 "/refcount lifecycle")):
            if bad:
                raise ValueError(f"{what} requires cache_layout='paged' "
                                 f"({why})")

    # -- selector hook ① ----------------------------------------------------
    def _check_mesh(self, cfg):
        """A config over ranks of the process group."""
        # the core package imports this engine (through its stages)
        from repro_torch.core.resharding import current_rank, world_size
        if cfg is None:
            return None
        lo, hi = cfg.device_offset, cfg.device_offset + cfg.n_devices
        if hi > world_size():
            where = (f"rank {lo}" if cfg.n_devices == 1
                     else f"ranks {lo}..{hi - 1}")
            raise ValueError(
                f"mesh_config {cfg.name!r} places the rollout on {where}; "
                f"this process is rank {current_rank()} of a world of "
                f"{world_size()}")
        return cfg

    @property
    def mesh_config(self):
        """The MeshConfig the engine is bound to (None: this rank alone)."""
        return self._mesh_config

    @property
    def in_mesh(self) -> bool:
        """Whether this rank takes part in the bound mesh's rollout."""
        return self._in_mesh

    @property
    def tp(self):
        """This rank's ``TPContext`` (None below tp=2)."""
        return self._tp

    @property
    def data_rows(self):
        """This rank's ``DataRows`` on the bound mesh (None on one data
        row)."""
        return self._rows

    def bind_mesh(self, mesh_config) -> None:
        """Re-bind to another MeshConfig (a Parallelism Selector switch).
        At tp above 1 the engine takes the plan's model-axis group, and at
        dp x pods above 1 its data-axis group (collectives over the
        default group: every rank binds the same configs in the same
        order), and re-shards the params it holds when the tp degree
        changes. A rank outside the mesh takes no part in its rollouts."""
        from repro_torch.core.resharding import current_rank, tp_plan
        from repro_torch.models.tensor_parallel import (TPContext, data_group,
                                                        model_group)
        cfg = self._check_mesh(mesh_config)
        old = self._mesh_config
        self._mesh_config = cfg
        self._in_mesh = cfg is None or bool(
            (cfg.ranks() == current_rank()).any())
        tp = draft_tp = rows = None
        if cfg is not None and cfg.tp > 1:
            group = model_group(cfg)          # every rank: collective
            if self._in_mesh:
                tp = draft_tp = TPContext(tp_plan(self.model, cfg), group)
                if self.draft_model is not None:
                    draft_tp = TPContext(tp_plan(self.draft_model, cfg),
                                         group)
        if cfg is not None and cfg.dp * cfg.pods > 1:
            group = data_group(cfg)           # every rank: collective
            if self._in_mesh:
                rows = DataRows(cfg, group)
        self._tp, self._draft_tp, self._rows = tp, draft_tp, rows
        if cfg != old:
            self._held = {k: (g, self._shard(g, k)) for k, (g, _) in
                          self._held.items() if self._in_mesh}

    def _shard(self, params, key: str = "params"):
        from repro_torch.core.resharding import shard_params
        tp = self._draft_tp if key == "draft" else self._tp
        if tp is None:
            return params
        return shard_params(params, tp.plan, device=self.device)

    def _local_params(self, params, key: str = "params"):
        """The tensors this rank runs on: ``params`` itself below tp=2, a
        ``LocalParams`` of the bound mesh as it is, and the rank's shards
        of a global tree (kept while the caller passes the same tree, and
        re-sharded by ``bind_mesh``); ``key="draft"`` shards by the draft
        model's plan."""
        from repro_torch.core.resharding import LocalParams
        if params is None or self._tp is None:
            return params
        if isinstance(params, LocalParams):
            if params.mesh_config != self._mesh_config:
                raise ValueError(
                    f"these local params are shards on mesh "
                    f"{params.mesh_config.name!r}; the engine is bound to "
                    f"{self._mesh_config.name!r}")
            return params
        held = self._held.get(key)
        if held is None or held[0] is not params:
            held = (params, self._shard(params, key))
            self._held[key] = held
        return held[1]

    def min_pool_pages(self, batch: int) -> int:
        """Smallest pool for which ``on_exhaust="preempt"`` guarantees zero
        dropped writes at ``batch`` slots: one full-context episode (the
        survivor always progresses) and the ungoverned initial feed (the
        pinned shared run once plus a private suffix per slot)."""
        ps = self.page_size
        per_admit = -(-(self.env.obs_len - self.shared_len) // ps)
        return max(-(-self.max_context // ps),
                   self.shared_pages + batch * per_admit)

    @staticmethod
    def _check_speculation(cfg, speculation, cache_layout, sampling, spec_k,
                           draft_layers, draft_model):
        """JAX's speculation checks; returns ``draft_layers`` with its
        default (``n_layers // 2``) for ``"self"``."""
        if speculation not in ("off", "self", "draft"):
            raise ValueError(f"speculation must be 'off', 'self' or "
                             f"'draft', got {speculation!r}")
        if speculation == "off":
            return draft_layers
        if cache_layout != "paged":
            raise ValueError(
                "speculation requires cache_layout='paged': the verify pass "
                "writes the candidate chunk into pool pages before "
                "attending (models/transformer.spec_verify_step)")
        if cfg.family != "dense":
            raise ValueError(f"speculation is a dense-family feature; got "
                             f"family {cfg.family!r}")
        if sampling == "fused":
            raise ValueError(
                f"speculation={speculation!r} is incompatible with "
                f"sampling='fused': the speculative path samples from "
                f"precomputed per-step noise rows so the committed stream "
                f"stays the one sequential decode commits; the fused "
                f"sampler draws one token per call")
        if spec_k < 2:
            raise ValueError(f"spec_k must be >= 2 (k=1 is non-speculative "
                             f"decode), got {spec_k}")
        if speculation == "self":
            if draft_layers is None:
                draft_layers = max(1, cfg.n_layers // 2)
            if not 1 <= draft_layers < cfg.n_layers:
                raise ValueError(f"draft_layers must be in [1, n_layers) = "
                                 f"[1, {cfg.n_layers}), got {draft_layers}")
            return draft_layers
        if draft_model is None:
            raise ValueError(
                "speculation='draft' requires a draft_model (a small dense "
                "Model whose params are passed to run(draft_params=...)); "
                "use speculation='self' for the truncated-layer draft")
        if draft_model.cfg.family != "dense":
            raise ValueError("draft_model must be dense-family")
        if draft_model.cfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft_model vocab ({draft_model.cfg.vocab_size}) must "
                f"match the policy's ({cfg.vocab_size}): the draft proposes "
                f"token ids the verify pass scores")
        return draft_layers

    # -- carry ---------------------------------------------------------------
    def _reset_noise(self, noise: NoiseFn, m, index, B: int):
        """The env reset's draw, or None for an env whose reset takes
        none."""
        w = self.env.reset_noise_width
        return noise("reset", m, index, (B, w)) if w else None

    def init_carry(self, B: int, N: int, with_ref: bool = False,
                   noise: Optional[NoiseFn] = None) -> slots.SlotCarry:
        """The carry before the initial feed: ``B`` global slots, of which
        a data row holds its window. ``noise`` supplies the env reset's
        draw (default: the engine's own draws)."""
        dev, T = self.device, self.max_context
        V = (self._tp.vocab_local if self._tp is not None
             else self.model.cfg.vocab_size)
        tkw = {} if self._tp is None else {"tp": self._tp}
        window = self._rows.window(B) if self._rows is not None else None
        lo, hi = (0, B) if window is None else window[:2]
        slot = torch.arange(lo, hi, device=dev)
        Bg, B = B, hi - lo
        live = slot < N
        z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev)
        spec = self.speculation != "off"
        preempt = self.on_exhaust == "preempt"
        noise = _local_noise(noise if noise is not None
                             else self.default_noise(), window)
        if preempt:
            # episode-keyed initial state: slot i starts episode i with the
            # draw a later re-admission of episode i makes
            rn = self._reset_noise(noise, slot, z((B,), torch.int32), B)
        else:
            rn = self._reset_noise(noise, -1, 0, B)
        pool_pages = 0
        if self.cache_layout == "paged":
            # the global pool (JAX's one pool; full provisioning is
            # sharing-aware: the shared run is one allocation, not one per
            # slot) and this row's own pages of it
            pool_pages = (self.cache_pages if self.cache_pages is not None
                          else self._full_pages(Bg))
            n_pages = self._row_pages(pool_pages, window, B)
            cache = self.model.init_cache(
                B, T, layout="paged", page_size=self.page_size,
                n_pages=n_pages, kv_dtype=self.kv_dtype, device=dev, **tkw)
        else:
            kw = {} if self.kv_dtype == "bf16" else {"kv_dtype": self.kv_dtype}
            cache = self.model.init_cache(B, T, device=dev, **kw, **tkw)
        return slots.SlotCarry(
            cache=cache,
            logits=z((B, V), torch.float32),
            env_state=self.env.reset(B, device=dev, noise=rn),
            tokens=torch.full((B, T + 1), TOK_PAD, dtype=torch.int32,
                              device=dev),
            gen_mask=z((B, T + 1), torch.bool),
            logprobs=z((B, T + 1), torch.float32),
            pos=z((B,), torch.int32),
            live=live,
            truncated=z((B,), torch.bool),
            n_turns=z((B,), torch.int32),
            turn_lengths=z((B, self.max_turns), torch.int32),
            episode=torch.where(live, slot, N).to(torch.int32),
            launched=torch.full((), min(Bg, N), dtype=torch.int32,
                                device=dev),
            returned=z((), torch.int32),
            store=slots.init_store(N, T, self.max_turns, dev),
            pages_peak=z((), torch.int32),
            kv_dropped=z((), torch.int32),
            kv_shortfall=z((B,), torch.int32),
            # the reference cache is always dense in its default bf16,
            # whatever the policy's layout and dtype (as in JAX)
            ref_cache=(self.model.init_cache(B, T, device=dev, **tkw)
                       if with_ref else None),
            ref_logits=z((B, V), torch.float32) if with_ref else None,
            ref_logprobs=z((B, T + 1), torch.float32) if with_ref else None,
            # the draft's cache is always dense in its default bf16 (a
            # truncated stack or a small model; as in JAX)
            draft_cache=(transformer.init_cache(self._draft_cfg, B, T,
                                                device=dev, tp=self._draft_tp)
                         if spec else None),
            spec_proposed=z((), torch.int32) if spec else None,
            spec_accepted=z((), torch.int32) if spec else None,
            spec_rounds=z((), torch.int32) if spec else None,
            prefix_pages=(torch.full((self.shared_pages,), -1,
                                     dtype=torch.int32, device=dev)
                          if self.shared_pages > 0 else None),
            preempted=z((), torch.int32) if preempt else None,
            requeue=z((N,), torch.bool) if preempt else None,
            requeue_peak=z((), torch.int32) if preempt else None,
            window=window,
            pool_pages=pool_pages,
        )

    def _full_pages(self, batch: int) -> int:
        """Exhaustion-free pool pages for ``batch`` slots (the shared run
        once under sharing)."""
        return pool_paging.pool_pages_needed_shared(
            batch, self.max_context, self.shared_len, self.page_size)

    def _row_pages(self, pool_pages: int, window, b: int) -> int:
        """A data row's own pool for a global pool of ``pool_pages``: no
        more than the global pool, nor than its ``b`` slots can map (its
        own copy of the shared run included), so every grant the global
        count allows finds a page here. The whole pool where the row runs
        every slot (``window`` None)."""
        if window is None:
            return pool_pages
        return min(pool_pages, self._full_pages(b))

    # -- pieces of the macro-step --------------------------------------------
    def _decode(self, params, grant=None):
        # the copy-on-write guard is dropped statically: without sharing no
        # page reaches refcount > 1, and the shared run is whole pages, so
        # every write lands past it (the guard stays in the model API for
        # callers that fork a partial page)
        kw = {"cow": False} if self.cache_layout == "paged" else {}
        if grant is not None:
            kw["grant"] = grant
        if self._tp is not None:
            kw["tp"] = self._tp
        return self.model.decode_scan_body(params, attn_impl=self.attn_impl,
                                           **kw)

    @staticmethod
    def _run_pages(c: slots.SlotCarry):
        """0-d int32: the pages of the shared prefix run this row holds (0
        without sharing). Every data row holds its own copy; the global
        pool counts the run once, as JAX's ``pages_in_use`` counts a
        forked page."""
        if c.prefix_pages is None:
            return torch.zeros((), dtype=torch.int32, device=c.pos.device)
        return (c.prefix_pages >= 0).sum(dtype=torch.int32)

    def _grant(self, c: slots.SlotCarry):
        """The allocations' global rank rule (``models.paging.alloc_pages``
        ``grant``) on a data row whose writes can fail: a paged pool below
        the global batch's full provisioning, outside preempt mode (whose
        governor admits only what fits, so no write fails there). Each call
        all-gathers the rows' need masks and private pages: ONE collective
        per allocation (a decode step, a verify chunk's page). None where
        no write can fail, or on one row."""
        if (c.window is None or self.on_exhaust == "preempt"
                or not paging.is_paged(c.cache)
                or c.pool_pages >= self._full_pages(c.window[2])):
            return None
        rows, pool, n_run = self._rows, c.pool_pages, self._run_pages(c)

        def grant(need, refcount):
            used = pool_paging.pages_in_use(refcount) - n_run
            (need_g,), used_g = rows.gather_slots([need], [used])
            b = need.shape[0]
            offset = need_g[:rows.index * b].sum(dtype=torch.int32)
            return offset, pool - used_g.sum(dtype=torch.int32) - n_run
        return grant

    def _ref_stream(self, ref_params, c: slots.SlotCarry):
        """The carry's reference stream, or None when it has none."""
        if c.ref_cache is None:
            return None
        if ref_params is None:
            raise ValueError("this carry holds a reference stream: pass "
                             "ref_params")
        kw = {} if self._tp is None else {"tp": self._tp}
        return _RefStream(
            self.model.decode_scan_body(ref_params,
                                        attn_impl=self.ref_attn_impl, **kw),
            c.ref_logits, c.ref_cache, c.ref_logprobs)

    def _draft_stream(self, params, draft_params,
                      c: slots.SlotCarry) -> Optional[_DraftStream]:
        """The carry's draft stream, or None when speculation is off. The
        draft decodes in plain attention, as JAX's (which passes no
        attn_impl): it launches no kernel."""
        if self.speculation == "off":
            return None
        if self.speculation == "self":
            d_params = transformer.draft_params_view(params,
                                                     self.draft_layers)
        elif draft_params is None:
            raise ValueError("speculation='draft' requires draft_params "
                             "(the draft_model's weights)")
        else:
            d_params = draft_params
        tp = self._draft_tp
        return _DraftStream(
            transformer.decode_scan_body(self._draft_cfg, d_params, tp=tp),
            c.draft_cache,
            self._draft_cfg.vocab_size if tp is None else tp.vocab_local)

    def _ref_advance(self, ref: _RefStream, tok, mask, pos, rows,
                     cidx) -> _RefStream:
        """Score ``tok`` from the reference logits before they advance (0
        at position 0, where nothing predicts it, and for masked rows),
        then feed it to the reference stream."""
        ref.logprobs[rows, cidx] = torch.where(
            mask & (pos > 0), common.token_lp(ref.logits, tok, tp=self._tp),
            0.0)
        (logits, cache), _ = ref.decode((ref.logits, ref.cache),
                                        (tok, mask))
        return ref._replace(logits=logits, cache=cache)

    def _feed_obs(self, decode, logits, cache, tokens, pos, obs, mask,
                  ref=None, draft=None, skip=None, n_skip: int = 0):
        """Teacher-force the obs columns into ``mask`` rows, one decode
        step per column (and one of the reference stream and of the draft,
        when on; the draft's logits are discarded, as its proposals always
        start from a freshly sampled c0); other rows are no-ops. ``skip``
        rows sit out the first ``n_skip`` columns (their forked prefix
        pages already hold them) and join at column ``n_skip``, where their
        fill position already points."""
        T = self.max_context
        B = pos.shape[0]
        rows = torch.arange(B, device=pos.device)
        d_logits = (torch.zeros((B, draft.vocab), dtype=torch.float32,
                                device=pos.device)
                    if draft is not None else None)
        for j in range(obs.shape[1]):
            m = mask & ~skip if j < n_skip else mask
            col = torch.where(m, obs[:, j], TOK_PAD).to(torch.int32)
            cidx = torch.where(m, pos, T).long()        # T = trash column
            tokens[rows, cidx] = col
            if ref is not None:
                ref = self._ref_advance(ref, col, m, pos, rows, cidx)
            if draft is not None:
                (d_logits, dc), _ = draft.decode((d_logits, draft.cache),
                                                 (col, m))
                draft = draft._replace(cache=dc)
            (logits, cache), _ = decode((logits, cache), (col, m))
            pos = pos + m.to(torch.int32)
        return logits, cache, tokens, pos, ref, draft

    @staticmethod
    def _with_streams(carry: slots.SlotCarry, ref,
                      draft) -> slots.SlotCarry:
        if ref is not None:
            carry = carry._replace(ref_logits=ref.logits,
                                   ref_cache=ref.cache,
                                   ref_logprobs=ref.logprobs)
        if draft is not None:
            carry = carry._replace(draft_cache=draft.cache)
        return carry

    def _sample(self, logits, noise):
        """Tokens and log-probs from the carried logits (the rank's vocab
        columns under tp) and the whole ``(B, V)`` noise draw."""
        if self.sampling == "fused":
            from repro_torch.kernels.fused_sample import ops as fs_ops
            return fs_ops.fused_sample_tokens(logits, self.temperature,
                                              top_p=self.top_p, noise=noise,
                                              tp=self._tp)
        return common.sample_with_noise(logits, noise, self.temperature,
                                        self.top_p, tp=self._tp)

    def _write_prefix_tokens(self, tokens, obs, rows_mask):
        """The skipped shared-prefix columns of ``obs`` into ``rows_mask``
        rows' context buffers: the harvested episode carries its whole
        prompt, although only the forked pages hold the prefix's K/V."""
        S = self.shared_len
        cols = torch.arange(tokens.shape[1], device=tokens.device)
        pre = torch.nn.functional.pad(obs[:, :S].to(tokens.dtype),
                                      (0, tokens.shape[1] - S))
        return torch.where(rows_mask[:, None] & (cols < S)[None, :], pre,
                           tokens)

    def init_feed(self, params, carry: slots.SlotCarry, ref_params=None,
                  draft_params=None) -> slots.SlotCarry:
        """Feed the initial observation of every live slot (run once before
        the macro-step loop). With sharing, the common prefix is decoded
        through slot 0 only, its pages pinned and forked into every live
        slot, and then every slot feeds its own suffix."""
        ref = self._ref_stream(ref_params, carry)
        draft = self._draft_stream(params, draft_params, carry)
        obs = self.env.encode_obs(carry.env_state)
        logits, cache, tokens, pos = (carry.logits, carry.cache,
                                      carry.tokens, carry.pos)
        live, S = carry.live, self.shared_len
        prefix_pages = carry.prefix_pages
        kv_shortfall = carry.kv_shortfall
        if self.shared_pages > 0:
            # the run through the row's first slot at batch 1: on a data
            # row even when that slot is idle (a re-admitted episode may
            # land on the row), allocated from the row's own pool alone
            # (every row holds the same run; the global count holds it
            # once)
            row0 = torch.arange(live.shape[0], device=live.device) == 0
            logits, cache, tokens, pos, ref, draft = self._feed_obs(
                self._decode(params), logits, cache, tokens, pos, obs[:, :S],
                row0 & (live | (carry.window is not None)), ref, draft)
            prefix_pages = cache.block_table[0, :self.shared_pages].clone()
            # the engine-held pin (an unmapped entry adds 0)
            pinned = prefix_pages >= 0
            cache = cache._replace(refcount=cache.refcount.scatter_add(
                0, torch.where(pinned, prefix_pages, 0).long(),
                pinned.to(cache.refcount.dtype)))
            cache = paging.fork_prefix(cache, prefix_pages, live & ~row0, S)
            pos = torch.where(live, S, pos)
            # an idle first slot's run pages a pool too small for the run
            # could not map are no drops of an episode
            kv_shortfall = torch.where(
                live, kv_shortfall, paging.dropped_tokens(cache,
                                                          self.page_size))
            if draft is not None:
                # the draft's dense cache cannot fork pool pages: other
                # rows skip the prefix with zero draft K/V behind their fill
                # line (lower acceptance only; verify gates every commit)
                draft = draft._replace(cache=draft.cache._replace(
                    pos=torch.where(live, S, draft.cache.pos)))
            tokens = self._write_prefix_tokens(tokens, obs, live)
            obs = obs[:, S:]
        carry = carry._replace(prefix_pages=prefix_pages)
        logits, cache, tokens, pos, ref, draft = self._feed_obs(
            self._decode(params, self._grant(carry)), logits, cache, tokens,
            pos, obs, live, ref, draft)
        return self._with_streams(carry._replace(
            logits=logits, cache=cache, tokens=tokens, pos=pos,
            kv_shortfall=kv_shortfall), ref, draft)

    def _more_rounds(self, pending) -> bool:
        """Whether any row still writes after a verify round: THE host read
        of the round. JAX's round loop is a ``lax.while_loop`` whose test
        runs on the device; eager PyTorch must read it back. The flag is a
        MAX over the whole mesh (the model axis under tp, then the data
        rows), so every rank leaves the loop after the global batch's last
        round, JAX's round count: a row whose slots are done runs masked
        no-op rounds meanwhile (rows that each run every slot agree
        already)."""
        flag = pending.any().to(torch.int32)
        if self._tp is not None:
            flag = self._tp.all_reduce(flag, "max")
        if self._rows is not None:
            dist.all_reduce(flag, op=dist.ReduceOp.MAX,
                            group=self._rows.group)
        return bool(flag)

    def _spec_gen_turn(self, params, draft: _DraftStream, logits, cache,
                       tokens, gen_mask, logprobs, pos, active, m: int,
                       noise: NoiseFn, grant=None):
        """One turn of speculative generation: verify rounds until no row
        writes (JAX's ``spec_gen_turn``, ``compiled.py:369-505``). Every
        round commits at least one token per writing row, so a turn runs at
        most ``max_turn_tokens`` rounds. Row b's token at turn index t is
        judged with the noise row the sequential loop draws for it,
        ``noise("sample", m, t, (B, V))``, all drawn up front (in the same
        order as the sequential loop) and gathered per row."""
        K, mtt, T = self.spec_k, self.max_turn_tokens, self.max_context
        V, n_actions = self.model.cfg.vocab_size, self.env.n_actions
        B = pos.shape[0]
        dev = pos.device
        rows = torch.arange(B, device=dev)
        i32 = lambda t: t.to(torch.int32)
        if self.temperature > 0.0:
            noise_all = torch.stack([noise("sample", m, t, (B, V))
                                     for t in range(mtt)])   # (mtt, B, V)
            noise_at = lambda t: noise_all[t.clamp(0, mtt - 1).long(), rows]
        else:
            noise_at = lambda t: None                       # greedy
        sample = lambda lg, t: common.sample_with_noise(
            lg, noise_at(t), self.temperature, self.top_p, tp=self._tp)
        d_sample = lambda lg, t: common.sample_with_noise(
            lg, noise_at(t), self.temperature, self.top_p, tp=self._draft_tp)
        dcache = draft.cache
        acted = ~active
        actions = torch.zeros((B,), dtype=torch.int32, device=dev)
        last_tok = torch.zeros_like(actions)
        tl = torch.zeros_like(actions)
        sp, sa, sr = (torch.zeros((), dtype=torch.int32, device=dev)
                      for _ in range(3))
        jarr = torch.arange(K, device=dev)[None, :]
        while True:
            write = active & ~acted & (tl < mtt)
            ek = torch.where(write, (mtt - tl).clamp(max=K), 0)
            # c0: the exact token sequential decode commits next; the draft
            # proposes c1 .. c_{K-1} and also consumes c_{K-1}, so its cache
            # covers every position a full acceptance can commit
            c0, lp0 = sample(logits, tl)
            toks, lps = [c0], [lp0]
            d_logits, cur = logits, c0
            for jj in range(K):
                (d_logits, dcache), _ = draft.decode(
                    (d_logits, dcache), (cur, write & (jj < ek)))
                if jj < K - 1:
                    cur, _ = d_sample(d_logits, tl + jj + 1)
                    toks.append(cur)
            chunk = torch.stack(toks, dim=1)                # (B, K)
            vlogits, cache = transformer.spec_verify_step(
                self.model.cfg, params, chunk, cache,
                attn_impl=self.attn_impl, advance=write, eff_k=ek,
                cow=False, tp=self._tp,         # cow: as in ``_decode``
                grant=grant)
            # chunk[:, j] commits iff it is the token sequential decode
            # samples from vlogits[:, j-1] with that step's noise row
            match, commits = write, i32(write)
            for jj in range(1, K):
                e_j, lp_j = sample(vlogits[:, jj - 1], tl + jj)
                lps.append(lp_j)
                match = match & (chunk[:, jj] == e_j) & (jj < ek)
                commits = commits + i32(match)
            # an action token ends the turn: never commit past the first
            is_act = common.action_mask(chunk, n_actions)
            first_act = i32(torch.where(is_act.any(dim=1),
                                        i32(is_act).argmax(dim=1), K))
            commits = torch.where(write,
                                  torch.minimum(commits, first_act + 1), 0)
            # every buffer in one scatter; the rest of the chunk lands in
            # the trash column T
            cmask = write[:, None] & (jarr < commits[:, None])
            cidx = torch.where(cmask, pos[:, None] + jarr, T).long()
            r2 = rows[:, None]
            tokens[r2, cidx] = chunk
            gen_mask[r2, cidx] = cmask
            logprobs[r2, cidx] = torch.stack(lps, dim=1)
            # carried logits: the full model's after the last committed
            # token (non-writing rows keep theirs)
            lastj = (commits - 1).clamp(0, K - 1).long()
            logits = torch.where(write[:, None], vlogits[rows, lastj],
                                 logits)
            cache = transformer.spec_commit(cache, commits)
            # the draft's rollback: its dense ring derives validity from
            # pos alone, so the committed fill line is the whole rollback
            dcache = dcache._replace(pos=pos + commits)
            last_tok = torch.where(write, chunk[rows, lastj], last_tok)
            newly = write & (first_act < commits)
            act_tok = chunk[rows, first_act.clamp(0, K - 1).long()]
            actions = torch.where(newly, act_tok - ACTION_BASE, actions)
            acted = acted | newly
            pos = pos + commits
            tl = tl + commits
            sp = sp + (ek - 1).clamp_min(0).sum(dtype=torch.int32)
            sa = sa + torch.where(write, commits - 1, 0).sum(
                dtype=torch.int32)
            sr = sr + write.sum(dtype=torch.int32)
            if not self._more_rounds(active & ~acted & (tl < mtt)):
                break
        return (logits, cache, draft._replace(cache=dcache), tokens,
                gen_mask, logprobs, pos, acted, actions, last_tok, tl,
                (sp, sa, sr))

    def _govern(self, c: slots.SlotCarry):
        """The pressure governor (preempt mode), before anything generates:
        which slots may write this turn, and which are evicted (their
        private pages released, their episode re-queued). Stalled slots
        keep their pages and their fed observation. On a data row it runs
        on the global batch, after ONE gather of every row's slots and
        private pages, with the whole pool's free count, and keeps its own
        rows of the plan: the victims and the requeue are JAX's, the same
        on every row. Returns ``(carry, run_mask, victims)``."""
        mtt, olen, ps = self.max_turn_tokens, self.env.obs_len, self.page_size
        T, N = self.max_context, c.requeue.shape[0]
        bt, refcount = c.cache.block_table, c.cache.refcount
        elig = (c.live & (c.pos + mtt + olen <= T)
                & (c.n_turns < self.max_turns))
        tgt = (c.pos + mtt + olen).clamp(max=bt.shape[1] * ps)
        mapped = (bt >= 0).sum(dim=1, dtype=torch.int32)
        demand = torch.where(elig, ((tgt + ps - 1) // ps - mapped).clamp_min(
            0), 0)
        freeable = paging.slot_private_pages(refcount, bt)
        n_run = self._run_pages(c)
        used = pool_paging.pages_in_use(refcount) - n_run
        episode = c.episode
        if c.window is not None:
            (elig, pos, demand, freeable, episode), used = \
                self._rows.gather_slots(
                    [elig, c.pos, demand, freeable, episode], [used])
            elig = elig.bool()
        else:
            pos = c.pos
        run_mask, victims = paging.pressure_plan_counts(
            c.pool_pages - used.sum() - n_run, freeable, elig, pos, demand)
        hit = torch.zeros((N + 1,), dtype=torch.bool, device=bt.device)
        hit.scatter_(0, torch.where(victims, episode, N).long(),
                     torch.ones_like(victims))
        requeue = c.requeue | hit[:N]
        n_victims = victims.sum(dtype=torch.int32)
        if c.window is not None:
            lo, hi = c.window[:2]
            run_mask, victims = run_mask[lo:hi], victims[lo:hi]
        c = c._replace(
            cache=paging.release_slot_pages(c.cache, victims),
            live=c.live & ~victims, truncated=c.truncated & ~victims,
            episode=torch.where(victims, N, c.episode).to(torch.int32),
            preempted=c.preempted + n_victims,
            requeue=requeue,
            requeue_peak=torch.maximum(c.requeue_peak,
                                       requeue.sum(dtype=torch.int32)))
        return c, run_mask, victims

    def _reserved(self, cache, cont, pos):
        """Pages the continuing slots' obs feeds can still take (preempt
        mode's admission keeps them free)."""
        olen, ps = self.env.obs_len, self.page_size
        bt = cache.block_table
        mapped = (bt >= 0).sum(dim=1, dtype=torch.int32)
        tgt = (pos + olen).clamp(max=bt.shape[1] * ps)
        return torch.where(
            cont, ((tgt + ps - 1) // ps - mapped).clamp_min(0), 0).sum(
                dtype=torch.int32)

    def _admit(self, c: slots.SlotCarry, free_slots, used, reserved, surv,
               n_run):
        """The watermark-gated refill plan of preempt mode, after every
        finished slot released its pages: re-queued episodes are admitted
        before fresh ones, and admission leaves ``admit_watermark`` free
        pages beyond what the continuing slots' obs feeds can take
        (``reserved``). ``free_slots`` (B,), the private pages in ``used``,
        ``reserved`` and the survivors ``surv`` are the global batch's (on
        a data row, from the turn's exchange), so every row plans JAX's
        admission and takes its own slots of it; a re-queued episode can
        land on another row than the one that evicted it. Returns
        ``(refill, new_ids, launched, requeue, admitted)``."""
        N = c.requeue.shape[0]
        per_admit = -(-(self.env.obs_len - self.shared_len) // self.page_size)
        free_now = c.pool_pages - used - n_run
        quota = ((free_now - reserved - self.admit_watermark)
                 // per_admit).clamp_min(0)
        # deadlock breaker: with no survivor but work left, every unpinned
        # page is free, so admit at least one episode (min_pool_pages
        # guarantees it fits)
        work_left = (c.launched < N) | c.requeue.any()
        quota = torch.where((surv == 0) & work_left, quota.clamp_min(1),
                            quota)
        refill, new_ids, launched, requeue = slots.admission_plan(
            free_slots, c.requeue, c.launched, N, quota)
        admitted = refill.sum(dtype=torch.int32)
        if c.window is not None:
            lo, hi = c.window[:2]
            refill, new_ids = refill[lo:hi], new_ids[lo:hi]
        return refill, new_ids, launched, requeue, admitted

    def _feed_pages(self, cache, pos, feed_mask, refill):
        """Pages the obs feed is about to allocate: each feeding row's
        unmapped block-table entries over the positions it writes. The
        pool's free count after the feed is the free count now less this
        (an exhausted pool stops at 0), which is what pool growth reads
        when sharing moves the turn's host read before the feed."""
        ps, olen, S = self.page_size, self.env.obs_len, self.shared_len
        bt = cache.block_table
        n = torch.where(refill, olen - S, olen)
        j = torch.arange(bt.shape[1], device=bt.device)[None, :]
        span = ((j >= (pos // ps)[:, None])
                & (j <= ((pos + n - 1) // ps)[:, None]))
        return (span & (bt < 0) & feed_mask[:, None]).sum(dtype=torch.int32)

    def turn_step(self, params, c: slots.SlotCarry, m: int,
                  noise: NoiseFn, ref_params=None,
                  draft_params=None) -> slots.SlotCarry:
        """One macro-step (one turn for every slot). Enqueues device work
        only, with no host read, unless speculation is on (one flag per
        verify round) or prefix sharing is (the turn's one read, before the
        feed; ``SlotCarry.host`` carries what it read). On a data row it
        runs the row's slots and makes the turn's exchanges across the
        rows (the module docstring lists them by mode)."""
        env, T, olen = self.env, self.max_context, self.env.obs_len
        mtt, mturns = self.max_turn_tokens, self.max_turns
        n_actions, V = env.n_actions, self.model.cfg.vocab_size
        B = c.pos.shape[0]
        N = c.store.tokens.shape[0] - 1
        S = self.shared_len
        dev = c.pos.device
        rows = torch.arange(B, device=dev)
        preempt = self.on_exhaust == "preempt"
        noise = _local_noise(noise, c.window)
        grant = self._grant(c)
        decode = self._decode(params, grant)
        ref = self._ref_stream(ref_params, c)
        draft = self._draft_stream(params, draft_params, c)
        i32 = lambda t: t.to(torch.int32)

        # 0. the pressure governor (preempt mode)
        victims = None
        if preempt:
            c, run_mask, victims = self._govern(c)

        # 1. truncation / active set
        room = c.pos + mtt + olen <= T
        truncated = c.truncated | (c.live & ~room)
        active = c.live & room & (c.n_turns < mturns)
        if preempt:
            active = active & run_mask

        # 2. generation: mtt decode steps; sample, then write the token's
        #    K/V (fused sample-and-write when sampling="fused"). With
        #    speculation: verify rounds committing the same token stream.
        logits, cache, pos = c.logits, c.cache, c.pos
        tokens, gen_mask, logprobs = c.tokens, c.gen_mask, c.logprobs
        spec = (c.spec_proposed, c.spec_accepted, c.spec_rounds)
        if draft is not None:
            (logits, cache, draft, tokens, gen_mask, logprobs, pos, acted,
             actions, last_tok, tl, d_spec) = self._spec_gen_turn(
                params, draft, logits, cache, tokens, gen_mask, logprobs,
                pos, active, m, noise, grant)
            spec = tuple(a + b for a, b in zip(spec, d_spec))
        else:
            acted = ~active
            actions = torch.zeros((B,), dtype=torch.int32, device=dev)
            last_tok = torch.zeros_like(actions)
            tl = torch.zeros_like(actions)
            for t in range(mtt):
                write = ~acted
                nz = (noise("sample", m, t, (B, V))
                      if self.temperature > 0.0 else None)
                tok, lp = self._sample(logits, nz)
                (logits_next, cache), _ = decode((logits, cache),
                                                 (tok, write))
                cidx = torch.where(write, pos, T).long()  # T: trash column
                tokens[rows, cidx] = tok
                gen_mask[rows, cidx] = write      # True where it lands
                logprobs[rows, cidx] = lp
                if ref is not None:
                    ref = self._ref_advance(ref, tok, write, pos, rows,
                                            cidx)
                pos = pos + i32(write)
                tl = tl + i32(write)
                last_tok = torch.where(write, tok, last_tok)
                newly = write & common.action_mask(tok, n_actions)
                actions = torch.where(newly, tok - ACTION_BASE, actions)
                acted = acted | newly
                logits = logits_next

        # 2b. pool telemetry after generation (peak: nothing released yet);
        #     the drop counter accumulates per-slot shortfall growth. The
        #     dense layout has no pool: its counters stay 0.
        occ = new_drops = torch.zeros((), dtype=torch.int32, device=dev)
        kv_shortfall = c.kv_shortfall
        if paging.is_paged(cache):
            occ, _ = paging.pool_stats(cache)
            drop_now = paging.dropped_tokens(cache, self.page_size)
            new_drops = (drop_now - kv_shortfall).clamp_min(0).sum(
                dtype=torch.int32)
            kv_shortfall = drop_now

        # 3. action fallback + turn accounting
        actions = common.fallback_actions(actions, last_tok, active, acted,
                                          n_actions)
        turn_idx = c.n_turns.clamp(0, mturns - 1).long()
        turn_lengths = c.turn_lengths.clone()
        turn_lengths[rows, turn_idx] = (turn_lengths[rows, turn_idx]
                                        + torch.where(active, tl, 0))
        n_turns = c.n_turns + i32(active)

        # 4. env transition (inactive rows absorb inside env.step). Preempt
        #    mode draws per episode and env step, and keeps inactive rows'
        #    state: a stalled slot is a no-op, not a step with action 0.
        env_actions = i32(torch.where(active, actions, 0))
        if preempt:
            state2, res = env.step(
                c.env_state, env_actions,
                noise("env", c.episode, c.n_turns,
                      (B, env.step_noise_width)))
            state2 = blend_rows(active, state2, c.env_state)
        else:
            state2, res = env.step(c.env_state, env_actions,
                                   noise("env", m, 0,
                                         (B, env.step_noise_width)))

        # 5. harvest finished episodes (truncated -> zero reward)
        finished = c.live & (state2.done | truncated | (n_turns >= mturns))
        rewards_row = torch.where(truncated, 0.0, state2.reward).float()
        store = slots.harvest(
            c.store, finished=finished, episode=c.episode,
            tokens=tokens[:, :T], gen_mask=gen_mask[:, :T],
            logprobs=logprobs[:, :T], rewards=rewards_row, pos=pos,
            truncated=truncated, n_turns=n_turns, turn_lengths=turn_lengths,
            ref_logprobs=ref.logprobs[:, :T] if ref is not None else None)

        # 5b. the turn's one exchange across data rows: the finished slots
        #     of the rows before this one, and the global counts (pages
        #     less the shared run, which the global pool holds once). In
        #     preempt mode every finished slot has released its pages
        #     first, and the exchange carries the admission's inputs too.
        cont = active & ~state2.done & ~finished
        n_run = self._run_pages(c)
        counts = [finished.sum(), occ - n_run, new_drops, cont.any()]
        flags = []
        if preempt:
            cache = paging.release_slot_pages(cache, finished)
            counts += [pool_paging.pages_in_use(cache.refcount) - n_run,
                       self._reserved(cache, cont, pos),
                       (c.live & ~finished).any()]
            flags = [finished | (~c.live & ~victims)]
        before, counts, flags = self._across_rows(c.window, counts, flags)
        n_fin, occ, new_drops, n_cont = counts[:4]
        returned = c.returned + n_fin
        pages_peak = torch.maximum(c.pages_peak, occ + n_run)
        kv_dropped = c.kv_dropped + new_drops

        # 6. slot refill: release pages or zero dense rows, fork the shared
        #    prefix, reset rows (masked, unconditional). Preempt mode plans
        #    the refill with the admission watermark.
        requeue = c.requeue
        if preempt:
            refill, new_ids, launched, requeue, n_refill = self._admit(
                c, flags[0], *counts[4:], n_run)
        else:
            refill, new_ids, launched = slots.refill_plan(
                finished, c.launched, N, before, n_fin)
            n_refill = launched - c.launched
        r1 = refill[:, None]
        cache = _reset_cache_rows(cache, refill)
        if ref is not None:
            ref = ref._replace(cache=_reset_cache_rows(ref.cache, refill),
                               logprobs=torch.where(r1, 0.0, ref.logprobs))
        if draft is not None:
            dc = _reset_cache_rows(draft.cache, refill)
            draft = draft._replace(cache=dc._replace(
                pos=torch.where(refill, S, dc.pos)))
        if self.shared_pages > 0:
            # a fresh episode inherits the pinned prefix run: its pages are
            # forked into the slot, whose own writes start after them
            cache = paging.fork_prefix(cache, c.prefix_pages, refill, S)
        if preempt:
            # episode-keyed reset: a re-admitted episode draws the initial
            # state it drew at first launch
            rn = self._reset_noise(noise, torch.where(refill, new_ids, 0),
                                   torch.zeros_like(new_ids), B)
        else:
            rn = self._reset_noise(noise, m, 0, B)
        state3 = env.reset_rows(state2, refill, rn)
        tokens = torch.where(r1, TOK_PAD, tokens)
        gen_mask = torch.where(r1, False, gen_mask)
        logprobs = torch.where(r1, 0.0, logprobs)
        pos = torch.where(refill, S, pos)
        n_turns = torch.where(refill, 0, n_turns)
        turn_lengths = torch.where(r1, 0, turn_lengths)
        kv_shortfall = torch.where(refill, 0, kv_shortfall)

        # 7. one combined obs feed: continuing rows get the env observation,
        #    refilled rows their reset observation. With sharing, refilled
        #    rows skip the shared columns, and the turn's one host read
        #    decides JAX's lax.cond: no feed, the refilled rows' suffix
        #    only (the common case under churn), or the full observation.
        feed_mask = cont | refill
        obs = torch.where(r1, env.encode_obs(state3), res.obs_tokens)
        host = None
        if self.shared_pages == 0:
            logits, cache, tokens, pos, ref, draft = self._feed_obs(
                decode, logits, cache, tokens, pos, obs, feed_mask, ref,
                draft)
        else:
            tokens = self._write_prefix_tokens(tokens, obs, refill)
            # the branch is the global batch's (n_cont, n_refill: every
            # row feeds as many steps), so is growth's free count
            free = (self._free_after(c, cache, self._feed_pages(
                cache, pos, feed_mask, refill))
                if self.pool_growth == "double" else n_cont * 0)
            host = self._host_read(
                returned, kv_dropped, c.preempted if preempt else None,
                free, n_cont > 0, (n_cont > 0) | (n_refill > 0))
            if host["any_cont"]:
                logits, cache, tokens, pos, ref, draft = self._feed_obs(
                    decode, logits, cache, tokens, pos, obs, feed_mask, ref,
                    draft, skip=refill, n_skip=S)
            elif host["any_feed"]:
                logits, cache, tokens, pos, ref, draft = self._feed_obs(
                    decode, logits, cache, tokens, pos, obs[:, S:], refill,
                    ref, draft)

        return self._with_streams(c._replace(
            cache=cache, logits=logits, env_state=state3, tokens=tokens,
            gen_mask=gen_mask, logprobs=logprobs, pos=pos,
            live=(c.live & ~finished) | refill,
            truncated=torch.where(finished | refill, False, truncated),
            n_turns=n_turns, turn_lengths=turn_lengths,
            episode=torch.where(refill, new_ids,
                                torch.where(finished, N, c.episode)).to(
                                    torch.int32),
            launched=launched, returned=returned, store=store,
            pages_peak=pages_peak, kv_dropped=kv_dropped,
            kv_shortfall=kv_shortfall, spec_proposed=spec[0],
            spec_accepted=spec[1], spec_rounds=spec[2], requeue=requeue,
            host=host), ref, draft)

    def _across_rows(self, window, counts, flags):
        """The turn's gather after the harvest on a data row
        (``window``): every row's 0-d ``counts`` (the first its finished
        slots) and its slots' ``flags`` (each (b,) bool). Returns the finished
        slots of the rows before this one, the global counts (int32) and
        the global batch's flags; on one row, ``(0, its own, its own)``."""
        counts = [t.to(torch.int32) for t in counts]
        if window is None:
            return 0, counts, flags
        rows = self._rows
        flags, g = rows.gather_slots(flags, counts)
        return (g[:rows.index, 0].sum(dtype=torch.int32),
                list(g.sum(dim=0, dtype=torch.int32)),
                [f.bool() for f in flags])

    def _free_after(self, c: slots.SlotCarry, cache, extra=0):
        """The global pool's free pages once ``extra`` more pages of this
        row are mapped, at least 0: what pool growth's watermark test
        reads. On a data row, ONE all-reduce of the rows' private
        pages."""
        n_run = self._run_pages(c)
        used = pool_paging.pages_in_use(cache.refcount) - n_run + extra
        if c.window is not None:
            used = self._rows.all_reduce_sum(used)
        return (c.pool_pages - used - n_run).clamp_min(0)

    @staticmethod
    def _host_read(returned, kv_dropped, preempted, free, *flags) -> dict:
        """THE host read of a turn: the run loop's counters (and, under
        sharing, the feed's two flags) in one copy."""
        vals = [returned, kv_dropped,
                preempted if preempted is not None else returned * 0, free,
                *flags]
        out = torch.stack([v.to(torch.int64) for v in vals]).tolist()
        keys = ("returned", "kv_dropped", "preempted", "free", "any_cont",
                "any_feed")
        return dict(zip(keys, out))

    # ------------------------------------------------------------------------
    def default_noise(self, generator: Optional[torch.Generator] = None
                      ) -> NoiseFn:
        """The engine's own draws on its device: uniform draws from
        ``generator`` (or the device's default generator), made Gumbel for
        sampling and the env's own for "env" and "reset". Under preemption
        the episode-keyed "env"/"reset" draws hash the episode coordinates
        from a seed taken once from ``generator``
        (``common.keyed_uniform``). A data-parallel rollout asks for the
        global batch's draws on every row, so equally seeded generators
        on every rank give the one-rank run's draws."""
        env = self.env
        seed = None
        if self.on_exhaust == "preempt":
            seed = int(torch.randint(1 << 31, (1,), generator=generator,
                                     device=self.device))

        def draw(kind, m, index, shape):
            if kind == "sample":
                return common.gumbel(shape, generator=generator,
                                     device=self.device)
            if isinstance(m, torch.Tensor):
                u = common.keyed_uniform(seed, kind, m, index, shape[1])
            else:
                u = torch.rand(shape, generator=generator,
                               device=self.device).clamp_min(
                                   torch.finfo(torch.float32).tiny)
            return env.noise_from_uniform(kind, u)
        return draw

    def run(self, params, batch: int, n_episodes: Optional[int] = None, *,
            generator: Optional[torch.Generator] = None,
            noise: Optional[NoiseFn] = None, params_version: int = -1,
            ref_params=None, draft_params=None):
        """Roll out ``n_episodes`` (default ``batch``) episodes over
        ``batch`` slots. Returns ``(ExperienceBatch, RolloutStats)``.
        ``ref_params`` folds the reference pass into the rollout: the
        batch's ``ref_logprobs`` hold log p_ref of every fed token at
        positions ``1 .. context_len-1`` (zeros without it).
        ``draft_params`` are the draft model's weights for
        ``speculation="draft"`` (``"self"`` slices the policy's own
        stack)."""
        B = int(batch)
        N = int(n_episodes) if n_episodes is not None else B
        if N < 1 or B < 1:
            raise ValueError(f"batch and n_episodes must be >= 1, got {B}, "
                             f"{N}")
        if ref_params is not None and self.shared_pages > 0:
            raise ValueError(
                "share_prefix with the folded reference pass (ref_params) is "
                "not supported: the reference model's dense cache cannot "
                "fork prefix pages, so refilled slots would skip tokens the "
                "reference pass needs. Run the reference pass separately "
                "(ExpPrep's standalone route) or disable share_prefix.")
        if ref_params is not None and self.speculation != "off":
            raise ValueError(
                "speculation with the folded reference pass (ref_params) is "
                "not supported: the reference decode consumes tokens one "
                "step at a time and cannot consume drafted chunks. Run the "
                "reference pass separately (ExpPrep's standalone route) or "
                "turn speculation off.")
        preempt = self.on_exhaust == "preempt"
        if preempt and self.cache_pages is not None \
                and self.cache_pages < self.min_pool_pages(B):
            raise ValueError(
                f"cache_pages={self.cache_pages} is below the preemption "
                f"governor's minimum viable pool ({self.min_pool_pages(B)} "
                f"pages for batch {B}): the pool must hold one full-context "
                f"episode plus the initial observation feed of every slot, "
                f"or the zero-drop guarantee cannot hold.")
        noise = noise if noise is not None else self.default_noise(generator)
        if not self._in_mesh:
            return self._outside(N)
        # the reference is often the policy itself: one set of shards
        local = self._local_params(params)
        ref_params = (local if ref_params is params
                      else self._local_params(ref_params, "ref"))
        draft_params = self._local_params(draft_params, "draft")
        params = local
        carry = self.init_feed(
            params, self.init_carry(B, N, with_ref=ref_params is not None,
                                    noise=noise),
            ref_params, draft_params)
        # preemption stalls slots and restarts episodes: its budget assumes
        # near-serial progress plus an admission turn per episode, as JAX's
        max_macro = ((self.max_turns + 2) * (N + B) + 8 if preempt
                     else self.max_turns * math.ceil(N / B) + 2)
        grow = self.pool_growth == "double"
        grow_cap = (self.pool_growth_max if self.pool_growth_max is not None
                    else pool_paging.pool_pages_needed(B, self.max_context,
                                                       self.page_size))
        pool_grows = last_dropped = last_preempted = 0
        for m in range(max_macro):
            carry = self.turn_step(params, carry, m, noise, ref_params,
                                   draft_params)
            # the one host read per turn (made inside turn_step under
            # sharing), plus one per speculative verify round
            h = carry.host if carry.host is not None else self._host_read(
                carry.returned, carry.kv_dropped, carry.preempted,
                self._free_after(carry, carry.cache) if grow
                else carry.returned * 0)
            if self.on_exhaust == "raise" and h["kv_dropped"] > 0:
                raise RuntimeError(
                    f"KV page pool exhausted during rollout: "
                    f"{h['kv_dropped']} dropped KV write(s) by macro-step "
                    f"{m} (pool {carry.pool_pages} pages); grow "
                    f"cache_pages (see models.paging.pool_pages_needed"
                    f"[_shared]), set pool_growth='double', use "
                    f"on_exhaust='preempt' to trade throughput for "
                    f"completeness, or on_exhaust='count' to tolerate "
                    f"truncation")
            if grow:
                # grow when the pool showed distress this turn: a dropped
                # write, a preemption, or free pages under the watermark
                # (global counts: every data row grows in the same turn,
                # its own pool to its share of the grown global pool)
                cap = carry.pool_pages
                if cap < grow_cap and (
                        h["kv_dropped"] > last_dropped
                        or h["preempted"] > last_preempted
                        or h["free"] < self.admit_watermark):
                    new = min(2 * cap, grow_cap)
                    carry = carry._replace(pool_pages=new, cache=(
                        paging.grow_pool(carry.cache, self._row_pages(
                            new, carry.window, carry.pos.shape[0]))))
                    pool_grows += 1
                last_dropped, last_preempted = h["kv_dropped"], h["preempted"]
            if h["returned"] >= N:
                break
        if preempt and h["returned"] < N:
            raise RuntimeError(
                f"preemption governor failed to drain the rollout: "
                f"{h['returned']}/{N} episodes returned after {max_macro} "
                f"macro-steps (pool {carry.pool_pages} pages, "
                f"{h['preempted']} preemption(s)); the pool is likely "
                f"below min_pool_pages({B}) = {self.min_pool_pages(B)}.")
        return self._finalize(carry, N, params_version, pool_grows)

    def gather_batch(self, x):
        """``x``, a leaf of the last harvested batch as this rank holds it,
        over the whole batch dim, and the slice of this rank's rows in it:
        where the batch lies split over data rows, ONE all-reduce over
        them (each row's rows in a zero buffer; adding zeros is exact),
        else ``x`` and all of it. ExpPrep's advantages read the global
        rewards through it."""
        from repro_torch.core.resharding import current_rank
        if self._rows is None \
                or self.experience_shardings.rewards.shards(0) == 1:
            return x, slice(None)
        lay = self.experience_shardings.rewards
        N = x.shape[0] * lay.shards(0)
        sl = lay.devices_indices_map((N,))[current_rank()][0]
        buf = x.new_zeros((N,) + tuple(x.shape[1:]))
        buf[sl] = x
        return self._rows.all_reduce_sum(buf), sl

    def _outside(self, N: int):
        """``run`` on a rank outside the bound mesh: no rollout, a batch of
        meta tensors of the global shapes, and no stats."""
        from repro_torch.launch.mesh import _batch_spec
        from repro_torch.rl.experience import zeros_like_experience
        exp = zeros_like_experience(N, self.max_context, device="meta")
        self.experience_shardings = ExperienceBatch(
            *(_batch_spec(self._mesh_config, x.shape) for x in exp))
        return exp, None

    def _finalize(self, carry: slots.SlotCarry, N: int,
                  params_version: int = -1, pool_grows: int = 0):
        """The batch and the stats; on data rows, after the run's one
        exchange, global stats and this rank's rows of the batch."""
        s = carry.store
        spec = (carry.spec_proposed, carry.spec_accepted, carry.spec_rounds)
        if carry.window is not None:
            # the speculative counters are each row's own: summed over the
            # rows in the store's exchange
            z = torch.zeros((), dtype=torch.int32, device=carry.pos.device)
            s, sums = _exchange_store(s, N, self._rows, torch.stack(
                [t if t is not None else z for t in spec]))
            spec = tuple(x if t is not None else None
                         for x, t in zip(sums, spec))
        # this rank's own pool, a data row's share of the global one
        self.rank_pool_pages = (carry.cache.n_pages
                                if paging.is_paged(carry.cache) else 0)
        rewards = s.rewards[:N]
        exp = ExperienceBatch(
            tokens=s.tokens[:N], gen_mask=s.gen_mask[:N],
            loss_mask=s.gen_mask[:N], logprobs=s.logprobs[:N],
            ref_logprobs=s.ref_logprobs[:N], rewards=rewards,
            returns=rewards, advantages=reinforce_advantages(rewards),
            context_len=s.context_len[:N], truncated=s.truncated[:N])
        from repro_torch.core.resharding import local_mesh_config
        from repro_torch.launch.mesh import _batch_spec
        mesh_cfg = self._mesh_config or local_mesh_config()
        self.experience_shardings = ExperienceBatch(
            *(_batch_spec(mesh_cfg, x.shape) for x in exp))
        opt = lambda t: int(t) if t is not None else 0
        stats = common.summarize(
            s.turn_lengths[:N].cpu(), s.context_len[:N].cpu(),
            s.n_turns[:N].cpu(), s.truncated[:N].cpu(), rewards.cpu(),
            episodes_started=int(carry.launched),
            episodes_returned=int(carry.returned),
            params_version=params_version,
            pages_in_use=int(carry.pages_peak),
            page_capacity=carry.pool_pages,
            kv_dropped_writes=int(carry.kv_dropped),
            shared_prefix_len=self.shared_len,
            preemptions=opt(carry.preempted),
            requeue_depth=opt(carry.requeue_peak),
            pool_grows=pool_grows,
            spec_proposed=opt(spec[0]), spec_accepted=opt(spec[1]),
            spec_rounds=opt(spec[2]))
        if self._rows is not None:
            exp = ExperienceBatch(*(lay.local_shard(x) for x, lay in
                                    zip(exp, self.experience_shardings)))
        return exp, stats
