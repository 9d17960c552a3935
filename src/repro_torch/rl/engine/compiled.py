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

The episode store and the slot token buffers carry one trash row/column
where JAX drops out-of-range writes (``slots.py``); the paged pools carry
one trash page (``models/layers.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import paging as pool_paging
from repro_torch.models import transformer
from repro_torch.rl.algo import reinforce_advantages
from repro_torch.rl.engine import common, paging, slots
from repro_torch.rl.engine.common import ACTION_BASE
from repro_torch.rl.envs.base import TOK_PAD, blend_rows
from repro_torch.rl.experience import ExperienceBatch

NoiseFn = Callable[[str, int, int, tuple], torch.Tensor]


def _unported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet: it arrives with "
                               f"ROADMAP Queue 1 item {item}")


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
    "dense"; the ssm family takes only "dense", its recurrent
    ``MambaCache``), ``attn_impl`` (paged layout: "paged" = the paged CUDA
    kernel, "xla" = gather + dense attention; dense layout: "pallas" = the
    split-K decode kernel, "xla" = masked dense attention; ``None`` = the
    layout's kernel; with speculation the verify pass takes "paged" = the
    spec-verify kernel; the ssm decode has no attention and ignores it, as
    JAX's), ``ref_attn_impl`` (the reference stream's dense
    decode: "pallas" or "xla"), ``sampling`` ("fused" = the one-pass CUDA
    sampler, the default; "reference" = plain argmax + log-softmax),
    ``temperature``, ``top_p``,
    ``page_size``, ``cache_pages``, ``kv_dtype`` ("bf16", "fp32", or
    "int8" on the paged layout), ``share_prefix`` with ``prefix_len``,
    ``on_exhaust`` ("count", "raise" or "preempt" with
    ``admit_watermark``), ``pool_growth`` ("off" or "double" with
    ``pool_growth_max``) and ``speculation`` ("off", "self" or "draft",
    with ``spec_k``, ``draft_layers`` and ``draft_model``) and
    ``mesh_config``: a one-device ``MeshConfig`` on this process's rank
    (``bind_mesh`` re-binds it on a selector switch); a config with dp or
    pods above 1 raises ``NotImplementedError`` naming ROADMAP Queue 1 item
    13, one with tp above 1 item 14. After each ``run``,
    ``experience_shardings`` holds the harvested batch's layouts (an
    ``ExperienceBatch`` of ``NamedLayout``s, the batch over ``data``), the
    data dispatcher's source layouts. Unlike the JAX engine, the defaults
    are the production path: the kernels on the card, and their plain
    versions for CPU tensors.
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
        cfg = model.cfg
        if cache_layout not in ("dense", "paged"):
            raise ValueError(f"cache_layout must be 'dense' or 'paged', got "
                             f"{cache_layout!r}")
        if cache_layout == "paged" and cfg.family != "dense":
            raise ValueError(
                f"the paged KV pool is a dense-family layout; family "
                f"{cfg.family!r} decodes on its own recurrent cache: pass "
                f"cache_layout='dense'")
        self._check_pool_options(cache_layout, kv_dtype, on_exhaust,
                                 pool_growth, share_prefix)
        self._mesh_config = self._check_mesh(mesh_config)
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
        self._draft_cfg = (
            dataclasses.replace(cfg, n_layers=draft_layers)
            if speculation == "self" else
            draft_model.cfg if speculation == "draft" else None)
        self.device = resolve_device(device)

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
    @staticmethod
    def _check_mesh(cfg):
        """A one-device config on this rank; data and tensor parallelism
        are later items."""
        # the core package imports this engine (through its stages)
        from repro_torch.core.resharding import current_rank
        if cfg is None:
            return None
        if cfg.dp > 1 or cfg.pods > 1:
            raise _unported(
                f"mesh_config {cfg.name!r} (dp={cfg.dp}, pods={cfg.pods}): "
                f"data-parallel rollout across ranks", "13")
        if cfg.tp > 1:
            raise _unported(f"mesh_config {cfg.name!r} (tp={cfg.tp}): a "
                            f"tensor-parallel model", "14")
        if cfg.device_offset != current_rank():
            raise ValueError(
                f"mesh_config {cfg.name!r} places the rollout on rank "
                f"{cfg.device_offset}; this process is rank "
                f"{current_rank()}")
        return cfg

    @property
    def mesh_config(self):
        """The MeshConfig the engine is bound to (None: this rank alone)."""
        return self._mesh_config

    def bind_mesh(self, mesh_config) -> None:
        """Re-bind to another MeshConfig (a Parallelism Selector switch).
        One device holds the same program under every one-device config."""
        self._mesh_config = self._check_mesh(mesh_config)

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
        """The carry before the initial feed. ``noise`` supplies the env
        reset's draw (default: the engine's own draws)."""
        dev, T = self.device, self.max_context
        V = self.model.cfg.vocab_size
        live = torch.arange(B, device=dev) < N
        z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev)
        spec = self.speculation != "off"
        preempt = self.on_exhaust == "preempt"
        noise = noise if noise is not None else self.default_noise()
        if preempt:
            # episode-keyed initial state: slot i starts episode i with the
            # draw a later re-admission of episode i makes
            rn = self._reset_noise(noise, torch.arange(B, device=dev),
                                   z((B,), torch.int32), B)
        else:
            rn = self._reset_noise(noise, -1, 0, B)
        if self.cache_layout == "paged":
            n_pages = self.cache_pages
            if n_pages is None and self.shared_pages > 0:
                # sharing-aware full provisioning: the shared run is one
                # allocation, not one per slot
                n_pages = pool_paging.pool_pages_needed_shared(
                    B, T, self.shared_len, self.page_size)
            cache = self.model.init_cache(
                B, T, layout="paged", page_size=self.page_size,
                n_pages=n_pages, kv_dtype=self.kv_dtype, device=dev)
        else:
            kw = {} if self.kv_dtype == "bf16" else {"kv_dtype": self.kv_dtype}
            cache = self.model.init_cache(B, T, device=dev, **kw)
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
            episode=torch.where(live, torch.arange(B, device=dev), N).to(
                torch.int32),
            launched=torch.full((), min(B, N), dtype=torch.int32,
                                device=dev),
            returned=z((), torch.int32),
            store=slots.init_store(N, T, self.max_turns, dev),
            pages_peak=z((), torch.int32),
            kv_dropped=z((), torch.int32),
            kv_shortfall=z((B,), torch.int32),
            # the reference cache is always dense in its default bf16,
            # whatever the policy's layout and dtype (as in JAX)
            ref_cache=(self.model.init_cache(B, T, device=dev)
                       if with_ref else None),
            ref_logits=z((B, V), torch.float32) if with_ref else None,
            ref_logprobs=z((B, T + 1), torch.float32) if with_ref else None,
            # the draft's cache is always dense in its default bf16 (a
            # truncated stack or a small model; as in JAX)
            draft_cache=(transformer.init_cache(self._draft_cfg, B, T,
                                                device=dev)
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
        )

    # -- pieces of the macro-step --------------------------------------------
    def _decode(self, params):
        # the copy-on-write guard is dropped statically: without sharing no
        # page reaches refcount > 1, and the shared run is whole pages, so
        # every write lands past it (the guard stays in the model API for
        # callers that fork a partial page)
        kw = {"cow": False} if self.cache_layout == "paged" else {}
        return self.model.decode_scan_body(params, attn_impl=self.attn_impl,
                                           **kw)

    def _ref_stream(self, ref_params, c: slots.SlotCarry):
        """The carry's reference stream, or None when it has none."""
        if c.ref_cache is None:
            return None
        if ref_params is None:
            raise ValueError("this carry holds a reference stream: pass "
                             "ref_params")
        return _RefStream(
            self.model.decode_scan_body(ref_params,
                                        attn_impl=self.ref_attn_impl),
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
        return _DraftStream(
            transformer.decode_scan_body(self._draft_cfg, d_params),
            c.draft_cache)

    @staticmethod
    def _ref_advance(ref: _RefStream, tok, mask, pos, rows,
                     cidx) -> _RefStream:
        """Score ``tok`` from the reference logits before they advance (0
        at position 0, where nothing predicts it, and for masked rows),
        then feed it to the reference stream."""
        ref.logprobs[rows, cidx] = torch.where(
            mask & (pos > 0), common.token_lp(ref.logits, tok), 0.0)
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
        d_logits = (torch.zeros((B, self.model.cfg.vocab_size),
                                dtype=torch.float32, device=pos.device)
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
        if self.sampling == "fused":
            from repro_torch.kernels.fused_sample import ops as fs_ops
            return fs_ops.fused_sample_tokens(logits, self.temperature,
                                              top_p=self.top_p, noise=noise)
        return common.sample_with_noise(logits, noise, self.temperature,
                                        self.top_p)

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
        decode = self._decode(params)
        ref = self._ref_stream(ref_params, carry)
        draft = self._draft_stream(params, draft_params, carry)
        obs = self.env.encode_obs(carry.env_state)
        logits, cache, tokens, pos = (carry.logits, carry.cache,
                                      carry.tokens, carry.pos)
        live, S = carry.live, self.shared_len
        prefix_pages = carry.prefix_pages
        if self.shared_pages > 0:
            row0 = torch.arange(live.shape[0], device=live.device) == 0
            logits, cache, tokens, pos, ref, draft = self._feed_obs(
                decode, logits, cache, tokens, pos, obs[:, :S], row0 & live,
                ref, draft)
            prefix_pages = cache.block_table[0, :self.shared_pages].clone()
            # the engine-held pin (an unmapped entry adds 0)
            pinned = prefix_pages >= 0
            cache = cache._replace(refcount=cache.refcount.scatter_add(
                0, torch.where(pinned, prefix_pages, 0).long(),
                pinned.to(cache.refcount.dtype)))
            cache = paging.fork_prefix(cache, prefix_pages, live & ~row0, S)
            pos = torch.where(live, S, pos)
            if draft is not None:
                # the draft's dense cache cannot fork pool pages: other
                # rows skip the prefix with zero draft K/V behind their fill
                # line (lower acceptance only; verify gates every commit)
                draft = draft._replace(cache=draft.cache._replace(
                    pos=torch.where(live, S, draft.cache.pos)))
            tokens = self._write_prefix_tokens(tokens, obs, live)
            obs = obs[:, S:]
        logits, cache, tokens, pos, ref, draft = self._feed_obs(
            decode, logits, cache, tokens, pos, obs, live, ref, draft)
        return self._with_streams(carry._replace(
            logits=logits, cache=cache, tokens=tokens, pos=pos,
            prefix_pages=prefix_pages), ref, draft)

    @staticmethod
    def _more_rounds(pending) -> bool:
        """Whether any row still writes after a verify round: THE host read
        of the round. JAX's round loop is a ``lax.while_loop`` whose test
        runs on the device; eager PyTorch must read it back."""
        return bool(pending.any())

    def _spec_gen_turn(self, params, draft: _DraftStream, logits, cache,
                       tokens, gen_mask, logprobs, pos, active, m: int,
                       noise: NoiseFn):
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
            lg, noise_at(t), self.temperature, self.top_p)
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
                    cur, _ = sample(d_logits, tl + jj + 1)
                    toks.append(cur)
            chunk = torch.stack(toks, dim=1)                # (B, K)
            vlogits, cache = transformer.spec_verify_step(
                self.model.cfg, params, chunk, cache,
                attn_impl=self.attn_impl, advance=write, eff_k=ek,
                cow=False)                      # as in ``_decode``
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
        keep their pages and their fed observation. Returns ``(carry,
        run_mask, victims)``."""
        mtt, olen, ps = self.max_turn_tokens, self.env.obs_len, self.page_size
        T, N = self.max_context, c.requeue.shape[0]
        bt = c.cache.block_table
        elig = (c.live & (c.pos + mtt + olen <= T)
                & (c.n_turns < self.max_turns))
        tgt = (c.pos + mtt + olen).clamp(max=bt.shape[1] * ps)
        mapped = (bt >= 0).sum(dim=1, dtype=torch.int32)
        demand = torch.where(elig, ((tgt + ps - 1) // ps - mapped).clamp_min(
            0), 0)
        run_mask, victims = paging.pressure_plan(
            c.cache.refcount, bt, elig, c.pos, demand)
        hit = torch.zeros((N + 1,), dtype=torch.bool, device=bt.device)
        hit.scatter_(0, torch.where(victims, c.episode, N).long(),
                     torch.ones_like(victims))
        requeue = c.requeue | hit[:N]
        c = c._replace(
            cache=paging.release_slot_pages(c.cache, victims),
            live=c.live & ~victims, truncated=c.truncated & ~victims,
            episode=torch.where(victims, N, c.episode).to(torch.int32),
            preempted=c.preempted + victims.sum(dtype=torch.int32),
            requeue=requeue,
            requeue_peak=torch.maximum(c.requeue_peak,
                                       requeue.sum(dtype=torch.int32)))
        return c, run_mask, victims

    def _admit(self, c: slots.SlotCarry, cache, victims, finished, active,
               done, pos):
        """The watermark-gated refill plan of preempt mode: every finished
        slot releases its pages first, re-queued episodes are admitted
        before fresh ones, and admission leaves ``admit_watermark`` free
        pages beyond what the continuing slots' obs feeds can take.
        Returns ``(cache, refill, new_ids, launched, requeue)``."""
        olen, ps = self.env.obs_len, self.page_size
        N = c.requeue.shape[0]
        cache = paging.release_slot_pages(cache, finished)
        bt = cache.block_table
        free_now = (cache.refcount == 0).sum(dtype=torch.int32)
        mapped = (bt >= 0).sum(dim=1, dtype=torch.int32)
        cont = active & ~done & ~finished
        tgt = (pos + olen).clamp(max=bt.shape[1] * ps)
        reserved = torch.where(
            cont, ((tgt + ps - 1) // ps - mapped).clamp_min(0), 0).sum(
                dtype=torch.int32)
        per_admit = -(-(olen - self.shared_len) // ps)
        quota = ((free_now - reserved - self.admit_watermark)
                 // per_admit).clamp_min(0)
        # deadlock breaker: with no survivor but work left, every unpinned
        # page is free, so admit at least one episode (min_pool_pages
        # guarantees it fits)
        surv = (c.live & ~finished).any()
        work_left = (c.launched < N) | c.requeue.any()
        quota = torch.where(~surv & work_left, quota.clamp_min(1), quota)
        free_slots = finished | (~c.live & ~victims)
        refill, new_ids, launched, requeue = slots.admission_plan(
            free_slots, c.requeue, c.launched, N, quota)
        return cache, refill, new_ids, launched, requeue

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
        feed; ``SlotCarry.host`` carries what it read)."""
        env, T, olen = self.env, self.max_context, self.env.obs_len
        mtt, mturns = self.max_turn_tokens, self.max_turns
        n_actions, V = env.n_actions, self.model.cfg.vocab_size
        B = c.pos.shape[0]
        N = c.store.tokens.shape[0] - 1
        S = self.shared_len
        dev = c.pos.device
        rows = torch.arange(B, device=dev)
        preempt = self.on_exhaust == "preempt"
        decode = self._decode(params)
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
                pos, active, m, noise)
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
        pages_peak, kv_dropped, kv_shortfall = (c.pages_peak, c.kv_dropped,
                                                c.kv_shortfall)
        if paging.is_paged(cache):
            occ, _ = paging.pool_stats(cache)
            pages_peak = torch.maximum(pages_peak, occ)
            drop_now = paging.dropped_tokens(cache, self.page_size)
            kv_dropped = kv_dropped + (drop_now - kv_shortfall).clamp_min(
                0).sum(dtype=torch.int32)
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
        returned = c.returned + finished.sum(dtype=torch.int32)

        # 6. slot refill: release pages or zero dense rows, fork the shared
        #    prefix, reset rows (masked, unconditional). Preempt mode plans
        #    the refill with the admission watermark.
        requeue = c.requeue
        if preempt:
            cache, refill, new_ids, launched, requeue = self._admit(
                c, cache, victims, finished, active, state2.done, pos)
        else:
            refill, new_ids, launched = slots.refill_plan(finished,
                                                          c.launched, N)
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
        cont = active & ~state2.done & ~finished
        feed_mask = cont | refill
        obs = torch.where(r1, env.encode_obs(state3), res.obs_tokens)
        host = None
        if self.shared_pages == 0:
            logits, cache, tokens, pos, ref, draft = self._feed_obs(
                decode, logits, cache, tokens, pos, obs, feed_mask, ref,
                draft)
        else:
            tokens = self._write_prefix_tokens(tokens, obs, refill)
            free = ((cache.refcount == 0).sum(dtype=torch.int32)
                    - self._feed_pages(cache, pos, feed_mask, refill))
            host = self._host_read(
                returned, kv_dropped,
                c.preempted if preempt else None, free.clamp_min(0),
                cont.any(), feed_mask.any())
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
        (``common.keyed_uniform``)."""
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
                (carry.cache.refcount == 0).sum(dtype=torch.int32)
                if paging.is_paged(carry.cache) else carry.returned * 0)
            if self.on_exhaust == "raise" and h["kv_dropped"] > 0:
                raise RuntimeError(
                    f"KV page pool exhausted during rollout: "
                    f"{h['kv_dropped']} dropped KV write(s) by macro-step "
                    f"{m} (pool {carry.cache.n_pages} pages); grow "
                    f"cache_pages (see models.paging.pool_pages_needed"
                    f"[_shared]), set pool_growth='double', use "
                    f"on_exhaust='preempt' to trade throughput for "
                    f"completeness, or on_exhaust='count' to tolerate "
                    f"truncation")
            if grow:
                # grow when the pool showed distress this turn: a dropped
                # write, a preemption, or free pages under the watermark
                cap = carry.cache.n_pages
                if cap < grow_cap and (
                        h["kv_dropped"] > last_dropped
                        or h["preempted"] > last_preempted
                        or h["free"] < self.admit_watermark):
                    carry = carry._replace(cache=paging.grow_pool(
                        carry.cache, min(2 * cap, grow_cap)))
                    pool_grows += 1
                last_dropped, last_preempted = h["kv_dropped"], h["preempted"]
            if h["returned"] >= N:
                break
        if preempt and h["returned"] < N:
            raise RuntimeError(
                f"preemption governor failed to drain the rollout: "
                f"{h['returned']}/{N} episodes returned after {max_macro} "
                f"macro-steps (pool {carry.cache.n_pages} pages, "
                f"{h['preempted']} preemption(s)); the pool is likely "
                f"below min_pool_pages({B}) = {self.min_pool_pages(B)}.")
        return self._finalize(carry, N, params_version, pool_grows)

    def _finalize(self, carry: slots.SlotCarry, N: int,
                  params_version: int = -1, pool_grows: int = 0):
        s = carry.store
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
            page_capacity=(carry.cache.n_pages
                           if paging.is_paged(carry.cache) else 0),
            kv_dropped_writes=int(carry.kv_dropped),
            shared_prefix_len=self.shared_len,
            preemptions=opt(carry.preempted),
            requeue_depth=opt(carry.requeue_peak),
            pool_grows=pool_grows,
            spec_proposed=opt(carry.spec_proposed),
            spec_accepted=opt(carry.spec_accepted),
            spec_rounds=opt(carry.spec_rounds))
        return exp, stats
