"""Slot-based continuous batching (port of ``repro/rl/engine/slots.py``).

The device batch is a pool of ``B`` slots. A finished episode is harvested
into an ``EpisodeStore`` of ``N`` episodes and a fresh one is reset into
the freed slot, keeping the batch full. Everything stays on the device.

The store carries one trash row (index ``N``) that harvest writes of
unfinished slots land in (JAX drops them with ``mode="drop"``); readers
take ``store.tokens[:N]`` and so on, as ``CompiledRolloutEngine`` does.

In a data-parallel rollout each data row runs its window of the global
slots: its store has rows for all ``N`` episode ids (and its own trash
row) but holds only the episodes its slots finished, and the engine
exchanges the stores once at the end of the run.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch


class EpisodeStore(NamedTuple):
    """Harvested-episode buffers indexed by episode id (N+1 rows, row N =
    trash)."""
    tokens: torch.Tensor        # (N+1, T) int32
    gen_mask: torch.Tensor      # (N+1, T) bool
    logprobs: torch.Tensor      # (N+1, T) f32
    ref_logprobs: torch.Tensor  # (N+1, T) f32 (0 without the folded ref)
    rewards: torch.Tensor       # (N+1,)   f32 (0 for truncated episodes)
    context_len: torch.Tensor   # (N+1,)   int32
    truncated: torch.Tensor     # (N+1,)   bool
    n_turns: torch.Tensor       # (N+1,)   int32
    turn_lengths: torch.Tensor  # (N+1, max_turns) int32


class SlotCarry(NamedTuple):
    """Device state threaded through macro-steps. Between macro-steps every
    live slot's observation is already fed (``logits`` is its next-token
    distribution). The per-slot token buffers carry one trash column
    (index T) that masked writes land in."""
    cache: Any                 # paged or dense decode cache (.pos (B,))
    logits: torch.Tensor       # (B, V) f32 last decode logits per slot
    env_state: Any             # env state, batch-B leaves
    tokens: torch.Tensor       # (B, T+1) int32 episode context buffer
    gen_mask: torch.Tensor     # (B, T+1) bool
    logprobs: torch.Tensor     # (B, T+1) f32
    pos: torch.Tensor          # (B,) int32 per-row write pointer
    live: torch.Tensor         # (B,) bool — slot holds a running episode
    truncated: torch.Tensor    # (B,) bool
    n_turns: torch.Tensor      # (B,) int32
    turn_lengths: torch.Tensor  # (B, max_turns) int32
    episode: torch.Tensor      # (B,) int32 episode id in [0, N); N = idle
    launched: torch.Tensor     # () int32 episodes reset into slots
    returned: torch.Tensor     # () int32 episodes harvested
    store: EpisodeStore
    pages_peak: torch.Tensor   # () int32 peak pool occupancy
    kv_dropped: torch.Tensor   # () int32 cumulative dropped KV writes
    kv_shortfall: torch.Tensor  # (B,) int32 current per-slot dropped tokens
    # the folded reference pass (None when off)
    ref_cache: Any = None      # dense bf16 decode cache of the reference
    ref_logits: Any = None     # (B, V) f32 last reference logits
    ref_logprobs: Any = None   # (B, T+1) f32 ref log-prob of each fed token
    # speculative decoding (None when off): the draft's dense decode cache
    # and the three counters of RolloutStats, as device scalars
    draft_cache: Any = None
    spec_proposed: Any = None  # () int32 draft tokens proposed
    spec_accepted: Any = None  # () int32 draft tokens accepted
    spec_rounds: Any = None    # () int32 (row, verify round) pairs
    # the shared-prefix run (None when share_prefix is off): the pinned
    # pool pages of the common prompt's full pages, prefilled once at init
    # and forked into every refilled slot
    prefix_pages: Any = None   # (shared_pages,) int32 pool page indices
    # preemption (None unless on_exhaust="preempt"): an evicted slot
    # releases its pages and its episode id enters ``requeue`` until the
    # admission plan re-launches it from scratch
    preempted: Any = None      # () int32 cumulative slot preemptions
    requeue: Any = None        # (N,) bool episodes awaiting re-admission
    requeue_peak: Any = None   # () int32 peak requeue depth
    # the turn's host read when the macro-step made it itself (prefix
    # sharing reads before its feed): the run loop's counters as ints
    host: Any = None
    # a data row's window of the global slots, (lo, hi, B) as ints: the
    # carry's rows are global slots [lo, hi) of B (None: all of them).
    # ``launched``, ``returned``, ``pages_peak``, ``kv_dropped`` and the
    # preempt mode's counters and requeue are then global, the same on
    # every row
    window: Any = None
    # the global paged pool's page count, an int (JAX's ``n_pages``; grown
    # by pool growth): the whole pool on one row, of which a data row's
    # ``cache`` holds its own pages (0 on the dense layout)
    pool_pages: Any = 0


def init_store(n_episodes: int, max_context: int, max_turns: int,
               device) -> EpisodeStore:
    n, T = n_episodes + 1, max_context
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    return EpisodeStore(
        tokens=z((n, T), torch.int32),
        gen_mask=z((n, T), torch.bool),
        logprobs=z((n, T), torch.float32),
        ref_logprobs=z((n, T), torch.float32),
        rewards=z((n,), torch.float32),
        context_len=z((n,), torch.int32),
        truncated=z((n,), torch.bool),
        n_turns=z((n,), torch.int32),
        turn_lengths=z((n, max_turns), torch.int32),
    )


def harvest(store: EpisodeStore, *, finished, episode, tokens, gen_mask,
            logprobs, rewards, pos, truncated, n_turns, turn_lengths,
            ref_logprobs=None) -> EpisodeStore:
    """Write finished slot rows into the store at their episode id, in
    place (on a data row, the rows it finished). Unfinished rows target
    the trash row ``N``. ``tokens`` / ``gen_mask`` / ``logprobs`` /
    ``ref_logprobs`` are (B, T) views (the slot buffers without their
    trash column)."""
    N = store.tokens.shape[0] - 1
    idx = (torch.where(finished, episode, N).long(),)
    pairs = [(store.tokens, tokens), (store.gen_mask, gen_mask),
             (store.logprobs, logprobs), (store.rewards, rewards),
             (store.context_len, pos), (store.truncated, truncated),
             (store.n_turns, n_turns), (store.turn_lengths, turn_lengths)]
    if ref_logprobs is not None:
        pairs.append((store.ref_logprobs, ref_logprobs))
    for buf, row in pairs:
        buf.index_put_(idx, row.to(buf.dtype))
    return store


def refill_plan(finished, launched, n_episodes: int, before=0, total=None):
    """Assign fresh episode ids to freed slots in the global slot order.
    Returns ``(refill_mask, new_ids, launched')``; finished slots beyond
    the remaining budget go idle. On a data row of a data-parallel
    rollout ``finished`` is the row's slots, ``before`` the finished slots
    of the rows before it and ``total`` the finished slots of every row
    (0-d tensors; ``launched`` is global): the row's k-th finished slot
    takes id ``launched + before + k``, as the global cumsum gives it."""
    order = before + torch.cumsum(finished.to(torch.int32), 0,
                                  dtype=torch.int32) - 1
    new_ids = launched + order
    refill = finished & (new_ids < n_episodes)
    if total is None:
        total = finished.sum(dtype=torch.int32)
    launched = launched + torch.minimum(
        total, (n_episodes - launched).clamp_min(0)).to(launched.dtype)
    return refill, torch.where(refill, new_ids, 0), launched


def _i32_cumsum(x):
    return torch.cumsum(x.to(torch.int32), 0, dtype=torch.int32)


def admission_plan(free_slots, requeue, launched, n_episodes: int, quota):
    """Watermark-gated refill of ``on_exhaust="preempt"``. Like
    ``refill_plan``, but (a) every free slot is a candidate (``free_slots``:
    slots freed by preemption or earlier throttling too), (b) re-queued
    episodes are admitted first, in ascending id order, before any fresh
    id, and (c) at most ``quota`` episodes are admitted.

    free_slots: (B,) bool; requeue: (N,) bool; quota: 0-d int. Returns
    ``(admit, new_ids, launched', requeue')``; ``launched`` advances only
    for fresh ids (a re-admitted episode was counted at its first launch).
    """
    B = free_slots.shape[0]
    N = requeue.shape[0]
    dev = free_slots.device
    rank = _i32_cumsum(free_slots) - 1                     # admission rank
    n_rq = requeue.sum(dtype=torch.int32)
    # rank-match requeued ids: the r-th admission takes the r-th lowest
    # requeued id (slot B of the table is the trash entry)
    rq_rank = _i32_cumsum(requeue) - 1                     # (N,)
    slot_of = torch.where(requeue & (rq_rank < B), rq_rank, B).long()
    rank_to_eid = torch.full((B + 1,), N, dtype=torch.int32, device=dev)
    rank_to_eid.scatter_(0, slot_of,
                         torch.arange(N, dtype=torch.int32, device=dev))
    from_rq = free_slots & (rank < n_rq)
    fresh_id = launched + (rank - n_rq)                    # ranks >= n_rq
    eid = torch.where(from_rq, rank_to_eid[rank.clamp(0, B - 1).long()],
                      fresh_id).to(torch.int32)
    have = free_slots & (from_rq
                         | ((rank >= n_rq) & (fresh_id < n_episodes)))
    admit = have & (rank < quota)
    launched = launched + (admit & ~from_rq).sum(dtype=torch.int32)
    done = torch.zeros((N + 1,), dtype=torch.bool, device=dev)
    done.scatter_(0, torch.where(admit & from_rq, eid, N).long(),
                  torch.ones_like(admit))
    return (admit, torch.where(admit, eid, 0), launched,
            requeue & ~done[:N])
