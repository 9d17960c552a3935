"""Slot-based continuous batching (port of ``repro/rl/engine/slots.py``).

The device batch is a pool of ``B`` slots. A finished episode is harvested
into an ``EpisodeStore`` of ``N`` episodes and a fresh one is reset into
the freed slot, keeping the batch full. Everything stays on the device.

The store carries one trash row (index ``N``) that harvest writes of
unfinished slots land in (JAX drops them with ``mode="drop"``); readers
take ``store.tokens[:N]`` and so on, as ``CompiledRolloutEngine`` does.
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
    place. Unfinished rows target the trash row ``N``. ``tokens`` /
    ``gen_mask`` / ``logprobs`` / ``ref_logprobs`` are (B, T) views (the
    slot buffers without their trash column)."""
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


def refill_plan(finished, launched, n_episodes: int):
    """Assign fresh episode ids to freed slots. Returns ``(refill_mask,
    new_ids, launched')``; finished slots beyond the remaining budget go
    idle."""
    order = torch.cumsum(finished.to(torch.int32), 0, dtype=torch.int32) - 1
    new_ids = launched + order
    refill = finished & (new_ids < n_episodes)
    launched = launched + refill.sum(dtype=torch.int32)
    return refill, torch.where(refill, new_ids, 0), launched
