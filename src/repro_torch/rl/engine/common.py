"""Action protocol, sampling and stats for the rollout engine (port of
``repro/rl/engine/common.py``).

  - **Action protocol**: token ids ``[ACTION_BASE, ACTION_BASE +
    n_actions)`` are actions; a row that spends its turn budget without one
    falls back to ``last_token % n_actions``.
  - **Sampling**: Gumbel-argmax with the noise passed in as a tensor (the
    port's stand-in for JAX's keys: tests feed the JAX draws), or greedy
    argmax when ``temperature <= 0``.
  - **Stats**: ``RolloutStats`` plus the slot-engine episode accounting.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.rl.algo import token_logprobs

ACTION_BASE = 32


@dataclass
class RolloutStats:
    turn_lengths: np.ndarray        # (B, max_turns) generated tokens / turn
    context_lengths: np.ndarray     # (B,) final episode context length
    n_turns: np.ndarray             # (B,)
    truncated: np.ndarray           # (B,) bool
    mean_turn_len: float = 0.0
    mean_context_len: float = 0.0
    mean_return: float = 0.0
    episodes_started: int = 0       # episodes reset into slots
    episodes_returned: int = 0      # episodes harvested
    params_version: int = -1        # -1 = caller did not tag
    pages_in_use: int = 0           # peak pool occupancy over the rollout
    page_capacity: int = 0          # pool size in pages
    kv_dropped_writes: int = 0      # tokens whose KV write was dropped
    # speculative decoding (all 0 when speculation="off"): draft tokens
    # proposed, draft tokens accepted, and (row, verify round) pairs. Each
    # round commits one exactly sampled token per writing row whatever the
    # acceptance, so the mean accepted length per round is
    #   (spec_accepted + spec_rounds) / spec_rounds
    spec_proposed: int = 0
    spec_accepted: int = 0
    spec_rounds: int = 0


def action_mask(tokens, n_actions: int):
    """(...,) int tokens -> bool mask of action-protocol tokens."""
    return (tokens >= ACTION_BASE) & (tokens < ACTION_BASE + n_actions)


def fallback_actions(actions, last_tok, active, acted, n_actions: int):
    """Rows that were active this turn and never emitted an action token
    fall back to ``last_token % n_actions``; every other row keeps its
    action."""
    never = active & ~acted
    fb = torch.remainder(last_tok, n_actions).to(actions.dtype)
    return torch.where(never, fb, actions)


def token_lp(logits, tokens):
    """(B, V) logits + (B,) token ids -> (B,) f32 log p(token)."""
    return token_logprobs(logits.float()[:, None, :], tokens[:, None])[:, 0]


def gumbel(shape, *, generator=None, device=None):
    """Standard Gumbel draws, ``-log(-log(u))`` with ``u`` uniform in
    ``(0, 1)`` (the same transform as ``jax.random.gumbel``; the bits
    differ)."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_with_noise(logits, noise, temperature: float, top_p: float = 1.0):
    """Sample from (B, V) logits with supplied Gumbel noise. Returns
    (tokens, logprobs). ``temperature <= 0`` is greedy (noise unused) with
    log-probs of the untempered logits; otherwise argmax of the tempered
    (and optionally top-p filtered) logits plus ``noise``, log-probs from
    that filtered distribution."""
    lg = logits.float()
    if temperature <= 0.0:
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
    else:
        lg = lg / temperature
        if top_p < 1.0:
            from repro_torch.kernels.fused_sample.ops import apply_top_p
            lg = apply_top_p(lg, top_p)
        tok = torch.argmax(lg + noise, dim=-1).to(torch.int32)
    return tok, token_lp(lg, tok)


def summarize(turn_lengths, context_lengths, n_turns, truncated, rewards, *,
              episodes_started: int, episodes_returned: int,
              params_version: int = -1, pages_in_use: int = 0,
              page_capacity: int = 0, kv_dropped_writes: int = 0,
              spec_proposed: int = 0, spec_accepted: int = 0,
              spec_rounds: int = 0) -> RolloutStats:
    turn_lengths = np.asarray(turn_lengths)
    context_lengths = np.asarray(context_lengths)
    tl = turn_lengths[turn_lengths > 0]
    return RolloutStats(
        turn_lengths=turn_lengths,
        context_lengths=context_lengths,
        n_turns=np.asarray(n_turns),
        truncated=np.asarray(truncated),
        mean_turn_len=float(tl.mean()) if tl.size else 0.0,
        mean_context_len=float(context_lengths.mean()),
        mean_return=float(np.asarray(rewards).mean()),
        episodes_started=int(episodes_started),
        episodes_returned=int(episodes_returned),
        params_version=int(params_version),
        pages_in_use=int(pages_in_use),
        page_capacity=int(page_capacity),
        kv_dropped_writes=int(kv_dropped_writes),
        spec_proposed=int(spec_proposed),
        spec_accepted=int(spec_accepted),
        spec_rounds=int(spec_rounds),
    )
