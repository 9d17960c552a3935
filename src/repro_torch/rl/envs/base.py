"""Batched board-game environments on tensors (port of
``repro/rl/envs/base.py``).

The agent plays piece 1; the built-in opponent (uniform random over legal
moves) plays piece 2 right after the agent inside ``step``. All state
carries a leading batch dimension and lives on one device; finished
episodes absorb. Randomness is an argument: ``step`` takes the opponent's
Gumbel noise as a tensor of shape ``(B, env.step_noise_width)``, so a test
can feed the JAX draws and reproduce the JAX trajectories.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# Control-token ids (kept below any game's OBS_BASE)
TOK_PAD = 0
TOK_BOS = 1
TOK_TURN = 2          # "your move" marker
TOK_WIN = 3
TOK_LOSS = 4
TOK_DRAW = 5
TOK_ILLEGAL = 6
TOK_OBS_BASE = 8      # cell encodings start here: empty/agent/opponent


class StepResult(NamedTuple):
    reward: torch.Tensor      # (B,) float32 — nonzero only on terminal step
    done: torch.Tensor        # (B,) bool
    obs_tokens: torch.Tensor  # (B, obs_len) int32 — next observation


def default_reset_rows(env, state, mask):
    """Rows where ``mask`` get a fresh episode state (slot refill): a fresh
    batch state is built with ``env.reset`` and blended in row-wise."""
    fresh = env.reset(mask.shape[0], device=mask.device)

    def mix(f, s):
        m = mask.reshape(mask.shape + (1,) * (s.dim() - 1))
        return torch.where(m, f, s)

    return type(state)(*(mix(f, s) for f, s in zip(fresh, state)))
