"""Experience batches (port of ``repro/rl/experience.py``)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class ExperienceBatch(NamedTuple):
    tokens: torch.Tensor        # (B, T) int32 — full episode contexts
    gen_mask: torch.Tensor      # (B, T) bool  — policy-generated positions
    loss_mask: torch.Tensor     # (B, T) bool  — positions in the loss
    logprobs: torch.Tensor      # (B, T) f32   — rollout-policy log-probs
    ref_logprobs: torch.Tensor  # (B, T) f32   — reference-model log-probs
    rewards: torch.Tensor       # (B,)   f32   — terminal episode rewards
    returns: torch.Tensor       # (B,)   f32   — reward-to-go at start
    advantages: torch.Tensor    # (B,)   f32
    context_len: torch.Tensor   # (B,)   int32 — episode context length
    truncated: torch.Tensor     # (B,)   bool  — hit the context limit
