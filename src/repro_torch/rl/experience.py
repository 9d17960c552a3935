"""Experience batches (port of ``repro/rl/experience.py``): the
intermediate data the Rollout stage produces and the Update stage
consumes."""
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

    @property
    def batch(self) -> int:
        return self.tokens.shape[0]

    @property
    def seq(self) -> int:
        return self.tokens.shape[1]

    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size() for x in self)

    def with_(self, **kw) -> "ExperienceBatch":
        return self._replace(**kw)


def zeros_like_experience(batch: int, seq: int,
                          device=None) -> ExperienceBatch:
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    return ExperienceBatch(
        tokens=z((batch, seq), torch.int32),
        gen_mask=z((batch, seq), torch.bool),
        loss_mask=z((batch, seq), torch.bool),
        logprobs=z((batch, seq), torch.float32),
        ref_logprobs=z((batch, seq), torch.float32),
        rewards=z((batch,), torch.float32),
        returns=z((batch,), torch.float32),
        advantages=z((batch,), torch.float32),
        context_len=z((batch,), torch.int32),
        truncated=z((batch,), torch.bool),
    )
