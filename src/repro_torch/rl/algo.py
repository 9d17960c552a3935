"""RL algorithm pieces the rollout needs (port of part of
``repro/rl/algo.py``): token log-probs and the REINFORCE advantage."""
from __future__ import annotations

import torch


def token_logprobs(logits, tokens):
    """logits: (B,T,V); tokens: (B,T) -> (B,T) f32 log p(token)."""
    lf = logits.float()
    m = lf.amax(dim=-1, keepdim=True).detach()
    shifted = lf - m
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    tok_logit = shifted.gather(-1, tokens.long()[..., None])[..., 0]
    return tok_logit - lse


def reinforce_advantages(rewards):
    """Episode-level REINFORCE advantage with a leave-one-out mean
    baseline. rewards: (B,) -> (B,)."""
    r = rewards.float()
    B = r.shape[0]
    if B > 1:
        loo = (r.sum() - r) / (B - 1)
        return r - loo
    return r
