"""Batched board-game environments on tensors (port of
``repro/rl/envs/base.py``).

The agent plays piece 1; the built-in opponent (uniform random over legal
moves) plays piece 2 right after the agent inside ``step``. All state
carries a leading batch dimension and lives on one device; finished
episodes absorb. Randomness is an argument: ``step`` takes the env's draw
as a tensor of shape ``(B, env.step_noise_width)`` (the opponent's Gumbel
noise, or the bandit's payout draw), and ``reset`` takes one of shape
``(B, env.reset_noise_width)`` when that width is not 0 (the bandit's
per-episode means and hint noise; the board games reset deterministically
and take none). So a test can feed the JAX draws and reproduce the JAX
trajectories. ``noise_from_uniform(kind, u)`` turns uniform draws in
``(0, 1)`` of those shapes into the env's own ("env" or "reset"), which is
how the engines draw when no noise is injected.

``prompt_prefix_len`` is the number of leading tokens of every episode's
initial observation that are identical across episodes and rows (a system
prompt, the rules): the engine's copy-on-write prefix sharing prefills
them once and forks their pages into every slot.
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


def gumbel_from_uniform(u):
    """Standard Gumbel draws from uniform ``u`` in (0, 1): the transform
    of ``jax.random.gumbel``."""
    return -torch.log(-torch.log(u))


def blend_rows(mask, new, old):
    """Env state with ``new``'s rows where ``mask`` (B,) and ``old``'s
    elsewhere; every leaf of the state carries the leading batch axis."""
    return type(old)(*(
        torch.where(mask.reshape(mask.shape + (1,) * (o.dim() - 1)), n, o)
        for n, o in zip(new, old)))


def default_reset_rows(env, state, mask, noise=None):
    """Rows where ``mask`` get a fresh episode state (slot refill): a fresh
    batch state is built with ``env.reset`` (from ``noise``, the reset draw
    of the whole batch, for an env that takes one) and blended in
    row-wise."""
    return blend_rows(mask, env.reset(mask.shape[0], device=mask.device,
                                      noise=noise), state)
