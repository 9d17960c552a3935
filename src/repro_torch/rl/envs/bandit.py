"""Batched multi-armed bandit on tensors (port of
``repro/rl/envs/bandit.py``): the single-turn env, one decision per
episode.

Each episode draws per-arm payout probabilities at reset; the observation
encodes a noisy quantized hint of each arm's mean, the agent picks an arm
with one action token, and the episode ends with a +1 payout with
probability ``mean[arm]``, else -1. ``prompt_len`` prepends a fixed
"system prompt" token run to every observation, so ``prompt_prefix_len``
(BOS + prompt) leading tokens are identical across episodes: the shape
prefix sharing forks.

The draws are arguments: ``reset`` takes ``(B, 2 * n_arms)`` — the uniform
means in the first ``n_arms`` columns, standard normal hint noise in the
rest (JAX's ``uniform`` and ``normal`` of ``bandit.py:61-63``) — and
``step`` takes ``(B, 1)`` uniform payout draws (``bandit.py:102``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.rl.envs.base import (StepResult, TOK_BOS, TOK_LOSS,
                                      TOK_OBS_BASE, TOK_TURN, TOK_WIN,
                                      default_reset_rows)


class BanditState(NamedTuple):
    means: torch.Tensor    # (B, n_arms) f32 in [0, 1] per-episode payout
    hints: torch.Tensor    # (B, n_arms) int32 noisy quantized mean levels
    done: torch.Tensor     # (B,) bool
    reward: torch.Tensor   # (B,) f32 (sticky terminal reward)


class MultiArmedBandit:
    step_noise_width = 1   # the payout draw

    def __init__(self, n_arms: int = 5, hint_noise: float = 0.15,
                 obs_levels: int = 4, prompt_len: int = 0):
        self.n_actions = n_arms
        self.n_arms = n_arms
        self.hint_noise = hint_noise
        self.obs_levels = obs_levels
        self.prompt_len = prompt_len
        # BOS + prompt + hints + result + TURN
        self.obs_len = 1 + prompt_len + n_arms + 2
        # BOS + the fixed prompt are identical for every episode; the hints
        # that follow are per-episode draws
        self.prompt_prefix_len = 1 + prompt_len
        self.reset_noise_width = 2 * n_arms

    def noise_from_uniform(self, kind: str, u):
        """``kind`` "env": the payout draw is ``u`` itself; "reset": the
        means are the first ``n_arms`` columns and the hint noise the
        normal quantiles of the rest."""
        if kind == "env":
            return u
        n = self.n_arms
        return torch.cat([u[:, :n], torch.special.ndtri(u[:, n:])], dim=1)

    def reset(self, batch: int, *, device, noise=None) -> BanditState:
        if noise is None:
            raise ValueError("the bandit's reset draws its means: pass noise "
                             f"of shape (batch, {self.reset_noise_width})")
        n = self.n_arms
        means = noise[:, :n].float()
        noisy = means + self.hint_noise * noise[:, n:].float()
        hints = (noisy * self.obs_levels).to(torch.int32).clamp(
            0, self.obs_levels - 1)
        return BanditState(
            means=means, hints=hints,
            done=torch.zeros((batch,), dtype=torch.bool, device=device),
            reward=torch.zeros((batch,), dtype=torch.float32, device=device))

    def reset_rows(self, state: BanditState, mask, noise=None) -> BanditState:
        return default_reset_rows(self, state, mask, noise)

    def encode_obs(self, state: BanditState, result_tok=None):
        B = state.means.shape[0]
        dev = state.means.device
        full = lambda tok: torch.full((B, 1), tok, dtype=torch.int32,
                                      device=dev)
        parts = [full(TOK_BOS)]
        if self.prompt_len > 0:
            # fixed deterministic preamble, identical for every episode
            pre = TOK_OBS_BASE + torch.remainder(
                torch.arange(self.prompt_len, dtype=torch.int32,
                             device=dev), self.obs_levels)
            parts.append(pre[None, :].expand(B, self.prompt_len))
        hints = TOK_OBS_BASE + state.hints.to(torch.int32)
        res = full(TOK_TURN) if result_tok is None else result_tok[:, None]
        return torch.cat(parts + [hints, res.to(torch.int32),
                                  full(TOK_TURN)], dim=1).to(torch.int32)

    def step(self, state: BanditState, actions, noise):
        """One pull ends the episode. actions: (B,) int in [0, n_arms);
        noise: (B, 1) uniform payout draws."""
        B = actions.shape[0]
        chosen = state.means.gather(1, actions.long()[:, None])[:, 0]
        payout = torch.where(noise[:, 0] < chosen, 1.0, -1.0).float()
        newly = ~state.done                          # absorbing done rows
        new_reward = torch.where(newly, payout, state.reward)
        new_done = torch.ones((B,), dtype=torch.bool, device=actions.device)
        result_tok = torch.where(new_reward > 0, TOK_WIN, TOK_LOSS).to(
            torch.int32)
        new_state = BanditState(means=state.means, hints=state.hints,
                                done=new_done, reward=new_reward)
        obs = self.encode_obs(new_state, result_tok)
        return new_state, StepResult(reward=new_reward * newly.float(),
                                     done=new_done, obs_tokens=obs)
