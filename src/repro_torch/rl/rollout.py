"""Multi-turn agentic rollout engine, the python reference loop (port of
``repro/rl/rollout.py``; the paper's Rollout stage, Fig. 2 ①).

Per turn: the policy decodes tokens one at a time (sampling with injected
Gumbel noise, or greedy argmax when ``temperature <= 0``) until it emits
an *action token* or hits the per-turn cap; the action is applied to the
batched environment; its observation tokens are then teacher-forced into
the context, and the next turn begins. The loop ends when every episode is
done or the context limit would be exceeded (a truncation).

The prompt is prefilled into a dense bf16 cache and every later token is
one ``decode_step`` with the model's default attention ("xla"). The loop
reads the device on every token: it is the semantic reference that the
compiled slot engine (``rl/engine/compiled.py``) is held against, not a
fast path. Randomness is injected through the compiled engine's
``NoiseFn``: token ``t`` of turn ``m`` samples with ``noise("sample", m,
t, (B, V))``, the opponent with ``noise("env", m, 0, (B, width))``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.train_step import make_ref_logprob_step
from repro_torch.device import resolve_device
from repro_torch.rl.algo import reinforce_advantages
from repro_torch.rl.engine import common
from repro_torch.rl.engine.common import ACTION_BASE
from repro_torch.rl.engine.compiled import NoiseFn
from repro_torch.rl.envs.base import TOK_PAD
from repro_torch.rl.experience import ExperienceBatch


@dataclass
class RolloutEngine:
    model: Any                      # repro_torch Model
    env: Any
    max_turns: int = 4
    max_turn_tokens: int = 8
    max_context: int = 256
    temperature: float = 1.0
    top_p: float = 1.0              # nucleus filter (1.0 = off)
    device: Any = None              # None = the GPU (raises without one)

    def __post_init__(self):
        if ACTION_BASE + self.env.n_actions > self.model.cfg.vocab_size:
            raise ValueError("the action tokens do not fit the vocabulary")
        self.device = resolve_device(self.device)
        self._ref_lp = make_ref_logprob_step(self.model)

    def default_noise(self, generator: Optional[torch.Generator] = None
                      ) -> NoiseFn:
        """Gumbel draws from ``generator`` on the engine's device."""
        return lambda kind, m, index, shape: common.gumbel(
            shape, generator=generator, device=self.device)

    def run(self, params, batch: int, n_episodes: Optional[int] = None, *,
            generator: Optional[torch.Generator] = None,
            noise: Optional[NoiseFn] = None, params_version: int = -1,
            ref_params=None):
        """Roll out ``batch`` episodes. Returns ``(ExperienceBatch,
        RolloutStats)``. ``n_episodes`` exists for signature parity with
        the compiled engine: there is no slot refill, so it must equal
        ``batch``. ``ref_params`` fills ``ref_logprobs`` at the fed
        positions ``1 .. context_len-1`` from one full-sequence reference
        pass, the compiled engine's folded convention."""
        if n_episodes is not None and n_episodes != batch:
            raise ValueError(
                "the python reference engine has no slot refill; use "
                "CompiledRolloutEngine for n_episodes != batch")
        noise = noise if noise is not None else self.default_noise(generator)
        env, model, dev = self.env, self.model, self.device
        T, B, V = self.max_context, int(batch), model.cfg.vocab_size

        state = env.reset(B, device=dev)
        obs = env.encode_obs(state).cpu().numpy()            # (B, obs_len)
        tokens = np.full((B, T), TOK_PAD, np.int32)
        gen_mask = np.zeros((B, T), bool)
        logprobs = np.zeros((B, T), np.float32)
        turn_lengths = np.zeros((B, self.max_turns), np.int32)
        n_turns = np.zeros(B, np.int32)
        truncated = np.zeros(B, bool)
        olen = obs.shape[1]
        tokens[:, :olen] = obs
        pos = np.full(B, olen, np.int32)                     # write pointer

        cache = model.init_cache(B, T, device=dev)
        logits, cache = model.prefill(params, torch.from_numpy(
            tokens[:, :olen]).to(dev), cache)
        logits = logits.float()
        done = np.zeros(B, bool)

        def advance_rows(fed, mask):
            """Feed per-row tokens; only ``mask`` rows advance."""
            nonlocal logits, cache
            m = torch.from_numpy(mask).to(dev)
            new, cache = model.decode_step(
                params, torch.from_numpy(fed).to(dev), cache, advance=m)
            logits = torch.where(m[:, None], new.float(), logits)

        for turn in range(self.max_turns):
            if done.all():
                break
            # rows that cannot fit another turn + observation are truncated
            room = pos + self.max_turn_tokens + olen <= T
            truncated |= ~done & ~room
            active = ~done & room
            if not active.any():
                break
            acted = ~active
            actions = np.zeros(B, np.int32)
            last_tok = np.zeros(B, np.int32)
            for t in range(self.max_turn_tokens):
                write = ~acted
                if not write.any():
                    break
                nz = (noise("sample", turn, t, (B, V))
                      if self.temperature > 0.0 else None)
                tok, lp = common.sample_with_noise(logits, nz,
                                                   self.temperature,
                                                   self.top_p)
                tok, lp = tok.cpu().numpy(), lp.cpu().numpy()
                rows = np.nonzero(write)[0]
                tokens[rows, pos[rows]] = tok[rows]
                gen_mask[rows, pos[rows]] = True
                logprobs[rows, pos[rows]] = lp[rows]
                pos[rows] += 1
                turn_lengths[rows, turn] += 1
                last_tok[rows] = tok[rows]
                newly = write & common.action_mask(
                    torch.from_numpy(tok), env.n_actions).numpy()
                actions[newly] = tok[newly] - ACTION_BASE
                acted |= newly
                advance_rows(tok, write)

            actions = common.fallback_actions(
                *(torch.from_numpy(a) for a in (actions, last_tok, active,
                                                acted)), env.n_actions)
            n_turns[active] += 1
            env_actions = torch.where(torch.from_numpy(active), actions, 0)
            state, res = env.step(
                state, env_actions.to(device=dev, dtype=torch.int32),
                noise("env", turn, 0, (B, env.step_noise_width)))
            res_obs = res.obs_tokens.cpu().numpy()
            new_done = res.done.cpu().numpy()

            # teacher-force the observation for still-running rows; rows
            # out of turn budget skip it (nothing can follow it)
            feed = active & ~new_done
            if turn + 1 < self.max_turns and feed.any():
                rows = np.nonzero(feed)[0]
                for j in range(olen):
                    col = np.where(feed, res_obs[:, j],
                                   TOK_PAD).astype(np.int32)
                    tokens[rows, pos[rows]] = col[rows]
                    pos[rows] += 1
                    advance_rows(col, feed)
            done |= new_done | truncated

        rewards = np.where(truncated, 0.0,
                           state.reward.cpu().numpy()).astype(np.float32)
        tok_t = torch.from_numpy(tokens).to(dev)
        ref_logprobs = torch.zeros((B, T), dtype=torch.float32, device=dev)
        if ref_params is not None:
            idx = np.arange(T)[None, :]
            fed = torch.from_numpy((idx >= 1) & (idx < pos[:, None])).to(dev)
            ref_logprobs = torch.where(fed, self._ref_lp(ref_params, tok_t),
                                       0.0)
        rew_t = torch.from_numpy(rewards).to(dev)
        gm = torch.from_numpy(gen_mask).to(dev)
        exp = ExperienceBatch(
            tokens=tok_t, gen_mask=gm, loss_mask=gm,
            logprobs=torch.from_numpy(logprobs).to(dev),
            ref_logprobs=ref_logprobs, rewards=rew_t, returns=rew_t,
            advantages=reinforce_advantages(rew_t),
            context_len=torch.from_numpy(pos.copy()).to(dev),
            truncated=torch.from_numpy(truncated).to(dev))
        stats = common.summarize(
            turn_lengths, pos.copy(), n_turns, truncated, rewards,
            episodes_started=B, episodes_returned=B,
            params_version=params_version)
        return exp, stats
