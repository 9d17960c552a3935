"""Action protocol, sampling and stats for the rollout engine (port of
``repro/rl/engine/common.py``).

  - **Action protocol**: token ids ``[ACTION_BASE, ACTION_BASE +
    n_actions)`` are actions; a row that spends its turn budget without one
    falls back to ``last_token % n_actions``.
  - **Sampling**: Gumbel-argmax with the noise passed in as a tensor (the
    port's stand-in for JAX's keys: tests feed the JAX draws), or greedy
    argmax when ``temperature <= 0``.
  - **Episode-keyed draws** (``on_exhaust="preempt"``): a preempted
    episode replays from scratch in another slot at another macro-step, so
    its env draws must be a function of the episode alone. JAX keys them
    by episode id and env step (``episode_reset_rng``/``episode_env_rng``);
    torch cannot rebuild threefry keys, so the port keys its injected noise
    by (kind, episode id, env step), and its own draws hash those
    coordinates (``keyed_uniform``).
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
    # prefix sharing (0 = off): leading tokens of every episode's initial
    # observation served from the one pinned prefix run
    shared_prefix_len: int = 0
    # under pool pressure (0 unless the mode is on): slots evicted by the
    # preemption governor, the peak number of episodes awaiting
    # re-admission, and pool doublings (pool_growth="double")
    preemptions: int = 0
    requeue_depth: int = 0
    pool_grows: int = 0
    # speculative decoding (all 0 when speculation="off"): draft tokens
    # proposed, draft tokens accepted, and (row, verify round) pairs. Each
    # round commits one exactly sampled token per writing row whatever the
    # acceptance, so the mean accepted length per round is
    #   (spec_accepted + spec_rounds) / spec_rounds
    spec_proposed: int = 0
    spec_accepted: int = 0
    spec_rounds: int = 0


def check_no_modality_inputs(model) -> None:
    """The rollout engines and the trainer carry no modality inputs, as in
    the JAX package (its engines never pass ``extra`` to prefill): a model
    whose ``input_extras`` is non-empty (the audio and vlm families) is
    refused up front. Serve and train those through
    ``core/train_step.py``'s steps, which take ``extra``."""
    extras = sorted(model.input_extras(1))
    if extras:
        raise ValueError(
            f"family {model.cfg.family!r} needs modality inputs {extras}, "
            f"which the rollout engine does not carry (nor does the JAX "
            f"package's): use core.train_step's make_lm_train_step, "
            f"make_prefill_step and make_serve_step with extra=")


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


def token_lp(logits, tokens, tp=None):
    """(B, V) logits + (B,) token ids -> (B,) f32 log p(token). Under
    ``tp`` (a ``TPContext``) ``logits`` are the rank's vocab columns and
    the log-sum-exp spans every rank's (``TPContext.token_logprob``)."""
    if tp is not None:
        return tp.token_logprob(logits, tokens)
    return token_logprobs(logits.float()[:, None, :], tokens[:, None])[:, 0]


def gumbel_from_uniform(u):
    """``-log(-log(u))``: the transform of ``jax.random.gumbel``."""
    return -torch.log(-torch.log(u))


def gumbel(shape, *, generator=None, device=None):
    """Standard Gumbel draws from ``u`` uniform in ``(0, 1)`` (the same
    transform as ``jax.random.gumbel``; the bits differ)."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return gumbel_from_uniform(u.clamp_min(torch.finfo(torch.float32).tiny))


_MASK32 = 0xFFFFFFFF
_KINDS = {"sample": 1, "env": 2, "reset": 3}


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32), in two 16-bit
    halves so no product leaves int64."""
    return ((((x >> 16) * c) & 0xFFFF) << 16) + (x & 0xFFFF) * c & _MASK32


def _hash32(x):
    """A 32-bit integer mix (lowbias32) on int64 tensors."""
    x = x & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keyed_uniform(seed: int, kind: str, episode, step, width: int):
    """(B, width) f32 uniform draws in (0, 1) that are a pure function of
    ``(seed, kind, episode[b], step[b], column)``: the engine's own draws
    under ``on_exhaust="preempt"``, where a replayed episode must draw what
    it drew the first time. Computed on ``episode``'s device, no host
    read."""
    base = _hash32(torch.full_like(episode, seed, dtype=torch.int64)
                   ^ _KINDS[kind])
    h = _hash32(base ^ episode.long())
    h = _hash32(h ^ step.long())                            # (B,)
    col = _hash32(torch.arange(width, device=episode.device,
                               dtype=torch.int64) + 0x9E3779B9)
    bits = _hash32(h[:, None] ^ col[None, :]) >> 8          # 24 bits
    return (bits.float() + 0.5) * (1.0 / (1 << 24))


def sample_with_noise(logits, noise, temperature: float, top_p: float = 1.0,
                      tp=None):
    """Sample from (B, V) logits with supplied Gumbel noise. Returns
    (tokens, logprobs). ``temperature <= 0`` is greedy (noise unused) with
    log-probs of the untempered logits; otherwise argmax of the tempered
    (and optionally top-p filtered) logits plus ``noise``, log-probs from
    that filtered distribution.

    Under ``tp`` whose vocab is split, ``logits`` are the rank's columns
    and ``noise`` the whole draw: each rank takes the argmax of its
    columns (earliest on ties), max and sums, merged as the fused
    sampler's partials are (``TPContext.sample_combine``); ``top_p < 1``
    gathers the row exactly and samples it as on one rank."""
    lg = logits.float()
    if tp is not None and tp.vocab_split:
        if temperature > 0.0 and top_p < 1.0:
            return sample_with_noise(tp.gather_row(lg), noise, temperature,
                                     top_p)
        if temperature > 0.0:
            lg = lg / temperature
            sc = lg + tp.shard_row(noise).float()
        else:
            sc = lg
        bi = torch.argmax(sc, dim=-1)
        m = lg.amax(dim=-1)
        take = lambda t: t.gather(1, bi[:, None])[:, 0]
        return tp.sample_combine(
            m, torch.exp(lg - m[:, None]).sum(dim=-1), take(sc),
            bi.to(torch.int32), take(lg))
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
              shared_prefix_len: int = 0, preemptions: int = 0,
              requeue_depth: int = 0, pool_grows: int = 0,
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
        shared_prefix_len=int(shared_prefix_len),
        preemptions=int(preemptions),
        requeue_depth=int(requeue_depth),
        pool_grows=int(pool_grows),
        spec_proposed=int(spec_proposed),
        spec_accepted=int(spec_accepted),
        spec_rounds=int(spec_rounds),
    )
