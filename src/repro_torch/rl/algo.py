"""RL algorithm substrate (port of ``repro/rl/algo.py``): token log-probs,
REINFORCE and group-relative advantages, returns-to-go, truncated
importance weights and the policy-gradient loss. Every
``jax.lax.stop_gradient`` of the JAX functions is a ``.detach()`` in the
same place."""
from __future__ import annotations

import torch
import torch.distributed as dist


def token_logprobs(logits, tokens):
    """logits: (B,T,V); tokens: (B,T) -> (B,T) f32 log p(token)."""
    lf = logits.float()
    m = lf.amax(dim=-1, keepdim=True).detach()
    shifted = lf - m
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    tok_logit = shifted.gather(-1, tokens.long()[..., None])[..., 0]
    return tok_logit - lse


def reinforce_advantages(rewards, *, baseline: str = "batch_mean"):
    """Episode-level REINFORCE advantage. rewards: (B,) -> (B,).
    baseline: "none" (the rewards) | "batch_mean" (leave-one-out mean)."""
    if baseline not in ("none", "batch_mean"):
        raise ValueError(f"baseline must be 'none' or 'batch_mean', got "
                         f"{baseline!r}")
    r = rewards.float()
    if baseline == "none":
        return r
    B = r.shape[0]
    if B > 1:
        loo = (r.sum() - r) / (B - 1)
        return r - loo
    return r


def group_relative_advantages(rewards, group_size: int, eps: float = 1e-6):
    """GRPO-style: normalise within groups of ``group_size`` consecutive
    rows (population std, as ``jnp.std``). rewards: (B,) with B %
    group_size == 0."""
    r = rewards.float()
    B = r.shape[0]
    if B % group_size:
        raise ValueError(f"batch {B} is not a multiple of group_size "
                         f"{group_size}")
    g = r.reshape(B // group_size, group_size)
    mean = g.mean(dim=1, keepdim=True)
    std = g.std(dim=1, keepdim=True, correction=0)
    return ((g - mean) / (std + eps)).reshape(B)


def returns_to_go(step_rewards, gamma: float = 1.0):
    """step_rewards: (B, n_turns) -> (B, n_turns) f32 discounted
    reward-to-go per turn, accumulated from the last turn back (JAX's
    reversed scan, carry ``r + gamma * carry`` from an f32 zero). XLA fuses
    that update into one multiply-add; it is computed here in f64 (the f32
    product is exact there) and rounded once to f32, which gives JAX's
    bits."""
    g = torch.tensor(gamma, dtype=torch.float32).double()
    carry = torch.zeros(step_rewards.shape[0], dtype=torch.float64,
                        device=step_rewards.device)
    out = []
    for t in range(step_rewards.shape[1] - 1, -1, -1):
        carry = (step_rewards[:, t].double() + g * carry).float().double()
        out.append(carry)
    return torch.stack(out[::-1], dim=1).float()


def truncated_importance_weights(logprobs, behavior_logprobs, *,
                                 rho_max: float = 2.0):
    """Per-token ``min(pi_current / pi_behavior, rho_max)`` (never below
    0), a constant multiplier of the estimator: no gradient flows through
    it."""
    d = logprobs.detach() - behavior_logprobs
    return torch.clamp(torch.exp(d), 0.0, rho_max)


def policy_gradient_loss(logprobs, advantages, gen_mask, *,
                         old_logprobs=None, clip_eps: float = 0.0,
                         ref_logprobs=None, kl_coef: float = 0.0,
                         entropy_logits=None, entropy_coef: float = 0.0,
                         behavior_logprobs=None, is_rho_max: float = 0.0,
                         group=None):
    """Masked token-level policy-gradient loss.

    logprobs: (B,T) current-policy log-probs of the taken tokens.
    advantages: (B,) episode-level or (B,T) token-level.
    gen_mask: (B,T) float/bool — 1 where the token is in the loss.
    old_logprobs + clip_eps > 0 -> PPO clipped surrogate; else REINFORCE.
    ref_logprobs + kl_coef > 0 -> k3 KL penalty against the reference.
    behavior_logprobs + is_rho_max > 0 -> truncated importance weights.
    group: the data-axis process group of an update whose batch rows are
    split over its ranks (these are this rank's rows): the denominator is
    the global token count, all-reduced before the loss, and the loss and
    every metric are this rank's share, whose sum over the group is the
    global batch's.
    Returns (loss, metrics dict of 0-dim tensors).
    """
    mask = gen_mask.float()
    n_tokens = mask.sum()
    if group is not None:
        dist.all_reduce(n_tokens, group=group)
    denom = torch.clamp(n_tokens, min=1.0)
    if advantages.dim() == 1:
        advantages = advantages[:, None]
    adv = advantages.float().detach()

    metrics = {}
    if behavior_logprobs is not None and is_rho_max > 0.0:
        w = truncated_importance_weights(logprobs, behavior_logprobs,
                                         rho_max=is_rho_max)
        adv = adv * w
        metrics["is_weight_mean"] = (w * mask).sum() / denom
        metrics["is_trunc_frac"] = ((w >= is_rho_max) * mask).sum() / denom
    if old_logprobs is not None and clip_eps > 0.0:
        ratio = torch.exp(logprobs - old_logprobs.detach())
        unclipped = ratio * adv
        clipped = torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * adv
        obj = torch.minimum(unclipped, clipped)
        metrics["clip_frac"] = (((ratio - 1).abs() > clip_eps) * mask).sum(
        ) / denom
    else:
        obj = logprobs * adv
    loss = -(obj * mask).sum() / denom

    if ref_logprobs is not None and kl_coef > 0.0:
        # k3 estimator: exp(ref-lp) - (ref-lp) - 1  (Schulman)
        d = ref_logprobs.detach() - logprobs
        kl_loss = ((torch.exp(d) - d - 1.0) * mask).sum() / denom
        loss = loss + kl_coef * kl_loss
        metrics["kl"] = kl_loss

    if entropy_logits is not None and entropy_coef > 0.0:
        p = torch.softmax(entropy_logits.float(), dim=-1)
        ent = -(p * torch.log(p + 1e-9)).sum(dim=-1)
        ent_mean = (ent * mask).sum() / denom
        loss = loss - entropy_coef * ent_mean
        metrics["entropy"] = ent_mean

    metrics["pg_loss"] = loss
    return loss, metrics


def distributed_reinforce_advantages(rewards, mesh, *, axis: str = "data"):
    """Leave-one-out REINFORCE advantages without centralizing the rewards
    (the paper's §5 future-work item). ``rewards`` is this rank's shard of
    a (B,) batch split over ``axis`` of the ``DeviceMesh`` ``mesh``: each
    rank sums its rewards and one scalar ``all_reduce`` over the axis's
    group crosses the mesh, O(1) bytes instead of a gather of O(B).
    Collective over that group. Equal to ``reinforce_advantages`` of the
    whole batch up to the order of the f32 sum."""
    n_shards = mesh.size(list(mesh.mesh_dim_names).index(axis))
    r = rewards.float()
    total = r.sum()
    dist.all_reduce(total, group=mesh.get_group(axis))
    B = r.shape[0] * n_shards
    if B <= 1:
        return r
    return r - (total - r) / (B - 1)


def distributed_group_advantages(rewards, mesh, group_size: int, *,
                                 axis: str = "data", eps: float = 1e-6):
    """GRPO-style group-relative advantages, distributed: response groups
    lie within a shard (``group_size`` divides the local batch), so the
    normalization needs no communication at all. ``rewards``: this rank's
    shard of a (B,) batch split over ``axis``."""
    del mesh, axis                       # no communication
    n = rewards.shape[0]
    if n % group_size:
        raise ValueError(f"local batch {n} is not a multiple of group_size "
                         f"{group_size}")
    return group_relative_advantages(rewards, group_size, eps)
