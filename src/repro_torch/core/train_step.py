"""Stage programs (port of ``repro/core/train_step.py``): the Model Update
step and the Experience Preparation reference pass.

JAX returns pure functions for ``jax.jit``; these are plain functions that
run eagerly. Gradients come from ``torch.autograd.grad`` of the loss with
respect to the param leaves; params are never modified in place (see
``optim/adamw.py``). ``make_lm_train_step`` is not ported yet (ROADMAP
Queue 1 item 4).
"""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import Optimizer, apply_updates
from repro_torch.rl.algo import policy_gradient_loss, token_logprobs
from repro_torch.rl.experience import ExperienceBatch


def make_rl_train_step(model, optimizer: Optimizer, *, clip_eps: float = 0.0,
                       kl_coef: float = 0.0, is_rho_max: float = 0.0,
                       attn_impl: str = "xla"):
    """The Model Update stage: ``(params, opt_state, batch) -> (params,
    opt_state, metrics)``, a policy-gradient step over an
    ``ExperienceBatch``. Predictions at position t score token t+1, so the
    per-token tensors are shifted by one inside. ``attn_impl``: "xla" or
    "flash" (the flash-attention kernels, forward and backward). Metrics
    are 0-dim device tensors; reading them is the caller's host sync."""

    def train_step(params, opt_state, batch: ExperienceBatch, extra=None):
        names = list(params)
        leaves = {k: params[k].detach().requires_grad_(True) for k in names}
        with torch.enable_grad():
            logits, aux = model.forward(leaves, batch.tokens, extra=extra,
                                        attn_impl=attn_impl)
            lp = token_logprobs(logits[:, :-1], batch.tokens[:, 1:])
            del logits
            loss, metrics = policy_gradient_loss(
                lp, batch.advantages, batch.loss_mask[:, 1:],
                old_logprobs=batch.logprobs[:, 1:] if clip_eps > 0 else None,
                clip_eps=clip_eps,
                ref_logprobs=(batch.ref_logprobs[:, 1:] if kl_coef > 0
                              else None),
                kl_coef=kl_coef,
                behavior_logprobs=(batch.logprobs[:, 1:] if is_rho_max > 0
                                   else None),
                is_rho_max=is_rho_max)
            if "aux_loss" in aux:
                loss = loss + aux["aux_loss"]
                metrics["aux_loss"] = aux["aux_loss"]
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        updates, opt_state2 = optimizer.update(dict(zip(names, grads)),
                                               opt_state, params)
        params2 = apply_updates(params, updates)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return params2, opt_state2, metrics

    return train_step


def make_ref_logprob_step(model, *, attn_impl: str = "xla"):
    """The Experience Preparation reference pass: ``(params, tokens) ->
    (B, T)`` f32 log p_ref(token_t | <t), position 0 zero-filled."""

    def ref_step(params, tokens, extra=None):
        with torch.no_grad():
            logits, _ = model.forward(params, tokens, extra=extra,
                                      attn_impl=attn_impl)
            lp = token_logprobs(logits[:, :-1], tokens[:, 1:])
        return torch.cat([lp.new_zeros((tokens.shape[0], 1)), lp], dim=1)

    return ref_step
