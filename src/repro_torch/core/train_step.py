"""Stage programs (port of ``repro/core/train_step.py``): the supervised
LM step (``lm_loss``, ``make_lm_train_step``), the Model Update step, the
Experience Preparation reference pass, and the serve and prefill steps.

JAX returns pure functions for ``jax.jit``; these are plain functions that
run eagerly. Gradients come from ``torch.autograd.grad`` of the loss with
respect to the param leaves; params are never modified in place (see
``optim/adamw.py``). Every step takes ``extra``, the audio and vlm
families' modality inputs (``Model.make_extras``).
"""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import Optimizer, apply_updates
from repro_torch.rl.algo import policy_gradient_loss, token_logprobs
from repro_torch.rl.experience import ExperienceBatch


def lm_loss(model, params, tokens, labels, *, extra=None,
            attn_impl: str = "xla"):
    """Masked next-token cross-entropy: positions with ``labels < 0`` are
    ignored; ``-sum(lp * mask) / max(sum(mask), 1)`` through
    ``token_logprobs``, plus the moe family's aux loss. Returns ``(loss,
    {"lm_loss", "n_tokens"})``."""
    logits, aux = model.forward(params, tokens, extra=extra,
                                attn_impl=attn_impl)
    mask = (labels >= 0).float()
    tok_lp = token_logprobs(logits, labels.clamp(min=0))
    denom = mask.sum().clamp(min=1.0)
    loss = -(tok_lp * mask).sum() / denom
    if "aux_loss" in aux:
        loss = loss + aux["aux_loss"]
    return loss, {"lm_loss": loss, "n_tokens": denom}


def _grads(loss_fn, params):
    """``(loss, metrics), grads`` of ``loss_fn(leaves)`` with respect to
    fresh leaves of ``params`` (``jax.value_and_grad`` with aux)."""
    names = list(params)
    leaves = {k: params[k].detach().requires_grad_(True) for k in names}
    with torch.enable_grad():
        loss, metrics = loss_fn(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            dict(zip(names, grads)))


def make_lm_train_step(model, optimizer: Optimizer, *,
                       attn_impl: str = "xla", microbatch: int = 0):
    """``(params, opt_state, tokens, labels, extra=None) -> (params,
    opt_state, metrics)``: cross-entropy and one optimizer step. tokens,
    labels: (B, S) int; the caller shifts the labels (JAX's docstring
    promises an internal shift when they are None, which its code does
    not do; neither does this port).

    ``microbatch > 1`` with ``B % microbatch == 0`` accumulates the
    gradients of ``microbatch`` slices in f32, one after another (live
    activation memory scales with B / microbatch), divides them by
    ``microbatch`` and takes one optimizer step; the loss is then the mean
    of the slices' means and the metrics are ``{"lm_loss", "loss"}``.
    Otherwise the whole batch makes one gradient and the metrics are
    ``lm_loss``'s plus ``"loss"``. Metrics are 0-dim device tensors."""

    def grads_of(p, tokens, labels, extra):
        return _grads(lambda leaves: lm_loss(
            model, leaves, tokens, labels, extra=extra,
            attn_impl=attn_impl), p)

    def train_step(params, opt_state, tokens, labels, extra=None):
        B = tokens.shape[0]
        if microbatch > 1 and B % microbatch == 0:
            mb = B // microbatch
            grads = {k: torch.zeros(v.shape, dtype=torch.float32,
                                    device=v.device)
                     for k, v in params.items()}
            loss = None
            for i in range(microbatch):
                sl = slice(i * mb, (i + 1) * mb)
                ex = (None if extra is None
                      else {k: v[sl] for k, v in extra.items()})
                (l_i, _), g = grads_of(params, tokens[sl], labels[sl], ex)
                for k in grads:
                    grads[k] += g[k].float()
                loss = l_i.float() if loss is None else loss + l_i
            grads = {k: g / microbatch for k, g in grads.items()}
            loss = loss / microbatch
            metrics = {"lm_loss": loss}
        else:
            (loss, metrics), grads = grads_of(params, tokens, labels, extra)
        updates, opt_state2 = optimizer.update(grads, opt_state, params)
        params2 = apply_updates(params, updates)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return params2, opt_state2, metrics

    return train_step


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
        def loss_fn(leaves):
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
            return loss, metrics

        (loss, metrics), grads = _grads(loss_fn, params)
        updates, opt_state2 = optimizer.update(grads, opt_state, params)
        params2 = apply_updates(params, updates)
        metrics["loss"] = loss
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


def make_serve_step(model, *, attn_impl: str = "xla"):
    """One new token per row against a filled cache: ``(params, token,
    cache, extra=None) -> (next_tok (B,) int32, logits (B, V), cache)``,
    greedy (argmax). ``attn_impl``: the decode step's ("pallas", the
    split-K decode kernel, or "xla")."""

    def serve_step(params, token, cache, extra=None):
        with torch.no_grad():
            logits, cache2 = model.decode_step(params, token, cache,
                                               extra=extra,
                                               attn_impl=attn_impl)
        return logits.argmax(dim=-1).to(torch.int32), logits, cache2

    return serve_step


def make_prefill_step(model, *, attn_impl: str = "xla"):
    """``(params, tokens, cache, extra=None) -> (last-position logits,
    cache)``. ``attn_impl``: the prefill's ("flash" or "xla")."""

    def prefill_step(params, tokens, cache, extra=None):
        with torch.no_grad():
            return model.prefill(params, tokens, cache, extra=extra,
                                 attn_impl=attn_impl)

    return prefill_step
