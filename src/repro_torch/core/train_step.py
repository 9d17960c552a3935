"""Stage programs (port of ``repro/core/train_step.py``): the supervised
LM step (``lm_loss``, ``make_lm_train_step``), the Model Update step, the
Experience Preparation reference pass, and the serve and prefill steps.

JAX returns pure functions for ``jax.jit``; these are plain functions that
run eagerly. Gradients come from ``torch.autograd.grad`` of the loss with
respect to the param leaves; params are never modified in place (see
``optim/adamw.py``). Every step takes ``extra``, the audio and vlm
families' modality inputs (``Model.make_extras``).

The LM and Model Update steps take an optional ``group``: the data-axis
process group of an update whose batch rows are split over its ranks
(``models.tensor_parallel.update_group``), as GSPMD runs JAX's jitted
step on a batch laid over ``data``. Each rank computes on its rows, and
the step equals the global batch's: the token denominators are the
global counts, the moe layers route the global batch's dispatch groups
(a group that straddles ranks moves between them) and share the aux loss
by them, the microbatch slices are the global batch's, and the gradients
are summed over the group in f32 and rounded once to the param dtype
before the optimizer (so the global-norm clip sees the global gradients,
and every rank takes the same step). The loss and metrics are summed the
same way.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.tensor_parallel import UpdateSplit, update_split
from repro_torch.optim.adamw import Optimizer, apply_updates
from repro_torch.rl.algo import policy_gradient_loss, token_logprobs
from repro_torch.rl.experience import ExperienceBatch


def lm_loss(model, params, tokens, labels, *, extra=None,
            attn_impl: str = "xla", group=None):
    """Masked next-token cross-entropy: positions with ``labels < 0`` are
    ignored; ``-sum(lp * mask) / max(sum(mask), 1)`` through
    ``token_logprobs``, plus the moe family's aux loss. Returns ``(loss,
    {"lm_loss", "n_tokens"})``. With ``group`` (the module docstring's)
    the denominator and ``n_tokens`` are the global count, and the loss
    is this rank's share."""
    return _lm_loss(model, params, tokens, labels, extra, attn_impl,
                    update_split(group, tokens.shape[0]))


def _lm_loss(model, params, tokens, labels, extra, attn_impl, split,
             n_tokens=None):
    """``lm_loss`` on this rank's rows of ``split`` (an
    ``UpdateSplit``, or None for one rank). ``n_tokens``: the global
    count of ``labels >= 0``, where the caller has reduced it already;
    else it is counted here and summed over the split's group."""
    logits, aux = model.forward(params, tokens, extra=extra,
                                attn_impl=attn_impl, split=split)
    mask = (labels >= 0).float()
    tok_lp = token_logprobs(logits, labels.clamp(min=0))
    if n_tokens is None:
        n_tokens = mask.sum()
        if split is not None:
            dist.all_reduce(n_tokens, group=split.group)
    denom = n_tokens.clamp(min=1.0)
    loss = -(tok_lp * mask).sum() / denom
    if "aux_loss" in aux:
        loss = loss + aux["aux_loss"]
    return loss, {"lm_loss": loss, "n_tokens": denom}


def _shards(group) -> int:
    """The number of ranks the batch rows are split over."""
    return 1 if group is None else dist.get_world_size(group)


# f32 elements a gradient all-reduce carries at most (a larger leaf goes
# alone): few calls, each a bounded staging buffer
_BUCKET = 1 << 26


def sum_grads(grads, group):
    """``grads`` summed over ``group``: each leaf in f32, in buckets of
    at most ``_BUCKET`` elements, rounded once to its own dtype. The same
    tensors when ``group`` is None."""
    if group is None:
        return grads
    out, bucket, size = {}, [], 0

    def flush():
        flat = torch.cat([grads[k].float().reshape(-1) for k in bucket])
        dist.all_reduce(flat, group=group)
        pieces = flat.split([grads[k].numel() for k in bucket])
        for k, piece in zip(bucket, pieces):
            out[k] = piece.view(grads[k].shape).to(grads[k].dtype)

    for k, g in grads.items():
        if bucket and size + g.numel() > _BUCKET:
            flush()
            bucket, size = [], 0
        bucket.append(k)
        size += g.numel()
    flush()
    return out


def _sum_metrics(metrics, group, keep=()):
    """The 0-dim ``metrics`` summed over ``group`` in one all-reduce, but
    those named in ``keep`` (already global)."""
    if group is None:
        return metrics
    names = [k for k in metrics if k not in keep]
    if not names:
        return metrics
    flat = torch.stack([metrics[k].float() for k in names])
    dist.all_reduce(flat, group=group)
    return dict(metrics, **dict(zip(names, flat.unbind())))


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
    """``(params, opt_state, tokens, labels, extra=None, group=None) ->
    (params, opt_state, metrics)``: cross-entropy and one optimizer step.
    tokens, labels: (B, S) int; the caller shifts the labels (JAX's
    docstring promises an internal shift when they are None, which its
    code does not do; neither does this port).

    ``microbatch > 1`` with ``B % microbatch == 0`` accumulates the
    gradients of ``microbatch`` slices in f32, one after another (live
    activation memory scales with B / microbatch), divides them by
    ``microbatch`` and takes one optimizer step; the loss is then the mean
    of the slices' means and the metrics are ``{"lm_loss", "loss"}``.
    Otherwise the whole batch makes one gradient and the metrics are
    ``lm_loss``'s plus ``"loss"``. Metrics are 0-dim device tensors.

    With ``group`` (the module docstring's) B is the global batch's rows,
    these ``tokens`` one rank's share of them, and the microbatch slices
    are the global batch's, rows ``[i mb, (i+1) mb)`` with ``mb = B /
    microbatch``, each scored by its own mean, as in JAX's one program.
    Where ``microbatch`` is a multiple of the group's size each slice lies
    whole on one rank, which runs its slices as the one-rank step does.
    Else a slice can straddle ranks (``_straddling_slices``)."""

    def train_step(params, opt_state, tokens, labels, extra=None,
                   group=None):
        D = _shards(group)
        B = tokens.shape[0]
        if microbatch > 1 and (B * D) % microbatch == 0:
            slices = (_straddling_slices if microbatch % D
                      else _whole_slices)
            grads, loss = _accumulate(params, slices(
                model, tokens, labels, extra, attn_impl, microbatch, group))
            grads = sum_grads(grads, group)
            loss = _sum_metrics({"loss": loss}, group)["loss"]
            grads = {k: g / microbatch for k, g in grads.items()}
            loss = loss / microbatch
            metrics = {"lm_loss": loss}
        else:
            (loss, metrics), grads = _grads(lambda leaves: lm_loss(
                model, leaves, tokens, labels, extra=extra,
                attn_impl=attn_impl, group=group), params)
            grads = sum_grads(grads, group)
            metrics = _sum_metrics(dict(metrics, loss=loss), group,
                                   keep=("n_tokens",))
            loss = metrics.pop("loss")
        updates, opt_state2 = optimizer.update(grads, opt_state, params)
        params2 = apply_updates(params, updates)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return params2, opt_state2, metrics

    return train_step


def _whole_slices(model, tokens, labels, extra, attn_impl,
                  microbatch: int, group):
    """The loss functions of the microbatch slices this rank holds whole
    (``microbatch`` a multiple of ``group``'s size), in order: each the
    one-rank ``lm_loss`` of its rows."""
    mb = tokens.shape[0] * _shards(group) // microbatch
    out = []
    for i in range(tokens.shape[0] // mb):
        sl = slice(i * mb, (i + 1) * mb)
        ex = None if extra is None else {k: v[sl] for k, v in extra.items()}
        out.append(lambda leaves, sl=sl, ex=ex: lm_loss(
            model, leaves, tokens[sl], labels[sl], extra=ex,
            attn_impl=attn_impl))
    return out


def _straddling_slices(model, tokens, labels, extra, attn_impl,
                       microbatch: int, group):
    """The loss functions of the microbatch slices this rank holds rows
    of, in order, where slices straddle the ranks of ``group``
    (``microbatch`` not a multiple of its size): every slice's global
    count of ``labels >= 0`` is summed over the group here, in one
    all-reduce; each function is this rank's part of a slice, on its rows
    of it, with the slice's global count as the denominator and the
    slice's own ``UpdateSplit`` (a moe dispatch group of the slice that
    straddles ranks moves between them, ``moe.moe_mlp``). A rank that
    holds no row of a slice computes nothing for it, and no transfer of
    the slice involves it."""
    D, me, B = _shards(group), dist.get_rank(group), tokens.shape[0]
    mb, first = B * D // microbatch, me * B
    # the rows each rank holds of each slice
    spans = [tuple(max(0, min((i + 1) * mb, (r + 1) * B)
                       - max(i * mb, r * B)) for r in range(D))
             for i in range(microbatch)]
    of_row = torch.div(torch.arange(first, first + B, device=labels.device),
                       mb, rounding_mode="floor")
    counts = torch.zeros((microbatch,), dtype=torch.float32,
                         device=labels.device).index_add_(
        0, of_row, (labels >= 0).float().sum(dim=1))
    dist.all_reduce(counts, group=group)
    out = []
    for i, rows in enumerate(spans):
        if not rows[me]:
            continue
        lo = max(i * mb, first) - first
        sl = slice(lo, lo + rows[me])
        ex = None if extra is None else {k: v[sl] for k, v in extra.items()}
        out.append(lambda leaves, sl=sl, ex=ex, i=i, rows=rows: _lm_loss(
            model, leaves, tokens[sl], labels[sl], ex, attn_impl,
            UpdateSplit(group, me, rows), n_tokens=counts[i]))
    return out


def _accumulate(params, losses):
    """The gradients of each of ``losses`` (functions of the param
    leaves) summed in f32, one after another, and their losses summed."""
    grads = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
             for k, v in params.items()}
    loss = None
    for fn in losses:
        (l_i, _), g = _grads(fn, params)
        for k in grads:
            grads[k] += g[k].float()
        loss = l_i.float() if loss is None else loss + l_i
    return grads, loss


def make_rl_train_step(model, optimizer: Optimizer, *, clip_eps: float = 0.0,
                       kl_coef: float = 0.0, is_rho_max: float = 0.0,
                       attn_impl: str = "xla"):
    """The Model Update stage: ``(params, opt_state, batch, extra=None,
    group=None) -> (params, opt_state, metrics)``, a policy-gradient step
    over an ``ExperienceBatch``. Predictions at position t score token
    t+1, so the per-token tensors are shifted by one inside.
    ``attn_impl``: "xla" or "flash" (the flash-attention kernels, forward
    and backward). ``group``: the module docstring's (``batch`` is this
    rank's rows). Metrics are 0-dim device tensors; reading them is the
    caller's host sync. ``train_step.grads_of(params, batch, extra=None,
    group=None)`` returns ``((loss, metrics), grads)``, the gradients the
    optimizer is given."""

    def grads_of(params, batch: ExperienceBatch, extra=None, group=None):
        def loss_fn(leaves):
            logits, aux = model.forward(
                leaves, batch.tokens, extra=extra, attn_impl=attn_impl,
                split=update_split(group, batch.tokens.shape[0]))
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
                is_rho_max=is_rho_max, group=group)
            if "aux_loss" in aux:
                loss = loss + aux["aux_loss"]
                metrics["aux_loss"] = aux["aux_loss"]
            return loss, metrics

        (loss, metrics), grads = _grads(loss_fn, params)
        grads = sum_grads(grads, group)
        metrics = _sum_metrics(dict(metrics, loss=loss), group)
        return (metrics.pop("loss"), metrics), grads

    def train_step(params, opt_state, batch: ExperienceBatch, extra=None,
                   group=None):
        (loss, metrics), grads = grads_of(params, batch, extra, group)
        updates, opt_state2 = optimizer.update(grads, opt_state, params)
        params2 = apply_updates(params, updates)
        metrics["loss"] = loss
        return params2, opt_state2, metrics

    train_step.grads_of = grads_of
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


def make_serve_step(model, *, attn_impl: str = "xla", tp=None):
    """One new token per row against a filled cache: ``(params, token,
    cache, extra=None) -> (next_tok (B,) int32, logits (B, V), cache)``,
    greedy (argmax). ``attn_impl``: the decode step's ("pallas", the
    split-K decode kernel, or "xla"). ``tp``: a rank's
    ``models.tensor_parallel.TPContext`` (the params are its shards, the
    cache holds its kv heads, the logits are its vocab shard, and the
    argmax the shard's)."""
    kw = {} if tp is None else {"tp": tp}

    def serve_step(params, token, cache, extra=None):
        with torch.no_grad():
            logits, cache2 = model.decode_step(params, token, cache,
                                               extra=extra,
                                               attn_impl=attn_impl, **kw)
        return logits.argmax(dim=-1).to(torch.int32), logits, cache2

    return serve_step


def make_prefill_step(model, *, attn_impl: str = "xla", tp=None):
    """``(params, tokens, cache, extra=None) -> (last-position logits,
    cache)``. ``attn_impl``: the prefill's ("flash" or "xla"). ``tp``: as
    ``make_serve_step``'s."""
    kw = {} if tp is None else {"tp": tp}

    def prefill_step(params, tokens, cache, extra=None):
        with torch.no_grad():
            return model.prefill(params, tokens, cache, extra=extra,
                                 attn_impl=attn_impl, **kw)

    return prefill_step
