"""AdamW (port of ``repro/optim/adamw.py``), the repo's own rather than
``torch.optim.AdamW``, whose weight decay, clipping and rounding order
differ.

    opt = adamw(lr_schedule, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                max_grad_norm=1.0)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Moments are f32 whatever the param dtype. The update is computed in f32,
cast to the param dtype, then added in the param dtype. Nothing is updated
in place: ``update`` and ``apply_updates`` return new tensors, so a caller
that keeps the old params (the trainer's reference model is the initial
params, aliased) still holds them unchanged.

Memory: ``init``'s zero moments are zero-stride views of one f32 zero, so
they hold no memory until the first update writes full moments, and
``update`` runs leaf by leaf, so only one leaf's f32 temporaries exist at
a time. The arithmetic is the same elementwise: a 3.4 B-parameter model
(granite-moe-3b-a800m) steps on one 80 GB card, where the whole-tree form
held the old and the new moments and an f32 copy of every gradient at
once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Union

import torch

from repro_torch.utils.tree import tree_global_norm


class OptState(NamedTuple):
    step: torch.Tensor               # () int32
    mu: Dict[str, torch.Tensor]      # first moment (f32)
    nu: Dict[str, torch.Tensor]      # second moment (f32)


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def adamw(learning_rate: Union[float, Callable], *, b1: float = 0.9,
          b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
          max_grad_norm: float = 1.0) -> Optimizer:
    lr_fn = learning_rate if callable(learning_rate) else (
        lambda _: learning_rate)

    def init(params) -> OptState:
        def zeros(p):
            return torch.zeros((), dtype=torch.float32,
                               device=p.device).expand(p.shape)
        dev = next(iter(params.values())).device
        return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                        mu={k: zeros(p) for k, p in params.items()},
                        nu={k: zeros(p) for k, p in params.items()})

    def update(grads, state: OptState, params):
        step = state.step + 1
        gnorm = tree_global_norm(grads)
        scale = (torch.clamp(max_grad_norm / (gnorm + 1e-9), max=1.0)
                 if max_grad_norm > 0 else None)
        sf = step.float()
        mu_hat_scale = 1.0 / (1 - b1 ** sf)
        nu_hat_scale = 1.0 / (1 - b2 ** sf)
        lr = lr_fn(step)
        mu, nu, updates = {}, {}, {}
        for k in grads:
            g = grads[k].float()
            if scale is not None:
                g = g * scale
            mu[k] = b1 * state.mu[k] + (1 - b1) * g
            nu[k] = b2 * state.nu[k] + (1 - b2) * g.square()
            del g
            p = params[k]
            u = (mu[k] * mu_hat_scale) / (torch.sqrt(nu[k] * nu_hat_scale)
                                          + eps)
            u = u + weight_decay * p.float()
            updates[k] = (-lr * u).to(p.dtype)
        return updates, OptState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update)


def apply_updates(params, updates):
    return {k: p + updates[k] for k, p in params.items()}
