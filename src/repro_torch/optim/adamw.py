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
        f32 = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()}
        dev = next(iter(params.values())).device
        return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                        mu=f32, nu={k: z.clone() for k, z in f32.items()})

    def update(grads, state: OptState, params):
        step = state.step + 1
        gnorm = tree_global_norm(grads)
        if max_grad_norm > 0:
            scale = torch.clamp(max_grad_norm / (gnorm + 1e-9), max=1.0)
            g = {k: grads[k].float() * scale for k in grads}
        else:
            g = {k: grads[k].float() for k in grads}
        mu = {k: b1 * state.mu[k] + (1 - b1) * g[k] for k in g}
        nu = {k: b2 * state.nu[k] + (1 - b2) * g[k].square() for k in g}
        sf = step.float()
        mu_hat_scale = 1.0 / (1 - b1 ** sf)
        nu_hat_scale = 1.0 / (1 - b2 ** sf)
        lr = lr_fn(step)
        updates = {}
        for k, p in params.items():
            u = (mu[k] * mu_hat_scale) / (torch.sqrt(nu[k] * nu_hat_scale)
                                          + eps)
            u = u + weight_decay * p.float()
            updates[k] = (-lr * u).to(p.dtype)
        return updates, OptState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update)


def apply_updates(params, updates):
    return {k: p + updates[k] for k, p in params.items()}
