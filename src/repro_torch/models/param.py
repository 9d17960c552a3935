"""Parameter definitions (port of ``repro/models/param.py``).

Models declare parameters as a flat ``{dotted.path: ParamDef}`` dict whose
keys are the JAX param tree's paths joined with dots (``layers.attn.wq``),
so a bridged JAX tree and a port-initialised one carry the same keys and
shapes. Layer parameters keep the stacked leading ``layers`` axis.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]     # logical axis names, len == ndim
    init: str = "normal"                # normal | zeros | ones | scaled
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")


def pdef(shape, axes, init="normal", scale=0.02) -> ParamDef:
    return ParamDef(tuple(shape), tuple(axes), init, scale)


def init_params(defs: Dict[str, ParamDef], generator: torch.Generator,
                device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Materialise ``defs`` with the JAX package's init kinds and shapes:
    ``normal`` draws N(0, scale²), ``scaled`` N(0, 1/fan_in) with fan_in
    the last-but-one dim, ``ones``/``zeros`` constants. Draws are f32 from
    ``generator`` (which must live on ``device``) in sorted key order, then
    cast to ``dtype``."""
    out = {}
    for name in sorted(defs):
        d = defs[name]
        if d.init == "zeros":
            t = torch.zeros(d.shape, dtype=dtype, device=device)
        elif d.init == "ones":
            t = torch.ones(d.shape, dtype=dtype, device=device)
        else:
            if d.init == "scaled":
                fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
                std = 1.0 / math.sqrt(max(fan_in, 1))
            else:
                std = d.scale
            t = torch.randn(d.shape, generator=generator, device=device,
                            dtype=torch.float32).mul_(std).to(dtype)
        out[name] = t
    return out
