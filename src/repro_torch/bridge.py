"""Bridge between the JAX package's param trees (as numpy) and the port.

The JAX model keeps its params as a nested dict whose layer leaves are
stacked on a leading ``layers`` axis; the port keeps the same leaves in a
flat ``{dotted.path: Tensor}`` dict (``models/param.py``). A tied head has
no ``lm_head`` leaf on either side: ``layers.unembed`` reads the ``(V, D)``
embedding table transposed, exactly as the JAX ``unembed`` does.

Inputs are numpy only (``np.asarray`` of each JAX leaf), so this module
imports neither JAX nor the JAX package. bfloat16 leaves arrive as
``ml_dtypes.bfloat16`` arrays and are moved bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def to_torch(x, device="cpu") -> torch.Tensor:
    """numpy array (or scalar) -> tensor on ``device``, bit-exact,
    including ``ml_dtypes.bfloat16`` arrays."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy, bit-exact; bfloat16 becomes ``ml_dtypes.bfloat16``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _flatten(tree: Any, prefix: str, out: Dict[str, Any]) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}.{k}" if prefix else str(k), out)
    else:
        out[prefix] = tree


def params_from_numpy(tree, device="cpu") -> Dict[str, torch.Tensor]:
    """Nested JAX param tree of numpy leaves -> flat ``{path: Tensor}``."""
    flat: Dict[str, Any] = {}
    _flatten(tree, "", flat)
    return {k: to_torch(v, device) for k, v in flat.items()}


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of ``params_from_numpy``: flat tensors -> nested numpy tree."""
    tree: Dict[str, Any] = {}
    for path, t in params.items():
        node = tree
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = to_numpy(t)
    return tree
