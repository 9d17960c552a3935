"""Helpers over the port's flat ``{dotted.path: Tensor}`` param dicts (port
of the part of ``repro/utils/tree.py`` the optimizer needs)."""
from __future__ import annotations

from typing import Dict

import torch


def tree_global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, summed leaf by
    leaf in sorted key order (the JAX tree's leaf order)."""
    return torch.sqrt(sum(tree[k].float().square().sum()
                          for k in sorted(tree)))
