"""Helpers over the port's trees (port of the parts of
``repro/utils/tree.py`` the optimizer, the dispatcher and the layouts
need). A tree is a tensor or a leaf object, a ``dict`` (keys walked in
sorted order, as JAX flattens dicts), or a tuple or list (NamedTuples such
as ``ExperienceBatch`` and the decode caches included); ``None`` is an
empty subtree, as in JAX."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    fields = getattr(tree, "_fields", None)
    if fields is not None:
        return list(zip(fields, tree))
    return [(str(i), v) for i, v in enumerate(tree)]


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def tree_flatten_with_names(tree, sep: str = "/") -> List[Tuple[str, Any]]:
    """``[(name, leaf)]`` with ``sep``-joined path names (NamedTuple field
    names, dict keys, list indices), in JAX's leaf order."""
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix):
        if node is None:
            return
        if not _is_node(node):
            out.append((prefix, node))
            return
        for key, child in _children(node):
            walk(child, f"{prefix}{sep}{key}" if prefix else key)

    walk(tree, "")
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_names(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); ``None`` stays ``None``."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    kids = [tree_map(fn, c, *(r[i] for r in rest))
            for i, c in enumerate(tree)]
    if getattr(tree, "_fields", None) is not None:
        return type(tree)(*kids)
    return type(tree)(kids)


def tree_map_with_names(fn: Callable, tree, sep: str = "/", prefix=""):
    """``fn(name, leaf)`` over the leaves of ``tree``, with the names of
    ``tree_flatten_with_names``; ``None`` stays ``None``."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(prefix, tree)
    join = lambda k: f"{prefix}{sep}{k}" if prefix else str(k)
    if isinstance(tree, dict):
        return {k: tree_map_with_names(fn, v, sep, join(k))
                for k, v in tree.items()}
    kids = [tree_map_with_names(fn, c, sep, join(k))
            for k, c in _children(tree)]
    if getattr(tree, "_fields", None) is not None:
        return type(tree)(*kids)
    return type(tree)(kids)


def tree_unflatten(template, leaves):
    """``template``'s structure with its leaves, in ``tree_leaves`` order,
    replaced by ``leaves``."""
    names = [name for name, _ in tree_flatten_with_names(template)]
    by_name = dict(zip(names, leaves))
    return tree_map_with_names(lambda name, _: by_name[name], template)


def tree_map_with_path(fn: Callable, tree):
    """``fn(key, leaf)`` over the leaves with '/'-joined keys (JAX's
    ``tree_map_with_path`` helper)."""
    return tree_map_with_names(fn, tree)


def tree_param_count(tree) -> int:
    """Total number of elements across all leaves."""
    return sum(x.numel() for x in tree_leaves(tree))


def tree_zeros_like(tree, dtype=None):
    """Zeros of each leaf's shape, in ``dtype`` (the leaf's own when
    None), on the leaf's device."""
    return tree_map(lambda x: torch.zeros(x.shape, dtype=dtype or x.dtype,
                                          device=x.device), tree)


def tree_size_bytes(tree) -> int:
    """Total bytes across all leaves: each tensor's elements times its
    dtype's item size (meta tensors count their shape)."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, summed leaf by
    leaf in sorted key order (the JAX tree's leaf order)."""
    return torch.sqrt(sum(tree[k].float().square().sum()
                          for k in sorted(tree)))
