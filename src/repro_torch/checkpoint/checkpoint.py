"""Checkpoints of the trainer's state (port of
``repro/checkpoint/checkpoint.py``), written with ``torch.save``.

Layout on disk, JAX's directory naming::

    <dir>/step_<n:08d>/state.pt     {"step": n, "leaves": {name: Tensor}}

A tree is nested dicts of tensors (the trainer's: the flat param dict, the
optimizer state as ``{"step", "mu", "nu"}``, the generator's state); a
leaf's name joins its keys with "/". Tensors keep their dtype (bf16
included). The file is written beside its final name and renamed into
place, so a step directory holds a whole checkpoint or none. Restore reads
with ``weights_only=True`` and checks every leaf of ``like`` by name,
shape and dtype.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

STATE_FILE = "state.pt"


def _named_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def save_checkpoint(directory: str, step: int, tree: Dict[str, Any]) -> str:
    """Write ``tree`` as step ``step``; returns the step directory."""
    path = _step_dir(directory, step)
    os.makedirs(path, exist_ok=True)
    leaves = dict(_named_leaves(tree))
    tmp = os.path.join(path, f"{STATE_FILE}.{os.getpid()}.tmp")
    torch.save({"step": int(step), "leaves": leaves}, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def restore_checkpoint(directory: str, step: int, like: Dict[str, Any],
                       map_location: Optional[Any] = None) -> Dict[str, Any]:
    """Read step ``step`` into the structure of ``like``. Leaves are loaded
    onto ``map_location`` (default: the CPU) and then moved to the device
    of their ``like`` leaf. A leaf missing from the file raises
    ``KeyError``; a shape or dtype that differs from ``like``'s raises
    ``ValueError``."""
    blob = torch.load(os.path.join(_step_dir(directory, step), STATE_FILE),
                      map_location=map_location or "cpu", weights_only=True)
    leaves = blob["leaves"]

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
        name = prefix[:-1]
        if name not in leaves:
            raise KeyError(f"checkpoint step {step} in {directory} has no "
                           f"leaf {name!r}")
        got = leaves[name]
        if got.shape != tree.shape or got.dtype != tree.dtype:
            raise ValueError(
                f"checkpoint leaf {name!r} is {tuple(got.shape)} "
                f"{got.dtype}, expected {tuple(tree.shape)} {tree.dtype}")
        return got.to(tree.device)
    return rebuild(like)


def latest_step(directory: str) -> Optional[int]:
    """The largest step with a whole checkpoint in ``directory``, or
    None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.isfile(os.path.join(directory, d, STATE_FILE)):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None
