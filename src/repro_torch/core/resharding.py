"""Mesh configs, logical-to-physical layout rules and live resharding (port
of ``repro/core/resharding.py``).

This is the substrate the Parallelism Selector acts on: a ``MeshConfig``
names a (pod, data, model) factorization of a window of ranks of the
process group, one rank per device. A ``NamedLayout`` (the counterpart of
JAX's ``NamedSharding``) places a tensor on such a mesh with a spec of plain
tuples: one entry per tensor dim, ``None`` (replicated), a mesh axis name,
or a tuple of axis names that split the dim together, major to minor.
``devices_indices_map`` gives each rank's slices exactly as JAX computes
them, in pure Python; ``placements`` gives the ``DTensor`` placements that
execute the layout on a ``DeviceMesh``.

Sharding rules keep the divisibility fallback: a tensor dim that does not
divide by its mesh axis is replicated (qwen2's 14 heads on a 4-way model
axis), and the event is recorded when a ``fallbacks`` list is given.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.utils.tree import tree_map, tree_size_bytes

# logical axis -> preferred mesh axis. "data" entries are the FSDP
# dimension; "model" entries are the TP dimension.
DEFAULT_RULES: Dict[str, Optional[str]] = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "expert_mlp": "model",
    "experts": "model",
    "embed": "data",
    "ssm_inner": "model",
    "ssm_heads": None,
    "layers": None,
}


def world_size() -> int:
    """Ranks of the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def current_rank() -> int:
    """This process's rank in the default process group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


@dataclass(frozen=True)
class MeshConfig:
    """A named factorization of ranks ``[device_offset, device_offset +
    n_devices)`` into (pod, data, model). Two configs with disjoint windows
    form disjoint submeshes of one process group, which is how the async
    schedule places the Rollout and Update stages on separate devices
    (``launch.mesh.rollout_trainer_split``)."""

    name: str
    dp: int
    tp: int
    pods: int = 1
    fsdp: bool = True          # shard "embed" dims over the data axis
    device_offset: int = 0     # first rank of the window

    @property
    def n_devices(self) -> int:
        return self.pods * self.dp * self.tp

    def axis_names(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.pods > 1 else ("data",
                                                               "model")

    def shape(self) -> Tuple[int, ...]:
        return ((self.pods, self.dp, self.tp) if self.pods > 1
                else (self.dp, self.tp))

    def batch_axes(self) -> Tuple[str, ...]:
        return ("pod", "data") if self.pods > 1 else ("data",)

    def axis_sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names(), self.shape()))

    def ranks(self) -> np.ndarray:
        """The window's ranks, reshaped row-major to the mesh shape."""
        return (self.device_offset
                + np.arange(self.n_devices)).reshape(self.shape())

    def make_mesh(self, device_type: Optional[str] = None):
        """A ``DeviceMesh`` over the window, axis names ``axis_names()``.
        Collective over the default process group: every rank calls it, in
        the same order, also the ranks outside the window (their
        ``get_coordinate()`` is None). ``device_type`` None means the GPU,
        as the port's entry points do (``"cpu"`` for gloo)."""
        lo, hi = self.device_offset, self.device_offset + self.n_devices
        n = world_size()
        if n < hi:
            raise ValueError(
                f"MeshConfig {self.name!r} wants devices [{lo}, {hi}) but "
                f"only {n} are visible (ranks of the process group)")
        if not dist.is_initialized():
            raise RuntimeError("make_mesh needs an initialized process "
                               "group (torch.distributed.init_process_group)")
        from torch.distributed.device_mesh import DeviceMesh
        if device_type is None:
            device_type = resolve_device(None).type
        return DeviceMesh(device_type,
                          torch.as_tensor(self.ranks(), dtype=torch.int64),
                          mesh_dim_names=self.axis_names())


def local_mesh_config() -> MeshConfig:
    """The one-device mesh of this process's own rank: the layout of a
    tensor that lies on this rank alone (JAX's single-device sharding)."""
    return MeshConfig("local", dp=1, tp=1, device_offset=current_rank())


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _norm_entry(entry):
    """As ``PartitionSpec`` does: a one-axis tuple is that axis, an empty
    one None."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return entry[0] if len(entry) == 1 else (entry or None)
    return entry


@dataclass(frozen=True)
class NamedLayout:
    """A tensor's placement on a ``MeshConfig``: ``spec`` has one entry per
    leading tensor dim (missing trailing entries replicate)."""

    mesh_config: MeshConfig
    spec: Tuple = ()

    def __post_init__(self):
        spec = tuple(_norm_entry(e) for e in self.spec)
        object.__setattr__(self, "spec", spec)
        names, used = self.mesh_config.axis_names(), set()
        for e in spec:
            for a in _entry_axes(e):
                if a not in names:
                    raise ValueError(f"axis {a!r} of spec {spec} is not a "
                                     f"mesh axis {names}")
                if a in used:
                    raise ValueError(f"axis {a!r} used twice in {spec}")
                used.add(a)

    def entry(self, dim: int):
        return self.spec[dim] if dim < len(self.spec) else None

    def shards(self, dim: int) -> int:
        """How many ways tensor dim ``dim`` is split."""
        sizes = self.mesh_config.axis_sizes()
        return math.prod(sizes[a] for a in _entry_axes(self.entry(dim)))

    def global_shape(self, local_shape) -> Tuple[int, ...]:
        """The global shape of which ``local_shape`` is one shard."""
        return tuple(int(n) * self.shards(d)
                     for d, n in enumerate(local_shape))

    def devices_indices_map(self, shape) -> Dict[int, Tuple[slice, ...]]:
        """rank -> the tuple of slices of a ``shape`` tensor that rank
        holds, as JAX's ``NamedSharding.devices_indices_map`` gives them:
        an unsplit dim is ``slice(None)``, a dim split n ways over axes
        (a0, a1, ...) takes chunk ``(c[a0] * size[a1] + c[a1]) ...`` of n,
        and a dim that does not divide raises."""
        shape = tuple(int(n) for n in shape)
        cfg = self.mesh_config
        sizes, names = cfg.axis_sizes(), cfg.axis_names()
        for d, n in enumerate(shape):
            k = self.shards(d)
            if k > 1 and n % k:
                raise ValueError(
                    f"layout {self.spec} splits dim {d} of {shape} {k} ways,"
                    f" which does not divide it")
        ranks = cfg.ranks()
        out: Dict[int, Tuple[slice, ...]] = {}
        for coord in np.ndindex(*cfg.shape()):
            at = dict(zip(names, coord))
            idx = []
            for d, n in enumerate(shape):
                axes = _entry_axes(self.entry(d))
                k = self.shards(d)
                if k == 1:
                    idx.append(slice(None, None, None))
                    continue
                i = 0
                for a in axes:
                    i = i * sizes[a] + at[a]
                c = n // k
                idx.append(slice(i * c, (i + 1) * c, None))
            out[int(ranks[coord])] = tuple(idx)
        return out

    def placements(self) -> list:
        """The ``DTensor`` placements of the layout, one per mesh dim:
        ``Shard(d)`` where tensor dim d is split over that axis, else
        ``Replicate()``. A dim split over several axes must name them in
        mesh order (DTensor splits mesh dim 0 first, major)."""
        from torch.distributed.tensor import Replicate, Shard
        names = self.mesh_config.axis_names()
        out = [Replicate() for _ in names]
        for d, e in enumerate(self.spec):
            axes = _entry_axes(e)
            pos = [names.index(a) for a in axes]
            if pos != sorted(pos):
                raise ValueError(f"DTensor splits a dim over mesh axes in "
                                 f"mesh order; spec entry {e} is not")
            for p in pos:
                out[p] = Shard(d)
        return out

    def local_shard(self, x: torch.Tensor, rank: Optional[int] = None):
        """``rank``'s shard of the global tensor ``x`` (this rank's by
        default); a meta tensor of the global shape on a rank outside the
        mesh."""
        rank = current_rank() if rank is None else rank
        idx = self.devices_indices_map(x.shape).get(rank)
        if idx is None:
            return torch.empty(x.shape, dtype=x.dtype, device="meta")
        return x[idx]


def _axis_size(mesh_cfg: MeshConfig, axis: Optional[str]) -> int:
    if axis is None:
        return 1
    return mesh_cfg.axis_sizes().get(axis, 1)


def logical_to_physical(shape, logical_axes, mesh_cfg: MeshConfig,
                        rules: Optional[Dict[str, Optional[str]]] = None,
                        *, fsdp: bool = True,
                        fallbacks: Optional[list] = None) -> NamedLayout:
    """Map a tensor's logical axes to a layout on ``mesh_cfg``.

    Divisibility fallback: if dim % axis_size != 0, the dim replicates and
    the (axes, dim, axis) triple is appended to ``fallbacks`` if given.
    """
    rules = dict(DEFAULT_RULES if rules is None else rules)
    if not fsdp:
        rules["embed"] = None
    names = mesh_cfg.axis_names()
    spec: list = []
    used = set()
    for dim, lax_name in zip(shape, logical_axes):
        target = rules.get(lax_name) if lax_name else None
        if target is None or target not in names:
            spec.append(None)
            continue
        size = _axis_size(mesh_cfg, target)
        if size <= 1 or dim % size != 0 or target in used:
            if fallbacks is not None and size > 1 and dim % size != 0:
                fallbacks.append((tuple(logical_axes), dim, target))
            spec.append(None)
            continue
        used.add(target)
        spec.append(target)
    return NamedLayout(mesh_cfg, tuple(spec))


def param_shardings(defs_or_model, mesh_cfg: MeshConfig, *, rules=None,
                    fsdp=True, fallbacks=None) -> Dict[str, NamedLayout]:
    """The port's flat ``{path: ParamDef}`` dict (or a Model) -> the same
    keys mapped to layouts."""
    defs = getattr(defs_or_model, "defs", defs_or_model)
    return {k: logical_to_physical(d.shape, d.axes, mesh_cfg, rules,
                                   fsdp=fsdp, fallbacks=fallbacks)
            for k, d in defs.items()}


def batch_sharding(mesh_cfg: MeshConfig, ndim: int, *, batch_dim: int = 0,
                   seq_dim: Optional[int] = None,
                   seq_axis: Optional[str] = None) -> NamedLayout:
    """Shard the batch dim over (pod, data); optionally the sequence dim
    over ``seq_axis``."""
    axes: list = [None] * ndim
    axes[batch_dim] = mesh_cfg.batch_axes()
    if seq_dim is not None and seq_axis is not None:
        axes[seq_dim] = seq_axis
    return NamedLayout(mesh_cfg, tuple(axes))


def replicated(mesh_cfg: MeshConfig) -> NamedLayout:
    return NamedLayout(mesh_cfg, ())


def _same_mesh(mesh, cfg: MeshConfig) -> bool:
    return (tuple(mesh.mesh_dim_names or ()) == cfg.axis_names()
            and mesh.mesh.tolist() == cfg.ranks().tolist())


def reshard(tree, layouts):
    """Re-lay every ``DTensor`` leaf of ``tree`` out as the matching
    ``NamedLayout`` of ``layouts`` through ``DTensor.redistribute``
    (collective over the leaf's mesh). Both layouts must lie on the same
    mesh; between meshes, move local shards with
    ``DataDispatcher.dispatch_direct``."""
    def one(x, layout: NamedLayout):
        mesh = x.device_mesh
        if not _same_mesh(mesh, layout.mesh_config):
            raise ValueError(
                f"reshard stays on one mesh: the tensor lies on "
                f"{mesh.mesh.tolist()}, the layout on "
                f"{layout.mesh_config.ranks().tolist()}; use "
                f"DataDispatcher.dispatch_direct between meshes")
        return x.redistribute(mesh, layout.placements())
    return tree_map(one, tree, layouts)


def reshard_bytes_moved(tree, src_cfg: MeshConfig, dst_cfg: MeshConfig) \
        -> int:
    """Analytic bytes moved by a config switch: 0 when the (dp, tp)
    factorization is unchanged, else every byte of ``tree`` (upper bound:
    a TP-degree change moves every param)."""
    if (src_cfg.dp, src_cfg.tp) == (dst_cfg.dp, dst_cfg.tp):
        return 0
    return tree_size_bytes(tree)

