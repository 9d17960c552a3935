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
divide by its mesh axis is replicated, and the event is recorded when a
``fallbacks`` list is given. The test is on the flattened ``heads *
head_dim`` column, as JAX's is, so a model axis can cut a head in half
(qwen2-0.5b's 14 heads of 64 on a 4-way axis: 896 columns split into 224,
3.5 heads a rank). ``tp_plan`` is the head-granular plan the tensor-
parallel rollout runs on: it splits attention only by whole heads, and
``shard_params`` gives a rank its local tensors under it.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

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


@dataclass(frozen=True)
class TPPlan:
    """The head-granular tensor-parallel plan of one model on one
    ``MeshConfig``, for ``rank`` (its ``index`` on the model axis; None
    outside the mesh). Local counts are the same on every rank:

      - ``attn`` "split": q heads over ``model`` (``n_heads % tp == 0``),
        ``heads_local`` a rank; "replicated" otherwise (every rank runs
        all heads and the o-proj needs no all-reduce).
      - ``kv`` "split": kv heads over ``model`` (``n_kv_heads % tp ==
        0``); "grouped": each rank holds the one kv head its q heads read
        (q head ``h`` reads kv head ``h // group``: ``tp % n_kv_heads ==
        0``); "replicated" with replicated attention.
      - ``mlp_split`` when ``d_ff % tp == 0``; ``vocab_split`` when
        ``vocab % tp == 0`` (the embedding rows, or the untied head's
        columns, over ``model``).

    ``layouts`` maps each param path to the ``NamedLayout`` its local
    tensor is a shard of (what the data dispatcher moves into); a
    "grouped" kv leaf is replicated there and ``shard_params`` then keeps
    the rank's kv head. ``fallbacks`` records each part that replicates
    where ``param_shardings`` would split, and why."""

    mesh_config: MeshConfig
    rank: int
    index: Optional[int]
    tp: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    attn: str
    kv: str
    mlp_split: bool
    vocab_split: bool
    layouts: Dict[str, NamedLayout] = field(default_factory=dict)
    fallbacks: List[Tuple[str, str]] = field(default_factory=list)

    @property
    def heads_local(self) -> int:
        return self.n_heads // self.tp if self.attn == "split" \
            else self.n_heads

    @property
    def kv_local(self) -> int:
        if self.kv == "split":
            return self.n_kv_heads // self.tp
        return 1 if self.kv == "grouped" else self.n_kv_heads

    @property
    def d_ff_local(self) -> int:
        return self.d_ff // self.tp if self.mlp_split else self.d_ff

    @property
    def vocab_local(self) -> int:
        return self.vocab_size // self.tp if self.vocab_split \
            else self.vocab_size

    def index_of(self, rank: int) -> Optional[int]:
        """``rank``'s index on the model axis (None outside the mesh)."""
        ranks = self.mesh_config.ranks()
        hit = np.argwhere(ranks == rank)
        return int(hit[0][-1]) if len(hit) else None

    def vocab_offset(self, index: Optional[int] = None) -> int:
        """First global vocab row of the shard at ``index`` (this rank's
        by default)."""
        index = self.index if index is None else index
        return (index or 0) * self.vocab_local if self.vocab_split else 0

    def kv_head(self, index: Optional[int] = None) -> int:
        """Under ``kv="grouped"``: the global kv head the rank at
        ``index`` holds."""
        index = self.index if index is None else index
        return (index or 0) * self.n_kv_heads // self.tp


_KV_LEAVES = ("attn.wk", "attn.wv", "attn.bk", "attn.bv")


def tp_plan(model_or_cfg, mesh_cfg: MeshConfig,
            rank: Optional[int] = None) -> TPPlan:
    """The head-granular tp plan of a dense-family model (a ``Model``,
    whose ``defs`` name the leaves, or its ``ModelConfig``) on
    ``mesh_cfg``, for ``rank`` (this process's by default). See
    ``TPPlan`` for the rules."""
    cfg = getattr(model_or_cfg, "cfg", model_or_cfg)
    if cfg.family != "dense":
        raise ValueError(f"tp_plan covers the dense family; got "
                         f"{cfg.family!r}")
    from repro_torch.models import transformer
    defs = getattr(model_or_cfg, "defs", None) or transformer.model_defs(cfg)
    tp = mesh_cfg.tp
    H, KV, F, V = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size
    fallbacks: List[Tuple[str, str]] = []
    if tp == 1:
        attn, kv = "replicated", "replicated"
    elif H % tp:
        attn, kv = "replicated", "replicated"
        fallbacks.append(("attention", f"{H} q heads do not divide {tp} "
                                       f"ways"))
    elif KV % tp == 0:
        attn, kv = "split", "split"
    elif tp % KV == 0:
        attn, kv = "split", "grouped"
    else:
        # a rank's q heads would read parts of two kv heads unevenly
        attn, kv = "replicated", "replicated"
        fallbacks.append(("attention", f"{H // tp} q heads a rank read "
                                       f"{KV} kv heads unevenly"))
    mlp_split = tp > 1 and F % tp == 0
    vocab_split = tp > 1 and V % tp == 0
    if tp > 1 and not mlp_split:
        fallbacks.append(("mlp", f"d_ff {F} does not divide {tp} ways"))
    if tp > 1 and not vocab_split:
        fallbacks.append(("vocab", f"{V} rows do not divide {tp} ways"))
    split = {"heads": attn == "split", "kv_heads": kv == "split",
             "mlp": mlp_split, "vocab": vocab_split}
    layouts = {path: NamedLayout(mesh_cfg, tuple(
                   "model" if split.get(a or "", False) else None
                   for a in d.axes))
               for path, d in defs.items()}
    rank = current_rank() if rank is None else rank
    plan = TPPlan(mesh_cfg, rank, None, tp, H, KV, cfg.head_dim_, F, V,
                  attn, kv, mlp_split, vocab_split, layouts, fallbacks)
    return dataclasses.replace(plan, index=plan.index_of(rank))


class LocalParams(dict):
    """A rank's local param tensors under a ``TPPlan`` on
    ``mesh_config``: what the tensor-parallel engine runs on, told apart
    from a global tree of the same keys by its type."""

    def __init__(self, tensors, mesh_config: MeshConfig):
        super().__init__(tensors)
        self.mesh_config = mesh_config


def shard_params(params, plan: TPPlan, rank: Optional[int] = None,
                 device=None) -> LocalParams:
    """``rank``'s ``LocalParams`` (the plan's rank by default) of the global
    flat ``params``, contiguous, on ``device`` (the params' own when
    None): each leaf's ``NamedLayout.local_shard``, and under ``kv=
    "grouped"`` the kv head the rank's q heads read (a ``local_shard`` of
    the kv leaves over ``n_kv_heads`` ways). A rank outside the mesh gets
    meta tensors of the global shapes."""
    rank = plan.rank if rank is None else rank
    return finish_shards({path: plan.layouts[path].local_shard(x, rank)
                          for path, x in params.items()}, plan, rank,
                         device)


def finish_shards(tensors, plan: TPPlan, rank: Optional[int] = None,
                  device=None) -> LocalParams:
    """``LocalParams`` from each leaf's shard under ``plan.layouts`` (what
    ``NamedLayout.local_shard`` or the data dispatcher gives ``rank``):
    under ``kv="grouped"`` the kv leaves, whole there, keep the kv head
    the rank's q heads read; every tensor contiguous on ``device`` (its
    own when None); meta tensors pass as they are."""
    rank = plan.rank if rank is None else rank
    index = plan.index_of(rank)
    kv_cfg = MeshConfig("kv", dp=1, tp=plan.n_kv_heads)
    out = {}
    for path, local in tensors.items():
        if local.device.type == "meta":
            out[path] = local
            continue
        if index is not None and plan.kv == "grouped" \
                and path.endswith(_KV_LEAVES):
            spec = (None,) * (local.dim() - 1) + ("model",)
            local = NamedLayout(kv_cfg, spec).local_shard(
                local, plan.kv_head(index))
        out[path] = local.to(device or local.device).contiguous()
    return LocalParams(out, plan.mesh_config)


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

