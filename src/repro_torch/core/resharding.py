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
``shard_params`` gives a rank its local tensors under it (the dense, moe,
ssm and hybrid families).
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
        all heads and the o-proj needs no all-reduce), and for a family
        without attention.
      - ``kv`` "split": kv heads over ``model`` (``n_kv_heads % tp ==
        0``); "grouped": each rank holds the one kv head its q heads read
        (q head ``h`` reads kv head ``h // group``: ``tp % n_kv_heads ==
        0``); "replicated" with replicated attention.
      - ``mlp_split`` when the family has a dense MLP (dense, and the
        hybrid's shared block) and ``d_ff % tp == 0``; ``vocab_split``
        when ``vocab % tp == 0`` (the embedding rows, or the untied head's
        columns, over ``model``).
      - moe: the router is replicated (every rank routes every token, so
        the capacity slots and drops agree); ``experts`` "split": whole
        experts over ``model`` (``n_experts % tp == 0``); "mlp": every
        expert's ``d_ff_expert`` columns, as the dense MLP's, where only
        that divides; "replicated" where neither does.
      - ssm (and the hybrid's Mamba layers): ``ssm_split`` puts whole SSM
        heads over ``model`` (``ssm.n_heads % tp == 0``); the B and C
        groups split with them only where ``n_groups % tp == 0``, else
        every rank keeps all of them. ``A_log``, ``D``, ``dt_bias``,
        ``norm_w`` and ``out_proj``'s rows split by head. ``in_proj``
        (``z | x | B | C | dt``) and the conv (``x | B | C``) are
        concatenations whose rank part is not one slice: they travel
        whole and ``finish_shards`` keeps the rank's columns
        (``ssm_columns``).

    ``layouts`` maps each param path to the ``NamedLayout`` its local
    tensor is a shard of (what the data dispatcher moves into); a
    "grouped" kv leaf and the concatenated SSM leaves are replicated there
    and ``shard_params`` then cuts them. ``fallbacks`` records each part
    that replicates (or splits another way) where ``param_shardings``
    would split, and why."""

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
    experts: str = "replicated"
    n_experts: int = 0
    d_ff_expert: int = 0
    ssm_split: bool = False
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_groups: int = 0
    ssm_state: int = 0

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

    @property
    def experts_local(self) -> int:
        return self.n_experts // self.tp if self.experts == "split" \
            else self.n_experts

    @property
    def d_ff_expert_local(self) -> int:
        return self.d_ff_expert // self.tp if self.experts == "mlp" \
            else self.d_ff_expert

    @property
    def ssm_groups_split(self) -> bool:
        return self.ssm_split and self.ssm_groups % self.tp == 0

    @property
    def ssm_heads_local(self) -> int:
        return self.ssm_heads // self.tp if self.ssm_split \
            else self.ssm_heads

    @property
    def ssm_groups_local(self) -> int:
        return self.ssm_groups // self.tp if self.ssm_groups_split \
            else self.ssm_groups

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

    def expert_offset(self, index: Optional[int] = None) -> int:
        """First global expert of the rank at ``index`` (this rank's by
        default)."""
        index = self.index if index is None else index
        return ((index or 0) * self.experts_local
                if self.experts == "split" else 0)

    def kv_head(self, index: Optional[int] = None) -> int:
        """Under ``kv="grouped"``: the global kv head the rank at
        ``index`` holds."""
        index = self.index if index is None else index
        return (index or 0) * self.n_kv_heads // self.tp

    def ssm_columns(self, index: Optional[int] = None, *,
                    proj: bool = True) -> torch.Tensor:
        """The columns the rank at ``index`` keeps of a concatenated SSM
        leaf: its heads' ``x`` columns and its groups' ``B`` and ``C`` of
        the conv's ``x | B | C`` (``proj=False``), and also its heads'
        ``z`` and ``dt`` of ``in_proj``'s ``z | x | B | C | dt``."""
        index = (self.index if index is None else index) or 0
        P, N = self.ssm_head_dim, self.ssm_state
        H, G = self.ssm_heads_local, self.ssm_groups_local
        di, gn = self.ssm_heads * P, self.ssm_groups * N
        h0 = index * H if self.ssm_split else 0
        g0 = index * G if self.ssm_groups_split else 0
        x = torch.arange(h0 * P, (h0 + H) * P)
        bc = torch.arange(g0 * N, (g0 + G) * N)
        conv = [x, bc + di, bc + di + gn]
        if not proj:
            return torch.cat(conv)
        return torch.cat([x] + [t + di for t in conv]
                         + [torch.arange(h0, h0 + H) + 2 * di + 2 * gn])

    def kept_fraction(self, path: str) -> float:
        """The share of the leaf ``path``'s carried shard (its
        ``layouts`` shard) that ``finish_shards`` keeps."""
        if self.kv == "grouped" and path.endswith(_KV_LEAVES):
            return 1.0 / self.n_kv_heads
        if self.ssm_split and path.endswith(_SSM_CAT_LEAVES):
            proj = path.endswith("in_proj")
            di = self.ssm_heads * self.ssm_head_dim
            whole = (di + 2 * self.ssm_groups * self.ssm_state
                     + (di + self.ssm_heads if proj else 0))
            return len(self.ssm_columns(proj=proj)) / whole
        return 1.0


_KV_LEAVES = ("attn.wk", "attn.wv", "attn.bk", "attn.bv")
# concatenations whose rank part is not one slice: carried whole
_SSM_CAT_LEAVES = ("mixer.in_proj", "mixer.conv_w", "mixer.conv_b")
# replicated whatever their axes say: every rank routes every token
_REPLICATED_LEAVES = ("moe.router",)
_TP_FAMILIES = ("dense", "moe", "ssm", "hybrid")


# The shortest sequence whose queries split over the model axis where the
# plan replicates attention (``models/layers.seq_parallel``): JAX's
# threshold, below which its reshards cost more than the split of the
# scores saves.
SEQ_PARALLEL_MIN_S = 16384


def _attention_rule(H: int, KV: int, tp: int, fallbacks: list):
    """Replicated attention splits its queries by sequence from
    ``SEQ_PARALLEL_MIN_S`` tokens (``models/layers.seq_parallel``); the
    fallback says so."""
    seq = (f": replicated, its queries split by sequence from "
           f"{SEQ_PARALLEL_MIN_S} tokens")
    if tp == 1 or H == 0:
        return "replicated", "replicated"
    if H % tp:
        fallbacks.append(("attention", f"{H} q heads do not divide {tp} "
                                       f"ways{seq}"))
        return "replicated", "replicated"
    if KV % tp == 0:
        return "split", "split"
    if tp % KV == 0:
        return "split", "grouped"
    # a rank's q heads would read parts of two kv heads unevenly
    fallbacks.append(("attention", f"{H // tp} q heads a rank read {KV} kv "
                                   f"heads unevenly{seq}"))
    return "replicated", "replicated"


def _experts_rule(E: int, F: int, tp: int, fallbacks: list) -> str:
    if tp == 1 or E == 0:
        return "replicated"
    if E % tp == 0:
        return "split"
    if F % tp == 0:
        fallbacks.append(("experts", f"{E} experts do not divide {tp} ways:"
                                     f" each expert's d_ff_expert {F} "
                                     f"splits instead"))
        return "mlp"
    fallbacks.append(("experts", f"neither {E} experts nor d_ff_expert {F}"
                                 f" divide {tp} ways"))
    return "replicated"


def tp_plan(model_or_cfg, mesh_cfg: MeshConfig,
            rank: Optional[int] = None) -> TPPlan:
    """The head-granular tp plan of a model of the dense, moe, ssm or
    hybrid family (a ``Model``, whose ``defs`` name the leaves, or its
    ``ModelConfig``) on ``mesh_cfg``, for ``rank`` (this process's by
    default). See ``TPPlan`` for the rules."""
    cfg = getattr(model_or_cfg, "cfg", model_or_cfg)
    if cfg.family not in _TP_FAMILIES:
        raise ValueError(f"tp_plan covers the {', '.join(_TP_FAMILIES)} "
                         f"families; got {cfg.family!r}")
    defs = getattr(model_or_cfg, "defs", None)
    if defs is None:
        from repro_torch.models.registry import build_model
        defs = build_model(cfg).defs
    tp = mesh_cfg.tp
    fam = cfg.family
    H, KV, V = cfg.n_heads, cfg.n_kv_heads, cfg.vocab_size
    F = cfg.d_ff if fam in ("dense", "hybrid") else 0
    fallbacks: List[Tuple[str, str]] = []
    attn, kv = _attention_rule(H if fam != "ssm" else 0, KV, tp, fallbacks)
    mlp_split = tp > 1 and F > 0 and F % tp == 0
    if tp > 1 and F > 0 and not mlp_split:
        fallbacks.append(("mlp", f"d_ff {F} does not divide {tp} ways"))
    E, Fe = (cfg.moe.n_experts, cfg.moe.d_ff_expert) if fam == "moe" \
        else (0, 0)
    experts = _experts_rule(E, Fe, tp, fallbacks)
    s = cfg.ssm if fam in ("ssm", "hybrid") else None
    ssm_split = s is not None and tp > 1 and s.n_heads % tp == 0
    if s is not None and tp > 1 and not ssm_split:
        fallbacks.append(("ssm", f"{s.n_heads} SSM heads do not divide {tp}"
                                 f" ways"))
    vocab_split = tp > 1 and V % tp == 0
    if tp > 1 and not vocab_split:
        fallbacks.append(("vocab", f"{V} rows do not divide {tp} ways"))
    split = {"heads": attn == "split", "kv_heads": kv == "split",
             "mlp": mlp_split, "vocab": vocab_split,
             "experts": experts == "split", "expert_mlp": experts == "mlp",
             "ssm_heads": ssm_split, "ssm_inner": ssm_split}
    whole = _SSM_CAT_LEAVES + _REPLICATED_LEAVES
    layouts = {path: NamedLayout(mesh_cfg, tuple(
                   "model" if split.get(a or "", False)
                   and not path.endswith(whole) else None
                   for a in d.axes))
               for path, d in defs.items()}
    rank = current_rank() if rank is None else rank
    plan = TPPlan(
        mesh_cfg, rank, None, tp, H, KV, cfg.head_dim_ if H else 0, F, V,
        attn, kv, mlp_split, vocab_split, layouts, fallbacks, experts, E,
        Fe, ssm_split, *((s.n_heads, s.head_dim, s.n_groups, s.state_size)
                         if s is not None else (0, 0, 0, 0)))
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
    out = {}
    for path, local in tensors.items():
        if local.device.type == "meta":
            out[path] = local
            continue
        if index is not None and plan.kv == "grouped" \
                and path.endswith(_KV_LEAVES):
            kv_cfg = MeshConfig("kv", dp=1, tp=plan.n_kv_heads)
            spec = (None,) * (local.dim() - 1) + ("model",)
            local = NamedLayout(kv_cfg, spec).local_shard(
                local, plan.kv_head(index))
        if index is not None and plan.ssm_split \
                and path.endswith(_SSM_CAT_LEAVES):
            cols = plan.ssm_columns(index,
                                    proj=path.endswith("in_proj"))
            local = local.index_select(-1, cols.to(local.device))
        out[path] = local.to(device or local.device).contiguous()
    return LocalParams(out, plan.mesh_config)


def shard_bytes(params, plan: TPPlan, rank: Optional[int] = None):
    """``(carried, kept)``: the bytes of the global flat ``params`` that
    ``rank`` (the plan's by default) receives under ``plan.layouts`` (what
    the data dispatcher moves to it) and the bytes of its ``LocalParams``
    after ``finish_shards``. They differ by the leaves that travel whole
    (the grouped kv leaves and the concatenated SSM leaves)."""
    rank = plan.rank if rank is None else rank
    carried = kept = 0
    for path, x in params.items():
        idx = plan.layouts[path].devices_indices_map(x.shape).get(rank)
        if idx is None:
            continue
        n = x[idx].numel() * x.element_size()
        carried += n
        kept += round(n * plan.kept_fraction(path))
    return carried, kept


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

