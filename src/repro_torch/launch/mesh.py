"""Production meshes, mesh splits, input specs and layout assembly (port
of ``repro/launch/mesh.py``).

``make_production_mesh`` builds the target topology on a fake world
(``utils/cost.start_fake_world``): single-pod (16, 16) = 256 ranks with
("data", "model") axes, and the 2-pod (2, 16, 16) = 512-rank variant
with a leading "pod" axis that extends data parallelism.

``input_specs(arch, shape_name)`` returns fake tensors (shapes, dtypes,
no data) for every global input of the stage program that shape runs
(train, prefill or decode), so the 80-program dry run never allocates.

``stage_shardings`` maps those inputs onto a mesh with the port's own
layouts: the prefill and decode params by the head-granular ``tp_plan``
(its ``fallbacks`` say where it departs from JAX's flat-column
``param_shardings``), the train step's params and moments replicated on
every rank (the update runs whole on each rank of a model-axis row, its
rows split over the data rows, as GSPMD runs JAX's), batches over (pod,
data) by ``_batch_spec``, and caches by ``cache_shardings``.
``rollout_trainer_split`` partitions the ranks for the async schedule.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import (INPUT_SHAPES, InputShape, ModelConfig,
                                      get_config, with_sliding_window)
from repro_torch.core.resharding import (MeshConfig, NamedLayout, replicated,
                                         tp_plan, world_size)
from repro_torch.utils.tree import tree_map, tree_map_with_names

# Sub-quadratic long-context policy: the attention families decode
# long_500k with a sliding window over the cache.
LONG_CONTEXT_WINDOW = 8192


def production_mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    return MeshConfig(name="2x16x16" if multi_pod else "16x16",
                      dp=16, tp=16, pods=2 if multi_pod else 1)


def traced_rank(mesh_cfg: MeshConfig) -> int:
    """The rank whose program a trace of ``mesh_cfg`` counts: the first
    data row's last model rank. Where the model ranks run one program
    each on shards of one size, any rank would do; where a long sequence's
    queries split over the model axis (``models/layers.seq_parallel``),
    the last rank holds the last rows, which attend to the most keys under
    the causal mask, so its program sets the step."""
    return int(mesh_cfg.ranks().reshape(-1, mesh_cfg.tp)[0, -1])


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """The production ``DeviceMesh`` (16, 16) or (2, 16, 16) on a fake
    world of 256 or 512 ranks, this process its ``traced_rank`` (``utils/
    cost.start_fake_world``: a fake world of another size or rank is
    replaced, a real one refuses). ``device_type``: the fake tensors'
    (``utils/cost.trace_device()`` by default)."""
    from repro_torch.utils.cost import start_fake_world, trace_device
    cfg = production_mesh_config(multi_pod=multi_pod)
    start_fake_world(cfg.n_devices, rank=traced_rank(cfg))
    return cfg.make_mesh(device_type or trace_device())


def rollout_trainer_split(*, n_devices: Optional[int] = None,
                          rollout_frac: float = 0.5,
                          rollout_tp: int = 1, trainer_tp: int = 1
                          ) -> Tuple[MeshConfig, MeshConfig]:
    """Partition the ranks into disjoint (rollout, trainer) submeshes for
    the async schedule: Rollout(k+1) decodes on the first while Update(k)
    runs on the second, joined by the dispatcher's direct handoff.

    ``rollout_frac`` splits the device count; each side is factored as
    dp x tp with the requested TP degree, clamped to the side's share, so
    the two windows never overlap. Leftover ranks of a side stay idle. With
    one device (``n_devices`` defaults to the process group's size, 1
    without one) both stages share rank 0. The engine takes every rollout
    side: one dp row of ``rollout_tp`` ranks (e.g. ``n_devices=4,
    rollout_tp=2``) runs the tensor-parallel rollout, several rows (the
    default ``n_devices=4`` gives ``rollout-2x1``) the data-parallel one,
    and both at once for dp x tp.
    """
    n = n_devices if n_devices is not None else world_size()
    if n <= 1:
        cfg = lambda nm: MeshConfig(nm, dp=1, tp=1, device_offset=0)
        return cfg("rollout-0"), cfg("trainer-0")
    n_roll = min(max(int(round(n * rollout_frac)), 1), n - 1)
    n_train = n - n_roll

    def side(name: str, n_side: int, tp: int, offset: int) -> MeshConfig:
        tp = min(max(tp, 1), n_side)         # tp cannot exceed the share
        dp = n_side // tp
        return MeshConfig(f"{name}-{dp}x{tp}", dp=dp, tp=tp,
                          device_offset=offset)

    rollout = side("rollout", n_roll, rollout_tp, 0)
    trainer = side("trainer", n_train, trainer_tp, n_roll)
    return rollout, trainer


def batch_axes(mesh) -> Tuple[str, ...]:
    """The batch axes ("pod", "data") of a ``MeshConfig`` or a
    ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = mesh.axis_names()
    return tuple(a for a in ("pod", "data") if a in names)


def arch_config_for_shape(arch_id: str, shape: InputShape) -> ModelConfig:
    """The arch config, with the long-context policy: the attention
    families decode long_500k with a sliding window (the ssm and hybrid
    families run it natively, their state O(1) in context)."""
    cfg = get_config(arch_id)
    if (shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid")
            and cfg.sliding_window == 0):
        cfg = with_sliding_window(cfg, LONG_CONTEXT_WINDOW)
    return cfg


def full_opt_state(params):
    """AdamW's state after a step, as fakes: the step and f32 moments of
    each param's shape (``adamw``'s ``init`` holds zero-stride views until
    the first update writes full moments)."""
    from repro_torch.optim.adamw import OptState
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32,
                                device=p.device)
    dev = next(iter(params.values())).device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=tree_map(f32, params), nu=tree_map(f32, params))


def input_specs(arch_id: str, shape_name: str, device=None,
                remat: Optional[str] = None) -> Dict[str, Any]:
    """Every global input of the (arch, shape) stage program, as fake
    tensors in the active ``FakeTensorMode`` (or a new one):

        train:   {params, opt_state, tokens, labels, extra}
        prefill: {params, tokens, cache, extra}
        decode:  {params, token, cache, extra}

    plus ``kind`` and ``model``. ``device``: the fakes' (``utils/cost.
    trace_device()`` by default); ``remat`` overrides the config's."""
    from repro_torch.models.param import abstract_params
    from repro_torch.models.registry import build_model
    from repro_torch.utils.cost import fake_mode, trace_device
    device = device or trace_device()
    shape = INPUT_SHAPES[shape_name]
    cfg = arch_config_for_shape(arch_id, shape)
    if remat is not None:
        cfg = replace(cfg, remat=remat)
    model = build_model(cfg)
    B, S = shape.global_batch, shape.seq_len
    with fake_mode():
        params = abstract_params(model.defs, device=device)
        extra = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                 for k, v in model.input_extras(B).items()} or None
        tokens = lambda *s: torch.empty(s, dtype=torch.int32, device=device)
        out = {"kind": shape.kind, "model": model, "params": params,
               "extra": extra}
        if shape.kind == "train":
            out.update(opt_state=full_opt_state(params),
                       tokens=tokens(B, S), labels=tokens(B, S))
        elif shape.kind == "prefill":
            out.update(tokens=tokens(B, S),
                       cache=model.init_cache(B, S, device=device))
        else:
            out.update(token=tokens(B),
                       cache=model.init_cache(B, S, device=device))
    return out


def _batch_spec(mesh_cfg: MeshConfig, shape_or_ndim, *, batch_dim: int = 0
                ) -> NamedLayout:
    """Batch layout over (pod, data) with a divisibility fallback: a batch
    that does not divide replicates."""
    if isinstance(shape_or_ndim, int):
        dims, ndim = None, shape_or_ndim
    else:
        dims = tuple(shape_or_ndim)
        ndim = len(dims)
    spec: list = [None] * ndim
    ba = mesh_cfg.batch_axes()
    sizes = mesh_cfg.axis_sizes()
    size = 1
    for a in ba:
        size *= sizes[a]
    if dims is None or dims[batch_dim] % size == 0:
        spec[batch_dim] = ba if len(ba) > 1 else ba[0]
    return NamedLayout(mesh_cfg, tuple(spec))


def cache_shardings(cache, mesh_cfg: MeshConfig, *, seq_len: int,
                    n_kv_heads: int):
    """Per-leaf cache layouts by the leaves' attribute names and ranks.

    KV entries (rank 5: layers, B, S, KV, hd): batch -> data, then kv heads
    -> model when divisible, else seq -> model when divisible. Mamba
    ``conv`` (L, B, W, CH): CH -> model when divisible; ``ssm`` (L, B, H,
    P, N): H -> model when divisible, else P. ``pos`` (B,) -> data. Paged
    pools (L, pages, page_size, KV, hd) and their int8 ``k_scale``/
    ``v_scale`` (L, pages, page_size, KV): pages -> data, kv heads ->
    model; ``block_table`` rows -> data; ``refcount`` replicates. Returns
    the cache's structure with a ``NamedLayout`` per tensor.

    The port's pool carries a trash page past its ``n_pages`` (where JAX
    drops a write, the port writes there). In a data-parallel rollout each
    of the D data rows holds a pool of its own and its own trash page:
    ``min(n_pages, the row's full provisioning)`` pages, the row's full
    provisioning being ``pool_pages_needed_shared`` of its B/D slots (its
    own copy of the shared prefix run included), which is ``n_pages / D``
    at full provisioning and up to all ``n_pages`` under pressure. The
    allocator's decisions follow JAX's one global count of ``n_pages``
    (``rl/engine/compiled.py``); the pages themselves stay on the row. The
    pools laid end to end form the page axis, which splits over data with
    each rank's slice its own pool, trash page included, and each block
    table's entries index its row's pool.
    """
    del seq_len, n_kv_heads          # JAX's signature; the rules read shapes
    sizes = mesh_cfg.axis_sizes()
    tp = sizes.get("model", 1)
    ba = mesh_cfg.batch_axes()
    batch_entry = ba if len(ba) > 1 else ba[0]
    dp = 1
    for a in ba:
        dp *= sizes[a]
    paged = hasattr(cache, "block_table")

    def one(name: str, leaf) -> NamedLayout:
        nd = leaf.dim()
        shape = tuple(leaf.shape)
        spec: list = [None] * nd
        leafname = name.rsplit("/", 1)[-1]
        if leafname == "block_table":
            if shape[0] % dp == 0:
                spec[0] = batch_entry
            return NamedLayout(mesh_cfg, tuple(spec))
        if leafname == "refcount":
            return NamedLayout(mesh_cfg, tuple(spec))
        if nd >= 2 and shape[1] % dp == 0:
            # dense: dim 1 is the batch; paged pools: dim 1 is the page axis
            spec[1] = batch_entry
        if nd == 1 and shape[0] % dp == 0:           # pos (B,)
            spec[0] = batch_entry
        if paged and ((nd == 5 and leafname in ("k", "v"))
                      or (nd == 4 and leafname in ("k_scale", "v_scale"))):
            KV = shape[3]
            if KV % tp == 0 and KV >= tp:
                spec[3] = "model"
            return NamedLayout(mesh_cfg, tuple(spec))
        if nd == 5 and leafname in ("k", "v"):
            S, KV = shape[2], shape[3]
            if KV % tp == 0 and KV >= tp:
                spec[3] = "model"
            elif S % tp == 0 and S >= tp:
                spec[2] = "model"
        elif nd == 4 and leafname == "conv":
            if shape[3] % tp == 0:
                spec[3] = "model"
        elif nd == 5 and leafname == "ssm":
            if shape[2] % tp == 0 and shape[2] >= tp:
                spec[2] = "model"
            elif shape[3] % tp == 0 and shape[3] >= tp:
                spec[3] = "model"
        return NamedLayout(mesh_cfg, tuple(spec))

    return tree_map_with_names(one, cache)


def stage_shardings(specs: Dict[str, Any], mesh_cfg: MeshConfig, *,
                    fallbacks=None) -> Dict[str, Any]:
    """The port's layouts of ``input_specs``' tensors on ``mesh_cfg``
    (the same keys but "kind" and "model", plus "plan"):

      - train: params and the moments replicated (every rank runs the
        whole update; its batch rows split over the data rows);
      - prefill and decode: params by ``tp_plan`` (the dense, moe, ssm and
        hybrid families; "plan" holds it) and replicated for the audio and
        vlm families, which run no tensor parallelism;
      - tokens, labels, token and extra by ``_batch_spec``; the cache by
        ``cache_shardings``.

    ``fallbacks`` (a list) receives each departure from JAX's flat-column
    layouts: the plan's own, and the families it does not cover. The
    port shards no param over the data axis, so JAX's ``fsdp`` and
    ``rules`` options have no counterpart. "plan" is the mesh's
    ``traced_rank``'s."""
    model = specs["model"]
    fallbacks = [] if fallbacks is None else fallbacks
    rep = lambda tree: tree_map(lambda _: replicated(mesh_cfg), tree)
    out: Dict[str, Any] = {"plan": None}
    kind = specs["kind"]
    if kind == "train":
        out["params"] = rep(specs["params"])
        out["opt_state"] = rep(specs["opt_state"])
        if mesh_cfg.tp > 1:
            fallbacks.append(("update", f"params and moments replicated "
                                        f"over model ({mesh_cfg.tp} ranks)"))
        for k in ("tokens", "labels"):
            out[k] = _batch_spec(mesh_cfg, specs[k].shape)
    else:
        if model.cfg.family in ("audio", "vlm"):
            out["params"] = rep(specs["params"])
            if mesh_cfg.tp > 1:
                fallbacks.append(("family", f"{model.cfg.family}: no tp "
                                            f"plan, replicated over model"))
        else:
            plan = tp_plan(model, mesh_cfg, rank=traced_rank(mesh_cfg))
            out["plan"] = plan
            out["params"] = dict(plan.layouts)
            fallbacks.extend(plan.fallbacks)
        tok = "tokens" if kind == "prefill" else "token"
        out[tok] = _batch_spec(mesh_cfg, specs[tok].shape)
        out["cache"] = cache_shardings(specs["cache"], mesh_cfg, seq_len=0,
                                       n_kv_heads=model.cfg.n_kv_heads)
    if specs.get("extra"):
        out["extra"] = {k: _batch_spec(mesh_cfg, v.shape)
                        for k, v in specs["extra"].items()}
    out["fallbacks"] = fallbacks
    return out
