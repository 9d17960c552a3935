"""Mesh splits and layout assembly (port of the part of
``repro/launch/mesh.py`` the dispatcher and the selector use):
``rollout_trainer_split``, ``_batch_spec`` and ``cache_shardings``. The production meshes, ``input_specs`` and
``stage_shardings`` belong to the dry run and are not ported (ROADMAP
Queue 1 item 12)."""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.core.resharding import MeshConfig, NamedLayout, world_size
from repro_torch.utils.tree import tree_map_with_names


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
    without one) both stages share rank 0.
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
