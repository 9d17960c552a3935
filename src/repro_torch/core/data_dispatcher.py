"""Data Dispatcher (port of ``repro/core/data_dispatcher.py``; paper §2,
Fig. 2 ③④⑤).

Experience batches move between RL stages whose layouts differ. Each rank
holds its local shard of every leaf under a source ``NamedLayout``; a rank
outside the source mesh passes a meta tensor of the leaf's global shape
(shape and dtype only, JAX's ``ShapeDtypeStruct``), and gets one back for
every leaf whose destination mesh it is outside. Two strategies:

  - **centralized** (the single-controller baseline): every distinct
    source shard goes to the ``controller`` rank, which assembles the
    global batch, copies it to the host and back (``.cpu()``, as
    ``jax.device_get`` does), and scatters each destination shard from
    there.
  - **direct** (EARL): a layout-aware point-to-point exchange
    (``dist.batch_isend_irecv``). Each rank that lacks part of its
    destination shard receives exactly that part from the part's
    canonical owner, the lowest rank that holds it. It works across
    disjoint meshes (``launch.mesh.rollout_trainer_split``), which
    ``DTensor.redistribute`` cannot cross, and must be called on every
    rank of the union of the two meshes. Same-mesh re-splits inside a
    stage use ``all_to_all_resplit``.

Every multi-rank call is collective over the default process group, whose
ranks the layouts name. On one device, with no process group, both
strategies run with no peers.

The **movement plan** comes from the source and destination index maps:
per-rank send and receive bytes, whose maximum is the bottleneck link's
traffic. ``estimate_latency`` turns a plan into seconds at a link rate:
the paper's 25 Gbps Ethernet testbed, or NVLink on an H100 SXM.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.resharding import (NamedLayout, current_rank,
                                         local_mesh_config, replicated)
from repro_torch.utils.tree import tree_leaves, tree_unflatten

# The paper's testbed transport (§3.3): TCP over 25 Gbps Ethernet.
ETHERNET_BW = 25e9 / 8          # 25 Gbps -> bytes/s
# NVLink 4 on an H100 SXM: 900 GB/s per GPU in total, 450 GB/s each way
# (NVIDIA's published figure); a plan's bottleneck is one direction.
NVLINK_BW = 450e9


# ---------------------------------------------------------------------------
# Movement plans
# ---------------------------------------------------------------------------

@dataclass
class MovementPlan:
    """Per-rank send/recv bytes for one tensor's layout change."""

    total_bytes: int                       # bytes that change owner
    send_bytes: Dict[int, int]             # rank -> bytes sent
    recv_bytes: Dict[int, int]             # rank -> bytes received

    @property
    def bottleneck_bytes(self) -> int:
        """Max bytes through any single rank (the serializing link)."""
        vals = list(self.send_bytes.values()) + list(self.recv_bytes.values())
        return max(vals) if vals else 0

    def merge(self, other: "MovementPlan") -> "MovementPlan":
        send = dict(self.send_bytes)
        recv = dict(self.recv_bytes)
        for d, b in other.send_bytes.items():
            send[d] = send.get(d, 0) + b
        for d, b in other.recv_bytes.items():
            recv[d] = recv.get(d, 0) + b
        return MovementPlan(self.total_bytes + other.total_bytes, send, recv)


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def _overlap(idx_a, idx_b, shape) -> int:
    """Element count of the intersection of two index tuples."""
    n = 1
    for sl_a, sl_b, dim in zip(idx_a, idx_b, shape):
        a0, a1 = sl_a.indices(dim)[:2]
        b0, b1 = sl_b.indices(dim)[:2]
        n *= max(0, min(a1, b1) - max(a0, b0))
        if n == 0:
            return 0
    return n


def _intersect(idx_a, idx_b, shape):
    out = []
    for sl_a, sl_b, dim in zip(idx_a, idx_b, shape):
        a0, a1 = sl_a.indices(dim)[:2]
        b0, b1 = sl_b.indices(dim)[:2]
        out.append(slice(max(a0, b0), min(a1, b1)))
    return tuple(out)


def _numel(idx, shape) -> int:
    return int(np.prod([sl.indices(d)[1] - sl.indices(d)[0]
                        for sl, d in zip(idx, shape)]))


def movement_plan(shape: Tuple[int, ...], dtype, src: NamedLayout,
                  dst: NamedLayout) -> MovementPlan:
    """Layout-aware plan: which bytes must move rank to rank so that a
    tensor laid out ``src`` becomes laid out ``dst``. Data already on the
    right rank does not move. Replicated sources are deduplicated: the
    receivers count from the lowest ranks first (JAX's own accounting,
    kept as it is; ``DataDispatcher`` records what its executor sent)."""
    itemsize = _itemsize(dtype)
    shape = tuple(shape)
    src_map = src.devices_indices_map(shape)
    dst_map = dst.devices_indices_map(shape)
    send: Dict[int, int] = {}
    recv: Dict[int, int] = {}
    total = 0
    src_items = sorted(src_map.items())
    for dst_dev, dst_idx in dst_map.items():
        needed = _numel(dst_idx, shape)
        # subtract what dst_dev already holds
        if dst_dev in src_map:
            needed -= _overlap(src_map[dst_dev], dst_idx, shape)
        if needed <= 0:
            continue
        remaining = needed
        for src_dev, src_idx in src_items:
            if src_dev == dst_dev:
                continue
            ov = _overlap(src_idx, dst_idx, shape)
            if dst_dev in src_map:
                ov -= _overlap(src_idx,
                               _intersect(src_map[dst_dev], dst_idx, shape),
                               shape)
                ov = max(ov, 0)
            if ov <= 0:
                continue
            take = min(ov, remaining)
            send[src_dev] = send.get(src_dev, 0) + take * itemsize
            remaining -= take
            if remaining == 0:
                break
        moved = needed - max(remaining, 0)
        recv[dst_dev] = recv.get(dst_dev, 0) + moved * itemsize
        total += moved * itemsize
    return MovementPlan(total, send, recv)


def centralized_plan(shape, dtype, src: NamedLayout, dst: NamedLayout,
                     controller: int = 0) -> MovementPlan:
    """The single-controller baseline plan: every source shard (minus the
    controller's own) flows into the controller, then every destination
    shard (minus the controller's own) flows out of it. The controller's
    link carries about twice the global tensor whatever the overlap."""
    itemsize = _itemsize(dtype)
    shape = tuple(shape)
    total_elems = int(np.prod(shape))
    src_map = src.devices_indices_map(shape)
    dst_map = dst.devices_indices_map(shape)
    send: Dict[int, int] = {}
    recv: Dict[int, int] = {}
    # gather: each source shard -> controller, until the global tensor is
    # counted once (replicas skipped)
    seen_elems = 0
    for dev, idx in sorted(src_map.items()):
        n = _numel(idx, shape)
        if seen_elems >= total_elems:
            break
        n = min(n, total_elems - seen_elems)
        seen_elems += n
        if dev == controller:
            continue
        send[dev] = send.get(dev, 0) + n * itemsize
        recv[controller] = recv.get(controller, 0) + n * itemsize
    # scatter: controller -> each destination shard
    for dev, idx in dst_map.items():
        if dev == controller:
            continue
        n = _numel(idx, shape)
        send[controller] = send.get(controller, 0) + n * itemsize
        recv[dev] = recv.get(dev, 0) + n * itemsize
    moved = sum(recv.values())
    return MovementPlan(moved, send, recv)


def estimate_latency(plan: MovementPlan, *, bandwidth: float = ETHERNET_BW,
                     links_parallel: bool = True) -> float:
    """Seconds to drain the plan. Direct dispatch drains all links in
    parallel (time = bottleneck link); a centralized plan serializes on
    the controller's link either way."""
    if links_parallel:
        return plan.bottleneck_bytes / bandwidth
    return plan.total_bytes / bandwidth


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------

def _norm(idx, shape) -> Tuple[Tuple[int, int], ...]:
    """A region as ((start, stop), ...) per dim."""
    return tuple(sl.indices(d)[:2] for sl, d in zip(idx, shape))


def _cut(region, base) -> Tuple[slice, ...]:
    """``region`` as slices of the shard whose region is ``base``."""
    return tuple(slice(r0 - b0, r1 - b0)
                 for (r0, r1), (b0, _) in zip(region, base))


def _meet(a, b):
    out = tuple((max(a0, b0), min(a1, b1)) for (a0, a1), (b0, b1)
                in zip(a, b))
    return out if all(lo < hi for lo, hi in out) else None


def _owners(layout: NamedLayout, shape) -> Dict[Tuple, int]:
    """Each distinct block of a layout -> its canonical owner, the lowest
    rank holding it. A layout's blocks are cells of one grid, so two
    ranks' blocks are either the same block or disjoint."""
    owners: Dict[Tuple, int] = {}
    for r, idx in sorted(layout.devices_indices_map(shape).items()):
        owners.setdefault(_norm(idx, shape), r)
    return owners


class _Leaf:
    """One leaf of a dispatch on this rank: its shape, layouts, local
    shard and (once made) its output."""

    def __init__(self, x: torch.Tensor, src: NamedLayout, dst: NamedLayout,
                 me: int):
        self.src, self.dst, self.dtype = src, dst, x.dtype
        self.shape = (tuple(x.shape) if x.is_meta
                      else src.global_shape(x.shape))
        self.src_map = {r: _norm(i, self.shape) for r, i in
                        src.devices_indices_map(self.shape).items()}
        self.dst_map = {r: _norm(i, self.shape) for r, i in
                        dst.devices_indices_map(self.shape).items()}
        self.held = self.src_map.get(me)
        self.want = self.dst_map.get(me)
        if (self.held is None) != x.is_meta:
            raise ValueError(
                f"rank {me} is {'outside' if self.held is None else 'in'} "
                f"the source mesh but passed "
                f"{'a tensor' if not x.is_meta else 'a meta tensor'}")
        self.x = x
        self.out: Optional[torch.Tensor] = None

    def start_output(self, device) -> None:
        """The output shard, with the part this rank already holds."""
        if self.want is None:
            self.out = torch.empty(self.shape, dtype=self.dtype,
                                   device="meta")
        elif self.want == self.held:
            self.out = self.x                   # nothing to move
        else:
            self.out = torch.empty([hi - lo for lo, hi in self.want],
                                   dtype=self.dtype, device=device)
            both = (_meet(self.held, self.want)
                    if self.held is not None else None)
            if both is not None:
                self.out[_cut(both, self.want)] = \
                    self.x[_cut(both, self.held)]


def _comm_device(leaves: List[_Leaf]) -> torch.device:
    for lf in leaves:
        if not lf.x.is_meta:
            return lf.x.device
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class _Exchange:
    """One round of point-to-point transfers posted together: the pieces
    this rank sends, and the buffers it receives into with where each
    goes. Gloo moves host memory: under it a device piece is sent from a
    host copy and received into a host buffer that ``wait`` copies back."""

    def __init__(self):
        self.ops: list = []
        # (buffer, host buffer, leaf, region): where wait() copies each
        # received piece
        self.recvs: List[Tuple[torch.Tensor, torch.Tensor, Optional[_Leaf],
                               Tuple]] = []
        self.sent = self.received = 0
        self.works: list = []

    @staticmethod
    def _need_group() -> None:
        if not dist.is_initialized():
            raise RuntimeError(
                "this dispatch moves data between ranks and needs an "
                "initialized process group "
                "(torch.distributed.init_process_group)")

    @staticmethod
    def _staged(t: torch.Tensor) -> bool:
        return t.device.type != "cpu" and dist.get_backend() == "gloo"

    def send(self, piece: torch.Tensor, to: int) -> None:
        self._need_group()
        piece = piece.contiguous()
        if self._staged(piece):
            piece = piece.cpu()
        self.ops.append(dist.P2POp(dist.isend, piece, to))
        self.sent += piece.numel() * piece.element_size()

    def recv(self, buf: torch.Tensor, frm: int, leaf=None,
             region=None) -> None:
        """Receive into ``buf``; with ``leaf``, ``wait`` copies it into
        ``region`` of the leaf's output."""
        self._need_group()
        host = (torch.empty(buf.shape, dtype=buf.dtype)
                if self._staged(buf) else buf)
        self.ops.append(dist.P2POp(dist.irecv, host, frm))
        self.recvs.append((buf, host, leaf, region))
        self.received += buf.numel() * buf.element_size()

    def post(self) -> "_Exchange":
        if self.ops:
            self.works = dist.batch_isend_irecv(self.ops)
        return self

    def wait(self) -> None:
        """Wait for the posted transfers (on NCCL: orders the current
        stream after them) and copy each received piece into place."""
        for w in self.works:
            w.wait()
        self.works = []
        for buf, host, lf, region in self.recvs:
            if host is not buf:
                buf.copy_(host)
            if lf is not None:
                lf.out[_cut(region, lf.want)] = buf
        self.recvs = []


def _post_direct(leaves: List[_Leaf], me: int, device) -> _Exchange:
    """Post the direct exchange: for every destination rank d and every
    distinct source block B it does not hold, B's canonical owner sends d
    the part of B inside d's destination shard. Every rank enumerates the
    transfers in the same order, so each pair's sends and receives match
    one for one."""
    ex = _Exchange()
    for lf in leaves:
        lf.start_output(device)
        owners = sorted(_owners(lf.src, lf.shape).items(),
                        key=lambda kv: kv[1])
        for d in sorted(lf.dst_map):
            want, held = lf.dst_map[d], lf.src_map.get(d)
            for block, o in owners:
                if block == held:
                    continue
                part = _meet(block, want)
                if part is None:
                    continue
                if o == me:
                    ex.send(lf.x[_cut(part, lf.held)], d)
                elif d == me:
                    ex.recv(torch.empty([hi - lo for lo, hi in part],
                                        dtype=lf.dtype, device=device), o,
                            lf, part)
    return ex.post()


def _slices(region) -> Tuple[slice, ...]:
    return tuple(slice(lo, hi) for lo, hi in region)


def _run_centralized(leaves: List[_Leaf], me: int, device,
                     controller: int) -> Tuple[int, int]:
    """Gather every distinct source block to ``controller`` (the block it
    holds stays put), copy the global batch to the host and back, scatter
    each destination shard. Returns this rank's (sent, received) bytes."""
    gather = _Exchange()
    full: List[Optional[torch.Tensor]] = [None] * len(leaves)
    placed = []                       # (leaf index, buffer, block)
    for i, lf in enumerate(leaves):
        held_c = lf.src_map.get(controller)
        if me == controller:
            full[i] = torch.empty(lf.shape, dtype=lf.dtype, device=device)
            if lf.held is not None:
                full[i][_slices(lf.held)] = lf.x
        for block, o in sorted(_owners(lf.src, lf.shape).items(),
                               key=lambda kv: kv[1]):
            if block == held_c:
                continue
            if me == controller:
                buf = torch.empty([hi - lo for lo, hi in block],
                                  dtype=lf.dtype, device=device)
                gather.recv(buf, o)
                placed.append((i, buf, block))
            elif o == me:
                gather.send(lf.x, controller)
    gather.post().wait()
    for i, buf, block in placed:
        full[i][_slices(block)] = buf
    host = [g.cpu() if g is not None else None for g in full]
    scatter = _Exchange()
    for lf, h in zip(leaves, host):
        lf.out = (torch.empty(lf.shape, dtype=lf.dtype, device="meta")
                  if lf.want is None else
                  torch.empty([hi - lo for lo, hi in lf.want],
                              dtype=lf.dtype, device=device))
        for d in sorted(lf.dst_map):
            if me == controller:
                piece = h[_slices(lf.dst_map[d])].to(device)
                if d == me:
                    lf.out.copy_(piece)
                else:
                    scatter.send(piece, d)
            elif d == me:
                scatter.recv(lf.out, controller)
    scatter.post().wait()
    return gather.sent + scatter.sent, gather.received + scatter.received


# ---------------------------------------------------------------------------
# Dispatcher
# ---------------------------------------------------------------------------

@dataclass
class DispatchReport:
    strategy: str
    n_leaves: int
    total_bytes: int                 # global batch bytes
    moved_bytes: int                 # bytes that change owner (plan)
    bottleneck_bytes: int            # max bytes through one rank (plan)
    wall_time_s: float
    est_latency_ethernet_s: float
    est_latency_nvlink_s: float
    rank_send_bytes: int = 0         # what this rank's executor sent
    rank_recv_bytes: int = 0         # and received

    def row(self) -> dict:
        return self.__dict__.copy()


@dataclass
class DispatchHandle:
    """An in-flight direct handoff (``DataDispatcher.dispatch_async``).

    ``batch`` is usable at once: reading it waits for the transfers (on
    NCCL the wait orders the current stream after them, so an update can
    be enqueued against the batch while the bytes still move) and copies
    each received piece into place. ``result()`` waits for the handoff to
    land and appends the report to the dispatcher's log, once. The report's
    wall time is the handoff's own: on CUDA the device time between events
    recorded on the current stream where it began and after its last copy,
    else the host time until the batch was assembled. (JAX stamps
    enqueue to ``result()``, which in the port would fold in the eager
    update enqueued between them.)
    """

    report: DispatchReport
    _dispatcher: "DataDispatcher"
    _t0: float
    _device: torch.device
    _start: Optional[torch.cuda.Event]    # CUDA: recorded at the start
    _exchange: _Exchange
    _leaves: List[_Leaf]
    _template: object
    _batch: object = None
    _end: Optional[torch.cuda.Event] = None
    _t_done: float = 0.0
    _done: bool = False

    @property
    def batch(self):
        if self._batch is None:
            self._exchange.wait()
            self._batch = tree_unflatten(
                self._template, [lf.out for lf in self._leaves])
            if self._start is not None:
                self._end = torch.cuda.Event(enable_timing=True)
                self._end.record(torch.cuda.current_stream(self._device))
            self._t_done = time.perf_counter()
        return self._batch

    def result(self):
        batch = self.batch
        if not self._done:
            if self._end is not None:
                self._end.synchronize()
                wall = self._start.elapsed_time(self._end) / 1e3
            else:
                wall = self._t_done - self._t0
            self.report.wall_time_s = wall
            self._dispatcher.log.append(self.report)
            self._done = True
        return batch, self.report


def _sync(leaves: List[_Leaf]) -> None:
    """Wait for the outputs' device work (``jax.block_until_ready``)."""
    for lf in leaves:
        if lf.out is not None and lf.out.is_cuda:
            torch.cuda.current_stream(lf.out.device).synchronize()
            return


class DataDispatcher:
    """Executes and accounts inter-stage batch movement (Fig. 2 ③④⑤)."""

    def __init__(self, *, controller: int = 0):
        self.controller = controller
        self.log: List[DispatchReport] = []

    # -- plans ---------------------------------------------------------------
    def _leaves(self, batch, src_shardings, dst_shardings) -> List[_Leaf]:
        me = current_rank()
        xs = tree_leaves(batch)
        if src_shardings is None:
            local = replicated(local_mesh_config())
            srcs = [local] * len(xs)
        else:
            srcs = tree_leaves(src_shardings)
        dsts = tree_leaves(dst_shardings)
        if not len(xs) == len(srcs) == len(dsts):
            raise ValueError(f"the batch has {len(xs)} leaves, the layouts "
                             f"{len(srcs)} and {len(dsts)}")
        return [_Leaf(x, s, d, me) for x, s, d in zip(xs, srcs, dsts)]

    def _plan(self, leaves: List[_Leaf], strategy: str) -> MovementPlan:
        plans = []
        for lf in leaves:
            if strategy == "centralized":
                plans.append(centralized_plan(lf.shape, lf.dtype, lf.src,
                                              lf.dst, self.controller))
            else:
                plans.append(movement_plan(lf.shape, lf.dtype, lf.src,
                                           lf.dst))
        out = MovementPlan(0, {}, {})
        for p in plans:
            out = out.merge(p)
        return out

    def plan(self, batch, src_shardings, dst_shardings,
             *, strategy: str) -> MovementPlan:
        return self._plan(self._leaves(batch, src_shardings, dst_shardings),
                          strategy)

    def _report(self, strategy, leaves, plan, wall, sent, received,
                links_parallel=True) -> DispatchReport:
        return DispatchReport(
            strategy=strategy, n_leaves=len(leaves),
            total_bytes=sum(int(np.prod(lf.shape)) * _itemsize(lf.dtype)
                            for lf in leaves),
            moved_bytes=plan.total_bytes,
            bottleneck_bytes=plan.bottleneck_bytes, wall_time_s=wall,
            est_latency_ethernet_s=estimate_latency(
                plan, bandwidth=ETHERNET_BW, links_parallel=links_parallel),
            est_latency_nvlink_s=estimate_latency(
                plan, bandwidth=NVLINK_BW, links_parallel=links_parallel),
            rank_send_bytes=sent, rank_recv_bytes=received)

    # -- execution -----------------------------------------------------------
    def _execute(self, batch, leaves, strategy) -> Tuple[object, int, int]:
        me = current_rank()
        device = _comm_device(leaves)
        if strategy == "centralized":
            sent, received = _run_centralized(leaves, me, device,
                                              self.controller)
        elif strategy == "direct":
            ex = _post_direct(leaves, me, device)
            ex.wait()
            sent, received = ex.sent, ex.received
        else:
            raise ValueError(f"unknown strategy {strategy!r}")
        return (tree_unflatten(batch, [lf.out for lf in leaves]), sent,
                received)

    def dispatch_centralized(self, batch, dst_shardings, src_shardings=None):
        """Baseline: a host round trip through the controller rank."""
        leaves = self._leaves(batch, src_shardings, dst_shardings)
        return self._execute(batch, leaves, "centralized")[0]

    def dispatch_direct(self, batch, dst_shardings, src_shardings=None):
        """EARL: rank-to-rank transfers of exactly the missing parts, no
        central hop; works across meshes."""
        leaves = self._leaves(batch, src_shardings, dst_shardings)
        return self._execute(batch, leaves, "direct")[0]

    def dispatch(self, batch, dst_shardings, *, strategy: str = "direct",
                 src_shardings=None):
        """Move ``batch`` (this rank's local shards) from ``src_shardings``
        (None: each leaf lies on this rank alone) to ``dst_shardings``;
        append a ``DispatchReport``. Returns ``(batch, report)``."""
        if strategy not in ("direct", "centralized"):
            raise ValueError(f"unknown strategy {strategy!r}")
        leaves = self._leaves(batch, src_shardings, dst_shardings)
        plan = self._plan(leaves, strategy)
        t0 = time.perf_counter()
        out, sent, received = self._execute(batch, leaves, strategy)
        _sync(leaves)
        rep = self._report(strategy, leaves, plan,
                           time.perf_counter() - t0, sent, received,
                           links_parallel=strategy != "centralized")
        self.log.append(rep)
        return out, rep

    def dispatch_async(self, batch, dst_shardings, *,
                       strategy: str = "direct",
                       src_shardings=None) -> DispatchHandle:
        """Post the direct handoff without waiting for it to land; the
        handle's ``batch`` feeds the next stage and ``result()`` closes
        the report. Only ``direct`` can: the centralized baseline's host
        round trip blocks."""
        if strategy != "direct":
            raise ValueError(
                "dispatch_async requires strategy='direct' (centralized "
                "gathers through the controller's host, which blocks)")
        leaves = self._leaves(batch, src_shardings, dst_shardings)
        plan = self._plan(leaves, strategy)
        device = _comm_device(leaves)
        start = None
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(device))
        t0 = time.perf_counter()
        ex = _post_direct(leaves, current_rank(), device)
        rep = self._report("direct-async", leaves, plan, 0.0, ex.sent,
                           ex.received)
        return DispatchHandle(report=rep, _dispatcher=self, _t0=t0,
                              _device=device, _start=start, _exchange=ex,
                              _leaves=leaves, _template=batch)


# ---------------------------------------------------------------------------
# Same-mesh re-split
# ---------------------------------------------------------------------------

def all_to_all_resplit(x: torch.Tensor, mesh, axis_name: str, *,
                       split_dim: int, concat_dim: int) -> torch.Tensor:
    """Re-partition this rank's shard ``x`` from split along
    ``concat_dim`` to split along ``split_dim`` over the mesh axis
    ``axis_name`` of the ``DeviceMesh`` ``mesh``, with one
    ``all_to_all_single`` on that axis's group and no gather (JAX's tiled
    ``lax.all_to_all``): chunk i of ``x`` along ``split_dim`` goes to the
    axis's i-th rank, and the received chunks are concatenated along
    ``concat_dim`` in rank order. Collective over the axis's group."""
    n = mesh.size(list(mesh.mesh_dim_names).index(axis_name))
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split {n} ways")
    chunks = x.chunk(n, dim=split_dim)
    inp = torch.cat([c.contiguous().reshape(-1) for c in chunks])
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=mesh.get_group(axis_name))
    shape = chunks[0].shape
    return torch.cat([p.view(shape) for p in out.chunk(n)], dim=concat_dim)
