"""What one rank's program costs, counted from a trace on fake tensors
(the port's counterpart of ``repro/utils/hlo.py``, which parses XLA's
compiled HLO).

``full_cost(fn, *args, **kw)`` runs ``fn`` once under a
``FakeTensorMode`` (tensors with shapes, dtypes and devices but no data,
so a 405B-parameter step traces on a laptop) and a ``TorchDispatchMode``
that sees every ATen operation and every ``c10d`` collective the program
issues:

  - **FLOPs**: matmul-class operations only (``mm``, ``bmm``, ``addmm``,
    ``baddbmm`` and what ``einsum``/``matmul`` decompose to), by
    ``torch.utils.flop_counter``'s formulas, as JAX's counts ``dot``
    instructions only; plus each hand-written kernel's own count, which
    its wrapper reports from its fake branch (``report_kernel``);
  - **bytes accessed**: each operation's tensor inputs read once and its
    outputs written once (views and allocations move nothing, a fill reads
    nothing, a gather reads the rows it returns and not its whole table),
    and each kernel's count from its wrapper;
  - **collectives** by kind (JAX's names: "all-reduce", "all-gather",
    ...), each counted once, with the bytes of its result;
  - **peak bytes**: the most bytes of storages alive at once, the
    arguments' included, each storage rounded up to the CUDA caching
    allocator's 512-byte block; ``argument_bytes`` is the arguments'
    share, so ``peak_bytes - argument_bytes`` is what the program
    allocates on top of its inputs.

An eager trace runs every iteration of every loop, so there are no
while-loop trip counts to correct. The counts are one rank's: a program
traced as rank r of a fake world of N ranks (``start_fake_world``) holds that
rank's shards and issues its collectives. Bytes are not XLA's: XLA counts
the operands of fused instructions, the eager program each operation.
"""
from __future__ import annotations

import contextlib
import statistics
import weakref
from dataclasses import dataclass, field
from typing import Dict, List

import torch
import torch.distributed as dist
from torch._guards import detect_fake_mode
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

# c10d operation -> the collective kind (JAX's HLO names)
_COLLECTIVE_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "collective-broadcast",
    "send": "collective-permute", "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
}

# operations that move no bytes: allocations and metadata
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "_unsafe_view", "detach", "alias",
             "lift_fresh", "_local_scalar_dense", "device", "set_",
             "resize_"}
# fills shaped after a tensor: write their output, read nothing
_FILLS = {"zeros_like", "ones_like", "full_like", "rand_like", "randn_like",
          "new_zeros", "new_ones", "new_full"}
# gathers: read the rows they return (and their indices)
_GATHERS = {"index", "embedding", "index_select", "gather"}
_ALLOCATOR_BLOCK = 512


def _flop_formulas():
    from torch.utils.flop_counter import flop_registry
    aten = torch.ops.aten
    return {p: flop_registry[p] for p in (aten.mm, aten.bmm, aten.addmm,
                                          aten.baddbmm)}


@dataclass
class FullCost:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    collective_count: float = 0.0       # collectives issued
    collective_by_kind: dict = field(default_factory=dict)   # kind -> bytes
    collective_counts: dict = field(default_factory=dict)    # kind -> count
    peak_bytes: float = 0.0
    argument_bytes: float = 0.0
    op_counts: dict = field(default_factory=dict)   # ATen op -> count
    kernels: dict = field(default_factory=dict)     # kernel -> launches

    def scaled(self, k: float) -> "FullCost":
        return FullCost(self.flops * k, self.bytes_accessed * k,
                        self.collective_bytes * k, self.collective_count * k,
                        {n: b * k for n, b in self.collective_by_kind.items()},
                        {n: c * k for n, c in self.collective_counts.items()},
                        self.peak_bytes, self.argument_bytes,
                        {n: c * k for n, c in self.op_counts.items()},
                        {n: c * k for n, c in self.kernels.items()})

    def plus(self, o: "FullCost") -> "FullCost":
        return FullCost(self.flops + o.flops,
                        self.bytes_accessed + o.bytes_accessed,
                        self.collective_bytes + o.collective_bytes,
                        self.collective_count + o.collective_count,
                        _sum_dicts(self.collective_by_kind,
                                   o.collective_by_kind),
                        _sum_dicts(self.collective_counts,
                                   o.collective_counts),
                        max(self.peak_bytes, o.peak_bytes),
                        max(self.argument_bytes, o.argument_bytes),
                        _sum_dicts(self.op_counts, o.op_counts),
                        _sum_dicts(self.kernels, o.kernels))


def _sum_dicts(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0) + v
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


# the counters tracing now (a kernel's fake branch reports to each)
_ACTIVE: List["CostMode"] = []


def report_kernel(name: str, nbytes: float, flops: float) -> None:
    """One launch of the hand-written kernel ``name`` that moves
    ``nbytes`` and does ``flops``: added to every active counter. The
    kernels' fake branches call it where a real launch would be."""
    for mode in _ACTIVE:
        mode.cost.kernels[name] = mode.cost.kernels.get(name, 0) + 1
        mode.cost.flops += flops
        mode.cost.bytes_accessed += nbytes


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor (shape, dtype and device, no data)."""
    return isinstance(t, FakeTensor)


class CostMode(TorchDispatchMode):
    """Counts what the operations dispatched under it cost (the module
    docstring's rules) into ``self.cost``. ``track(tree)`` adds tensors
    that exist before the trace (the arguments) to the live storages."""

    def __init__(self):
        super().__init__()
        self.cost = FullCost()
        self._flops = _flop_formulas()
        self._live: Dict[int, int] = {}   # storage address -> bytes
        self._live_bytes = 0
        self._refs: list = []   # a weakref calls back only while it lives

    def _hold(self, t: torch.Tensor) -> int:
        """Start tracking ``t``'s storage; the bytes it adds (0 if it is
        tracked already)."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return 0
        n = -(-st.nbytes() // _ALLOCATOR_BLOCK) * _ALLOCATOR_BLOCK
        self._live[key] = n
        self._live_bytes += n
        self._refs.append(weakref.ref(st, lambda _, key=key: self._drop(key)))
        return n

    def _drop(self, key: int) -> None:
        n = self._live.pop(key, 0)
        self._live_bytes -= n

    def track(self, tree) -> int:
        """Hold the storages of ``tree``'s tensors; returns their bytes."""
        n = sum(self._hold(t) for t in _tensors(tree))
        self._peak()
        return n

    def _peak(self) -> None:
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live_bytes)

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        c = self.cost
        c.op_counts[name] = c.op_counts.get(name, 0) + 1
        if func.namespace == "c10d":
            kind = _COLLECTIVE_KINDS.get(name)
            if kind is not None:
                n = sum(_nbytes(t) for t in _tensors(args[0]))
                c.collective_bytes += n
                c.collective_count += 1
                c.collective_by_kind[kind] = (
                    c.collective_by_kind.get(kind, 0) + n)
                c.collective_counts[kind] = (
                    c.collective_counts.get(kind, 0) + 1)
            return out
        formula = self._flops.get(func.overloadpacket)
        if formula is not None:
            c.flops += formula(*args, **kwargs, out_val=out)
        outs = _tensors(out)
        if not (func.is_view or name in _NO_BYTES):
            out_b = sum(_nbytes(t) for t in outs)
            ins = {id(t): t for t in _tensors((args, kwargs))}.values()
            if name in _GATHERS:
                c.bytes_accessed += 2 * out_b + sum(
                    _nbytes(t) for t in ins if not t.is_floating_point())
            elif name in _FILLS:
                c.bytes_accessed += out_b
            else:
                c.bytes_accessed += out_b + sum(_nbytes(t) for t in ins)
        for t in outs:
            self._hold(t)
        self._peak()
        return out


@contextlib.contextmanager
def fake_mode(tree=()):
    """The ``FakeTensorMode`` to make fake tensors in, active for the
    block: the one already active, else the one ``tree``'s fake tensors
    belong to, else a new one."""
    active = torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE)
    if active is not None:
        yield active
        return
    mode = detect_fake_mode(_tensors(tree)) or FakeTensorMode()
    with mode:
        yield mode


def full_cost(fn, *args, **kw) -> FullCost:
    """Trace ``fn(*args, **kw)`` once on fake tensors and count its cost
    (the module docstring's rules). Fake tensors among the arguments
    (``models.param.abstract_params``, ``launch.mesh.input_specs``) are
    used as they are; real ones are replaced by fakes of the same shapes,
    so nothing runs on a device."""
    with fake_mode((args, kw)) as mode:
        conv = lambda x: (mode.from_tensor(x) if isinstance(x, torch.Tensor)
                          and not is_fake(x) else x)
        args, kw = pytree.tree_map(conv, (args, kw))
        counter = CostMode()
        with counter:
            counter.cost.argument_bytes = counter.track((args, kw))
            fn(*args, **kw)
    return counter.cost


@dataclass
class CollectiveStats:
    """Bytes moved per collective kind over one traced program."""

    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())

    def summary(self) -> str:
        parts = [
            f"{k}: {self.count_by_kind[k]}x "
            f"{self.bytes_by_kind[k] / 2**20:.1f} MiB"
            for k in sorted(self.bytes_by_kind)
        ]
        return "; ".join(parts) if parts else "none"


def collective_bytes(cost: FullCost) -> CollectiveStats:
    """The collectives of a traced program by kind (``hlo.collective_bytes``
    over the HLO text in JAX)."""
    return CollectiveStats(dict(cost.collective_by_kind),
                           dict(cost.collective_counts))


def count_op(cost: FullCost, opname: str) -> int:
    """How many times a traced program ran the ATen operation ``opname``
    (e.g. "mm", "bmm") or the ``c10d`` one (e.g. "allreduce_")."""
    return int(cost.op_counts.get(opname, 0))


def measure_step(fn, args, read, repeats: int = 5) -> dict:
    """The card's side of ``full_cost``: one warm-up call of ``fn(*args)``
    with the launch counters read just after it by ``read()`` (the caller
    sets them to 0 just before), then ``repeats`` calls timed by CUDA
    events, each with the peak of ``torch.cuda.max_memory_allocated()``
    above the bytes allocated before it. Returns the median ms, every ms,
    the largest peak and the warm-up call's nonzero launches."""
    fn(*args)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read().items() if v}
    times, peaks = [], []
    for _ in range(repeats):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(*args)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        peaks.append(torch.cuda.max_memory_allocated() - base)
        del out
    return dict(ms=statistics.median(times), ms_all=times,
                peak_bytes=max(peaks), launches=launches)


def trace_device() -> str:
    """The device fake tensors are made on: "cuda" where PyTorch is built
    with CUDA, else "cpu" (a CPU-only build refuses some operations on
    fake CUDA tensors). The counts do not depend on it."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def start_fake_world(n: int, rank: int = 0) -> None:
    """Make this process rank ``rank`` of a fake process group of ``n``
    ranks: collectives return at once and move nothing, so one process
    traces that rank's program of an ``n``-rank mesh. A process holds one
    default group: a fake world of another size or rank is replaced, and a
    real world (gloo, NCCL) refuses (trace in a process of its own)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()!r} process group is running: trace "
                f"on a fake world in a process of its own")
        if dist.get_world_size() == n and dist.get_rank() == rank:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
