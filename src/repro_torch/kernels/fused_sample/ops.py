"""Public wrapper for the fused sampling kernel (``csrc/fused_sample.cu``;
replaces the Pallas ``_fused_sample_kernel`` of
``repro/kernels/fused_sample/kernel.py``).

``fused_sample_tokens`` mirrors the JAX ``fused_sample_tokens``: greedy
when ``temperature <= 0``, else Gumbel-argmax over ``logits /
temperature`` with an optional nucleus filter. Temperature, top-p and the
noise are plain tensor work outside the kernel, as in JAX; the noise is an
operand, so a caller can feed the JAX draws and reproduce its tokens.

The tensor-parallel rollout samples from vocab shards:
``fused_sample_partial`` launches the kernel's partial-state mode on a
rank's ``(B, V_local)`` slice, and ``combine_partials`` merges the ranks'
states into the whole row's token and log-prob (``fused_sample_tokens``
with ``tp=``). ``partial_launches`` counts that mode's launches.

Fake tensors (``utils/cost.full_cost``'s trace) launch nothing: each
wrapper returns outputs of the right shapes and dtypes and reports the
kernel's ``work`` to the cost counter, leaving the launch counters alone.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_sample.ref import (NEG_INF, fused_sample_ref,
                                                  fused_sample_partial_ref)
from repro_torch.utils.cost import is_fake, report_kernel

launches = 0          # kernel launches since the last reset_launches()
partial_launches = 0  # launches of the partial-state mode, likewise

_MAX_BLOCKS = 8       # blocks per row: one cluster, the portable size
_THREADS = 256        # threads per block (csrc/fused_sample.cu)
_BLOCKS_PER_SM = 4    # resident blocks an SM holds at the kernel's registers
_MIN_SLICE = 2048     # elements a block streams at least (8 per thread)


def reset_launches() -> None:
    global launches, partial_launches
    launches = partial_launches = 0


@functools.cache
def _bind():
    fn = _build.load("fused_sample").fused_sample_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bind_partial():
    fn = _build.load("fused_sample").fused_sample_partial_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cluster_plan(B: int, V: int, n_sm: int):
    """``(k, slice)``: blocks per row (one thread-block cluster, at most 8)
    and the elements each streams. As many blocks as fill about four per
    SM over the ``B`` rows, but none with fewer than 8 elements a thread,
    and at least four while the row allows, so that no thread sums more
    terms than about the first design's V/1024 (or 16, in a short row);
    the slice is a whole number of float4s, so each starts 16-byte
    aligned when the row does, and no block is empty. At B=32 on 132 SMs:
    V=151,936 gives 8 blocks of 18,992; V=50,280 gives 8 of 6,288."""
    V = max(V, 1)
    k = min(_MAX_BLOCKS, max(1, V // _MIN_SLICE),
            max(1024 // _THREADS, -(-_BLOCKS_PER_SM * n_sm // max(B, 1))))
    slice_ = 4 * -(-V // (4 * k))
    return -(-V // slice_), slice_


def work(B: int, V: int, partial: bool = False):
    """``(bytes, flops)`` of one launch: the f32 logits and noise read
    once, the outputs written once (a token and a log-prob a row, or the
    partial mode's five words a row); 4 flops per element (the add, the
    compare, the online max and the exp-sum)."""
    return 2 * B * V * 4 + B * (20 if partial else 8), 4 * B * V


def _check_cuda_inputs(lg, noise):
    if lg.device.type != "cuda":
        raise ValueError(f"unsupported device {lg.device}")
    _check_args(lg, noise)


def _check_args(lg, noise):
    """What the kernel refuses of its arguments' dtypes, shapes and
    layouts (a fake trace refuses it too)."""
    if lg.dtype != torch.float32 or noise.dtype != torch.float32:
        raise TypeError(f"logits and noise must be float32, got {lg.dtype} "
                        f"/ {noise.dtype}")
    if lg.dim() != 2 or noise.shape != lg.shape:
        raise ValueError(f"logits {tuple(lg.shape)} and noise "
                         f"{tuple(noise.shape)} must be one (B, V) shape")
    if noise.device != lg.device:
        raise ValueError("logits and noise must share a device")
    if not (lg.is_contiguous() and noise.is_contiguous()):
        raise ValueError("logits and noise must be contiguous")


def _plan_for(lg):
    B, V = lg.shape
    return cluster_plan(B, V, _build.sm_count(lg.device.index or 0))


def fused_sample(lg, noise):
    """lg, noise: (B, V) f32. Returns ``(tokens (B,) int32, logprobs (B,)
    f32)``: ``argmax(lg + noise)`` (earliest index on ties) and ``lg[tok] -
    logsumexp(lg)``. CPU tensors use ``ref.py``; CUDA tensors launch the
    kernel."""
    if is_fake(lg):
        _check_args(lg, noise)
        B, V = lg.shape
        report_kernel("fused_sample", *work(B, V))
        return (lg.new_empty((B,), dtype=torch.int32),
                lg.new_empty((B,), dtype=torch.float32))
    if lg.device.type == "cpu":
        return fused_sample_ref(lg, noise)
    _check_cuda_inputs(lg, noise)
    return _launch(lg, noise, _plan_for(lg))


def fused_sample_partial(lg, noise):
    """The partial-state mode over a vocab shard ``lg, noise`` (B, V_local)
    f32: per row ``(m, l, bs, bi, bl)``, f32 but ``bi`` int32 (the online
    logsumexp state, the best score of ``lg + noise``, its earliest local
    index and ``lg`` there). CPU tensors use ``ref.py``; CUDA tensors
    launch the kernel."""
    if is_fake(lg):
        _check_args(lg, noise)
        B, V = lg.shape
        report_kernel("fused_sample_partial", *work(B, V, partial=True))
        f32 = lambda: lg.new_empty((B,), dtype=torch.float32)
        return (f32(), f32(), f32(), lg.new_empty((B,), dtype=torch.int32),
                f32())
    if lg.device.type == "cpu":
        return fused_sample_partial_ref(lg, noise)
    _check_cuda_inputs(lg, noise)
    return _launch_partial(lg, noise, _plan_for(lg))


def _launch_partial(lg, noise, plan):
    """One counted launch of the partial-state mode under ``plan``."""
    B, V = lg.shape
    f32 = lambda: torch.empty((B,), dtype=torch.float32, device=lg.device)
    m, l, bs, bl = f32(), f32(), f32(), f32()
    bi = torch.empty((B,), dtype=torch.int32, device=lg.device)
    stream = torch.cuda.current_stream(lg.device).cuda_stream
    err = _bind_partial()(lg.data_ptr(), noise.data_ptr(), m.data_ptr(),
                          l.data_ptr(), bs.data_ptr(), bi.data_ptr(),
                          bl.data_ptr(), B, V, *plan, stream)
    _build.check(err, "fused_sample_partial")
    global partial_launches
    with _build.LAUNCH_LOCK:
        partial_launches += 1
    return m, l, bs, bi, bl


def combine_partials(m, l, bs, bi, bl, offset: int, reduce):
    """Merge the vocab shards' partial states into the whole row's
    ``(tokens (B,) int32, logprobs (B,) f32)``, the one-launch kernel's
    rule: the greatest score wins, and among equal scores the smallest
    GLOBAL index ``offset + bi`` (so the earliest index still wins a tie
    that spans shards); the log-prob is ``bl`` of the winner less ``M +
    log(sum l exp(m - M))`` with ``M`` the greatest ``m``. ``reduce(t,
    op)`` all-reduces ``t`` over the shards with op "max", "min" or
    "sum" (three calls: a MAX of (B, 2), a MIN of (B,), a SUM of (B,
    2))."""
    gi = bi.long() + offset
    top = reduce(torch.stack([bs, m], dim=1), "max")
    BS, M = top[:, 0], top[:, 1]
    big = torch.iinfo(torch.int64).max
    tok = reduce(torch.where(bs == BS, gi, big), "min")
    # an empty shard (m = -inf) adds nothing to the sum
    scale = torch.where(m == -torch.inf, 0.0, torch.exp(m - M))
    sums = reduce(torch.stack([l * scale, torch.where(gi == tok, bl, 0.0)],
                              dim=1), "sum")
    return tok.to(torch.int32), sums[:, 1] - (M + torch.log(sums[:, 0]))


def _launch(lg, noise, plan):
    """One counted launch on checked CUDA inputs under ``plan`` = ``(k,
    slice)``: the wrapper's is ``cluster_plan``'s, and ``chip_smoke.py``'s
    cluster probe times others."""
    B, V = lg.shape
    tok = torch.empty((B,), dtype=torch.int32, device=lg.device)
    lp = torch.empty((B,), dtype=torch.float32, device=lg.device)
    stream = torch.cuda.current_stream(lg.device).cuda_stream
    err = _bind()(lg.data_ptr(), noise.data_ptr(), tok.data_ptr(),
                  lp.data_ptr(), B, V, *plan, stream)
    _build.check(err, "fused_sample")
    global launches
    with _build.LAUNCH_LOCK:
        launches += 1
    return tok, lp


def apply_top_p(lg, top_p: float):
    """Nucleus filter on (B, V) f32 logits: keep the smallest set of
    top-probability tokens whose cumulative mass reaches ``top_p`` (a token
    survives iff the mass strictly above it is < top_p); the rest go to
    ``NEG_INF``."""
    lg = lg.float()
    sorted_lg = torch.sort(lg, dim=-1, descending=True).values
    probs = torch.softmax(sorted_lg, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    keep = (csum - probs) < top_p
    thr = torch.where(keep, sorted_lg, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(lg >= thr, lg, NEG_INF)


def fused_sample_tokens(logits, temperature: float, *, top_p: float = 1.0,
                        noise=None, tp=None):
    """Sample next tokens from (B, V) logits in one kernel pass. Returns
    ``(tokens, logprobs)``. ``temperature <= 0`` is greedy with log-probs
    of the untempered logits (``noise`` and ``top_p`` unused); otherwise
    ``noise`` is the (B, V) Gumbel draw added to ``logits / temperature``
    after the optional top-p filter.

    ``tp`` (a ``models.tensor_parallel.TPContext`` whose vocab is split):
    ``logits`` are the rank's (B, V_local) shard and ``noise`` the whole
    (B, V) draw, of which the rank takes its columns; the kernel's
    partial-state mode runs on the shard and ``combine_partials`` merges
    the ranks' states, so every rank gets the tokens of the whole row.
    ``top_p < 1`` needs the whole row sorted: the row is gathered exactly
    (``TPContext.gather_row``) and sampled as on one rank."""
    lg = logits.float()
    split = tp is not None and tp.vocab_split
    if split and temperature > 0.0 and top_p < 1.0:
        lg, split = tp.gather_row(lg), False
    if temperature <= 0.0:
        z = torch.zeros_like(lg)
    else:
        if noise is None:
            raise ValueError("sampling at temperature > 0 needs a noise "
                             "tensor")
        lg = lg / temperature
        if top_p < 1.0:
            lg = apply_top_p(lg, top_p)
        z = (tp.shard_row(noise) if split else noise).float().contiguous()
    if not split:
        return fused_sample(lg.contiguous(), z)
    return tp.sample_combine(*fused_sample_partial(lg.contiguous(), z))
