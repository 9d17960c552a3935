"""Public wrapper for the flash attention kernels (``csrc/flash_attention.cu``
replaces the Pallas ``_fa_kernel`` of ``repro/kernels/flash_attention/
kernel.py``; ``csrc/flash_attention_bwd.cu`` replaces ``_dq_kernel`` and
``_dkv_kernel`` of ``bwd_kernel.py``).

Head dims 32, 64 and 128 are built from ``csrc/flash_attention.cu`` and
``flash_attention_bwd.cu``; 160 (stablelm-12b) from ``csrc/flash_hd160.cu``,
a library of its own with the same entry points (the kernels themselves
are in ``csrc/flash_fwd.cuh`` and ``flash_bwd.cuh``).

``flash_attention`` takes the model layout, like the JAX
``ops.flash_attention``, and is a ``torch.autograd.Function``: the forward
saves q, k, v, O and L; the backward computes ``D = rowsum(dO∘O)`` and
launches the dq and dk/dv kernels. The kernels read the model layout by
stride, so the JAX wrapper's transposes and block-size picking have no
counterpart. bf16 runs the forward, dq and dk/dv on the tensor cores
(wgmma, tiles loaded by TMA); fp32 runs f32 FMA kernels. CPU
tensors go to the plain versions in ``ref.py``; CUDA tensors launch the
kernels or raise — there is no fallback between the two. Under ``torch.utils.checkpoint`` the forward runs again inside the
backward, and that recompute launches (and counts) the forward kernel a
second time.

The forward takes ``q_offset``, the position of query row 0: a model
rank's rows of a sequence split over the model axis
(``models/layers.seq_parallel``) attend to the whole K/V from there. The
backward kernels take no offset yet: ``flash_attention`` refuses an
offset where autograd would record the call.

Fake tensors (``utils/cost.full_cost``'s trace) launch nothing: each
wrapper returns outputs of the right shapes and dtypes and reports its
kernel's ``work`` to the cost counter, leaving the launch counters alone;
the backward reports its dq and dk/dv kernels as two launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_fwd_ref)
from repro_torch.utils.cost import is_fake, report_kernel

# kernel launches since the last reset_launches(), per kernel
launches = {"fwd": 0, "dq": 0, "dkv": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128, 160)


def _lib(name: str, hd: int) -> str:
    """The library whose entry points take head dim ``hd``."""
    return "flash_hd160" if hd == 160 else name


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@functools.cache
def _bind(lib: str, fn_name: str, n_ptrs: int, n_ints: int):
    fn = getattr(_build.load(lib), fn_name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B,S,H,hd) and k, v one (B,Sk,KV,hd) "
                         f"shape; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (batch, head_dim, H % KV == 0)")


def _check_args(causal, window, *tensors, q_offset: int = 0):
    """What the kernels refuse of their arguments' dtypes, shapes, devices,
    layouts and query offset (a fake trace refuses it too)."""
    q, k = tensors[0], tensors[1]
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype
                                          for t in tensors):
        raise TypeError(f"q, k, v (and dO) must share float32 or bfloat16, "
                        f"got {[t.dtype for t in tensors]}")
    if q.shape[3] not in _HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {_HEAD_DIMS}, got "
                         f"{q.shape[3]}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if (causal or window > 0) and q_offset + q.shape[1] > k.shape[1]:
        raise ValueError(f"a causal or windowed query past the last key "
                         f"(q_offset + S = {q_offset} + {q.shape[1]} > "
                         f"Sk={k.shape[1]}) would be fully masked; the "
                         f"kernel takes q_offset + S <= Sk")
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("all inputs must be contiguous")


def _check_aligned(*tensors):
    for t in tensors:
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError("bfloat16 inputs must start on a 16-byte "
                             "boundary: the kernels load them by TMA")


def valid_pairs(S: int, Sk: int, causal: bool, window: int,
                q_offset: int = 0) -> int:
    """(query, key) pairs one (row, head) attends under ``ref.py``'s
    ``allowed_mask``: query i, at position p = q_offset + i, takes key j
    when j <= p (causal) and j > p - window (window > 0). Each count is
    the one over positions ``[0, q_offset + S)`` less the one over ``[0,
    q_offset)``."""
    if causal:
        def upto(n):            # the pairs of positions [0, n)
            w = window if 0 < window < n else n
            return w * (w + 1) // 2 + (n - w) * w
        return upto(q_offset + S) - upto(q_offset)

    def masked(n):              # keys the window takes from [0, n)
        m = max(n - window, 0) if window > 0 else 0
        return m * (m + 1) // 2
    return S * Sk - masked(q_offset + S) + masked(q_offset)


def key_span(S: int, Sk: int, causal: bool, window: int,
             q_offset: int = 0) -> int:
    """Keys that any of the S queries from position ``q_offset`` attends:
    ``[lo, hi)``, hi = q_offset + S when causal (else Sk) and lo =
    q_offset - window + 1 when window > 0 (else 0), the slabs the kernels
    walk; the rest are never read."""
    hi = min(Sk, q_offset + S) if causal else Sk
    lo = max(0, q_offset - window + 1) if window > 0 else 0
    return max(hi - lo, 0)


def work(kernel: str, B: int, S: int, Sk: int, H: int, KV: int, hd: int,
         esz: int, causal: bool = True, window: int = 0, q_offset: int = 0):
    """``(bytes, flops)`` of one launch of ``kernel`` ("fwd", "dq" or
    "dkv") at q (B,S,H,hd) and k, v (B,Sk,KV,hd) of ``esz``-byte elements,
    the queries from position ``q_offset``: each input read once (k and v
    over ``key_span``) and each output written once (q, k, v, O and the
    f32 L; the backward also dO and D, and writes dq or dk and dv over all
    Sk), and 4, 6 and 8·hd flops per attended (query head, key) pair."""
    pairs = B * H * valid_pairs(S, Sk, causal, window, q_offset)
    qb, lb = B * S * H * hd * esz, B * H * S * 4
    kvb = B * Sk * KV * hd * esz
    kvr = B * key_span(S, Sk, causal, window, q_offset) * KV * hd * esz
    return {"fwd": (2 * qb + 2 * kvr + lb, 4 * hd * pairs),
            "dq": (3 * qb + 2 * kvr + 2 * lb, 6 * hd * pairs),
            "dkv": (2 * qb + 2 * kvr + 2 * kvb + 2 * lb, 8 * hd * pairs)
            }[kernel]


def _report(kernel, q, k, causal, window, q_offset=0):
    B, S, H, hd = q.shape
    report_kernel(f"flash_{kernel}", *work(kernel, B, S, k.shape[1], H,
                                           k.shape[2], hd, q.element_size(),
                                           causal, window, q_offset))


def _device_of(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return q.device.type


def _dims(q, k, causal, window):
    """The int arguments that the C entry points share; the forward's
    take the query offset after them."""
    B, S, H, hd = q.shape
    return [B, S, k.shape[1], H, k.shape[2], hd, int(bool(causal)),
            int(window), _DTYPE_CODES[q.dtype]]


def flash_attention_fwd(q, k, v, causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """q: (B,S,H,hd); k,v: (B,Sk,KV,hd); query i at position ``q_offset
    + i``. Returns ``(out (B,S,H,hd) in q's dtype, L (B,H,S) f32)`` — the
    forward kernel, or ``ref.py`` on the CPU."""
    _check_shapes(q, k, v)
    q_offset = int(q_offset)
    if is_fake(q):
        _check_args(causal, window, q, k, v, q_offset=q_offset)
        B, S, H, _ = q.shape
        _report("fwd", q, k, causal, window, q_offset)
        return torch.empty_like(q), q.new_empty((B, H, S),
                                                dtype=torch.float32)
    if _device_of(q) == "cpu":
        return attention_fwd_ref(q, k, v, causal, window, q_offset)
    _check_args(causal, window, q, k, v, q_offset=q_offset)
    _check_aligned(q, k, v)
    B, S, H, _ = q.shape
    out = torch.empty_like(q)
    L = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    ints = _dims(q, k, causal, window) + [q_offset]
    err = _bind(_lib("flash_attention", q.shape[3]),
                "flash_attention_fwd_launch", 5, len(ints))(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        L.data_ptr(), *ints, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_fwd")
    with _build.LAUNCH_LOCK:
        launches["fwd"] += 1
    return out, L


def flash_attention_dq(q, k, v, dout, L, D, causal: bool = True,
                       window: int = 0):
    """The dq kernel on CUDA tensors (D = rowsum(dO∘O), (B,H,S) f32).
    CPU tensors take ``flash_attention_bwd``'s plain version instead."""
    dq = torch.empty_like(q)
    if is_fake(q):
        _check_bwd(q, k, v, dout, L, D, causal, window)
        _report("dq", q, k, causal, window)
        return dq
    _launch_bwd("flash_attention_dq_launch", "dq", q, k, v, dout, L, D,
                [dq], causal, window)
    return dq


def flash_attention_dkv(q, k, v, dout, L, D, causal: bool = True,
                        window: int = 0):
    """The dk/dv kernel on CUDA tensors; returns ``(dk, dv)``."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if is_fake(q):
        _check_bwd(q, k, v, dout, L, D, causal, window)
        _report("dkv", q, k, causal, window)
        return dk, dv
    _launch_bwd("flash_attention_dkv_launch", "dkv", q, k, v, dout, L, D,
                [dk, dv], causal, window)
    return dk, dv


def _check_bwd(q, k, v, dout, L, D, causal, window):
    _check_shapes(q, k, v)
    _check_args(causal, window, q, k, v, dout)
    B, S, H, _ = q.shape
    for t in (L, D):
        if t.dtype != torch.float32 or t.shape != (B, H, S) or \
                not t.is_contiguous() or t.device != q.device:
            raise ValueError("L and D must be contiguous float32 (B,H,S) "
                             "on q's device")


def _launch_bwd(fn_name, counter, q, k, v, dout, L, D, outs, causal,
                window):
    if _device_of(q) != "cuda":
        raise ValueError("the dq and dk/dv kernels take CUDA tensors; CPU "
                         "tensors go through flash_attention_bwd")
    _check_bwd(q, k, v, dout, L, D, causal, window)
    _check_aligned(q, k, v, dout)
    ints = _dims(q, k, causal, window)
    fn = _bind(_lib("flash_attention_bwd", q.shape[3]), fn_name,
               6 + len(outs), len(ints))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             L.data_ptr(), D.data_ptr(), *(t.data_ptr() for t in outs),
             *ints, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, fn_name)
    with _build.LAUNCH_LOCK:
        launches[counter] += 1


def flash_attention_bwd(q, k, v, out, dout, L, causal: bool = True,
                        window: int = 0):
    """Gradients ``(dq, dk, dv)`` of ``out = attention(q, k, v)`` given
    ``dout`` and the forward's ``L``: ``D = rowsum(dO∘O)`` as one
    expression, then the dq kernel and the dk/dv kernel (or ``ref.py`` on
    the CPU)."""
    _check_shapes(q, k, v)
    if _device_of(q) == "cpu" and not is_fake(q):
        return attention_bwd_ref(q, k, v, out, dout, L, causal, window)
    dout = dout.contiguous()
    D = torch.einsum("bshd,bshd->bhs", dout.float(), out.float()).contiguous()
    dq = flash_attention_dq(q, k, v, dout, L, D, causal, window)
    return (dq, *flash_attention_dkv(q, k, v, dout, L, D, causal, window))


class FlashAttention(torch.autograd.Function):
    """Flash attention with its own backward (the JAX ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        out, L = flash_attention_fwd(q, k, v, causal, window, q_offset)
        ctx.save_for_backward(q, k, v, out, L)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, L = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, L, ctx.causal,
                                         ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    q_offset: int = 0):
    """q: (B,S,H,hd); k,v: (B,Sk,KV,hd) with H % KV == 0 -> (B,S,H,hd),
    query i at position ``q_offset + i``. Differentiable in q, k and v at
    ``q_offset == 0``; an offset is refused where autograd would record
    the call (the backward kernels take none yet)."""
    if q_offset and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise ValueError(
            f"flash_attention at q_offset={q_offset} takes no gradient: the "
            f"dq and dk/dv kernels take no query offset yet (ROADMAP item "
            f"20, second part: the update's attention split over the model "
            f"axis); run it under torch.no_grad()")
    return FlashAttention.apply(q, k, v, causal, int(window), int(q_offset))
