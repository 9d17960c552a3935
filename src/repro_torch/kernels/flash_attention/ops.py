"""Public wrapper for the flash attention kernels (``csrc/flash_attention.cu``
replaces the Pallas ``_fa_kernel`` of ``repro/kernels/flash_attention/
kernel.py``; ``csrc/flash_attention_bwd.cu`` replaces ``_dq_kernel`` and
``_dkv_kernel`` of ``bwd_kernel.py``).

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
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_fwd_ref)

# kernel launches since the last reset_launches(), per kernel
launches = {"fwd": 0, "dq": 0, "dkv": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@functools.cache
def _bind(lib: str, fn_name: str, n_ptrs: int):
    fn = getattr(_build.load(lib), fn_name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 9
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


def _check_cuda(causal, window, *tensors):
    q, k = tensors[0], tensors[1]
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype
                                          for t in tensors):
        raise TypeError(f"q, k, v (and dO) must share float32 or bfloat16, "
                        f"got {[t.dtype for t in tensors]}")
    if q.shape[3] not in _HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {_HEAD_DIMS}, got "
                         f"{q.shape[3]}")
    if (causal or window > 0) and q.shape[1] > k.shape[1]:
        raise ValueError(f"a causal or windowed query past the last key "
                         f"(S={q.shape[1]} > Sk={k.shape[1]}) would be fully "
                         f"masked; the kernel takes S <= Sk")
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("all inputs must be contiguous")
        if q.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError("bfloat16 inputs must start on a 16-byte "
                             "boundary: the kernels load them by TMA")


def _device_of(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return q.device.type


def _dims(q, k, causal, window):
    B, S, H, hd = q.shape
    return [B, S, k.shape[1], H, k.shape[2], hd, int(bool(causal)),
            int(window), _DTYPE_CODES[q.dtype]]


def flash_attention_fwd(q, k, v, causal: bool = True, window: int = 0):
    """q: (B,S,H,hd); k,v: (B,Sk,KV,hd). Returns ``(out (B,S,H,hd) in q's
    dtype, L (B,H,S) f32)`` — the forward kernel, or ``ref.py`` on the
    CPU."""
    _check_shapes(q, k, v)
    if _device_of(q) == "cpu":
        return attention_fwd_ref(q, k, v, causal, window)
    _check_cuda(causal, window, q, k, v)
    B, S, H, _ = q.shape
    out = torch.empty_like(q)
    L = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    err = _bind("flash_attention", "flash_attention_fwd_launch", 5)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        L.data_ptr(), *_dims(q, k, causal, window),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_fwd")
    launches["fwd"] += 1
    return out, L


def flash_attention_dq(q, k, v, dout, L, D, causal: bool = True,
                       window: int = 0):
    """The dq kernel on CUDA tensors (D = rowsum(dO∘O), (B,H,S) f32).
    CPU tensors take ``flash_attention_bwd``'s plain version instead."""
    dq = torch.empty_like(q)
    _launch_bwd("flash_attention_dq_launch", "dq", q, k, v, dout, L, D,
                [dq], causal, window)
    return dq


def flash_attention_dkv(q, k, v, dout, L, D, causal: bool = True,
                        window: int = 0):
    """The dk/dv kernel on CUDA tensors; returns ``(dk, dv)``."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("flash_attention_dkv_launch", "dkv", q, k, v, dout, L, D,
                [dk, dv], causal, window)
    return dk, dv


def _launch_bwd(fn_name, counter, q, k, v, dout, L, D, outs, causal,
                window):
    _check_shapes(q, k, v)
    if _device_of(q) != "cuda":
        raise ValueError("the dq and dk/dv kernels take CUDA tensors; CPU "
                         "tensors go through flash_attention_bwd")
    _check_cuda(causal, window, q, k, v, dout)
    B, S, H, _ = q.shape
    for t in (L, D):
        if t.dtype != torch.float32 or t.shape != (B, H, S) or \
                not t.is_contiguous() or t.device != q.device:
            raise ValueError("L and D must be contiguous float32 (B,H,S) "
                             "on q's device")
    fn = _bind("flash_attention_bwd", fn_name, 6 + len(outs))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             L.data_ptr(), D.data_ptr(), *(t.data_ptr() for t in outs),
             *_dims(q, k, causal, window),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, fn_name)
    launches[counter] += 1


def flash_attention_bwd(q, k, v, out, dout, L, causal: bool = True,
                        window: int = 0):
    """Gradients ``(dq, dk, dv)`` of ``out = attention(q, k, v)`` given
    ``dout`` and the forward's ``L``: ``D = rowsum(dO∘O)`` as one
    expression, then the dq kernel and the dk/dv kernel (or ``ref.py`` on
    the CPU)."""
    _check_shapes(q, k, v)
    if _device_of(q) == "cpu":
        return attention_bwd_ref(q, k, v, out, dout, L, causal, window)
    dout = dout.contiguous()
    D = torch.einsum("bshd,bshd->bhs", dout.float(), out.float()).contiguous()
    dq = flash_attention_dq(q, k, v, dout, L, D, causal, window)
    return (dq, *flash_attention_dkv(q, k, v, dout, L, D, causal, window))


class FlashAttention(torch.autograd.Function):
    """Flash attention with its own backward (the JAX ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, L = flash_attention_fwd(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, L)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, L = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, L, ctx.causal,
                                         ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q: (B,S,H,hd); k,v: (B,Sk,KV,hd) with H % KV == 0 -> (B,S,H,hd).
    Differentiable in q, k and v."""
    return FlashAttention.apply(q, k, v, causal, int(window))
