"""Public wrapper for the SSD scan kernel (``csrc/ssd_scan.cu``; replaces
the Pallas ``_ssd_kernel`` of ``repro/kernels/ssd_scan/kernel.py``).

The signature is the JAX ``ops.ssd_scan``'s, which mirrors
``models/mamba.ssd_chunked``. The chunk is ``q = min(chunk_size, s)``; an
``s`` that is not a whole number of chunks is padded with zero-``dt``
steps, which leave the state untouched (decay exp(0) = 1, input weight 0),
and y is cut back to ``s``. ``dA = dt * A`` is formed here in f32. The
kernel reads x, B and C in the model layout by stride, so the JAX
wrapper's transposes have no counterpart.

CPU tensors go to the plain version in ``ref.py``; CUDA tensors launch the
kernel or raise — there is no fallback between the two. The kernel starts
from zero state (JAX asserts ``initial_state is None``) and has no backward
(the JAX kernel has no VJP): an ``initial_state``, or an input that
requires grad while grad mode is on, raises on either device.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_ref

launches = 0          # wrapper calls that launched the kernel since reset

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_MAX_STATE = 128
_TILE = 64            # rows of an i-tile / columns of a j-tile in the kernel
_MAX_SMEM = 232448    # bytes of shared memory a block may use on Hopper


def reset_launches() -> None:
    global launches
    launches = 0


@functools.cache
def _bind():
    fn = _build.load("ssd_scan").ssd_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 9 + [ctypes.c_int]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(p: int, n: int, q: int) -> int:
    """The kernel's dynamic shared memory: the (p, n) state, the C_i and
    B_j tiles, the x_j and W tiles (rows padded by one float) and three
    q-long vectors (cs, dt, decay weights)."""
    return 4 * (p * (n + 1) + 2 * _TILE * (n + 1) + _TILE * (p + 1)
                + _TILE * (_TILE + 1) + 3 * q)


def _check_cuda_inputs(x, dt, A, B, C, q):
    b, s, h, p = x.shape
    if B.dim() != 4 or B.shape != C.shape or B.shape[:2] != (b, s) or \
            h % B.shape[2]:
        raise ValueError(f"B and C must be one (b,s,g,n) shape fitting x "
                         f"{tuple(x.shape)} with h % g == 0; got "
                         f"{tuple(B.shape)} / {tuple(C.shape)}")
    if dt.shape != (b, s, h) or A.shape != (h,):
        raise ValueError(f"dt must be (b,s,h) = {(b, s, h)} and A (h,); got "
                         f"{tuple(dt.shape)} and {tuple(A.shape)}")
    n = B.shape[3]
    if p not in _HEAD_DIMS or not 1 <= n <= _MAX_STATE or \
            smem_bytes(p, n, q) > _MAX_SMEM:
        raise ValueError(f"kernel takes head_dim in {_HEAD_DIMS}, state "
                         f"size 1..{_MAX_STATE} and a chunk whose shared "
                         f"memory fits {_MAX_SMEM} bytes; got p={p}, n={n}, "
                         f"chunk {q}")
    if x.dtype not in _DTYPE_CODES or B.dtype != x.dtype or \
            C.dtype != x.dtype:
        raise TypeError(f"x, B and C must share float32 or bfloat16, got "
                        f"{x.dtype}, {B.dtype}, {C.dtype}")
    for t in (dt, A, B, C):
        if t.device != x.device:
            raise ValueError(f"all inputs must be on {x.device}, got "
                             f"{t.device}")
    if x.stride(3) != 1 or B.stride(3) != 1 or C.stride(3) != 1:
        raise ValueError("x, B and C must be contiguous in their last dim")


def ssd_scan(x, dt, A, B, C, chunk_size: int, initial_state=None):
    """x: (b,s,h,p) f32 or bf16; dt: (b,s,h) (softplus'ed); A: (h,)
    negative; B, C: (b,s,g,n) in x's dtype. Returns (y (b,s,h,p) in x's
    dtype, final_state (b,h,p,n) f32)."""
    if initial_state is not None:
        raise ValueError("the SSD scan kernel starts from zero state (as "
                         "JAX's, which asserts initial_state is None); run "
                         "models.mamba.ssd_chunked to carry a state in")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C)):
        raise RuntimeError("the SSD scan kernel has no backward (the JAX "
                           "kernel has no VJP): run the model's chunked "
                           "form (attn_impl='xla') under autograd")
    if x.device.type == "cpu":
        return ssd_ref(x, dt, A, B, C, chunk_size)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, s, h, p = x.shape
    q = min(chunk_size, s)
    _check_cuda_inputs(x, dt, A, B, C, q)
    pad = (-s) % q
    if pad:
        x, dt, B, C = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                       for t in (x, dt, B, C))
    dt = dt.float().contiguous()
    dA = (dt * A.float()[None, None, :]).contiguous()
    sp, g, n = s + pad, B.shape[2], B.shape[3]
    y = torch.empty((b, sp, h, p), dtype=x.dtype, device=x.device)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    err = _bind()(x.data_ptr(), dt.data_ptr(), dA.data_ptr(), B.data_ptr(),
                  C.data_ptr(), y.data_ptr(), final.data_ptr(), b, sp, h, g,
                  p, n, q, x.stride(0), x.stride(1), x.stride(2),
                  B.stride(0), B.stride(1), B.stride(2), C.stride(0),
                  C.stride(1), C.stride(2), _DTYPE_CODES[x.dtype],
                  torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd_scan")
    global launches
    launches += 1
    return y[:, :s], final
