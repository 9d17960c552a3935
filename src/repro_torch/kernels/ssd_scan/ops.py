"""Public wrapper for the SSD scan kernel (``csrc/ssd_scan.cu``; replaces
the Pallas ``_ssd_kernel`` of ``repro/kernels/ssd_scan/kernel.py``).

The signature is the JAX ``ops.ssd_scan``'s, which mirrors
``models/mamba.ssd_chunked``. The chunk is ``q = min(chunk_size, s)``; an
``s`` that is not a whole number of chunks is padded with zero-``dt``
steps, which leave the state untouched (decay exp(0) = 1, input weight 0),
and y is cut back to ``s``. ``dA = dt * A`` is formed here in f32. The
kernel reads x, B and C in the model layout by stride, so the JAX
wrapper's transposes have no counterpart.

The kernel has two routes, one launch each, and ``plan`` picks one with
its head tile: bf16 on the tensor cores (``wgmma`` with TMA tiles) where
the shape and the views allow it, else f32 FMAs (fp32 inputs, every other
shape, and views TMA cannot read). Both take every shape this wrapper
takes; neither is a fallback for the other.

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
SIMT, TENSOR_CORES = 0, 1      # the kernel's two routes
_TC_HEAD_DIMS = (64, 128)      # one or two warpgroups per head
_TC_STATES = (32, 64, 128)
_HEAD_TILES = (2, 1)           # heads a block, widest first
_MAX_WARPGROUPS = 2            # tensor-core route: per block


def reset_launches() -> None:
    global launches
    launches = 0


@functools.cache
def _bind():
    fn = _build.load("ssd_scan").ssd_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(route: int, p: int, n: int, q: int, ht: int) -> int:
    """Dynamic shared memory of one block (``csrc/ssd_scan.cu``'s
    ``*_smem_bytes``). f32 route: per head of the tile the (p, n) state,
    the x_j tile and three q-long vectors (cs, dt, decay weights); once
    the C_i, B_j and W tiles (rows padded by one float). Tensor-core
    route: 1 KB of alignment slack, two C_i tiles, two stages of {B_j, x_j
    per head}, the f32 Gram tile, three bf16 terms of each 64-row state
    slice, the mbarriers and the q-long vectors."""
    if route == TENSOR_CORES:
        tb, tx = 2 * _TILE * n, 2 * _TILE * p
        return (1024 + 2 * tb + 2 * (tb + ht * tx) + 4 * _TILE * _TILE
                + ht * (p // 64) * 3 * tb + 8 * 4 + 12 * ht * q)
    return 4 * (ht * p * (n + 1) + 2 * _TILE * (n + 1)
                + ht * _TILE * (p + 1) + _TILE * (_TILE + 1) + 3 * ht * q)


def _tma_ready(*views) -> bool:
    """Whether TMA can read each (b, s, ·, d) view: a 16-byte aligned base
    and strides in whole 16 bytes (bf16: multiples of 8 elements)."""
    return all(t.data_ptr() % 16 == 0 and all(
        t.stride(d) % 8 == 0 for d in range(3)) for t in views)


def plan(dtype, p: int, n: int, q: int, heads_per_group: int,
         n_blocks: int, n_sm: int, tma_ready: bool = True):
    """``(route, head tile)``: the tensor-core route for bf16 at p in (64,
    128) and n in (32, 64, 128) on views TMA can read, else the f32
    route; on either, two heads a block where two divide the heads of a
    group, fit the block (two warpgroups of 64 columns of p on the tensor
    cores) and its shared memory, and take fewer waves over ``n_sm`` SMs
    than the ``n_blocks`` (rows x heads) one-head blocks would: a two-head
    block shares its Gram tiles but takes longer than a one-head block
    (about 1.3x on the tensor cores and 1.6x on the f32 route at the
    ssm_score shape on an NVIDIA H100 80GB HBM3 at 700 W: chip_smoke.py's
    head-tile probe), so it pays only where it saves a wave. ``None``
    when no tile fits (the wrapper refuses the shape). At the ssm_score
    shape (bf16, p 64, n 128, chunk 256, B=32, 32 heads a group, 132 SMs):
    the tensor cores, two heads a block."""
    def fits(route, ht):
        return (heads_per_group % ht == 0
                and (route == SIMT or ht * (p // 64) <= _MAX_WARPGROUPS)
                and smem_bytes(route, p, n, q, ht) <= _MAX_SMEM
                and (ht == 1 or -(-n_blocks // (ht * n_sm))
                     < -(-n_blocks // n_sm)))
    routes = (TENSOR_CORES, SIMT) if (
        dtype == torch.bfloat16 and tma_ready and p in _TC_HEAD_DIMS
        and n in _TC_STATES) else (SIMT,)
    for route in routes:
        for ht in _HEAD_TILES:
            if fits(route, ht):
                return route, ht
    return None


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
            smem_bytes(SIMT, p, n, q, 1) > _MAX_SMEM:
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
    g = B.shape[2]
    y, final = _launch(x, dt, dA, B, C, q, plan(
        x.dtype, p, B.shape[3], q, h // g, b * h,
        _build.sm_count(x.device.index or 0), _tma_ready(x, B, C)))
    return y[:, :s], final


def _launch(x, dt, dA, B, C, q, route_plan):
    """One counted launch on checked, padded CUDA inputs (dt and dA
    contiguous f32) under ``route_plan`` = ``(route, head tile)``: the
    wrapper's is ``plan``'s, and ``chip_smoke.py``'s head-tile probe times
    others."""
    b, sp, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y = torch.empty((b, sp, h, p), dtype=x.dtype, device=x.device)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    err = _bind()(x.data_ptr(), dt.data_ptr(), dA.data_ptr(), B.data_ptr(),
                  C.data_ptr(), y.data_ptr(), final.data_ptr(), b, sp, h, g,
                  p, n, q, x.stride(0), x.stride(1), x.stride(2),
                  B.stride(0), B.stride(1), B.stride(2), C.stride(0),
                  C.stride(1), C.stride(2), _DTYPE_CODES[x.dtype],
                  *route_plan, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd_scan")
    global launches
    launches += 1
    return y, final
