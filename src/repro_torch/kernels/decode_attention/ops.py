"""Public wrapper for the decode attention kernel
(``csrc/decode_attention.cu``; replaces the Pallas ``_decode_kernel`` of
``repro/kernels/decode_attention/kernel.py``).

The kernel reads the model layout ``(B, S, KV, hd)`` by stride, so the JAX
wrapper's transposes and block picking have no counterpart; it masks the
ragged last tile itself, so any S is taken. It splits the keys into chunks
that one thread-block cluster merges inside the launch, so a call is one
launch and needs no workspace. CPU tensors go to the plain version in
``ref.py``; CUDA tensors launch the kernel or raise — there is no fallback
between the two.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

launches = 0          # wrapper calls that launched the kernel since reset

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GROUP = 32       # one warp per query head of a GQA group
_MAX_HD = 256
_TILE = 32            # keys per tile in the kernel: one mask bit per lane
_MAX_CHUNKS = 8       # chunks of one (row, kv head): the portable cluster
_BLOCKS_PER_SM = 4    # the split aims at about this many blocks per SM


def reset_launches() -> None:
    global launches
    launches = 0


@functools.cache
def _bind():
    fn = _build.load("decode_attention").decode_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def split_plan(n_pairs: int, S: int, n_sm: int):
    """``(chunk, n_chunks)``: keys per block, in whole 32-key tiles. As
    many chunks as fill about four blocks per SM over ``n_pairs`` (row, kv
    head) pairs, but at most 8 (one cluster per pair) and at most one per
    two tiles, so each block has a tile in flight while it computes one;
    past that the chunk grows with S. No chunk is empty. At B=32, KV=2 on
    132 SMs: S=256 gives 4 chunks of 64 keys (256 blocks), S=2048 8 chunks
    of 256."""
    tiles = -(-S // _TILE)
    want = min(_MAX_CHUNKS, max(1, tiles // 2),
               max(1, -(-_BLOCKS_PER_SM * n_sm // n_pairs)))
    chunk = _TILE * -(-tiles // want)
    return chunk, -(-S // chunk)


def _check_cuda_inputs(q, k, v, valid):
    B, H, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or \
            k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"k/v must be one (B,S,KV,hd) shape fitting q "
                         f"{tuple(q.shape)}; got {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    S, KV = k.shape[1], k.shape[2]
    if H // KV > _MAX_GROUP or hd % 32 or hd > _MAX_HD or S < 1:
        raise ValueError(f"kernel takes group <= {_MAX_GROUP}, head_dim a "
                         f"multiple of 32 up to {_MAX_HD} and S >= 1; got "
                         f"group {H // KV}, head_dim {hd}, S {S}")
    if q.dtype not in _DTYPE_CODES or k.dtype not in _DTYPE_CODES or \
            v.dtype != k.dtype:
        raise TypeError(f"q and the k/v pair must each be float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype} / {v.dtype}")
    if valid.dtype != torch.bool or valid.shape != (B, S):
        raise ValueError(f"valid must be bool (B,S) = ({B},{S}), got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    for t in (q, k, v, valid):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got "
                             f"{t.device}")
    if not (q.is_contiguous() and valid.is_contiguous()):
        raise ValueError("q and valid must be contiguous")
    for t in (k, v):
        if t.stride(3) != 1 or t.stride(2) != hd:
            raise ValueError("k/v must hold each position's kv heads and "
                             "head dims contiguously")


def decode_attention(q, k, v, valid):
    """q: (B,H,hd) one query per row; k,v: (B,S,KV,hd) (f32 or bf16, read
    by stride); valid: (B,S) bool. Returns (B,H,hd) in q's dtype; a row
    with no valid key gets the mean of V over S, as ``ref.py``."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, valid)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda_inputs(q, k, v, valid)
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    group = H // KV
    chunk, n_chunks = split_plan(B * KV, S,
                                 _build.sm_count(q.device.index or 0))
    out = torch.empty_like(q)
    err = _bind()(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                  out.data_ptr(), B, S, KV, group, hd, chunk, n_chunks,
                  k.stride(0), k.stride(1), v.stride(0), v.stride(1),
                  _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype],
                  torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention")
    global launches
    launches += 1
    return out
