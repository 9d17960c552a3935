"""Public wrapper for the paged decode attention kernel
(``csrc/paged_attention.cu``; replaces the Pallas ``_paged_decode_kernel``
of ``repro/kernels/paged_attention/kernel.py``).

The kernel splits each row's pages into chunks that one thread-block
cluster merges inside the launch, so a call is one launch and needs no
workspace. ``split_plan`` picks the chunks; the spec-verify wrapper uses
it too, which keeps each verify query bitwise equal to this kernel. CPU
tensors go to the plain version in ``ref.py``; CUDA tensors launch the
kernel or raise — there is no fallback between the two.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import paged_decode_attention_ref

launches = 0          # kernel launches since the last reset_launches()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
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
    fn = _build.load("paged_attention").paged_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def split_plan(n_pairs: int, NP: int, ps: int, n_sm: int):
    """``(chunk, n_chunks)``: whole pages per block, and blocks per (row,
    kv head), over ``n_pairs`` = B*KV pairs of ``NP`` pages of ``ps``
    tokens on ``n_sm`` SMs. As many chunks as fill about four blocks per
    SM, but at most 8 (one cluster per pair) and at most one per two
    32-key tiles, so each block has a tile in flight while it computes
    one; past that the chunk grows with NP. No chunk is empty. At B=32,
    KV=2, ps=16 on 132 SMs: NP=16 gives 4 chunks of 4 pages (256 blocks),
    NP=128 8 chunks of 16.

    The plan takes no length: it depends on neither ``lens`` nor ``pos``,
    so a verify query at ``pos + j + 1`` and this kernel at ``lens = pos +
    j + 1`` walk the same chunks. Every shape the two wrappers take fits
    the kernels' shared memory under any plan (the merge reuses the tiles'
    bytes), so the verify wrapper refuses no shape for the plan's sake."""
    NP = max(NP, 1)
    min_pages = -(-2 * _TILE // ps)
    want = min(_MAX_CHUNKS, max(1, NP // min_pages),
               max(1, -(-_BLOCKS_PER_SM * n_sm // n_pairs)))
    chunk = -(-NP // want)
    return chunk, -(-NP // chunk)


def check_aligned(k_pages, v_pages) -> None:
    """The kernels read pool rows by 16-byte copies: refuse a pool whose
    base is not 16-byte aligned (every pool the engine makes is: hd is a
    multiple of 32 and views start at whole pages)."""
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary, "
                             f"got address {t.data_ptr():#x}")


def _check_cuda_inputs(q, k_pages, v_pages, block_table, lens, k_scales,
                       v_scales):
    dev = q.device
    B, H, hd = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"k/v pools must be (P,ps,KV,hd) and equal, got "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    P, ps, KV, hd_k = k_pages.shape
    if hd_k != hd or H % KV:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pages.shape)}")
    if H // KV > _MAX_GROUP or hd % 32 or hd > _MAX_HD:
        raise ValueError(f"kernel takes group <= {_MAX_GROUP} and head_dim "
                         f"a multiple of 32 up to {_MAX_HD}; got group "
                         f"{H // KV}, head_dim {hd}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_pages.dtype not in _DTYPE_CODES or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"pools must share one of {list(_DTYPE_CODES)}, got "
                        f"{k_pages.dtype} / {v_pages.dtype}")
    quant = k_pages.dtype == torch.int8
    if quant != (k_scales is not None) or (k_scales is None) != (
            v_scales is None):
        raise ValueError("int8 pools need k_scales and v_scales; other "
                         "pools take none")
    if block_table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("block_table and lens must be int32")
    if block_table.dim() != 2 or block_table.shape[0] != B or \
            lens.shape != (B,):
        raise ValueError(f"block_table {tuple(block_table.shape)} / lens "
                         f"{tuple(lens.shape)} do not match batch {B}")
    tensors = [q, k_pages, v_pages, block_table, lens]
    if quant:
        for s in (k_scales, v_scales):
            if s.dtype != torch.float32 or s.shape != (P, ps, KV):
                raise ValueError(f"scales must be f32 (P,ps,KV), got "
                                 f"{s.dtype} {tuple(s.shape)}")
        tensors += [k_scales, v_scales]
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("all inputs must be contiguous")
    check_aligned(k_pages, v_pages)


def paged_decode_attention(q, k_pages, v_pages, block_table, lens, *,
                           k_scales=None, v_scales=None):
    """q: (B,H,hd) one query per row; k_pages,v_pages: (P,ps,KV,hd) shared
    page pool (f32, bf16, or int8 with (P,ps,KV) f32 ``k_scales`` /
    ``v_scales``); block_table: (B,NP) int32 (-1 = unmapped); lens: (B,)
    int32 live tokens per row. Returns (B,H,hd) in q's dtype."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, block_table,
                                          lens, k_scales, v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda_inputs(q, k_pages, v_pages, block_table, lens, k_scales,
                       v_scales)
    B, _, _ = q.shape
    _, ps, KV, _ = k_pages.shape
    return _launch(q, k_pages, v_pages, block_table, lens, k_scales,
                   v_scales, split_plan(B * KV, block_table.shape[1], ps,
                                        _build.sm_count(q.device.index or 0)))


def _launch(q, k_pages, v_pages, block_table, lens, k_scales, v_scales,
            plan):
    """One counted launch on checked CUDA inputs under ``plan`` =
    ``(chunk, n_chunks)``: the wrapper's is ``split_plan``'s, and
    ``chip_smoke.py``'s split probe times another."""
    B, H, hd = q.shape
    P, ps, KV, _ = k_pages.shape
    out = torch.empty_like(q)
    err = _bind()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                  k_scales.data_ptr() if k_scales is not None else None,
                  v_scales.data_ptr() if v_scales is not None else None,
                  block_table.data_ptr(), lens.data_ptr(), out.data_ptr(),
                  B, KV, H // KV, hd, P, ps, block_table.shape[1], *plan,
                  _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pages.dtype],
                  torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_attention")
    global launches
    launches += 1
    return out
