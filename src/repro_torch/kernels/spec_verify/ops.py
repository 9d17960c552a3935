"""Public wrapper for the speculative verify attention kernel
(``csrc/spec_verify.cuh``, built as one library per pool dtype from
``spec_verify_{f32,bf16,int8}.cu``; replaces the Pallas
``_spec_verify_kernel`` of ``repro/kernels/spec_verify/kernel.py``).

The JAX wrapper flattens q position-major into ``(B, KV, K*group, hd)``
(row ``j*group + g``); the kernel numbers its rows the same way but reads
q and writes the output in place in the model layout ``(B, K, H, hd)``, so
the two transposes have no counterpart here. The kernel splits each row's
pages into the chunks of the paged wrapper's ``split_plan`` (which depends
on neither ``pos`` nor ``lens``), so query ``j`` walks exactly the chunks
the paged kernel walks at ``lens = pos + j + 1``. Every shape this wrapper
takes (up to 128 query rows, hd up to 256) fits the kernel's shared
memory under any plan, because the merge reuses the tiles' bytes: the
plan is never narrowed for the verify kernel, and no shape is refused for
it. CPU tensors go to the plain version in ``ref.py``; CUDA tensors launch
the kernel or raise — there is no fallback between the two.

Fake tensors (``utils/cost.full_cost``'s trace) launch nothing: the
wrapper returns outputs of the right shapes and dtypes and reports its
kernel's ``work`` to the cost counter, leaving the launch counter alone.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ops import (check_aligned,
                                                     split_plan)
from repro_torch.kernels.spec_verify.ref import spec_verify_attention_ref
from repro_torch.utils.cost import is_fake, report_kernel

launches = 0          # kernel launches since the last reset_launches()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_ROWS = 128       # K * group: 32 warps of up to 4 query rows each
_MAX_HD = 256


def reset_launches() -> None:
    global launches
    launches = 0


# the library of each pool dtype code
_LIBS = {0: "spec_verify_f32", 1: "spec_verify_bf16", 2: "spec_verify_int8"}


@functools.cache
def _bind(kv_code: int):
    fn = _build.load(_LIBS[kv_code]).spec_verify_launch
    fn.argtypes = ([ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def work(B: int, K: int, H: int, KV: int, hd: int, NP: int, ps: int,
         q_esz: int, kv_esz: int, quant: bool, live=None, pairs=None):
    """``(bytes, flops)`` of one launch that reads ``live`` (row,
    position) pairs of the pool and attends ``pairs`` (query head, key)
    pairs: K and V (and their f32 scales on an int8 pool) of the live
    positions, q, the output, the block table and ``pos`` each once, and
    4·hd flops per attended pair. By default every row sits at the
    largest base position, ``NP * ps - K``: all ``NP * ps`` positions
    live, query j attending ``pos + j + 1`` keys."""
    pos = NP * ps - K
    live = B * NP * ps if live is None else live
    pairs = B * H * (pos * K + K * (K + 1) // 2) if pairs is None else pairs
    nbytes = (2 * live * KV * hd * kv_esz + (2 * live * KV * 4 if quant
                                             else 0)
              + 2 * B * K * H * hd * q_esz + B * NP * 4 + B * 4)
    return nbytes, 4 * hd * pairs


def _check_cuda_inputs(q, k_pages, v_pages, block_table, pos, k_scales,
                       v_scales):
    dev = q.device
    if q.dim() != 4:
        raise ValueError(f"q must be (B,K,H,hd), got {tuple(q.shape)}")
    B, K, H, hd = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"k/v pools must be (P,ps,KV,hd) and equal, got "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    P, ps, KV, hd_k = k_pages.shape
    if hd_k != hd or H % KV:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pages.shape)}")
    if K * (H // KV) > _MAX_ROWS or hd % 32 or hd > _MAX_HD:
        raise ValueError(f"kernel takes K * group <= {_MAX_ROWS} query rows "
                         f"and head_dim a multiple of 32 up to {_MAX_HD}; "
                         f"got K {K}, group {H // KV}, head_dim {hd}")
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
    if block_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("block_table and pos must be int32")
    if block_table.dim() != 2 or block_table.shape[0] != B or \
            pos.shape != (B,):
        raise ValueError(f"block_table {tuple(block_table.shape)} / pos "
                         f"{tuple(pos.shape)} do not match batch {B}")
    tensors = [q, k_pages, v_pages, block_table, pos]
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


def spec_verify_attention(q, k_pages, v_pages, block_table, pos, *,
                          k_scales=None, v_scales=None):
    """q: (B,K,H,hd) K chunk queries per row, the chunk's K/V already
    written into the pool at positions ``pos[b] .. pos[b]+K-1``;
    k_pages,v_pages: (P,ps,KV,hd) shared page pool (f32, bf16, or int8
    with (P,ps,KV) f32 ``k_scales`` / ``v_scales``); block_table: (B,NP)
    int32 (-1 = unmapped); pos: (B,) int32 base positions. Query ``j``
    attends pool positions ``<= pos[b]+j``. Returns (B,K,H,hd) in q's
    dtype; each query is bitwise the paged kernel's output at ``lens =
    pos + j + 1`` on the card."""
    if is_fake(q):
        _check_cuda_inputs(q, k_pages, v_pages, block_table, pos,
                           k_scales, v_scales)
        B, K, H, hd = q.shape
        _, ps, KV, _ = k_pages.shape
        report_kernel("spec_verify", *work(
            B, K, H, KV, hd, block_table.shape[1], ps, q.element_size(),
            k_pages.element_size(), k_pages.dtype == torch.int8))
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return spec_verify_attention_ref(q, k_pages, v_pages, block_table,
                                         pos, k_scales, v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda_inputs(q, k_pages, v_pages, block_table, pos, k_scales,
                       v_scales)
    check_aligned(k_pages, v_pages)
    B = q.shape[0]
    _, ps, KV, _ = k_pages.shape
    return _launch(q, k_pages, v_pages, block_table, pos, k_scales,
                   v_scales, split_plan(B * KV, block_table.shape[1], ps,
                                        _build.sm_count(q.device.index or 0)))


def _launch(q, k_pages, v_pages, block_table, pos, k_scales, v_scales,
            plan):
    """One counted launch on checked CUDA inputs under ``plan`` =
    ``(chunk, n_chunks)``: the wrapper's is ``split_plan``'s, and
    ``chip_smoke.py``'s split probe times another."""
    B, K, H, hd = q.shape
    P, ps, KV, _ = k_pages.shape
    out = torch.empty_like(q)
    err = _bind(_DTYPE_CODES[k_pages.dtype])(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if k_scales is not None else None,
        v_scales.data_ptr() if v_scales is not None else None,
        block_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
        B, K, KV, H // KV, hd, P, ps, block_table.shape[1], *plan,
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pages.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "spec_verify")
    global launches
    with _build.LAUNCH_LOCK:
        launches += 1
    return out
