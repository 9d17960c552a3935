"""Page-pool primitives for the paged KV cache (port of
``repro/models/paging.py``): allocation, release, fork and copy-on-write
on refcounted pages, and the int8 page format.

Pages are refcounted: a page may be mapped by several block tables at once
(the prefix-sharing substrate). ``fork_pages`` maps an existing page run
into more rows, ``release_pages`` decrements, and ``cow_pages`` privatizes
a shared page on first write (allocate + remap; the data copy is the
caller's, per layer).

Conventions, as in the JAX package:

  - ``block_table``: ``(B, pages_per_slot) int32``; ``PAGE_UNMAPPED``
    (= -1) marks an unallocated entry. Slot-local page ``j`` holds the
    absolute positions ``[j*page_size, (j+1)*page_size)``.
  - ``refcount``: ``(n_pages,) int32`` — 0 = free, k >= 1 = k owners.
  - A failed allocation returns the sentinel ``n_pages``.

JAX drops out-of-range scatter indices (``mode="drop"``); on CUDA an
out-of-range index is a device-side assert. So every scatter here either
targets one trash slot appended past the end (sliced off afterwards;
duplicate writes into it are harmless) or adds a zero through a clamped
index. Nothing reads a value back to the host: these run inside the
rollout macro-step.
"""
from __future__ import annotations

import torch

PAGE_UNMAPPED = -1


def pages_per_slot(s_max: int, page_size: int) -> int:
    """Block-table width covering ``s_max`` tokens."""
    return -(-s_max // page_size)


def pool_pages_needed(batch: int, s_max: int, page_size: int) -> int:
    """Pool size that can never exhaust: full per-slot provisioning."""
    return batch * pages_per_slot(s_max, page_size)


def pool_pages_needed_shared(batch: int, s_max: int, prefix_len: int,
                             page_size: int) -> int:
    """Exhaustion-free pool size when the first ``prefix_len`` tokens of
    every slot are one shared prefix run: its full pages are allocated once
    and forked into every slot. Pass the effective shared length (full
    pages only); a partial prefix page stays per slot."""
    pps = pages_per_slot(s_max, page_size)
    shared = min(prefix_len // page_size, pps)
    return batch * (pps - shared) + shared


def _i32_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x.to(torch.int32), 0, dtype=torch.int32)


def alloc_pages(refcount: torch.Tensor, need: torch.Tensor, grant=None):
    """Grab one free page (refcount 0) for every row with ``need=True``.

    refcount: (P,) int32; need: (B,) bool. Returns ``(pages, refcount')``:
    the r-th needing row receives the r-th free page (its refcount becomes
    1); rows with ``need=False`` or beyond the free supply get the sentinel
    ``P``. Rank-match by cumulative sums: no loop, no host read.

    ``grant``: on a data row of a data-parallel rollout, a callable
    ``(need, refcount) -> (offset, free)`` (0-d tensors, the same exchange
    on every row) giving the needing rows of the data rows before this one
    and the free count of the whole (global) pool. A needing row is then
    granted a page iff its rank over the global batch, ``offset`` plus its
    rank here, is below ``free``: JAX's rank rule over its one pool. The
    page itself comes from this row's own pool, which holds enough free
    pages for every grant the global count allows.
    """
    P = refcount.shape[0]
    dev = refcount.device
    free = refcount == 0
    rank = _i32_cumsum(need) - 1                            # (B,) alloc rank
    free_rank = _i32_cumsum(free) - 1                       # (P,)
    if grant is None:
        offset, total_free = 0, free.sum(dtype=torch.int32)
    else:
        offset, total_free = grant(need, refcount)
    # rank_to_page[r] = pool index of the r-th free page (slot P = trash)
    rank_to_page = torch.full((P + 1,), P, dtype=torch.int32, device=dev)
    rank_to_page.scatter_(0, torch.where(free, free_rank, P).long(),
                          torch.arange(P, dtype=torch.int32, device=dev))
    ok = need & (rank + offset < total_free)
    pages = torch.where(ok, rank_to_page[rank.clamp(0, P - 1)], P)
    rc = torch.cat([refcount, refcount.new_zeros(1)])
    rc.scatter_(0, pages.long(), 1)
    return pages.to(torch.int32), rc[:P]


def release_pages(refcount: torch.Tensor, block_table: torch.Tensor,
                  rows: torch.Tensor):
    """Drop one reference per page mapped by ``rows`` (bool (B,)) and unmap
    those block-table rows. Duplicate pages accumulate (``scatter_add``);
    unowned entries add 0 through a clamped index. Returns
    ``(refcount', block_table')``."""
    owned = rows[:, None] & (block_table >= 0)
    idx = torch.where(owned, block_table, 0).long().reshape(-1)
    refcount = refcount.scatter_add(
        0, idx, -owned.to(refcount.dtype).reshape(-1))
    block_table = torch.where(rows[:, None], PAGE_UNMAPPED, block_table)
    return refcount, block_table


def fork_pages(refcount: torch.Tensor, block_table: torch.Tensor,
               pages: torch.Tensor, rows: torch.Tensor):
    """Map the page run ``pages`` (K,) into block-table entries ``[0, K)``
    of every row with ``rows=True``, adding one reference per (row, page).
    Sentinel and unmapped entries of ``pages`` are skipped. The target
    entries must be unmapped (released rows, fresh slots). Returns
    ``(refcount', block_table')``."""
    P = refcount.shape[0]
    K = pages.shape[0]
    valid = (pages >= 0) & (pages < P)                      # (K,)
    take = rows[:, None] & valid[None, :]                   # (B, K)
    head = torch.where(take, pages[None, :].to(block_table.dtype),
                       block_table[:, :K])
    block_table = torch.cat([head, block_table[:, K:]], dim=1)
    n = rows.sum(dtype=torch.int32)
    refcount = refcount.scatter_add(
        0, torch.where(valid, pages, 0).long(),
        torch.where(valid, n, 0).to(refcount.dtype))
    return refcount, block_table


def cow_pages(refcount: torch.Tensor, block_table: torch.Tensor,
              entry: torch.Tensor, rows: torch.Tensor, grant=None):
    """Copy-on-write: privatize the page behind ``block_table[r,
    entry[r]]`` for every row with ``rows=True`` about to write into a
    SHARED page (refcount > 1) — allocate a fresh page, remap the entry and
    drop one reference from the shared source. Private and unmapped pages
    are untouched.

    Returns ``(src, dst, blocked, refcount', block_table')``: ``src``/``dst``
    (B,) are the page pairs whose data the caller copies per layer
    (sentinel ``P`` = no copy); ``blocked`` marks rows that needed a
    private copy and found the pool exhausted: their write must be dropped,
    or it would land in every sibling's page. ``grant``: the copies'
    allocation on a data row (``alloc_pages``)."""
    B, NP = block_table.shape
    P = refcount.shape[0]
    ridx = torch.arange(B, device=block_table.device)
    ent = entry.long().clamp(0, NP - 1)
    cur = block_table[ridx, ent]                            # (B,)
    shared = (cur >= 0) & (refcount[cur.clamp(0, P - 1).long()] > 1)
    need = rows & shared
    new_pages, refcount = alloc_pages(refcount, need, grant)
    ok = need & (new_pages < P)
    blocked = need & ~ok
    block_table = block_table.clone()
    block_table[ridx, ent] = torch.where(ok, new_pages, cur)
    refcount = refcount.scatter_add(
        0, torch.where(ok, cur, 0).long(), -ok.to(refcount.dtype))
    src = torch.where(ok, cur, P).to(torch.int32)
    dst = torch.where(ok, new_pages, P).to(torch.int32)
    return src, dst, blocked, refcount, block_table


def pages_in_use(refcount: torch.Tensor) -> torch.Tensor:
    """0-d int32 tensor: currently allocated pages. A page forked into many
    rows counts once: that is the prefix-sharing memory win."""
    return (refcount > 0).sum(dtype=torch.int32)


# ---------------------------------------------------------------------------
# Quantized page format (kv_dtype="int8")
# ---------------------------------------------------------------------------
#
# An int8 pool stores each K/V head vector as 8-bit values plus ONE f32
# scale per (page, in-page offset, kv head): the scales are a second pool
# of shape (..., n_pages, page_size, KV) with the same refcount lifecycle,
# so alloc, release, fork, the CoW copy and the scrub treat both alike.
# Per-entry scales keep a write independent of its page's other entries.

INT8_QMAX = 127.0


def quantize_kv(x: torch.Tensor):
    """Symmetric per-vector int8 quantization over the last axis: ``x``
    (..., hd) float -> ``(q (..., hd) int8, scale (...) f32)``. JAX's order
    of operations: ``round(x / scale)`` with ties to even, then the clip
    (a multiply by the reciprocal would move ties). An all-zero vector
    quantizes exactly (scale 0, q 0)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / INT8_QMAX               # 0 for zero rows
    safe = torch.where(scale > 0, scale, 1.0)
    q = torch.round(xf / safe[..., None]).clamp(-INT8_QMAX, INT8_QMAX)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quantize_kv``: (..., hd) int8 + (...) f32 -> f32, the
    formula the kernels apply in registers."""
    return q.float() * scale.float()[..., None]
