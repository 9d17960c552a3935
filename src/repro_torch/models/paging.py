"""Page-pool primitives for the paged KV cache (port of
``repro/models/paging.py``: allocation and release; fork and copy-on-write
arrive with prefix sharing).

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


def _i32_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x.to(torch.int32), 0, dtype=torch.int32)


def alloc_pages(refcount: torch.Tensor, need: torch.Tensor):
    """Grab one free page (refcount 0) for every row with ``need=True``.

    refcount: (P,) int32; need: (B,) bool. Returns ``(pages, refcount')``:
    the r-th needing row receives the r-th free page (its refcount becomes
    1); rows with ``need=False`` or beyond the free supply get the sentinel
    ``P``. Rank-match by cumulative sums: no loop, no host read.
    """
    P = refcount.shape[0]
    dev = refcount.device
    free = refcount == 0
    rank = _i32_cumsum(need) - 1                            # (B,) alloc rank
    free_rank = _i32_cumsum(free) - 1                       # (P,)
    total_free = free.sum(dtype=torch.int32)
    # rank_to_page[r] = pool index of the r-th free page (slot P = trash)
    rank_to_page = torch.full((P + 1,), P, dtype=torch.int32, device=dev)
    rank_to_page.scatter_(0, torch.where(free, free_rank, P).long(),
                          torch.arange(P, dtype=torch.int32, device=dev))
    ok = need & (rank < total_free)
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


def pages_in_use(refcount: torch.Tensor) -> torch.Tensor:
    """0-d int32 tensor: currently allocated pages."""
    return (refcount > 0).sum(dtype=torch.int32)
