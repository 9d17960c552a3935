"""Refill-side page management for the rollout engine (port of part of
``repro/rl/engine/paging.py``). Slot refill releases the slot's pages back
to the shared pool — a block-table / refcount update that never touches
the KV data. Everything stays on the device."""
from __future__ import annotations

import torch

from repro_torch.models import paging


def is_paged(cache) -> bool:
    """Structural check on a decode cache (the engine stays layout
    generic): a paged cache carries a block table and refcounts."""
    return hasattr(cache, "block_table") and hasattr(cache, "refcount")


def release_slot_pages(cache, refill):
    """Drop every page reference owned by ``refill`` slots and reset their
    fill position. Released pages are unmapped, so stale contents are never
    read: re-allocated pages map at offset 0 and fill monotonically, and a
    page mapped mid-row is scrubbed at allocation."""
    refcount, block_table = paging.release_pages(
        cache.refcount, cache.block_table, refill)
    return cache._replace(block_table=block_table, refcount=refcount,
                          pos=torch.where(refill, 0, cache.pos))


def pool_stats(cache):
    """(pages_in_use as a 0-d tensor, n_pages)."""
    return paging.pages_in_use(cache.refcount), cache.refcount.shape[0]


def dropped_tokens(cache, page_size: int):
    """(B,) int32 — tokens per slot whose KV write was dropped because the
    pool was exhausted: ``pos`` minus the positions covered by mapped
    block-table entries."""
    bt = cache.block_table
    pos = cache.pos.to(torch.int32)
    k = torch.arange(bt.shape[1], dtype=torch.int32,
                     device=bt.device) * page_size
    in_range = (pos[:, None] - k[None, :]).clamp(0, page_size)
    covered = torch.where(bt >= 0, in_range, 0).sum(dim=1,
                                                    dtype=torch.int32)
    return pos - covered
