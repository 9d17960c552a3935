"""Refill-side page management for the rollout engine (port of
``repro/rl/engine/paging.py``). Slot refill releases the slot's pages back
to the shared pool — a block-table / refcount update that never touches
the KV data. Prefix sharing rides on the refcounts: the engine pins the
shared prompt's pages and forks them into every refilled slot
(``fork_prefix``), and a slot's release only drops its own references.
Under pool pressure the governor (``pressure_plan``) stalls or preempts
slots before a turn writes, and ``grow_pool`` extends the pool between
macro-steps. Everything but ``grow_pool`` stays on the device."""
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


def fork_prefix(cache, prefix_pages, rows, prefix_len: int):
    """Map the pinned shared-prefix run into freshly released ``rows`` and
    advance their fill position past it: the slot starts its episode with
    the common prompt's full pages in its block table, no prefill and no
    copy. The rows' own writes begin at the page-aligned ``prefix_len``."""
    refcount, block_table = paging.fork_pages(
        cache.refcount, cache.block_table, prefix_pages, rows)
    return cache._replace(block_table=block_table, refcount=refcount,
                          pos=torch.where(rows, prefix_len, cache.pos))


def pressure_plan(refcount, block_table, eligible, pos, demand):
    """The memory-pressure governor of ``on_exhaust="preempt"``: decides,
    before a turn generates, which eligible slots may write (``run``) and
    which live slots are preempted (``victims``: pages released, episode
    re-queued), so that no KV write can hit an exhausted pool.

      1. Throttle first: slots run in (zero demand, then shortest context)
         order while their cumulative worst-case page demand fits the free
         pool; the rest stall for the turn, keeping their pages.
      2. Preempt only when not even the cheapest slot fits: victims are
         taken longest context first, counting only their private pages
         (refcount 1; shared prefix pages free nothing). The smallest
         victim set that lets the cheapest slot run is chosen, and the
         cheapest slot is never a victim.

    eligible: (B,) bool; pos, demand: (B,) int (demand 0 for ineligible
    rows). Returns ``(run, victims)`` bool masks. Stable argsorts and
    cumulative sums, as JAX's; no host read."""
    return pressure_plan_counts(
        (refcount == 0).sum(), slot_private_pages(refcount, block_table),
        eligible, pos, demand)


def slot_private_pages(refcount, block_table):
    """(B,) int32: the pages each slot alone maps (refcount 1), which its
    release frees; shared prefix pages free nothing."""
    P = refcount.shape[0]
    page_rc = refcount[block_table.clamp(0, P - 1).long()]
    return ((block_table >= 0) & (page_rc == 1)).sum(dim=1,
                                                      dtype=torch.int32)


def pressure_plan_counts(free, freeable, eligible, pos, demand):
    """``pressure_plan`` on the pool's free count ``free`` (0-d) and each
    slot's private pages ``freeable`` (B,): a data-parallel rollout runs it
    on the global batch's gathered rows and the whole pool's free count,
    the same on every data row."""
    B = pos.shape[0]
    dev = pos.device
    pos = pos.long()
    demand = demand.long()
    free = free.long()
    freeable = freeable.long()
    big = torch.iinfo(torch.int64).max
    ar = torch.arange(B, device=dev)

    def ranks(order):
        r = torch.empty_like(order)
        r[order] = ar
        return r

    # run set: zero-demand rows first, demanders shortest-first, while the
    # cumulative demand fits the free pool
    off = 1 << 20                              # > any pos
    asc_key = torch.where(eligible, pos + off * (demand > 0).long(), big)
    asc = torch.argsort(asc_key, stable=True)  # ties by row id
    rank_asc = ranks(asc)
    cum = torch.cumsum(demand[asc], 0)
    run_count = ((cum <= free) & eligible[asc]).sum()
    run = eligible & (rank_asc < run_count)

    # victims, only when nothing can run: eligible rows but the survivor
    # (the cheapest slot), longest context first, each freeing its private
    # pages
    survivor = eligible & (rank_asc == 0)
    vcand = eligible & ~survivor
    desc = torch.argsort(torch.where(vcand, -pos, big), stable=True)
    rank_desc = ranks(desc)
    n_cand = vcand.sum()
    sd = demand[asc[:1]]       # the survivor's demand (a (1,) index: no read)
    cum_freed = torch.cumsum(torch.where(vcand[desc], freeable[desc], 0), 0)
    k_grid = torch.arange(1, B + 1, device=dev)
    feasible = (sd <= free + cum_freed) & (k_grid <= n_cand)
    k = torch.where(feasible.any(), feasible.long().argmax() + 1, 0)
    need_preempt = (run_count == 0) & eligible.any()
    k = torch.where(need_preempt, k, 0)
    victims = vcand & (rank_desc < k)
    # infeasible even after evicting every candidate (k == 0): the whole
    # turn stalls; finishing slots release pages at harvest
    run = torch.where(need_preempt & (k > 0), survivor, run)
    return run, victims


def grow_pool(cache, new_pages: int):
    """Pool growth (``pool_growth="double"``), on the host between
    macro-steps: extend every layer's pool to ``new_pages`` pages by
    inserting zeroed FREE pages (refcount 0) before the trash page, which
    moves to the new last index. Values and int8 scales grow together;
    block tables and positions are untouched, so every mapping stays
    valid."""
    P = cache.refcount.shape[0]
    extra = int(new_pages) - P
    if extra <= 0:
        return cache

    def pad_pages(leaf):
        if leaf is None:
            return None
        shape = list(leaf.shape)
        shape[1] = extra
        return torch.cat([leaf[:, :P], leaf.new_zeros(shape),
                          leaf[:, P:]], dim=1)

    return cache._replace(
        kv=type(cache.kv)(*(pad_pages(t) for t in cache.kv)),
        refcount=torch.cat([cache.refcount,
                            cache.refcount.new_zeros(extra)]))


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
