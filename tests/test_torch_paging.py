"""Page allocator of the PyTorch port against the JAX package: random
alloc/release walks are bitwise equal, and both keep the refcount
invariants of tests/test_prefix_sharing.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import paging as jpaging
from repro.rl.engine import paging as jepaging
from repro.models.transformer import PagedDecodeCache as JCache
from repro_torch.models import paging as tpaging
from repro_torch.models.transformer import PagedDecodeCache as TCache
from repro_torch.rl.engine import paging as tepaging

P, B, NP = 12, 4, 3


def _check_invariants(rc, bt):
    assert (rc >= 0).all(), rc
    mapped, counts = np.unique(bt[bt >= 0], return_counts=True)
    assert (rc[mapped] > 0).all(), (rc, bt)       # never free and mapped
    ref = np.zeros_like(rc)
    ref[mapped] = counts
    np.testing.assert_array_equal(rc, ref)        # refcount == references


def _walk(seed, n_ops=30):
    rr = np.random.RandomState(seed)
    jrc, jbt = jnp.zeros((P,), jnp.int32), jnp.full((B, NP), -1, jnp.int32)
    trc = torch.zeros((P,), dtype=torch.int32)
    tbt = torch.full((B, NP), -1, dtype=torch.int32)
    rows = np.arange(B)
    for _ in range(n_ops):
        if rr.rand() < 0.65:
            bt = np.asarray(jbt)
            entry = np.argmax(bt < 0, axis=1)
            need = (rr.rand(B) < 0.6) & (bt < 0).any(axis=1)
            jpages, jrc = jpaging.alloc_pages(jrc, jnp.asarray(need))
            tpages, trc = tpaging.alloc_pages(trc, torch.from_numpy(need))
            np.testing.assert_array_equal(tpages.numpy(), np.asarray(jpages))
            ok = need & (np.asarray(jpages) < P)
            col = np.where(ok, entry, NP)
            jbt = jbt.at[rows, col].set(jpages, mode="drop")
            upd = tbt.numpy().copy()
            upd[rows[ok], col[ok]] = tpages.numpy()[ok]
            tbt = torch.from_numpy(upd)
        else:
            sel = rr.rand(B) < 0.5
            jrc, jbt = jpaging.release_pages(jrc, jbt, jnp.asarray(sel))
            trc, tbt = tpaging.release_pages(trc, tbt, torch.from_numpy(sel))
        np.testing.assert_array_equal(trc.numpy(), np.asarray(jrc))
        np.testing.assert_array_equal(tbt.numpy(), np.asarray(jbt))
        assert int(tpaging.pages_in_use(trc)) == int(
            jpaging.pages_in_use(jrc))
        _check_invariants(trc.numpy(), tbt.numpy())


@pytest.mark.parametrize("seed", range(6))
def test_alloc_release_walk_matches_jax(seed):
    _walk(seed)


def test_release_duplicate_pages_accumulate():
    """Two rows mapping the same page (a shared page) both drop a ref: the
    decrement must accumulate, not overwrite."""
    rc = torch.tensor([2, 1, 0, 0], dtype=torch.int32)
    bt = torch.tensor([[0, 1], [0, -1]], dtype=torch.int32)
    rc2, bt2 = tpaging.release_pages(rc, bt, torch.tensor([True, True]))
    j_rc, j_bt = jpaging.release_pages(jnp.asarray(rc.numpy()),
                                       jnp.asarray(bt.numpy()),
                                       jnp.asarray([True, True]))
    np.testing.assert_array_equal(rc2.numpy(), [0, 0, 0, 0])
    np.testing.assert_array_equal(rc2.numpy(), np.asarray(j_rc))
    np.testing.assert_array_equal(bt2.numpy(), np.asarray(j_bt))


def test_alloc_exhaustion_returns_sentinel():
    rc = torch.tensor([1, 0, 1], dtype=torch.int32)
    pages, rc2 = tpaging.alloc_pages(rc, torch.tensor([True, False, True]))
    np.testing.assert_array_equal(pages.numpy(), [1, 3, 3])
    np.testing.assert_array_equal(rc2.numpy(), [1, 1, 1])


def test_sizes():
    assert tpaging.pages_per_slot(96, 16) == jpaging.pages_per_slot(96, 16)
    assert tpaging.pages_per_slot(97, 16) == 7
    assert tpaging.pool_pages_needed(4, 97, 16) == \
        jpaging.pool_pages_needed(4, 97, 16)


def test_engine_paging_release_and_dropped_tokens():
    rs = np.random.RandomState(3)
    bt = np.array([[2, -1, 5], [0, 1, -1], [-1, -1, -1], [3, 4, 6]],
                  np.int32)
    rc = np.zeros(8, np.int32)
    rc[bt[bt >= 0]] = 1
    pos = np.array([40, 20, 5, 33], np.int32)
    refill = rs.rand(4) < 0.5
    jc = JCache(kv=None, block_table=jnp.asarray(bt),
                refcount=jnp.asarray(rc), pos=jnp.asarray(pos))
    tc = TCache(kv=None, block_table=torch.from_numpy(bt),
                refcount=torch.from_numpy(rc), pos=torch.from_numpy(pos))
    np.testing.assert_array_equal(
        tepaging.dropped_tokens(tc, 16).numpy(),
        np.asarray(jepaging.dropped_tokens(jc, 16)))
    j2 = jepaging.release_slot_pages(jc, jnp.asarray(refill))
    t2 = tepaging.release_slot_pages(tc, torch.from_numpy(refill))
    for f in ("block_table", "refcount", "pos"):
        np.testing.assert_array_equal(getattr(t2, f).numpy(),
                                      np.asarray(getattr(j2, f)))
    assert int(tepaging.pool_stats(t2)[0]) == int(jepaging.pool_stats(j2)[0])
    assert tepaging.is_paged(t2) and jepaging.is_paged(j2)
    assert not tepaging.is_paged(t2.kv)
