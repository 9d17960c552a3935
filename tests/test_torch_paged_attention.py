"""Paged decode attention: the port's plain version (``ref.py``, what the
wrapper runs on CPU tensors) against the JAX oracle and the JAX Pallas
kernel in interpret mode (the CUDA kernel is held against the plain
version on the card in tests/test_torch_cuda.py). fp32 atol 1e-5: the
same f32 math summed in another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.kernel import paged_decode_attention_bkgd
from repro.kernels.paged_attention.ref import (
    paged_decode_attention_ref as jax_ref)
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import paged_decode_attention_ref



CASES = {
    # name: (B, NP, P, ps, H, KV, hd, lens or None, int8)
    "shuffled_table": (3, 4, 16, 8, 4, 2, 32, [25, 9, 32], False),
    "lens_zero_and_partial_page": (3, 4, 16, 8, 4, 2, 32, [0, 17, 8], False),
    "qwen2_heads": (2, 4, 8, 8, 14, 2, 64, [30, 5], False),
    "int8_scales": (3, 4, 16, 8, 4, 2, 32, [25, 0, 13], True),
}


def _case(seed, B, NP, P, ps, H, KV, hd, lens, int8):
    rs = np.random.RandomState(seed)
    q = rs.standard_normal((B, H, hd)).astype(np.float32)
    if int8:
        kp = rs.randint(-127, 128, (P, ps, KV, hd)).astype(np.int8)
        vp = rs.randint(-127, 128, (P, ps, KV, hd)).astype(np.int8)
        ks = (rs.rand(P, ps, KV) / 127).astype(np.float32)
        vs = (rs.rand(P, ps, KV) / 127).astype(np.float32)
    else:
        kp = rs.standard_normal((P, ps, KV, hd)).astype(np.float32)
        vp = rs.standard_normal((P, ps, KV, hd)).astype(np.float32)
        ks = vs = None
    lens = np.asarray(lens, np.int32)
    perm = rs.permutation(P)[:B * NP].reshape(B, NP).astype(np.int32)
    npages = -(-lens // ps)
    bt = np.where(np.arange(NP)[None, :] < npages[:, None], perm, -1)
    if B > 2 and npages[0] > 1:
        bt[0, 1] = -1                    # unmapped entry inside the range
    return q, kp, vp, bt.astype(np.int32), lens, ks, vs


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("name", sorted(CASES))
def test_ref_matches_jax_ref_and_interpreted_kernel(name):
    q, kp, vp, bt, lens, ks, vs = _case(0, *CASES[name])
    out = paged_decode_attention_ref(*_torch(q, kp, vp, bt, lens, ks, vs))
    j = [None if a is None else jnp.asarray(a)
         for a in (q, kp, vp, bt, lens, ks, vs)]
    expect = jax_ref(*j)
    B, H, hd = q.shape
    KV = kp.shape[2]
    interp = paged_decode_attention_bkgd(
        j[0].reshape(B, KV, H // KV, hd), *j[1:5], k_scales=j[5],
        v_scales=j[6], interpret=True).reshape(B, H, hd)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(interp), atol=1e-5)
    if lens[0] == 0:
        assert not out[0].any()          # fully masked row outputs zeros


def test_wrapper_uses_plain_version_for_cpu_tensors():
    q, kp, vp, bt, lens, ks, vs = _case(1, *CASES["shuffled_table"])
    before = ops.launches
    out = ops.paged_decode_attention(*_torch(q, kp, vp, bt, lens))
    assert ops.launches == before        # the kernel was not launched
    torch.testing.assert_close(
        out, paged_decode_attention_ref(*_torch(q, kp, vp, bt, lens)),
        rtol=0, atol=0)


def test_wrapper_rejects_other_devices():
    q = torch.zeros((1, 2, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.paged_decode_attention(q, q, q, q, q)


PLAN_CASES = [
    # (B*KV, NP, ps, n_sm)
    (64, 16, 16, 132),      # the rollout's shape: 4 chunks of 4 pages
    (64, 128, 16, 132),     # S=2048: 8 chunks of 16
    (2, 64, 16, 132),       # B=1: the most chunks
    (1, 1, 16, 132),        # one page
    (8, 2, 128, 132),       # big pages: a page per chunk
    (6, 4, 8, 132),
    (264, 16, 16, 132),     # many rows: fewer chunks
    (1000, 256, 16, 132),
    (64, 17, 16, 132),      # a ragged last chunk
    (64, 16, 16, 114),      # another card
    (4, 3, 1, 16),
    (1, 0, 16, 132),        # an empty table
]


@pytest.mark.parametrize("n_pairs,NP,ps,n_sm", PLAN_CASES)
def test_split_plan_cuts_whole_pages_into_at_most_8_chunks(n_pairs, NP, ps,
                                                           n_sm):
    chunk, n_chunks = ops.split_plan(n_pairs, NP, ps, n_sm)
    assert isinstance(chunk, int) and isinstance(n_chunks, int)
    assert 1 <= n_chunks <= 8 and chunk >= 1
    assert chunk * n_chunks >= NP                  # every page covered
    assert chunk * (n_chunks - 1) < max(NP, 1)     # no chunk is empty
    if n_chunks > 1:                               # two 32-key tiles each
        assert chunk * ps >= 64


def test_split_plan_at_the_main_path_shapes():
    assert ops.split_plan(64, 16, 16, 132) == (4, 4)
    assert ops.split_plan(64, 128, 16, 132) == (16, 8)


def test_split_plan_takes_no_length_and_serves_both_kernels():
    """The plan depends on neither lens nor pos, so a verify query at
    pos + j + 1 and the paged kernel at lens = pos + j + 1 walk the same
    chunks; the verify wrapper takes the very same function."""
    import inspect

    from repro_torch.kernels.spec_verify import ops as sv_ops
    assert list(inspect.signature(ops.split_plan).parameters) == [
        "n_pairs", "NP", "ps", "n_sm"]
    assert sv_ops.split_plan is ops.split_plan
