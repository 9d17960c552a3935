"""Speculative verify attention: the port's plain version (``ref.py``, what
the wrapper runs on CPU tensors) against the JAX oracle and the JAX Pallas
kernel in interpret mode, on the grid of tests/test_speculative.py (the
CUDA kernel is held against the plain version, and bitwise against the
paged kernel, on the card in tests/test_torch_cuda.py). fp32 atol 1e-6 of
the output scale max|ref|: the same f32 math summed in another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.spec_verify import spec_verify_attention as jax_kernel
from repro.kernels.spec_verify import spec_verify_attention_ref as jax_ref
from repro_torch.kernels.paged_attention.ref import paged_decode_attention_ref
from repro_torch.kernels.spec_verify import ops
from repro_torch.kernels.spec_verify.ref import spec_verify_attention_ref


def _case(seed, B, K, NP, P, ps, H, KV, hd, *, pos=None, int8=False):
    """Random verify inputs, as tests/test_speculative.py builds them: a
    shuffled block table whose mapped pages cover ``[0, pos+K)`` per row
    (the chunk K/V is already in the pool)."""
    rs = np.random.RandomState(seed)
    q = rs.standard_normal((B, K, H, hd)).astype(np.float32)
    if int8:
        kp = rs.randint(-127, 128, (P, ps, KV, hd)).astype(np.int8)
        vp = rs.randint(-127, 128, (P, ps, KV, hd)).astype(np.int8)
        ks = (rs.rand(P, ps, KV) / 127).astype(np.float32)
        vs = (rs.rand(P, ps, KV) / 127).astype(np.float32)
    else:
        kp = rs.standard_normal((P, ps, KV, hd)).astype(np.float32)
        vp = rs.standard_normal((P, ps, KV, hd)).astype(np.float32)
        ks = vs = None
    if pos is None:
        pos = rs.randint(0, NP * ps - K + 1, (B,))
    pos = np.asarray(pos, np.int32)
    perm = rs.permutation(P)[:B * NP].reshape(B, NP)
    npages = -(-(pos + K) // ps)
    bt = np.where(np.arange(NP)[None, :] < npages[:, None], perm, -1)
    return [q, kp, vp, bt.astype(np.int32), pos, ks, vs]


def _torch(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _check(arrays):
    """The port's ref against the JAX ref and the interpreted kernel."""
    out = spec_verify_attention_ref(*_torch(arrays)).numpy()
    q, kp, vp, bt, pos, ks, vs = [None if a is None else jnp.asarray(a)
                                  for a in arrays]
    expect = np.asarray(jax_ref(q, kp, vp, bt, pos, k_scales=ks,
                                v_scales=vs))
    interp = np.asarray(jax_kernel(q, kp, vp, bt, pos, k_scales=ks,
                                   v_scales=vs, interpret=True))
    atol = 1e-6 * float(np.abs(expect).max())
    np.testing.assert_allclose(out, expect, atol=atol, rtol=0)
    np.testing.assert_allclose(out, interp, atol=atol, rtol=0)
    assert np.isfinite(out).all()
    return out


@pytest.mark.parametrize("B,K,NP,P,ps,H,KV,hd", [
    (2, 4, 4, 16, 8, 4, 2, 64),
    (3, 6, 8, 32, 16, 8, 8, 32),
    (2, 4, 4, 16, 8, 14, 2, 64),   # qwen2's group of 7
    (1, 8, 2, 8, 128, 2, 1, 64),   # MQA, the chunk inside one big page
])
def test_ref_matches_jax_ref_and_interpreted_kernel(B, K, NP, P, ps, H, KV,
                                                    hd):
    out = _check(_case(0, B, K, NP, P, ps, H, KV, hd))
    assert out.shape == (B, K, H, hd)


def test_ragged_positions_and_partial_last_page():
    """One chunk starts a fresh page, one straddles a page boundary, one
    ends one token short of a page: each query sees its own length."""
    ps, K = 8, 4
    _check(_case(1, 3, K, 4, 16, ps, 4, 2, 32,
                 pos=[ps * 2, ps - 2, ps * 2 - K - 1]))


def test_k1_is_paged_decode_at_pos_plus_one():
    q, kp, vp, bt, pos, _, _ = _torch(_case(2, 2, 1, 4, 16, 8, 4, 2, 64))
    out = spec_verify_attention_ref(q, kp, vp, bt, pos)
    single = paged_decode_attention_ref(q[:, 0], kp, vp, bt, pos + 1)
    torch.testing.assert_close(out[:, 0], single, atol=1e-6, rtol=0)


def test_unmapped_chunk_page_gives_zero_rows():
    """A dropped chunk write leaves a query's own page unmapped: a query
    with no valid position outputs 0 (not the mean of V), never NaN."""
    ps = 8
    arrays = _case(3, 2, 4, 4, 16, ps, 4, 2, 32, pos=[ps - 2, 0])
    arrays[3][1] = -1                    # row 1: nothing mapped at all
    arrays[3][0, 1] = -1                 # row 0: its chunk's second page
    out = _check(arrays)
    assert not out[1].any()
    # row 0 (pos 6): queries 2-3 lost their own page but still see page 0
    assert all(out[0, j].any() for j in range(4))


def test_int8_pools_dequantise_like_jax():
    _check(_case(4, 2, 4, 4, 16, 8, 4, 2, 32, int8=True))


def test_wrapper_uses_plain_version_for_cpu_tensors():
    q, kp, vp, bt, pos, _, _ = _torch(_case(5, 2, 4, 4, 16, 8, 4, 2, 32))
    before = ops.launches
    out = ops.spec_verify_attention(q, kp, vp, bt, pos)
    assert ops.launches == before        # the kernel was not launched
    assert torch.equal(out, spec_verify_attention_ref(q, kp, vp, bt, pos))


def test_wrapper_rejects_other_devices():
    q = torch.zeros((1, 1, 2, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.spec_verify_attention(q, q, q, q, q)
