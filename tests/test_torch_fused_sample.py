"""Fused sampling: the port's plain version (``ref.py``) against the JAX
Pallas kernel in interpret mode on the same numpy noise, ``apply_top_p``
and ``fused_sample_tokens`` against JAX (the CUDA kernel is held against
the plain version on the card in tests/test_torch_cuda.py), and the
kernel's cluster plan. Tokens must be equal; log-probs within atol 1e-5
(one f32 logsumexp in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_sample import ops as jops
from repro.kernels.fused_sample.kernel import fused_sample_bkgd
from repro_torch.bridge import to_torch
from repro_torch.kernels.fused_sample import ops
from repro_torch.kernels.fused_sample.ref import fused_sample_ref



def _inputs(seed, B, V, noise):
    rs = np.random.RandomState(seed)
    lg = (rs.standard_normal((B, V)) * 3).astype(np.float32)
    # planted tie in row 0, across two vocab blocks: the earliest wins
    lg[0, 7] = lg[0, V - 3] = 50.0
    nz = (np.zeros((B, V), np.float32) if noise == "zero" else
          rs.gumbel(size=(B, V)).astype(np.float32))
    nz[0] = 0.0
    return lg, nz


@pytest.mark.parametrize("V", [1000, 2500])
@pytest.mark.parametrize("noise", ["zero", "gumbel"])
def test_ref_matches_interpreted_kernel(V, noise):
    lg, nz = _inputs(0, 4, V, noise)
    tok, lp = fused_sample_ref(torch.from_numpy(lg), torch.from_numpy(nz))
    jtok, jlp = fused_sample_bkgd(jnp.asarray(lg), jnp.asarray(nz),
                                  block_v=1024, interpret=True)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert tok[0] == 7
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-5)


@pytest.mark.parametrize("top_p", [0.3, 0.9])
def test_apply_top_p_matches_jax(top_p):
    lg, _ = _inputs(1, 3, 700, "zero")
    out = ops.apply_top_p(torch.from_numpy(lg), top_p)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jops.apply_top_p(lg, top_p)))


@pytest.mark.parametrize("temperature,top_p", [(0.0, 1.0), (0.7, 1.0),
                                               (1.0, 0.8)])
def test_fused_sample_tokens_matches_jax(temperature, top_p):
    """Same logits, and the JAX key's Gumbel draw passed in as noise."""
    lg, _ = _inputs(2, 4, 1500, "zero")
    key = jax.random.PRNGKey(5)
    jtok, jlp = jops.fused_sample_tokens(key, jnp.asarray(lg), temperature,
                                         top_p=top_p, interpret=True)
    noise = to_torch(np.asarray(jax.random.gumbel(key, lg.shape,
                                                  jnp.float32)))
    tok, lp = ops.fused_sample_tokens(torch.from_numpy(lg), temperature,
                                      top_p=top_p, noise=noise)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-5)


def test_sampling_needs_noise():
    with pytest.raises(ValueError, match="noise"):
        ops.fused_sample_tokens(torch.zeros(2, 8), 1.0)



@pytest.mark.parametrize("n_sm", [1, 78, 132])
@pytest.mark.parametrize("B", [1, 2, 8, 32, 300, 1000])
def test_cluster_plan_covers_every_index_once(B, n_sm):
    """k blocks a row, at most 8 (one portable cluster); slices cover
    every index of the row exactly once, none empty; a whole number of
    float4s when V is a multiple of 4, so each starts 16-byte aligned;
    no thread sums more than about the first design's V/1024 terms, or 16
    in a short row."""
    for V in (1, 3, 4, 1000, 2047, 2048, 4100, 32004, 50280, 151936,
              151937):
        k, sl = ops.cluster_plan(B, V, n_sm)
        assert 1 <= k <= 8
        cover = np.zeros(V, np.int64)
        for r in range(k):
            lo, hi = r * sl, min(V, (r + 1) * sl)
            assert hi > lo
            cover[lo:hi] += 1
        assert (cover == 1).all()
        if V % 4 == 0:
            assert sl % 4 == 0
        per_thread = -(-sl // ops._THREADS)
        assert per_thread <= max(V // 1024 + 1, 16), (B, V, n_sm, k, sl)
