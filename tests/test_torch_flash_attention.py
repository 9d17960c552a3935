"""The port's flash-attention plain versions (``kernels/flash_attention/
ref.py``) against the JAX package: the forward against
``ops.flash_attention(..., interpret=True)`` and the kernel's ``L``, and
the backward against ``jax.vjp`` of that interpreted kernel; then the
port's ``autograd.Function`` (CPU path) under float64 ``gradcheck``.

Inputs are made with numpy from fixed seeds. Tolerances: float32 on both
sides, the same math in another summation order (JAX walks blocks of up
to 128 keys with an online softmax, the plain version takes one softmax
over the whole row): outputs and L within atol 2e-6 and rtol 1e-5 (a few
f32 ulps of values of order 1 summed over 96-256 keys); gradients within
atol 1e-5 and rtol 1e-4 (two more reductions over the sequence)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jax_fa_ops
from repro.kernels.flash_attention.kernel import flash_attention_bhsd
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_fwd_ref)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small eager ops: one intra-op thread per test worker, so parallel
    workers do not oversubscribe the cores (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = {
    # name: (B, S, H, KV, hd, causal, window)
    "s96_group2": (2, 96, 4, 2, 32, True, 0),         # S not a multiple of 128
    "s96_window": (1, 96, 4, 2, 32, True, 40),
    # two JAX slabs of 128: rows >= 168 find slab 0 fully outside their
    # window, add p = 1 there, and the first allowed key wipes it
    "window_after_empty_slab": (1, 256, 2, 1, 32, True, 40),
    "group7_qwen2_heads": (1, 64, 14, 2, 64, True, 0),
    "not_causal": (1, 96, 4, 1, 32, False, 0),
}


def _inputs(seed, B, S, H, KV, hd, dtype=np.float32):
    rs = np.random.RandomState(seed)
    q = rs.standard_normal((B, S, H, hd)).astype(dtype)
    k = rs.standard_normal((B, S, KV, hd)).astype(dtype)
    v = rs.standard_normal((B, S, KV, hd)).astype(dtype)
    do = rs.standard_normal((B, S, H, hd)).astype(dtype)
    return q, k, v, do


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_interpreted_pallas_kernel(name):
    B, S, H, KV, hd, causal, window = CASES[name]
    q, k, v, _ = _inputs(0, B, S, H, KV, hd)
    out, L = attention_fwd_ref(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal, window)
    j_out = jax_fa_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal, window, True)
    tr = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)
    _, j_L = flash_attention_bhsd(tr(q), tr(k), tr(v), causal=causal,
                                  window=window,
                                  bq=jax_fa_ops._pick_block(S),
                                  bk=jax_fa_ops._pick_block(S),
                                  interpret=True)
    j_ref = attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=2e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_ref), atol=2e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(L.numpy(), np.asarray(j_L), atol=2e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_matches_vjp_of_interpreted_kernel(name):
    B, S, H, KV, hd, causal, window = CASES[name]
    q, k, v, do = _inputs(1, B, S, H, KV, hd)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, L = attention_fwd_ref(tq, tk, tv, causal, window)
    grads = attention_bwd_ref(tq, tk, tv, out, torch.from_numpy(do), L,
                              causal, window)
    _, vjp = jax.vjp(lambda a, b, c: jax_fa_ops.flash_attention(
        a, b, c, causal, window, True), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    for name_, g, jg in zip(("dq", "dk", "dv"), grads, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5,
                                   rtol=1e-4, err_msg=name_)


@pytest.mark.parametrize("causal,window,KV", [(True, 0, 2), (True, 3, 1),
                                              (False, 0, 2), (False, 3, 1)])
def test_function_cpu_path_gradcheck_float64(causal, window, KV):
    """The Function's CPU path (forward and backward both plain versions)
    against finite differences, in float64."""
    q, k, v, _ = _inputs(2, 1, 8, 4, KV, 4, np.float64)
    args = tuple(torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    n0 = dict(fa_ops.launches)
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa_ops.flash_attention(a, b, c, causal, window),
        args)
    assert fa_ops.launches == n0        # CPU tensors launch no kernel


def test_function_matches_autograd_through_the_plain_forward():
    """The Function's backward (the two-pass formula) equals autograd
    through the plain forward, at fp32 with group 7."""
    q, k, v, do = _inputs(3, 2, 40, 14, 2, 16)
    a = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    b = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    fa_ops.flash_attention(*a, True, 7).backward(torch.from_numpy(do))
    attention_fwd_ref(*b, True, 7)[0].backward(torch.from_numpy(do))
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, atol=1e-5, rtol=1e-4)


def test_wrapper_checks_inputs():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(4, 1, 8, 4, 2, 8))
    with pytest.raises(ValueError, match="H % KV"):
        fa_ops.flash_attention(q, k[:, :, :1].expand(1, 8, 3, 8), v[:, :, :1]
                               .expand(1, 8, 3, 8))
    with pytest.raises(ValueError, match="one"):
        fa_ops.flash_attention(q, k, v[:, :4])
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.flash_attention(q, k[..., :4], v[..., :4])
    with pytest.raises(ValueError, match="unsupported device"):
        fa_ops.flash_attention_fwd(q.to("meta"), k.to("meta"), v.to("meta"))
