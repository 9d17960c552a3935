"""The SSD scan's plain version and its CPU route against JAX.

``kernels/ssd_scan/ref.py`` (the model's ``ssd_chunked``) and
``ops.ssd_scan`` on CPU tensors (which runs ``ref.py``) against JAX's
``ssd_ref`` and its Pallas ``ssd_scan`` in interpret mode, on the four
shapes of ``tests/test_kernels.py``'s SSD test (ragged S, g > 1, n = 128)
in fp32 and bf16, inputs made with numpy from a seed. Tolerances are the
JAX test's own (``tests/test_kernels.py:15``): y within 2e-5 / 1e-4 at fp32
and 2e-2 / 2e-2 at bf16. The port's plain form and JAX's do the same math
in the same casts, so their final states (f32 throughout) agree at the
fp32 tolerance in both dtypes; against the JAX kernel, which keeps W in
f32 where the chunked form rounds it to x's dtype, the final state is
held at the JAX test's 5e-3. Then: the carried ``initial_state`` and the
recurrent ``ssd_decode_step`` against JAX, the chunked form against the
per-token recurrence, the wrapper's refusals (an initial state; an input
that requires grad under autograd: the kernel has no backward), and the
wrapper's plan (route and head tile) for every shape it takes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_ref as jax_ssd_ref
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models import mamba as jmamba
from repro_torch.bridge import to_torch
from repro_torch.kernels.ssd_scan import ops, ssd_ref
from repro_torch.models import mamba

SHAPES = [  # b, s, h, g, p, n, chunk (tests/test_kernels.py:433-438)
    (2, 256, 4, 1, 32, 16, 64),
    (1, 512, 8, 2, 64, 32, 128),
    (2, 100, 4, 4, 16, 8, 32),      # ragged: s % chunk != 0 (pad path)
    (1, 128, 2, 1, 64, 128, 64),    # wide state (mamba2-370m n=128)
]
TOLS = {"fp32": dict(atol=2e-5, rtol=1e-4), "bf16": dict(atol=2e-2,
                                                         rtol=2e-2)}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}


def make_inputs(seed, b, s, h, g, p, n, dtype):
    """(jax arrays, torch tensors) of the same values: x, B, C in
    ``dtype``, dt and A in f32, as the mixer hands them over."""
    r = np.random.default_rng(seed)
    f = lambda *shape: r.standard_normal(shape).astype(np.float32)
    jx = (jnp.asarray(f(b, s, h, p) * 0.5).astype(JDT[dtype]),
          jax.nn.softplus(jnp.asarray(f(b, s, h))),
          -jnp.exp(jnp.asarray(f(h)) * 0.3),
          jnp.asarray(f(b, s, g, n) * 0.5).astype(JDT[dtype]),
          jnp.asarray(f(b, s, g, n) * 0.5).astype(JDT[dtype]))
    return jx, tuple(to_torch(np.asarray(a)) for a in jx)


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.float().numpy()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,s,h,g,p,n,chunk", SHAPES)
def test_ref_and_ops_match_jax(b, s, h, g, p, n, chunk, dtype):
    jx, tx = make_inputs(0, b, s, h, g, p, n, dtype)
    ye, fine = jax_ssd_ref(*jx, chunk)
    yk, fink = jax_ssd_scan(*jx, chunk, interpret=True)
    n0 = ops.launches
    for name, (y, fin) in (("ref", ssd_ref(*tx, chunk)),
                           ("ops", ops.ssd_scan(*tx, chunk))):
        assert y.dtype == tx[0].dtype and fin.dtype == torch.float32
        assert y.shape == (b, s, h, p) and fin.shape == (b, h, p, n)
        np.testing.assert_allclose(_np(y), _np(ye), **TOLS[dtype],
                                   err_msg=f"{name} y vs jax ref")
        np.testing.assert_allclose(_np(fin), _np(fine), **TOLS["fp32"],
                                   err_msg=f"{name} state vs jax ref")
        np.testing.assert_allclose(_np(y), _np(yk), **TOLS[dtype],
                                   err_msg=f"{name} y vs jax kernel")
        np.testing.assert_allclose(_np(fin), _np(fink), atol=5e-3,
                                   rtol=5e-3,
                                   err_msg=f"{name} state vs jax kernel")
    assert ops.launches == n0          # CPU tensors launch no kernel


def test_initial_state_matches_jax():
    b, s, h, g, p, n, chunk = 2, 100, 4, 2, 16, 8, 32
    jx, tx = make_inputs(1, b, s, h, g, p, n, "fp32")
    s0 = np.random.default_rng(2).standard_normal(
        (b, h, p, n)).astype(np.float32)
    ye, fine = jmamba.ssd_chunked(*jx, chunk, initial_state=jnp.asarray(s0))
    y, fin = mamba.ssd_chunked(*tx, chunk, initial_state=to_torch(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(ye), **TOLS["fp32"])
    np.testing.assert_allclose(fin.numpy(), np.asarray(fine),
                               **TOLS["fp32"])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_decode_step_matches_jax(dtype):
    b, h, g, p, n = 3, 4, 2, 16, 8
    jx, tx = make_inputs(3, b, 1, h, g, p, n, dtype)
    s0 = np.random.default_rng(4).standard_normal(
        (b, h, p, n)).astype(np.float32)
    sq = lambda a: a[:, 0]
    ye, st_e = jmamba.ssd_decode_step(jnp.asarray(s0), sq(jx[0]), sq(jx[1]),
                                      jx[2], sq(jx[3]), sq(jx[4]))
    y, st = mamba.ssd_decode_step(to_torch(s0), sq(tx[0]), sq(tx[1]), tx[2],
                                  sq(tx[3]), sq(tx[4]))
    assert y.dtype == tx[0].dtype
    # the same f32 math, cast once at the end (one bf16 ulp at bf16)
    tol = dict(atol=1e-6, rtol=1e-5) if dtype == "fp32" else dict(
        atol=1e-6, rtol=2 ** -7)
    np.testing.assert_allclose(_np(y), _np(ye), **tol)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_e), atol=1e-6,
                               rtol=1e-5)


def test_chunked_equals_sequential_recurrence():
    """The chunked dual form (plain and through the wrapper) equals the
    per-token recurrence (tests/test_kernels.py's tolerances)."""
    b, s, h, g, p, n = 1, 32, 2, 1, 8, 4
    _, (x, dt, A, B, C) = make_inputs(5, b, s, h, g, p, n, "fp32")
    state = torch.zeros((b, h, p, n))
    ys = []
    for t in range(s):
        y_t, state = mamba.ssd_decode_step(state, x[:, t], dt[:, t], A,
                                           B[:, t], C[:, t])
        ys.append(y_t)
    y_seq = torch.stack(ys, dim=1)
    for y, fin in (mamba.ssd_chunked(x, dt, A, B, C, 8),
                   ops.ssd_scan(x, dt, A, B, C, 8)):
        torch.testing.assert_close(y, y_seq, atol=1e-4, rtol=1e-3)
        torch.testing.assert_close(fin, state, atol=1e-4, rtol=1e-3)


def test_ops_refuses_initial_state_and_autograd():
    _, (x, dt, A, B, C) = make_inputs(6, 1, 16, 2, 1, 16, 8, "fp32")
    with pytest.raises(ValueError, match="zero state"):
        ops.ssd_scan(x, dt, A, B, C, 8, initial_state=torch.zeros(
            (1, 2, 16, 8)))
    xg = x.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ssd_scan(xg, dt, A, B, C, 8)
    # without grad mode the same inputs run (ExpPrep's no_grad pass)
    with torch.no_grad():
        y, _ = ops.ssd_scan(xg, dt, A, B, C, 8)
    torch.testing.assert_close(y, ssd_ref(x, dt, A, B, C, 8)[0])


def test_plan_routes():
    """The bf16 score shape (B=32, 32 heads, 132 SMs) runs on the tensor
    cores, two heads a block; three heads a group take one; p=32, fp32
    and views TMA cannot read take the f32 route; two heads a block only
    where they save a wave (64 one-head blocks fill one wave already)."""
    bf, f32, tc, simt = torch.bfloat16, torch.float32, ops.TENSOR_CORES, \
        ops.SIMT
    assert ops.plan(bf, 64, 128, 256, 32, 1024, 132) == (tc, 2)
    assert ops.plan(bf, 64, 128, 256, 32, 256, 132) == (tc, 2)
    assert ops.plan(bf, 64, 64, 64, 3, 12, 132) == (tc, 1)
    assert ops.plan(bf, 128, 128, 256, 4, 8, 132) == (tc, 1)
    assert ops.plan(bf, 32, 16, 32, 4, 8, 132)[0] == simt
    assert ops.plan(f32, 64, 128, 256, 32, 1024, 132) == (simt, 2)
    assert ops.plan(bf, 64, 128, 256, 32, 1024, 132, False) == (simt, 2)
    assert ops.plan(bf, 32, 64, 64, 4, 64, 132) == (simt, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [16, 32, 64, 128])
def test_plan_fits_every_shape_the_wrapper_takes(dtype, p):
    """For every (p, n, chunk) and heads per group: either the wrapper
    refuses the shape, or the plan's head tile divides the heads of a
    group, its warpgroups fit a block, and its shared memory fits the
    232,448 bytes a Hopper block may use."""
    for n in (1, 8, 16, 24, 32, 48, 64, 96, 128):
        for q in (1, 16, 32, 64, 100, 128, 256, 512, 1024, 2048, 4096):
            x = torch.zeros((1, q, 6, p), dtype=dtype)
            B = torch.zeros((1, q, 1, n), dtype=dtype)
            dt, A = torch.zeros((1, q, 6)), torch.zeros(6)
            try:
                ops._check_cuda_inputs(x, dt, A, B, B, q)
            except ValueError as e:
                assert "fits" in str(e)
                assert ops.smem_bytes(ops.SIMT, p, n, q, 1) > 232448
                continue
            for hpg in (1, 2, 3, 4, 6, 32):
                for tma, blocks in ((True, 6), (True, 4096),
                                    (False, 4096)):
                    route, ht = ops.plan(dtype, p, n, q, hpg, blocks, 132,
                                         tma)
                    assert hpg % ht == 0
                    assert ops.smem_bytes(route, p, n, q, ht) <= 232448
                    if route == ops.TENSOR_CORES:
                        assert dtype == torch.bfloat16 and tma
                        assert ht * p // 64 <= 2 and n % 32 == 0
