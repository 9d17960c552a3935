"""The decode attention of the PyTorch port against the JAX package on the
same numpy inputs.

``kernels/decode_attention/ref.py`` (what the wrapper runs for CPU tensors)
is held against the JAX Pallas kernel in interpret mode and its jnp ref,
at the shapes of ``tests/test_kernels.py`` plus an S that is a multiple of
no block, a prime S, and fully masked rows (whose output is the mean of V
over S on both sides). f32 within atol 2e-5 + rtol 1e-4 (the same f32 math
in another order); bf16 within one bf16 ulp of the output scale
(atol 2^-8·s, rtol 2^-7: both sides round one f32 result once).

``layers.decode_attention`` ("pallas" and "xla") is held against the JAX
layer over a stream of tokens on a ring that wraps (8 slots, a window of
8, positions past it) with rows that do not advance: outputs of advancing
rows within atol 1e-5, and the cache written equal within atol 1e-6, at
fp32. ``tests/test_torch_dense.py`` runs the same ring through the whole
model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_kernel
from repro.kernels.decode_attention import decode_attention_ref as jax_ref
from repro.models import layers as JL
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.models import layers as TL


def _inputs(seed, B, S, H, KV, hd, mask):
    rs = np.random.RandomState(seed)
    q = rs.standard_normal((B, H, hd)).astype(np.float32)
    k = rs.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rs.standard_normal((B, S, KV, hd)).astype(np.float32)
    pos = rs.randint(1, S, (B,))
    valid = np.arange(S)[None, :] <= pos[:, None]
    if mask == "row0_masked":
        valid[0] = False
    elif mask == "all_masked":
        valid[:] = False
    return q, k, v, valid


CASES = [
    # (B, S, H, KV, hd, mask): tests/test_kernels.py's shapes, then ragged
    (2, 1024, 4, 2, 64, "fill"),
    (1, 2048, 8, 8, 32, "fill"),
    (3, 512, 6, 2, 128, "fill"),
    (2, 256, 14, 2, 64, "fill"),
    (3, 100, 14, 2, 64, "fill"),
    (2, 97, 4, 2, 32, "row0_masked"),
    (2, 96, 4, 2, 32, "all_masked"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,hd,mask", CASES)
def test_ref_matches_jax_kernel_and_ref(B, S, H, KV, hd, mask, dtype):
    q, k, v, valid = _inputs(B * S + hd, B, S, H, KV, hd, mask)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jd) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    n0 = da_ops.launches
    out = da_ops.decode_attention(tq, tk, tv, torch.from_numpy(valid))
    assert da_ops.launches == n0              # CPU tensors: plain version
    assert out.dtype == td and tuple(out.shape) == (B, H, hd)
    out = out.float().numpy()
    jvalid = jnp.asarray(valid)
    for expect in (jax_kernel(jq, jk, jv, jvalid, interpret=True),
                   jax_ref(jq, jk, jv, jvalid)):
        expect = np.asarray(expect, np.float32)
        if dtype == "float32":
            tol = dict(atol=2e-5, rtol=1e-4)
        else:
            tol = dict(atol=2.0 ** -8 * np.abs(expect).max(), rtol=2.0 ** -7)
        np.testing.assert_allclose(out, expect, **tol)
    if mask != "fill":                        # fully masked: mean of V
        mean = np.repeat(v[0].astype(np.float32) if dtype == "float32"
                         else np.asarray(jv[0], np.float32), H // KV,
                         axis=1).mean(0)
        np.testing.assert_allclose(out[0], mean, atol=2e-5 if
                                   dtype == "float32" else 2e-2)


@pytest.mark.parametrize("n_sm", [1, 8, 78, 132])
def test_split_plan_invariants(n_sm):
    """The kernel's chunks, over a grid of (B*KV, S): whole 32-key tiles,
    covering S with no empty chunk, at most 8 (one thread-block cluster
    per (row, kv head)), and two tiles or more in each when S is split."""
    for n_pairs in (1, 2, 3, 7, 64, 100, 1000, 4096):
        for S in [*range(1, 70), 100, 255, 256, 257, 1000, 2048, 4097,
                  32768]:
            chunk, n = da_ops.split_plan(n_pairs, S, n_sm)
            assert chunk % da_ops._TILE == 0 and chunk >= da_ops._TILE
            assert chunk * n >= S and chunk * (n - 1) < S
            assert 1 <= n <= da_ops._MAX_CHUNKS
            assert n == 1 or chunk >= 2 * da_ops._TILE
    # the main path's shape on an H100: 4 chunks of two tiles, 256 blocks
    if n_sm == 132:
        assert da_ops.split_plan(64, 256, n_sm) == (64, 4)
        assert da_ops.split_plan(64, 2048, n_sm) == (256, 8)
        # the card tests' one-pair cases: 3 chunks of 96 at S=200, a whole
        # 8-block cluster at S=512
        assert da_ops.split_plan(1, 200, n_sm) == (96, 3)
        assert da_ops.split_plan(1, 512, n_sm) == (64, 8)


WINDOW, S_MAX, B, STEPS = 8, 8, 3, 14


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_layer_ring_that_wraps_matches_jax(attn_impl):
    """A sliding-window ring of 8 slots fed 14 tokens (positions run past
    the window, so slots are overwritten), one row held back on some
    steps; the JAX side runs its "xla" layer (the Pallas one interprets
    the same softmax)."""
    rs = np.random.RandomState(5)
    D, H, KV, hd = 64, 4, 2, 16
    p = {"wq": rs.standard_normal((D, H * hd)) * 0.1,
         "wk": rs.standard_normal((D, KV * hd)) * 0.1,
         "wv": rs.standard_normal((D, KV * hd)) * 0.1,
         "wo": rs.standard_normal((H * hd, D)) * 0.1,
         "bq": rs.standard_normal(H * hd) * 0.1,
         "bk": rs.standard_normal(KV * hd) * 0.1,
         "bv": rs.standard_normal(KV * hd) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    kw = dict(n_heads=H, n_kv_heads=KV, head_dim=hd, rope_theta=1e4,
              window=WINDOW)
    tkv = TL.init_kv(B, S_MAX, KV, hd, torch.float32)
    jkv = JL.init_kv(B, S_MAX, KV, hd, jnp.float32)
    pos = np.zeros(B, np.int32)
    for t in range(STEPS):
        x = rs.standard_normal((B, 1, D)).astype(np.float32)
        adv = np.array([True, t % 3 != 1, t % 4 != 2])
        to, tkv = TL.decode_attention(tp, torch.from_numpy(x), tkv,
                                      torch.from_numpy(pos),
                                      advance=torch.from_numpy(adv),
                                      attn_impl=attn_impl, **kw)
        jo, jkv = JL.decode_attention(jp, jnp.asarray(x), jkv,
                                      jnp.asarray(pos),
                                      advance=jnp.asarray(adv),
                                      attn_impl="xla", **kw)
        np.testing.assert_allclose(to.numpy()[adv], np.asarray(jo)[adv],
                                   atol=1e-5, err_msg=f"step {t}")
        np.testing.assert_allclose(tkv.k.numpy(), np.asarray(jkv.k),
                                   atol=1e-6)
        np.testing.assert_allclose(tkv.v.numpy(), np.asarray(jkv.v),
                                   atol=1e-6)
        pos = pos + adv
    assert pos.max() > S_MAX                  # the ring wrapped


def test_layer_rejects_unknown_attn_impl():
    kv = TL.init_kv(1, 4, 1, 8, torch.float32)
    p = {k: torch.zeros(s) for k, s in (("wq", (8, 8)), ("wk", (8, 8)),
                                        ("wv", (8, 8)), ("wo", (8, 8)))}
    with pytest.raises(ValueError, match="pallas"):
        TL.decode_attention(p, torch.zeros(1, 1, 8), kv, 0, n_heads=1,
                            n_kv_heads=1, head_dim=8, rope_theta=1e4,
                            attn_impl="paged")
