"""Layer functions of the PyTorch port against the JAX package at fp32,
on the same numpy inputs (atol 1e-5: f32 math, different summation
order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

ATOL = 1e-5


def _np(rs, *shape, scale=1.0):
    return (rs.standard_normal(shape) * scale).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=1e-5)


def test_rms_norm():
    rs = np.random.RandomState(0)
    x, w = _np(rs, 3, 5, 64), _np(rs, 64)
    _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(theta):
    rs = np.random.RandomState(1)
    x = _np(rs, 2, 7, 4, 32)
    pos = rs.randint(0, 300, (2, 7)).astype(np.int32)
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def _attn_params(rs, D=128, H=4, KV=2, hd=32):
    p = {"wq": _np(rs, D, H * hd, scale=0.1),
         "wk": _np(rs, D, KV * hd, scale=0.1),
         "wv": _np(rs, D, KV * hd, scale=0.1),
         "wo": _np(rs, H * hd, D, scale=0.1),
         "bq": _np(rs, H * hd, scale=0.1), "bk": _np(rs, KV * hd, scale=0.1),
         "bv": _np(rs, KV * hd, scale=0.1)}
    return ({k: torch.from_numpy(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in p.items()})


def test_project_qkv_with_bias():
    rs = np.random.RandomState(2)
    tp, jp = _attn_params(rs)
    x = _np(rs, 2, 3, 128)
    for t, j in zip(TL._project_qkv(tp, torch.from_numpy(x), 4, 2, 32),
                    JL._project_qkv(jp, jnp.asarray(x), 4, 2, 32)):
        assert tuple(t.shape) == j.shape
        _close(t, j)


def test_sdpa_gqa_masked():
    rs = np.random.RandomState(3)
    q, k, v = _np(rs, 2, 1, 4, 32), _np(rs, 2, 9, 2, 32), _np(rs, 2, 9, 2, 32)
    valid = rs.rand(2, 9) < 0.7
    valid[:, 0] = True
    mask = np.where(valid, 0.0, JL.NEG_INF).astype(np.float32)[:, None, None]
    _close(TL._sdpa(*(torch.from_numpy(a) for a in (q, k, v, mask))),
           JL._sdpa(*(jnp.asarray(a) for a in (q, k, v, mask))))


def test_mlp():
    rs = np.random.RandomState(4)
    p = {"w_gate": _np(rs, 128, 256, scale=0.1),
         "w_up": _np(rs, 128, 256, scale=0.1),
         "w_down": _np(rs, 256, 128, scale=0.1)}
    x = _np(rs, 2, 3, 128)
    _close(TL.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                  torch.from_numpy(x)),
           JL.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))


@pytest.mark.parametrize("tied", [True, False])
def test_embed_unembed(tied):
    rs = np.random.RandomState(5)
    emb = _np(rs, 512, 128, scale=0.02)
    head = emb if tied else _np(rs, 128, 512, scale=0.1)
    tok = rs.randint(0, 512, (2, 3))
    x = _np(rs, 2, 3, 128)
    np.testing.assert_array_equal(
        TL.embed(torch.from_numpy(emb), torch.from_numpy(tok)).numpy(),
        np.asarray(JL.embed(jnp.asarray(emb), jnp.asarray(tok))))
    _close(TL.unembed(torch.from_numpy(head), torch.from_numpy(x)),
           JL.unembed(jnp.asarray(head), jnp.asarray(x)))


@pytest.mark.parametrize("attn_impl", ["xla", "paged"])
def test_paged_decode_attention_write_then_attend(attn_impl):
    """One decode step against a pool with a scrub page and a dropped
    (sentinel) write: the port's pool (with its trash page) matches the JAX
    pool on the real pages, and the outputs match. The port's "paged"
    branch runs the kernel's plain f32 version; both are held against the
    JAX gather branch (equal at fp32 within atol)."""
    rs = np.random.RandomState(6)
    B, P, ps, NP, KV, hd, H = 3, 10, 4, 3, 2, 32, 4
    tp, jp = _attn_params(rs)
    kp, vp = _np(rs, P, ps, KV, hd), _np(rs, P, ps, KV, hd)
    bt = np.array([[3, 7, -1], [0, -1, -1], [5, 1, 8]], np.int32)
    pos = np.array([5, 2, 10], np.int32)
    wpage = np.array([7, P, 8], np.int32)       # row 1's write is dropped
    woff = pos % ps
    scrub = np.array([P, P, 8], np.int32)       # row 2's page is scrubbed
    x = _np(rs, B, 1, 128)
    kw = dict(n_heads=H, n_kv_heads=KV, head_dim=hd, rope_theta=1e6)
    trash = np.zeros((1, ps, KV, hd), np.float32)
    tkv = TL.KVEntry(torch.from_numpy(np.concatenate([kp, trash])),
                     torch.from_numpy(np.concatenate([vp, trash])))
    out_t, kv_t = TL.paged_decode_attention(
        tp, torch.from_numpy(x), tkv, torch.from_numpy(bt),
        torch.from_numpy(pos), wpage=torch.from_numpy(wpage),
        woff=torch.from_numpy(woff), scrub=torch.from_numpy(scrub),
        attn_impl=attn_impl, **kw)
    out_j, kv_j = JL.paged_decode_attention(
        jp, jnp.asarray(x), JL.KVEntry(jnp.asarray(kp), jnp.asarray(vp)),
        jnp.asarray(bt), jnp.asarray(pos), wpage=jnp.asarray(wpage),
        woff=jnp.asarray(woff), scrub=jnp.asarray(scrub), attn_impl="xla",
        **kw)
    _close(out_t, out_j)
    _close(kv_t.k[:P], kv_j.k)
    _close(kv_t.v[:P], kv_j.v)


def test_paged_decode_attention_cow_unported():
    with pytest.raises(NotImplementedError, match="prefix sharing"):
        TL.paged_decode_attention(
            {}, torch.zeros(1, 1, 8), None, None, None, wpage=None,
            woff=None, cow_src=torch.zeros(1), n_heads=1, n_kv_heads=1,
            head_dim=8, rope_theta=1e4)
