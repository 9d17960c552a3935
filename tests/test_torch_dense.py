"""The dense KV layout of the PyTorch port against the JAX package, on the
smoke qwen2 config with bridged params.

A prompt of 12 tokens is prefilled, then 8 more are decoded one at a time
(row 1 held back on two steps, as the engines do with rows waiting on the
rest of the batch). The logits are held against JAX's full-sequence
``transformer.forward`` over the same tokens and against JAX's dense
``prefill`` and ``decode_step`` ("xla"), with the port's "xla"/"flash"
prefill and "xla"/"pallas" decode (the kernels' plain versions on the
CPU). The cache takes the weights' dtype. fp32: logits within atol 1e-4
(f32 math in another order). bf16: within 5% of the logit scale (bf16
matmuls round at other places in the two frameworks, and the forward keeps
K/V unrounded).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import transformer as jtf
from repro.models.registry import build_model as jax_build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as ttf
from repro_torch.models.registry import build_model

B, PROMPT, GEN = 3, 12, 8


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config("qwen2-0.5b")
    jmodel = jax_build_model(jcfg)
    tmodel = build_model(get_smoke_config("qwen2-0.5b"))
    out = {}
    for dt in ("float32", "bfloat16"):
        jp = jmodel.init(jax.random.PRNGKey(0), dtype=getattr(jnp, dt))
        out[dt] = (jp, params_from_numpy(jax.tree.map(
            lambda a: np.asarray(a.astype(jnp.float32)), jp)))
        if dt == "bfloat16":
            out[dt] = (jp, {k: v.to(torch.bfloat16)
                            for k, v in out[dt][1].items()})
    return jcfg, jmodel, tmodel, out


def test_init_cache_defaults_to_dense(models):
    jcfg, jmodel, tmodel, _ = models
    tc = tmodel.init_cache(2, 16)
    jc = jmodel.init_cache(2, 16)
    assert isinstance(tc, ttf.DecodeCache)
    assert tuple(tc.kv.k.shape) == jc.kv.k.shape
    assert tc.kv.k.dtype == torch.bfloat16 and tc.pos.dtype == torch.int32
    # a sliding-window config allocates only its window
    wcfg = dataclasses.replace(tmodel.cfg, sliding_window=8)
    jw = jtf.init_cache(dataclasses.replace(jcfg, sliding_window=8), 2, 16)
    tw = ttf.init_cache(wcfg, 2, 16, kv_dtype="fp32")
    assert tuple(tw.kv.k.shape) == jw.kv.k.shape == (2, 2, 8, 2, 32)
    assert tw.kv.k.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prefill_impl,decode_impl", [
    ("xla", "xla"), ("flash", "pallas")])
def test_prefill_then_decode_matches_jax(models, dtype, prefill_impl,
                                         decode_impl):
    jcfg, jmodel, tmodel, params = models
    jp, tp = params[dtype]
    rs = np.random.RandomState(11)
    toks = rs.randint(0, jcfg.vocab_size, (B, PROMPT + GEN)).astype(np.int32)
    adv = np.ones((GEN, B), bool)
    adv[[2, 5], 1] = False

    jfwd = np.asarray(jtf.forward(jcfg, jp, jnp.asarray(toks)), np.float32)
    kv_dtype = "fp32" if dtype == "float32" else "bf16"
    jc = jmodel.init_cache(B, 32, kv_dtype=kv_dtype)
    jl, jc = jmodel.prefill(jp, jnp.asarray(toks[:, :PROMPT]), jc)
    jstep = jax.jit(functools.partial(jtf.decode_step, jcfg))
    tc = tmodel.init_cache(B, 32, kv_dtype=kv_dtype)
    tl, tc = tmodel.prefill(tp, torch.from_numpy(toks[:, :PROMPT]), tc,
                            attn_impl=prefill_impl)
    assert tc.pos.tolist() == [PROMPT] * B

    if dtype == "float32":
        tol = lambda ref: 1e-4
    else:
        tol = lambda ref: 0.05 * float(np.abs(ref).max())
    fed = np.full(B, PROMPT)              # next position of each row
    for t in range(-1, GEN):
        if t >= 0:
            tok = toks[np.arange(B), fed]
            jl, jc = jstep(jp, jnp.asarray(tok), jc,
                           advance=jnp.asarray(adv[t]))
            tl, tc = tmodel.decode_step(tp, torch.from_numpy(tok), tc,
                                        attn_impl=decode_impl,
                                        advance=torch.from_numpy(adv[t]))
            rows = adv[t]
            fed = fed + adv[t]
        else:
            rows = np.ones(B, bool)
        got = tl.float().numpy()[rows]
        for ref in (np.asarray(jl, np.float32)[rows],
                    jfwd[np.arange(B), fed - 1][rows]):
            np.testing.assert_allclose(got, ref, atol=tol(ref), rtol=0,
                                       err_msg=f"step {t}")
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    np.testing.assert_allclose(tc.kv.k.float().numpy(),
                               np.asarray(jc.kv.k, np.float32),
                               atol=0.05 if dtype == "bfloat16" else 1e-5)


@pytest.mark.parametrize("decode_impl", ["xla", "pallas"])
def test_sliding_window_ring_matches_jax(models, decode_impl):
    """A copy of the smoke config with ``sliding_window=8`` on both sides:
    the cache holds 8 slots, 14 tokens are decoded one at a time (row 2
    held back on three steps), so the ring wraps; logits of advancing rows
    within atol 1e-4 at fp32, the ring's contents within 1e-5."""
    jcfg, _, tmodel, params = models
    jp, tp = params["float32"]
    jw = dataclasses.replace(jcfg, sliding_window=8)
    tw = dataclasses.replace(tmodel.cfg, sliding_window=8)
    rs = np.random.RandomState(13)
    toks = rs.randint(0, jcfg.vocab_size, (14, B)).astype(np.int32)
    adv = np.ones((14, B), bool)
    adv[[3, 7, 10], 2] = False
    jc = jtf.init_cache(jw, B, 32, kv_dtype="fp32")
    tc = ttf.init_cache(tw, B, 32, kv_dtype="fp32")
    assert tc.kv.k.shape[2] == 8
    jstep = jax.jit(functools.partial(jtf.decode_step, jw))
    for t in range(14):
        jl, jc = jstep(jp, jnp.asarray(toks[t]), jc,
                       advance=jnp.asarray(adv[t]))
        tl, tc = ttf.decode_step(tw, tp, torch.from_numpy(toks[t]), tc,
                                 attn_impl=decode_impl,
                                 advance=torch.from_numpy(adv[t]))
        np.testing.assert_allclose(tl.numpy()[adv[t]],
                                   np.asarray(jl)[adv[t]], atol=1e-4,
                                   err_msg=f"step {t}")
    assert int(tc.pos.max()) > 8
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    np.testing.assert_allclose(tc.kv.k.numpy(), np.asarray(jc.kv.k),
                               atol=1e-5)


def test_paged_prefill_raises(models):
    """The paged prefill (ported with prefix sharing) no longer raises: at
    fp32 its last-position logits match JAX's paged prefill and the port's
    dense prefill within atol 1e-4, and its block table and refcounts are
    JAX's bitwise. A shared prefix needs the paged layout (ValueError on
    the dense one, as JAX's assert)."""
    _, jmodel, tmodel, out = models
    jp, tp = out["float32"]
    toks = np.random.RandomState(3).randint(8, 500, (B, PROMPT))
    tl, tc = tmodel.prefill(tp, torch.from_numpy(toks), tmodel.init_cache(
        B, 32, layout="paged", page_size=8, kv_dtype="fp32", device="cpu"))
    jl, jc = jmodel.prefill(jp, jnp.asarray(toks), jmodel.init_cache(
        B, 32, layout="paged", page_size=8, kv_dtype="fp32"))
    dl, _ = tmodel.prefill(tp, torch.from_numpy(toks), tmodel.init_cache(
        B, 32, kv_dtype="fp32", device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(tl.numpy(), dl.numpy(), atol=1e-4)
    for f in ("block_table", "refcount", "pos"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)))
    with pytest.raises(ValueError, match="paged"):
        tmodel.prefill(tp, torch.from_numpy(toks),
                       tmodel.init_cache(B, 32, device="cpu"),
                       shared_prefix_len=8)
