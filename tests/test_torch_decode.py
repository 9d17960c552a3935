"""Paged ``decode_step`` of the PyTorch port against the JAX package at
fp32: the same bridged params and the same fed token stream (20 tokens,
ragged ``advance`` masks, page crossings, and a pool small enough that a
row's writes drop and recover onto a scrubbed page) give the same logits
(atol 1e-4) and the same allocator state. Each port branch is held against
the JAX gather branch: the JAX Pallas branch is not a reference on this
tree (ROADMAP Queue 3), and at fp32 the two branches agree within atol."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import paging as jpaging
from repro.models import transformer as jtf
from repro.models.registry import build_model as jax_build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models import paging as tpaging
from repro_torch.models.registry import build_model
from repro_torch.rl.engine import paging as epaging

STEPS, B, S_MAX, PS = 20, 3, 32, 4


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config("qwen2-0.5b")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    tmodel = build_model(get_smoke_config("qwen2-0.5b"))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    jstep = jax.jit(functools.partial(jtf.decode_step, jcfg, attn_impl="xla"))
    return jmodel, jparams, jstep, tmodel, tparams


@pytest.mark.parametrize("attn_impl", ["xla", "paged"])
@pytest.mark.parametrize("n_pages", [None, 6])
def test_decode_stream_matches_jax(models, attn_impl, n_pages):
    jmodel, jparams, jstep, tmodel, tparams = models
    rs = np.random.RandomState(7)
    toks = rs.randint(0, 512, (STEPS, B)).astype(np.int32)
    adv = rs.rand(STEPS, B) < 0.8
    adv[0] = True
    jc = jmodel.init_cache(B, S_MAX, layout="paged", page_size=PS,
                           n_pages=n_pages, kv_dtype="fp32")
    tc = tmodel.init_cache(B, S_MAX, layout="paged", page_size=PS,
                           n_pages=n_pages, kv_dtype="fp32", device="cpu")
    for t in range(STEPS):
        if n_pages is not None and t == 14:
            # free row 0's pages mid-stream: rows that lost writes to the
            # exhausted pool now map pages mid-row (scrubbed)
            assert int(epaging.dropped_tokens(tc, PS).sum()) > 0
            rel = np.array([True, False, False])
            rc, bt = jpaging.release_pages(jc.refcount, jc.block_table,
                                           jnp.asarray(rel))
            jc = jc._replace(refcount=rc, block_table=bt,
                             pos=jnp.where(jnp.asarray(rel), 0, jc.pos))
            trc, tbt = tpaging.release_pages(tc.refcount, tc.block_table,
                                             torch.from_numpy(rel))
            tc = tc._replace(refcount=trc, block_table=tbt,
                             pos=torch.where(torch.from_numpy(rel), 0,
                                             tc.pos))
        jl, jc = jstep(jparams, jnp.asarray(toks[t]), jc,
                       advance=jnp.asarray(adv[t]))
        tl, tc = tmodel.decode_step(tparams, torch.from_numpy(toks[t]), tc,
                                    attn_impl=attn_impl,
                                    advance=torch.from_numpy(adv[t]))
        # rows that did not advance return logits nobody reads (a fully
        # unmapped row attends to nothing: the kernel gives 0, _sdpa a mean)
        np.testing.assert_allclose(tl.numpy()[adv[t]],
                                   np.asarray(jl)[adv[t]], atol=1e-4,
                                   err_msg=f"step {t}")
        for f in ("block_table", "refcount", "pos"):
            np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                          np.asarray(getattr(jc, f)))
    P = tc.n_pages
    np.testing.assert_allclose(tc.kv.k[:, :P].numpy(), np.asarray(jc.kv.k),
                               atol=1e-5)


def test_unported_layouts_raise(models):
    """int8 pages are a paged-layout format: the dense cache refuses them
    with JAX's reason."""
    tmodel = models[3]
    with pytest.raises(ValueError, match="int8.*requires the paged layout"):
        tmodel.init_cache(2, 16, kv_dtype="int8")
