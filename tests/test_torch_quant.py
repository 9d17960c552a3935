"""int8 KV pages in the port against the JAX package.

- ``quantize_kv``/``dequantize_kv`` bitwise equal to JAX's on the same
  inputs (f32 and bf16, ties at .5 included: both round half to even
  before the clip), zero vectors exact.
- The int8 cache: value pools int8, f32 scale pools beside them with the
  trash page; the dense layout refuses int8.
- The layer: the copy-on-write copy moves the scales with their values
  (bitwise the same as copying the page by hand first), and the scrub
  zeroes the scales, so a recycled page reads exactly 0.
- The engine at fp32 weights on int8 pages, greedy and sampled with JAX's
  noise, on tictactoe and bandit: tokens, masks, rewards and context
  lengths equal to JAX's int8 engine; log-probs within atol 1e-4 (the
  scales of K/V that differ from JAX's by an f32 ulp, measured up to
  4.2e-5). Also with prefix sharing, and with speculation. JAX's own 0.95
  top-1 agreement gate against fp32 is not used (it fails in JAX).
- The port's kernel route against its gather route on the same int8
  pool: logits within atol 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models import paging as jpaging
from repro.models.registry import build_model as jax_build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as TL
from repro_torch.models import paging as tpaging
from repro_torch.models.registry import build_model
from repro_torch.rl.engine import CompiledRolloutEngine
from repro_torch.rl.envs import make_env
from test_torch_envs import assert_same_rollout, run_both


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small eager ops: one intra-op thread per test worker, so parallel
    workers do not oversubscribe the cores (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_matches_jax_bitwise(dtype, seed):
    rs = np.random.RandomState(seed)
    x = (rs.standard_normal((5, 7, 2, 64)) * rs.uniform(0.01, 30)).astype(
        np.float32)
    x[0, 0, 0] = 0.0                                 # a zero vector
    # exact ties: absmax 127 makes the scale 1, so x / scale = x
    x[1, 0, 0, :4] = [127.0, 2.5, -3.5, 0.5]
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jq, js = jpaging.quantize_kv(jx)
    tq, ts = tpaging.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq[1, 0, 0, :4].tolist() == [127, 2, -4, 0]   # half to even
    assert not tq[0, 0, 0].any() and float(ts[0, 0, 0]) == 0.0
    np.testing.assert_array_equal(
        tpaging.dequantize_kv(tq, ts).numpy(),
        np.asarray(jpaging.dequantize_kv(jq, js)))
    err = (tpaging.dequantize_kv(tq, ts) - tx.float()).abs()
    assert (err <= ts[..., None] / 2 + 1e-6).all()


def test_int8_cache_allocates_scale_pools():
    model = build_model(get_smoke_config("qwen2-0.5b"))
    cfg = model.cfg
    c = model.init_cache(2, 24, layout="paged", page_size=4, n_pages=9,
                         kv_dtype="int8", device="cpu")
    shape = (cfg.n_layers, 10, 4, cfg.n_kv_heads, cfg.head_dim_)
    assert tuple(c.kv.k.shape) == shape and c.kv.k.dtype == torch.int8
    for s in (c.kv.k_scale, c.kv.v_scale):
        assert tuple(s.shape) == shape[:-1] and s.dtype == torch.float32
    assert c.n_pages == 9
    assert model.init_cache(2, 24, layout="paged",
                            device="cpu").kv.k_scale is None
    with pytest.raises(ValueError, match="paged"):
        model.init_cache(2, 24, kv_dtype="int8", device="cpu")


def _layer_case(seed):
    rs = np.random.RandomState(seed)
    H = KV = 2
    hd, D, P, ps, B = 8, 16, 6, 4, 2
    p = {k: (rs.standard_normal(s) * 0.1).astype(np.float32)
         for k, s in (("wq", (D, H * hd)), ("wk", (D, KV * hd)),
                      ("wv", (D, KV * hd)), ("wo", (H * hd, D)))}
    x = rs.standard_normal((B, 1, D)).astype(np.float32)
    qk, sk = jpaging.quantize_kv(jnp.asarray(
        rs.standard_normal((P, ps, KV, hd)), jnp.float32))
    qv, sv = jpaging.quantize_kv(jnp.asarray(
        rs.standard_normal((P, ps, KV, hd)), jnp.float32))
    pools = [np.asarray(a) for a in (qk, qv, sk, sv)]
    kw = dict(n_heads=H, n_kv_heads=KV, head_dim=hd, rope_theta=1e4)
    return p, x, pools, P, ps, kw


def _tkv(pools):
    """The port's pools: each with its trash page appended."""
    return TL.KVEntry(*(torch.from_numpy(np.concatenate(
        [a, np.zeros((1,) + a.shape[1:], a.dtype)])) for a in pools))


def test_cow_copies_scales():
    """Row 0 writes into page 4, a privatized copy of shared page 1 (row 1
    takes the sentinel): bitwise the same pools and output as copying page
    1 (values and scales) into page 4 by hand first, and the copy's scales
    below the fill line are the source's."""
    p, x, pools, P, ps, kw = _layer_case(0)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    args = dict(wpage=torch.tensor([4, 2], dtype=torch.int32),
                woff=torch.tensor([2, 1], dtype=torch.int32))
    bt = torch.tensor([[4, -1], [2, -1]], dtype=torch.int32)
    pos = torch.tensor([2, 1], dtype=torch.int32)
    out_c, kv_c = TL.paged_decode_attention(
        tp, torch.from_numpy(x), _tkv(pools), bt, pos,
        cow_src=torch.tensor([1, P], dtype=torch.int32),
        cow_dst=torch.tensor([4, P], dtype=torch.int32), attn_impl="xla",
        **args, **kw)
    pre = [a.copy() for a in pools]
    for a in pre:
        a[4] = a[1]
    out_p, kv_p = TL.paged_decode_attention(
        tp, torch.from_numpy(x), _tkv(pre), bt, pos, attn_impl="xla",
        **args, **kw)
    assert torch.equal(out_c, out_p)
    for a, b in zip(kv_c, kv_p):
        assert torch.equal(a[:P], b[:P])
    np.testing.assert_array_equal(kv_c.k_scale[4, :2].numpy(),
                                  pools[2][1, :2])
    # and JAX's layer agrees on the written pools: the new entry's K/V come
    # from f32 projections summed in another order, so its scale may sit an
    # f32 ulp away and its int8 values one step away at a rounding edge
    _, kv_j = JL.paged_decode_attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        JL.KVEntry(*(jnp.asarray(a) for a in pools)), jnp.asarray(bt),
        jnp.asarray(pos), wpage=jnp.asarray(args["wpage"]),
        woff=jnp.asarray(args["woff"]), cow_src=jnp.array([1, P]),
        cow_dst=jnp.array([4, P]), **kw)
    for a, b in zip(kv_c[:2], kv_j[:2]):
        assert np.abs(a[:P].numpy().astype(np.int32)
                      - np.asarray(b).astype(np.int32)).max() <= 1
    for a, b in zip(kv_c[2:], kv_j[2:]):
        np.testing.assert_allclose(a[:P].numpy(), np.asarray(b), rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("attn_impl", ["xla", "paged"])
def test_scrub_zeroes_scales(attn_impl):
    """A page holding int8 residue (values and nonzero scales) re-mapped
    mid-row is scrubbed: bitwise the same as a hand-zeroed page, and its
    unwritten offsets dequantize to exactly 0."""
    p, x, pools, P, ps, kw = _layer_case(1)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    assert np.abs(pools[2][4]).sum() > 0                # residue
    bt = torch.tensor([[0, -1], [2, 4]], dtype=torch.int32)
    pos = torch.tensor([0, ps], dtype=torch.int32)
    args = dict(wpage=torch.tensor([0, 4], dtype=torch.int32),
                woff=torch.tensor([0, 0], dtype=torch.int32))
    out_s, kv_s = TL.paged_decode_attention(
        tp, torch.from_numpy(x), _tkv(pools), bt, pos,
        scrub=torch.tensor([P, 4], dtype=torch.int32), attn_impl=attn_impl,
        **args, **kw)
    clean = [a.copy() for a in pools]
    for a in clean:
        a[4] = 0
    out_o, kv_o = TL.paged_decode_attention(
        tp, torch.from_numpy(x), _tkv(clean), bt, pos, attn_impl=attn_impl,
        **args, **kw)
    assert torch.equal(out_s, out_o)
    for a, b in zip(kv_s, kv_o):
        assert torch.equal(a[:P], b[:P])
    assert not kv_s.k[4, 1:].any() and not kv_s.k_scale[4, 1:].any()
    assert not kv_s.v_scale[4, 1:].any()
    assert not tpaging.dequantize_kv(kv_s.k[4], kv_s.k_scale[4])[1:].any()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jmodel = jax_build_model(jax_smoke_config("qwen2-0.5b"))
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    tmodel = build_model(get_smoke_config("qwen2-0.5b"))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, tmodel, tparams


KW = dict(max_turns=3, max_turn_tokens=4, max_context=96,
          cache_layout="paged", page_size=8, kv_dtype="int8")


def _case(env_name):
    if env_name == "bandit":
        return {"prompt_len": 16}, dict(KW, max_turns=1)
    return {}, KW


@pytest.mark.parametrize("env_name,sampling,temperature", [
    ("tictactoe", "fused", 0.0), ("tictactoe", "reference", 1.0),
    ("bandit", "fused", 1.0), ("bandit", "reference", 0.0)])
def test_int8_engine_matches_jax(models, env_name, sampling, temperature):
    env_kw, kw = _case(env_name)
    j, t, _ = run_both(models, env_name, env_kw, 4, 8, jax.random.PRNGKey(9),
                       sampling=sampling, temperature=temperature, **kw)
    assert_same_rollout(j, t, lp_atol=1e-4)


@pytest.mark.parametrize("env_name", ["tictactoe", "bandit"])
def test_int8_with_sharing_matches_jax(models, env_name):
    env_kw, kw = _case(env_name)
    j, t, teng = run_both(models, env_name, env_kw, 4, 9,
                          jax.random.PRNGKey(4), share_prefix=True,
                          sampling="reference", temperature=1.0, **kw)
    assert teng.shared_pages > 0
    assert_same_rollout(j, t, lp_atol=1e-4)


@pytest.mark.parametrize("share", [False, True])
def test_int8_with_speculation_matches_jax(models, share):
    """speculation="self" on int8 pages (with sharing: the CoW guard in the
    verify chunk stays armed), greedy and sampled against JAX's; the spec
    counters equal."""
    j, t, _ = run_both(models, "tictactoe", {}, 3, 5, jax.random.PRNGKey(2),
                       speculation="self", spec_k=3, draft_layers=1,
                       sampling="reference", temperature=1.0,
                       share_prefix=share, **KW)
    assert_same_rollout(j, t, lp_atol=1e-4)
    for f in ("spec_proposed", "spec_accepted", "spec_rounds"):
        assert getattr(t[1], f) == getattr(j[1], f), f


def test_int8_kernel_route_matches_gather_route(models):
    """One decode step on an int8 pool after a shared initial feed: the
    paged kernel's route (its plain version here: dequantize, then f32
    softmax) against the gather route (gather, dequantize, ``_sdpa``),
    logits within atol 1e-4 at fp32 weights."""
    _, _, tmodel, tparams = models
    eng = CompiledRolloutEngine(tmodel, make_env("bandit", prompt_len=16),
                                device="cpu", share_prefix=True,
                                temperature=0.0, **dict(KW, max_turns=1))
    carry = eng.init_feed(tparams, eng.init_carry(4, 4))
    tok = torch.full((4,), 40, dtype=torch.int32)
    out = {}
    for impl in ("paged", "xla"):
        cache = carry.cache._replace(kv=type(carry.cache.kv)(
            *(t.clone() for t in carry.cache.kv)))
        out[impl] = tmodel.decode_step(tparams, tok, cache,
                                       attn_impl=impl)[0]
    torch.testing.assert_close(out["paged"], out["xla"], atol=1e-4, rtol=0)


def test_int8_pool_is_smaller_than_bf16(models):
    """Bytes per token and kv head: hd + 4 (int8 + one f32 scale) against
    2 * hd (bf16)."""
    tmodel = models[2]
    sizes = {}
    for dt in ("int8", "bf16"):
        c = tmodel.init_cache(4, 96, layout="paged", page_size=8,
                              kv_dtype=dt, device="cpu")
        sizes[dt] = sum(t.numel() * t.element_size() for t in c.kv
                        if t is not None)
    hd = tmodel.cfg.head_dim_
    assert sizes["int8"] * 2 * hd == sizes["bf16"] * (hd + 4)
