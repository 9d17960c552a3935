"""Transformer layers: RMSNorm, RoPE, GQA attention, SwiGLU MLP (port of
the dense-model parts of ``repro/models/layers.py``: full-sequence
self-attention, the dense ring-buffer prefill and decode, the paged
prefill, chunk and decode attention and the speculative verify chunk).

Functions take the same layouts as the JAX ones: activations
``(B, S, D)``, per-head tensors ``(B, S, H, hd)``, params a dict of
tensors for one layer. Normalisation, RoPE and softmax run in f32;
matmuls run in the model dtype.

Tensor parallelism (``tp=``, a ``models.tensor_parallel.TPContext``): the
head counts a caller passes are the rank's local ones, the kernels run on
those heads, and the o-proj's and the MLP's partial sums are all-reduced
over the model axis when their dims are split; ``embed`` and ``unembed``
are vocab-parallel. ``tp=None`` is one rank. Where the plan replicates
attention, a long sequence's queries split over the model axis instead
(``seq_parallel``, JAX's ``_maybe_seq_parallel``).

Paged KV pools carry ONE trash page past the end: a layer's pool is
``(P + 1, ps, KV, hd)`` with ``P`` real pages, and the drop sentinel
``wpage == P`` names the trash page (JAX drops such writes with
``mode="drop"``; on CUDA an out-of-range index is a device assert). Block
tables only ever name pages ``< P``, so the trash page is never read as
context. An int8 pool carries ``(P + 1, ps, KV)`` f32 scale pools beside
its values (``paging.quantize_kv``): every write quantizes per token and
kv head, every read dequantizes, and the copy-on-write copy and the scrub
move the scales with their values.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

# the threshold of ``seq_parallel``, defined beside the plan whose
# fallbacks state it; this module's binding is the one the gate reads
from repro_torch.core.resharding import SEQ_PARALLEL_MIN_S
from repro_torch.models import paging
from repro_torch.models.param import pdef

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Normalization / RoPE
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)                      # (head_dim//2,)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S).
    Split-halves layout, f32 math, result in x's dtype."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., :, None].float() * freqs      # (...,S,hd//2)
    cos = torch.cos(angles)[..., None, :]                 # (...,S,1,hd//2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attention_defs(d_model, n_heads, n_kv_heads, head_dim, *, qkv_bias=False,
                   layers=None):
    """Flat ParamDef dict for one attention block (optionally stacked)."""
    L = (layers,) if layers else ()
    ax = ("layers",) if layers else ()
    defs = {
        "wq": pdef(L + (d_model, n_heads * head_dim), ax + ("embed", "heads"),
                   init="scaled"),
        "wk": pdef(L + (d_model, n_kv_heads * head_dim),
                   ax + ("embed", "kv_heads"), init="scaled"),
        "wv": pdef(L + (d_model, n_kv_heads * head_dim),
                   ax + ("embed", "kv_heads"), init="scaled"),
        "wo": pdef(L + (n_heads * head_dim, d_model), ax + ("heads", "embed"),
                   init="scaled"),
    }
    if qkv_bias:
        defs["bq"] = pdef(L + (n_heads * head_dim,), ax + ("heads",), "zeros")
        defs["bk"] = pdef(L + (n_kv_heads * head_dim,), ax + ("kv_heads",),
                          "zeros")
        defs["bv"] = pdef(L + (n_kv_heads * head_dim,), ax + ("kv_heads",),
                          "zeros")
    return defs


def _project_qkv(p, x, n_heads, n_kv_heads, head_dim):
    B, S, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return (q.reshape(B, S, n_heads, head_dim),
            k.reshape(B, S, n_kv_heads, head_dim),
            v.reshape(B, S, n_kv_heads, head_dim))


def _sdpa(q, k, v, mask):
    """q: (B,Sq,H,hd)  k,v: (B,Sk,KV,hd)  mask: (B|1,1,Sq,Sk) additive.
    Scores and softmax in f32, matmuls in the inputs' dtype."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    q = q.reshape(B, Sq, KV, H // KV, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k).float()
    scores = scores / math.sqrt(hd)
    scores = scores + mask[:, :, None, :, :]              # (B,KV,G,Sq,Sk)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, Sq, H, hd)


def _o_proj(p, out, tp=None):
    """The output projection of (B, S, H*hd) attention output: partial
    sums over the rank's heads, all-reduced when attention is split."""
    if tp is None:
        return out @ p["wo"]
    return tp.row_parallel(out, p["wo"], tp.attn_split)


def causal_mask(Sq: int, Sk: int, *, q_offset: int = 0, window: int = 0,
                device=None):
    """Additive f32 mask (1,1,Sq,Sk): q position i attends to k <= i +
    q_offset, and (if window > 0) k > i + q_offset - window."""
    qpos = torch.arange(Sq, device=device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=device)[None, :]
    ok = kpos <= qpos
    if window > 0:
        ok &= kpos > (qpos - window)
    return torch.where(ok, 0.0, NEG_INF).float()[None, None]


def seq_parallel(tp, S: int) -> bool:
    """Whether a causal self-attention of ``S`` queries splits its queries
    over the model axis (the port's ``_maybe_seq_parallel``, JAX's
    ``models/layers.py``): at tp above 1 where ``tp``'s plan replicates
    attention, S >= ``SEQ_PARALLEL_MIN_S`` and tp divides S. The plan
    replicates attention where the q heads do not divide the model axis
    (JAX's case: qwen2's 14 heads on 4 or 16 ranks) and also where a
    rank's q heads would read their kv heads unevenly (the port's own
    fallback, ``core/resharding._attention_rule``): both split by
    sequence. Model rank r then takes the contiguous rows ``[r S/tp, (r+1)
    S/tp)`` (JAX's ``constrain(q, "batch", "model", ...)``) against the
    whole K/V (``_causal_attention``)."""
    return (tp is not None and tp.size > 1 and not tp.attn_split
            and S >= SEQ_PARALLEL_MIN_S and S % tp.size == 0)


def _causal_attention(q, k, v, *, window: int, flash: bool, tp=None):
    """Causal self-attention of q (B,S,H,hd) over k, v (B,S,KV,hd): the
    flash forward kernel (``flash``) or ``_sdpa`` with ``causal_mask``.
    Under ``seq_parallel`` this rank attends with its S/tp query rows
    only, at their offset, and the rows are gathered over the model axis:
    each row's arithmetic is the replicated run's."""
    S = q.shape[1]
    split = seq_parallel(tp, S)
    off = 0
    if split:
        n = S // tp.size
        off = tp.index * n
        q = q[:, off:off + n].contiguous()
    if flash:
        from repro_torch.kernels.flash_attention import ops as fa_ops
        out = fa_ops.flash_attention(q, k, v, causal=True, window=window,
                                     q_offset=off)
    else:
        out = _sdpa(q, k, v, causal_mask(q.shape[1], S, q_offset=off,
                                         window=window, device=q.device))
    return tp.gather_seq(out) if split else out


def self_attention(p, x, *, n_heads, n_kv_heads, head_dim, rope_theta,
                   positions=None, window: int = 0, cross_kv=None,
                   attn_impl: str = "xla", tp=None):
    """Full-sequence causal self-attention (training and the reference
    pass). x: (B,S,D) -> (B,S,D).

    attn_impl: "xla" runs the plain ``_sdpa`` with ``causal_mask``;
    "flash" runs the flash-attention kernels (``kernels/flash_attention``,
    forward and backward; their plain versions for CPU tensors) — the
    port's name for what the JAX package calls "pallas" here. Under
    ``seq_parallel`` the rank attends with its share of the queries.

    cross_kv: optional ``(k, v)``, each (B, Sk, KV, hd) — attend to those
    instead of self-derived k/v (encoder-decoder cross-attention and the
    vlm's image layers): q takes no RoPE, the mask is zero, and the
    attention is always the plain ``_sdpa``, whatever ``attn_impl`` says
    (no Pallas kernel computes it in the JAX package either).
    """
    B, S, _ = x.shape
    if cross_kv is not None:
        q = x @ p["wq"]
        if "bq" in p:
            q = q + p["bq"]
        k, v = cross_kv
        mask = torch.zeros((1, 1, S, k.shape[1]), dtype=torch.float32,
                           device=x.device)
        out = _sdpa(q.reshape(B, S, n_heads, head_dim), k, v, mask)
        return out.reshape(B, S, n_heads * head_dim) @ p["wo"]
    if attn_impl not in ("flash", "xla"):
        raise ValueError(f"attn_impl must be 'flash' or 'xla', got "
                         f"{attn_impl!r}")
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    out = _causal_attention(q, k, v, window=window,
                            flash=attn_impl == "flash", tp=tp)
    return _o_proj(p, out.reshape(B, S, n_heads * head_dim), tp)


class KVEntry(NamedTuple):
    k: torch.Tensor   # dense (B, s_max, KV, hd) or paged (P+1, ps, KV, hd)
                      # per layer, or stacked over layers
    v: torch.Tensor
    # int8 page pools: per (page, offset, kv head) f32 scales, (P+1, ps, KV)
    # per layer; None for full-precision pools and every dense cache
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    def layer(self, i: int) -> "KVEntry":
        """Layer ``i``'s views of a stacked entry (scales included)."""
        return KVEntry(*(None if t is None else t[i] for t in self))


def _pool_is_quantized(kv: KVEntry) -> bool:
    return kv.k_scale is not None


def _scatter_pool(kv: KVEntry, pages, k, v):
    """Write new (B, S, KV, hd) K/V IN PLACE into the pool pages ``pages``
    (B, npp) (the trash page takes dropped rows), padding the last page;
    int8 pools quantize on write, values and scales in the same scatter."""
    B, S = k.shape[:2]
    npp = pages.shape[1]
    ps = kv.k.shape[1]
    pad = npp * ps - S
    idx = (pages.long(),)

    def put(pool, new):
        buf = F.pad(new.to(pool.dtype),
                    (0, 0) * (new.dim() - 2) + (0, pad))
        pool.index_put_(idx, buf.reshape((B, npp, ps) + new.shape[2:]))

    if _pool_is_quantized(kv):
        qk, sk = paging.quantize_kv(k)
        qv, sv = paging.quantize_kv(v)
        for pool, new in ((kv.k, qk), (kv.v, qv), (kv.k_scale, sk),
                          (kv.v_scale, sv)):
            put(pool, new)
    else:
        put(kv.k, k)
        put(kv.v, v)
    return kv


def _cow_scrub_write(kv: KVEntry, k_new, v_new, *, wpage, woff, scrub,
                     cow_src, cow_dst):
    """The paged write of one decode step or verify chunk, IN PLACE, in
    JAX's order: the copy-on-write copy of privatized pages (values and
    scales: a privatized page reads bitwise as its shared source until the
    row's own write lands), the scrub of pages mapped mid-row (zero scales
    dequantize to 0 whatever int8 residue the values hold), then the write
    of ``k_new``/``v_new`` (B, [K,] KV, hd) at ``(wpage, woff)``, quantized
    per token for int8 pools. Sentinel ``P`` (the trash page) makes each a
    no-op: the CoW sentinel copies the trash page onto itself."""
    quant = _pool_is_quantized(kv)
    pools = ((kv.k, kv.v, kv.k_scale, kv.v_scale) if quant
             else (kv.k, kv.v))
    if cow_src is not None:
        src, dst = cow_src.long(), cow_dst.long()
        for t in pools:
            t.index_copy_(0, dst, t[src])
    if scrub is not None:
        idx = scrub.long()
        for t in pools:
            t.index_fill_(0, idx, 0)
    wp, wo = wpage.long(), woff.long()
    if quant:
        qk, sk = paging.quantize_kv(k_new)
        qv, sv = paging.quantize_kv(v_new)
        for t, new in zip(pools, (qk, qv, sk, sv)):
            t.index_put_((wp, wo), new)
    else:
        kv.k.index_put_((wp, wo), k_new.to(kv.k.dtype))
        kv.v.index_put_((wp, wo), v_new.to(kv.v.dtype))
    return kv


def init_kv(batch, s_max, n_kv_heads, head_dim, dtype=torch.bfloat16,
            device=None):
    shape = (batch, s_max, n_kv_heads, head_dim)
    return KVEntry(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def prefill_attention(p, x, kv: KVEntry, *, n_heads, n_kv_heads, head_dim,
                      rope_theta, window: int = 0, attn_impl: str = "xla",
                      tp=None):
    """Causal attention over the prompt x (B,S,D); writes its K/V into
    cache slots ``[0, S)`` of ``kv`` (B, s_max, KV, hd) IN PLACE.
    attn_impl: "xla" (``_sdpa``) or "flash" (the flash forward kernel).
    Under ``seq_parallel`` the rank attends with its share of the queries
    and still writes the whole cache."""
    B, S, _ = x.shape
    if S > kv.k.shape[1]:
        raise ValueError(f"prompt of {S} tokens does not fit a cache of "
                         f"{kv.k.shape[1]} slots")
    if attn_impl not in ("flash", "xla"):
        raise ValueError(f"attn_impl must be 'flash' or 'xla', got "
                         f"{attn_impl!r}")
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    kv.k[:, :S] = k.to(kv.k.dtype)
    kv.v[:, :S] = v.to(kv.v.dtype)
    out = _causal_attention(q, k, v, window=window,
                            flash=attn_impl == "flash", tp=tp)
    return _o_proj(p, out.reshape(B, S, n_heads * head_dim), tp), kv


def decode_attention(p, x, kv: KVEntry, pos, *, n_heads, n_kv_heads,
                     head_dim, rope_theta, window: int = 0,
                     attn_impl: str = "xla", advance=None, tp=None):
    """One-token decode against a dense ring-buffer cache. x: (B,1,D);
    kv.k/v: (B, s_max, KV, hd), written IN PLACE; pos: (B,) int absolute
    positions (or an int for every row). advance: optional (B,) bool —
    rows with False write nothing (their slot keeps its old value) and
    their output is not to be consumed.

    The token at position t lands in slot ``t % s_max``; slot i holds
    position ``kpos_i = pos - ((pos - i) mod s_max)``, valid when ``0 <=
    kpos_i <= pos`` and, with a window, ``kpos_i > pos - window``. With
    ``s_max`` covering the context the ring is a plain linear cache.
    attn_impl: "pallas" runs the split-K decode kernel
    (``kernels/decode_attention``; its plain f32 version on CPU tensors),
    "xla" the plain ``_sdpa`` with an additive mask in the model dtype.
    """
    B, S1, _ = x.shape
    if S1 != 1:
        raise ValueError(f"decode takes one token per row, got {S1}")
    s_max = kv.k.shape[1]
    dev = x.device
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev).expand(B)
    positions = pos[:, None]
    q, k_new, v_new = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k_new = apply_rope(k_new, positions, rope_theta)
    rows = torch.arange(B, device=dev)
    slot = torch.remainder(pos, s_max).long()             # ring write slot
    wk, wv = k_new[:, 0].to(kv.k.dtype), v_new[:, 0].to(kv.v.dtype)
    if advance is not None:
        adv = advance[:, None, None]
        wk = torch.where(adv, wk, kv.k[rows, slot])
        wv = torch.where(adv, wv, kv.v[rows, slot])
    kv.k.index_put_((rows, slot), wk)
    kv.v.index_put_((rows, slot), wv)
    # absolute position held by each ring slot (identity when s_max > pos)
    idx = torch.arange(s_max, device=dev)[None, :]
    kpos = pos[:, None] - torch.remainder(pos[:, None] - idx, s_max)
    valid = (kpos >= 0) & (kpos <= pos[:, None])
    if window > 0:
        valid &= kpos > (pos[:, None] - window)
    if attn_impl == "pallas":
        from repro_torch.kernels.decode_attention import ops as da_ops
        out = da_ops.decode_attention(q[:, 0].contiguous(), kv.k, kv.v,
                                      valid)[:, None]
    elif attn_impl == "xla":
        mask = torch.where(valid, 0.0, NEG_INF).float()[:, None, None, :]
        out = _sdpa(q, kv.k.to(q.dtype), kv.v.to(q.dtype), mask)
    else:
        raise ValueError(f"attn_impl must be 'pallas' or 'xla', got "
                         f"{attn_impl!r}")
    return _o_proj(p, out.reshape(B, 1, n_heads * head_dim), tp), kv


def _gather_pool(kv: KVEntry, block_table, dtype):
    """Each row's pages gathered into dense ``(B, NP*ps, KV, hd)`` K/V in
    ``dtype`` (unmapped entries read a clamped page; int8 pools
    dequantized in the same step, the plain twin of the kernels' in-register
    dequant), and the ``(B, NP*ps)`` mask of positions on mapped pages."""
    P = kv.k.shape[0] - 1                       # the trash page excluded
    ps, n_kv_heads, head_dim = kv.k.shape[1:]
    B, NP = block_table.shape
    bt_c = block_table.clamp(0, P - 1).long()
    k, v = kv.k[bt_c], kv.v[bt_c]
    if _pool_is_quantized(kv):
        k = paging.dequantize_kv(k, kv.k_scale[bt_c])
        v = paging.dequantize_kv(v, kv.v_scale[bt_c])
    k = k.reshape(B, NP * ps, n_kv_heads, head_dim).to(dtype)
    v = v.reshape(B, NP * ps, n_kv_heads, head_dim).to(dtype)
    mapped = (block_table >= 0)[:, :, None].expand(B, NP, ps).reshape(
        B, NP * ps)
    return k, v, mapped


def paged_prefill_attention(p, x, kv: KVEntry, block_table, *, n_heads,
                            n_kv_heads, head_dim, rope_theta,
                            attn_impl: str = "xla", tp=None):
    """Causal attention over the prompt x (B,S,D); its K/V are written IN
    PLACE into the pool pages ``block_table[:, :ceil(S/ps)]`` (already
    mapped by ``transformer._paged_prefill``; unmapped entries drop into
    the trash page). The attention itself is the dense prefill's:
    attn_impl "flash" or "paged" runs the flash forward kernel, "xla"
    ``_sdpa`` with the causal mask. Under ``seq_parallel`` the rank
    attends with its share of the queries and still writes every page."""
    B, S, _ = x.shape
    if attn_impl not in ("flash", "paged", "xla"):
        raise ValueError(f"attn_impl must be 'flash', 'paged' or 'xla', got "
                         f"{attn_impl!r}")
    P, ps = kv.k.shape[0] - 1, kv.k.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    pages = block_table[:, :-(-S // ps)]
    _scatter_pool(kv, torch.where(pages >= 0, pages, P), k, v)
    out = _causal_attention(q, k, v, window=0, flash=attn_impl != "xla",
                            tp=tp)
    return _o_proj(p, out.reshape(B, S, n_heads * head_dim), tp), kv


def paged_chunk_attention(p, x, kv: KVEntry, block_table, start: int, *,
                          n_heads, n_kv_heads, head_dim, rope_theta,
                          attn_impl: str = "xla", tp=None):
    """Causal attention for a chunk of positions ``[start, start + S)``
    whose preceding context already lives in the pool: the per-row suffix
    pass of the shared-prefix prefill. The chunk's K/V are written IN PLACE
    into the rows' (already mapped) pages, then each query attends over the
    full context gathered back through the block table, forked prefix pages
    included. ``start`` is page-aligned (the shared run is whole pages).
    JAX has no kernel here; ``attn_impl`` is accepted for the signature and
    the attention is always the gather path's ``_sdpa``."""
    del attn_impl
    B, S, _ = x.shape
    P, ps = kv.k.shape[0] - 1, kv.k.shape[1]
    if start % ps:
        raise ValueError(f"chunk start {start} is not page-aligned ({ps})")
    dev = x.device
    positions = start + torch.arange(S, device=dev)[None, :]
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    j0, npp = start // ps, -(-S // ps)
    pages = block_table[:, j0:j0 + npp]
    _scatter_pool(kv, torch.where(pages >= 0, pages, P), k, v)
    kc, vc, mapped = _gather_pool(kv, block_table[:, :j0 + npp], q.dtype)
    s_idx = torch.arange(mapped.shape[1], device=dev)[None, None, :]
    valid = (s_idx <= positions[:, :, None]) & mapped[:, None, :]
    mask = torch.where(valid, 0.0, NEG_INF).float()[:, None]
    out = _sdpa(q, kc, vc, mask)
    return _o_proj(p, out.reshape(B, S, n_heads * head_dim), tp), kv


def paged_decode_attention(p, x, kv: KVEntry, block_table, pos, *, wpage,
                           woff, scrub=None, cow_src=None, cow_dst=None,
                           n_heads, n_kv_heads, head_dim, rope_theta,
                           attn_impl: str = "xla", tp=None):
    """One-token decode against a paged KV pool. x: (B,1,D).

    kv.k/v: (P+1, ps, KV, hd) — this layer's pool, trash page at index P.
    block_table: (B, NP) int32 (-1 = unmapped); pos: (B,) absolute
    positions. wpage/woff: per-row write page and in-page offset from the
    caller's allocator; ``wpage == P`` drops the write (into the trash
    page). scrub: optional (B,) pages to zero before the write (sentinel P
    = none). cow_src/cow_dst: optional (B,) page pairs from
    ``paging.cow_pages`` — this layer's slice of each privatized shared
    page is copied into its fresh page before the write (sentinel P = no
    copy); the caller has already remapped the block table. Write-then-
    attend: the new token's K/V lands in the pool first (quantized for an
    int8 pool), then the row attends over positions ``< pos + 1``.

    The pools are updated IN PLACE (the returned KVEntry holds the same
    tensors). attn_impl: "xla" gathers the row's pages into a dense view
    (dequantized) and runs ``_sdpa`` in the model dtype; "paged" runs the
    CUDA kernel, which takes int8 pools with their scales (its plain f32
    version on CPU tensors).
    """
    B, S1, _ = x.shape
    if S1 != 1:
        raise ValueError(f"decode takes one token per row, got {S1}")
    positions = pos[:, None]
    q, k_new, v_new = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k_new = apply_rope(k_new, positions, rope_theta)
    _cow_scrub_write(kv, k_new[:, 0], v_new[:, 0], wpage=wpage, woff=woff,
                     scrub=scrub, cow_src=cow_src, cow_dst=cow_dst)
    lens = (pos + 1).to(torch.int32)       # current token included
    if attn_impl == "paged":
        from repro_torch.kernels.paged_attention import ops as pa_ops
        out = pa_ops.paged_decode_attention(
            q[:, 0].contiguous(), kv.k, kv.v, block_table, lens,
            k_scales=kv.k_scale, v_scales=kv.v_scale)[:, None]
    elif attn_impl == "xla":
        k, v, mapped = _gather_pool(kv, block_table, q.dtype)
        s_idx = torch.arange(mapped.shape[1], device=x.device)[None, :]
        valid = (s_idx < lens[:, None]) & mapped
        mask = torch.where(valid, 0.0, NEG_INF).float()[:, None, None, :]
        out = _sdpa(q, k, v, mask)
    else:
        raise ValueError(f"attn_impl must be 'paged' or 'xla', got "
                         f"{attn_impl!r}")
    return _o_proj(p, out.reshape(B, 1, n_heads * head_dim), tp), kv


def spec_verify_chunk_attention(p, x, kv: KVEntry, block_table, pos, *,
                                wpage, woff, scrub=None, cow_src=None,
                                cow_dst=None, n_heads, n_kv_heads, head_dim,
                                rope_theta, attn_impl: str = "xla", tp=None):
    """Speculative-verify attention for a chunk of K candidate tokens.
    x: (B,K,D) hidden states at absolute positions ``pos[b] .. pos[b]+K-1``;
    the committed pool context ends at ``pos``.

    The K-token form of ``paged_decode_attention``'s write-then-attend: the
    whole chunk's K/V is written IN PLACE into pool entries ``(wpage,
    woff)`` (both (B,K); ``wpage == P``, the trash page, drops the write),
    after the optional ``scrub`` of a freshly mapped first page. Attention
    then reads everything back from the pool with per-query validity ``idx
    <= pos + j``, so each query sees the keys a sequential decode step
    would see at its position. Chunk entries beyond the accepted prefix
    stay above the fill line, invisible to later reads and rewritten by
    the next chunk. scrub / cow_src / cow_dst: as in
    ``paged_decode_attention``, one page per row — only the chunk's first
    page can pre-exist (a mid-page fill line or a shared prefix page); an
    int8 pool is written per token, so the stored bytes are bitwise what K
    sequential writes store. attn_impl: "paged" runs the spec-verify CUDA
    kernel (its plain f32 version on CPU tensors); "xla" gathers the row's
    pages and runs ``_sdpa`` with the additive mask in the model dtype.
    """
    B, K, _ = x.shape
    positions = pos[:, None] + torch.arange(K, device=x.device)[None, :]
    q, k_new, v_new = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k_new = apply_rope(k_new, positions, rope_theta)
    _cow_scrub_write(kv, k_new, v_new, wpage=wpage, woff=woff, scrub=scrub,
                     cow_src=cow_src, cow_dst=cow_dst)
    if attn_impl == "paged":
        from repro_torch.kernels.spec_verify import ops as sv_ops
        out = sv_ops.spec_verify_attention(q.contiguous(), kv.k, kv.v,
                                           block_table, pos,
                                           k_scales=kv.k_scale,
                                           v_scales=kv.v_scale)
    elif attn_impl == "xla":
        k, v, mapped = _gather_pool(kv, block_table, q.dtype)
        s_idx = torch.arange(mapped.shape[1], device=x.device)[None, None, :]
        valid = (s_idx <= positions[:, :, None]) & mapped[:, None, :]
        mask = torch.where(valid, 0.0, NEG_INF).float()[:, None]
        out = _sdpa(q, k, v, mask)
    else:
        raise ValueError(f"attn_impl must be 'paged' or 'xla', got "
                         f"{attn_impl!r}")
    return _o_proj(p, out.reshape(B, K, n_heads * head_dim), tp), kv


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_defs(d_model, d_ff, *, layers=None):
    L = (layers,) if layers else ()
    ax = ("layers",) if layers else ()
    return {
        "w_gate": pdef(L + (d_model, d_ff), ax + ("embed", "mlp"), "scaled"),
        "w_up": pdef(L + (d_model, d_ff), ax + ("embed", "mlp"), "scaled"),
        "w_down": pdef(L + (d_ff, d_model), ax + ("mlp", "embed"), "scaled"),
    }


def mlp(p, x, tp=None):
    """SwiGLU; under ``tp`` the rank's ``d_ff`` slice, all-reduced after
    ``w_down`` when it is split."""
    gate = x @ p["w_gate"]
    up = x @ p["w_up"]
    act = F.silu(gate.float()).to(x.dtype) * up
    if tp is None:
        return act @ p["w_down"]
    return tp.row_parallel(act, p["w_down"], tp.mlp_split)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embedding_defs(vocab, d_model):
    return pdef((vocab, d_model), ("vocab", "embed"), init="normal")


def embed(emb, tokens, tp=None):
    """Rows of ``emb`` (V, D) for ``tokens``; under ``tp`` ``emb`` is the
    rank's vocab shard and the lookup is vocab-parallel
    (``TPContext.embed``)."""
    if tp is not None:
        return tp.embed(emb, tokens)
    return emb[tokens]


def unembed(emb_or_head, x, tied: Optional[bool] = None):
    """x: (B,S,D) -> logits (B,S,V). Takes the (V,D) table (``tied``) or
    a (D,V) head. ``tied=None`` tells them apart by shape, as the JAX
    package does; a vocab shard can be square or narrower than D (the
    smoke config at tp=4: (128, 128)), so the tensor-parallel path says
    which it passes. Under tp the logits are the rank's vocab columns."""
    if tied is None:
        tied = emb_or_head.shape[0] >= emb_or_head.shape[1]
    return x @ emb_or_head.T if tied else x @ emb_or_head
