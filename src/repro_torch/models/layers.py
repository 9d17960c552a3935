"""Transformer layers: RMSNorm, RoPE, GQA attention, SwiGLU MLP (port of
the dense-model parts of ``repro/models/layers.py``: full-sequence
self-attention, the dense ring-buffer prefill and decode, paged decode
and the speculative verify chunk).

Functions take the same layouts as the JAX ones: activations
``(B, S, D)``, per-head tensors ``(B, S, H, hd)``, params a dict of
tensors for one layer. Normalisation, RoPE and softmax run in f32;
matmuls run in the model dtype.

Paged KV pools carry ONE trash page past the end: a layer's pool is
``(P + 1, ps, KV, hd)`` with ``P`` real pages, and the drop sentinel
``wpage == P`` names the trash page (JAX drops such writes with
``mode="drop"``; on CUDA an out-of-range index is a device assert). Block
tables only ever name pages ``< P``, so the trash page is never read as
context.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

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


def self_attention(p, x, *, n_heads, n_kv_heads, head_dim, rope_theta,
                   positions=None, window: int = 0, attn_impl: str = "xla"):
    """Full-sequence causal self-attention (training and the reference
    pass). x: (B,S,D) -> (B,S,D).

    attn_impl: "xla" runs the plain ``_sdpa`` with ``causal_mask``;
    "flash" runs the flash-attention kernels (``kernels/flash_attention``,
    forward and backward; their plain versions for CPU tensors) — the
    port's name for what the JAX package calls "pallas" here. The JAX
    ``cross_kv`` (encoder-decoder) branch is not ported.
    """
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    if attn_impl == "flash":
        from repro_torch.kernels.flash_attention import ops as fa_ops
        out = fa_ops.flash_attention(q, k, v, causal=True, window=window)
    elif attn_impl == "xla":
        out = _sdpa(q, k, v, causal_mask(S, S, window=window,
                                         device=x.device))
    else:
        raise ValueError(f"attn_impl must be 'flash' or 'xla', got "
                         f"{attn_impl!r}")
    return out.reshape(B, S, n_heads * head_dim) @ p["wo"]


class KVEntry(NamedTuple):
    k: torch.Tensor   # dense (B, s_max, KV, hd) or paged (P+1, ps, KV, hd)
                      # per layer, or stacked over layers
    v: torch.Tensor


def init_kv(batch, s_max, n_kv_heads, head_dim, dtype=torch.bfloat16,
            device=None):
    shape = (batch, s_max, n_kv_heads, head_dim)
    return KVEntry(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def prefill_attention(p, x, kv: KVEntry, *, n_heads, n_kv_heads, head_dim,
                      rope_theta, window: int = 0, attn_impl: str = "xla"):
    """Causal attention over the prompt x (B,S,D); writes its K/V into
    cache slots ``[0, S)`` of ``kv`` (B, s_max, KV, hd) IN PLACE.
    attn_impl: "xla" (``_sdpa``) or "flash" (the flash forward kernel)."""
    B, S, _ = x.shape
    if S > kv.k.shape[1]:
        raise ValueError(f"prompt of {S} tokens does not fit a cache of "
                         f"{kv.k.shape[1]} slots")
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    kv.k[:, :S] = k.to(kv.k.dtype)
    kv.v[:, :S] = v.to(kv.v.dtype)
    if attn_impl == "flash":
        from repro_torch.kernels.flash_attention import ops as fa_ops
        out = fa_ops.flash_attention(q, k, v, causal=True, window=window)
    elif attn_impl == "xla":
        out = _sdpa(q, k, v, causal_mask(S, S, window=window,
                                         device=x.device))
    else:
        raise ValueError(f"attn_impl must be 'flash' or 'xla', got "
                         f"{attn_impl!r}")
    return out.reshape(B, S, n_heads * head_dim) @ p["wo"], kv


def decode_attention(p, x, kv: KVEntry, pos, *, n_heads, n_kv_heads,
                     head_dim, rope_theta, window: int = 0,
                     attn_impl: str = "xla", advance=None):
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
    out = out.reshape(B, 1, n_heads * head_dim)
    return out @ p["wo"], kv


def _gather_pool(kv: KVEntry, block_table, dtype):
    """Each row's pages gathered into dense ``(B, NP*ps, KV, hd)`` K/V in
    ``dtype`` (unmapped entries read a clamped page), and the ``(B,
    NP*ps)`` mask of positions on mapped pages."""
    P = kv.k.shape[0] - 1                       # the trash page excluded
    ps, n_kv_heads, head_dim = kv.k.shape[1:]
    B, NP = block_table.shape
    bt_c = block_table.clamp(0, P - 1).long()
    k = kv.k[bt_c].reshape(B, NP * ps, n_kv_heads, head_dim).to(dtype)
    v = kv.v[bt_c].reshape(B, NP * ps, n_kv_heads, head_dim).to(dtype)
    mapped = (block_table >= 0)[:, :, None].expand(B, NP, ps).reshape(
        B, NP * ps)
    return k, v, mapped


def paged_decode_attention(p, x, kv: KVEntry, block_table, pos, *, wpage,
                           woff, scrub=None, cow_src=None, cow_dst=None,
                           n_heads, n_kv_heads, head_dim, rope_theta,
                           attn_impl: str = "xla"):
    """One-token decode against a paged KV pool. x: (B,1,D).

    kv.k/v: (P+1, ps, KV, hd) — this layer's pool, trash page at index P.
    block_table: (B, NP) int32 (-1 = unmapped); pos: (B,) absolute
    positions. wpage/woff: per-row write page and in-page offset from the
    caller's allocator; ``wpage == P`` drops the write (into the trash
    page). scrub: optional (B,) pages to zero before the write (sentinel P
    = none). Write-then-attend: the new token's K/V lands in the pool
    first, then the row attends over positions ``< pos + 1``.

    The pools are updated IN PLACE (the returned KVEntry holds the same
    tensors). attn_impl: "xla" gathers the row's pages into a dense view
    and runs ``_sdpa`` in the model dtype; "paged" runs the CUDA kernel
    (its plain f32 version on CPU tensors).

    cow_src/cow_dst (copy-on-write for prefix sharing) are not ported yet
    and raise.
    """
    if cow_src is not None or cow_dst is not None:
        raise NotImplementedError(
            "copy-on-write page copies arrive with prefix sharing "
            "(ROADMAP Queue 1 item 8)")
    B, S1, _ = x.shape
    if S1 != 1:
        raise ValueError(f"decode takes one token per row, got {S1}")
    positions = pos[:, None]
    q, k_new, v_new = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k_new = apply_rope(k_new, positions, rope_theta)
    if scrub is not None:
        idx = scrub.long()
        kv.k.index_fill_(0, idx, 0)
        kv.v.index_fill_(0, idx, 0)
    wp, wo = wpage.long(), woff.long()
    kv.k.index_put_((wp, wo), k_new[:, 0].to(kv.k.dtype))
    kv.v.index_put_((wp, wo), v_new[:, 0].to(kv.v.dtype))
    lens = (pos + 1).to(torch.int32)       # current token included
    if attn_impl == "paged":
        from repro_torch.kernels.paged_attention import ops as pa_ops
        out = pa_ops.paged_decode_attention(
            q[:, 0].contiguous(), kv.k, kv.v, block_table, lens)[:, None]
    elif attn_impl == "xla":
        k, v, mapped = _gather_pool(kv, block_table, q.dtype)
        s_idx = torch.arange(mapped.shape[1], device=x.device)[None, :]
        valid = (s_idx < lens[:, None]) & mapped
        mask = torch.where(valid, 0.0, NEG_INF).float()[:, None, None, :]
        out = _sdpa(q, k, v, mask)
    else:
        raise ValueError(f"attn_impl must be 'paged' or 'xla', got "
                         f"{attn_impl!r}")
    out = out.reshape(B, 1, n_heads * head_dim)
    return out @ p["wo"], kv


def spec_verify_chunk_attention(p, x, kv: KVEntry, block_table, pos, *,
                                wpage, woff, scrub=None, cow_src=None,
                                cow_dst=None, n_heads, n_kv_heads, head_dim,
                                rope_theta, attn_impl: str = "xla"):
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
    the next chunk. attn_impl: "paged" runs the spec-verify CUDA kernel
    (its plain f32 version on CPU tensors); "xla" gathers the row's pages
    and runs ``_sdpa`` with the additive mask in the model dtype.

    cow_src/cow_dst (copy-on-write for prefix sharing) are not ported yet
    and raise.
    """
    if cow_src is not None or cow_dst is not None:
        raise NotImplementedError(
            "copy-on-write page copies arrive with prefix sharing "
            "(ROADMAP Queue 1 item 8)")
    B, K, _ = x.shape
    positions = pos[:, None] + torch.arange(K, device=x.device)[None, :]
    q, k_new, v_new = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k_new = apply_rope(k_new, positions, rope_theta)
    if scrub is not None:
        idx = scrub.long()
        kv.k.index_fill_(0, idx, 0)
        kv.v.index_fill_(0, idx, 0)
    wp, wo = wpage.long(), woff.long()
    kv.k.index_put_((wp, wo), k_new.to(kv.k.dtype))
    kv.v.index_put_((wp, wo), v_new.to(kv.v.dtype))
    if attn_impl == "paged":
        from repro_torch.kernels.spec_verify import ops as sv_ops
        out = sv_ops.spec_verify_attention(q.contiguous(), kv.k, kv.v,
                                           block_table, pos)
    elif attn_impl == "xla":
        k, v, mapped = _gather_pool(kv, block_table, q.dtype)
        s_idx = torch.arange(mapped.shape[1], device=x.device)[None, None, :]
        valid = (s_idx <= positions[:, :, None]) & mapped[:, None, :]
        mask = torch.where(valid, 0.0, NEG_INF).float()[:, None]
        out = _sdpa(q, k, v, mask)
    else:
        raise ValueError(f"attn_impl must be 'paged' or 'xla', got "
                         f"{attn_impl!r}")
    out = out.reshape(B, K, n_heads * head_dim)
    return out @ p["wo"], kv


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


def mlp(p, x):
    gate = x @ p["w_gate"]
    up = x @ p["w_up"]
    act = F.silu(gate.float()).to(x.dtype) * up
    return act @ p["w_down"]


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embedding_defs(vocab, d_model):
    return pdef((vocab, d_model), ("vocab", "embed"), init="normal")


def embed(emb, tokens):
    return emb[tokens]


def unembed(emb_or_head, x):
    """x: (B,S,D) -> logits (B,S,V). Takes the (V,D) table (tied) or a
    (D,V) head, told apart by shape as in the JAX package."""
    if emb_or_head.shape[0] < emb_or_head.shape[1]:
        return x @ emb_or_head
    return x @ emb_or_head.T
