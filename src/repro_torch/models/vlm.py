"""Llama-3.2-Vision-style VLM backbone (port of ``repro/models/vlm.py``).
[hf:meta-llama/Llama-3.2-11B-Vision]

As in the JAX package, the ViT vision encoder and projector are stubbed:
``extra["image_embeds"]`` carries projected patch embeddings (B,
n_image_tokens, d_model). The backbone is the language decoder in JAX's
layer order (not HF's indices): ``n_cross`` groups, each of ``k = n_self
/ n_cross`` self-attention layers followed by one gated cross-attention
layer over the image tokens; ``cross_attn_layers`` only counts the sites.
The gates start at zero (``tanh(0) = 0``), so at init the image path adds
nothing to the logits.

The self-attention layers take ``attn_impl`` ("flash" in ``forward`` and
``prefill``, "pallas" — the split-K decode kernel — in ``decode_step``);
the cross-attention is always the plain ``layers._sdpa``, as in JAX. The
self-attention KV cache is stacked over the ``n_self`` layers (group
``gi`` owns rows ``[gi*k, (gi+1)*k)``) and the image K/V over the
``n_cross`` layers; both are written IN PLACE, and ``pos`` is returned as
a new tensor.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.param import pdef
from repro_torch.models.transformer import layer_params, scan_body_over


def n_cross_layers(cfg: ModelConfig) -> int:
    return len(cfg.cross_attn_layers)


def n_self_layers(cfg: ModelConfig) -> int:
    return cfg.n_layers - n_cross_layers(cfg)


def _block_defs(cfg: ModelConfig, n: int, gated: bool):
    defs = {"ln1": pdef((n, cfg.d_model), ("layers", "embed"), "ones"),
            "ln2": pdef((n, cfg.d_model), ("layers", "embed"), "ones")}
    for k, d in L.attention_defs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.head_dim_, layers=n).items():
        defs[f"attn.{k}"] = d
    for k, d in L.mlp_defs(cfg.d_model, cfg.d_ff, layers=n).items():
        defs[f"mlp.{k}"] = d
    if gated:
        defs["gate_attn"] = pdef((n,), ("layers",), "zeros")
        defs["gate_mlp"] = pdef((n,), ("layers",), "zeros")
    return defs


def model_defs(cfg: ModelConfig):
    """Flat ParamDef dict with the JAX tree's dotted paths."""
    defs = {"embedding": L.embedding_defs(cfg.vocab_size, cfg.d_model),
            "ln_f": pdef((cfg.d_model,), ("embed",), "ones"),
            "lm_head": pdef((cfg.d_model, cfg.vocab_size),
                            ("embed", "vocab"), "scaled")}
    for k, d in _block_defs(cfg, n_self_layers(cfg), False).items():
        defs[f"layers.{k}"] = d
    for k, d in _block_defs(cfg, n_cross_layers(cfg), True).items():
        defs[f"cross_layers.{k}"] = d
    return defs


def _groups(cfg: ModelConfig):
    """``(n_cross, k)``: n_cross groups, each k self layers then one cross
    layer."""
    nx, ns = n_cross_layers(cfg), n_self_layers(cfg)
    if ns % nx:
        raise ValueError(f"{ns} self layers do not split evenly across "
                         f"{nx} cross sites")
    return nx, ns // nx


def _image_kv(p, img, n_kv_heads, head_dim):
    B, T, _ = img.shape
    k = (img @ p["wk"]).reshape(B, T, n_kv_heads, head_dim)
    v = (img @ p["wv"]).reshape(B, T, n_kv_heads, head_dim)
    return k, v


def _akw(cfg: ModelConfig):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta)


def _self_block(cfg: ModelConfig, p, x, *, attn_impl: str = "xla"):
    h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
    x = x + L.self_attention(p["attn"], h, window=cfg.sliding_window,
                             attn_impl=attn_impl, **_akw(cfg))
    h = L.rms_norm(x, p["ln2"], cfg.rms_eps)
    return x + L.mlp(p["mlp"], h)


def _cross_block(cfg: ModelConfig, p, x, img_kv):
    """Gated cross-attention block: tanh-gated residuals (init 0)."""
    h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
    h = L.self_attention(p["attn"], h, cross_kv=img_kv, **_akw(cfg))
    x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * h
    h = L.rms_norm(x, p["ln2"], cfg.rms_eps)
    return x + torch.tanh(p["gate_mlp"]).to(x.dtype) * L.mlp(p["mlp"], h)


def _image(params, extra):
    return extra["image_embeds"].to(params["ln_f"].dtype)


def _logits(cfg: ModelConfig, params, x):
    x = L.rms_norm(x, params["ln_f"], cfg.rms_eps)
    return L.unembed(params["lm_head"], x)


def forward(cfg: ModelConfig, params, tokens, *, extra=None,
            attn_impl: str = "xla"):
    """tokens: (B, S); ``extra["image_embeds"]``: (B, T_img, D) -> logits
    (B, S, V). attn_impl: "xla" or "flash" (the self layers). With
    ``cfg.remat == "full"`` and grad enabled, each self layer keeps only
    its input for the backward (the cross layers are not checkpointed, as
    in JAX)."""
    img = _image(params, extra)
    x = L.embed(params["embedding"], tokens)
    nx, k = _groups(cfg)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    for gi in range(nx):
        for i in range(gi * k, (gi + 1) * k):
            lp = layer_params(params, i)
            if remat:
                x = checkpoint(_self_block, cfg, lp, x, attn_impl=attn_impl,
                               use_reentrant=False)
            else:
                x = _self_block(cfg, lp, x, attn_impl=attn_impl)
        cp = layer_params(params, gi, "cross_layers")
        x = _cross_block(cfg, cp, x, _image_kv(cp["attn"], img,
                                               cfg.n_kv_heads, cfg.head_dim_))
    return _logits(cfg, params, x)


class VLMCache(NamedTuple):
    """``self_kv``: ``(n_self, B, s_max, KV, hd)`` rings
    (``layers.decode_attention``); ``img_kv``: ``(n_cross, B, T_img, KV,
    hd)``, fixed after prefill."""
    self_kv: L.KVEntry
    img_kv: L.KVEntry
    pos: torch.Tensor           # (B,) int32 per-row cache fill


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               dtype=torch.bfloat16, *, device=None):
    """Zeroed caches: a self-attention ring of ``s_max`` slots
    (``min(s_max, window)`` with a sliding window) per self layer and the
    image K/V per cross layer."""
    if cfg.sliding_window > 0:
        s_max = min(s_max, cfg.sliding_window)
    shape = (n_self_layers(cfg), batch, s_max, cfg.n_kv_heads,
             cfg.head_dim_)
    ishape = (n_cross_layers(cfg), batch, cfg.n_image_tokens,
              cfg.n_kv_heads, cfg.head_dim_)
    z = lambda s: torch.zeros(s, dtype=dtype, device=device)
    return VLMCache(self_kv=L.KVEntry(z(shape), z(shape)),
                    img_kv=L.KVEntry(z(ishape), z(ishape)),
                    pos=torch.zeros((batch,), dtype=torch.int32,
                                    device=device))


def prefill(cfg: ModelConfig, params, tokens, cache: VLMCache, *,
            extra=None, attn_impl: str = "xla"):
    """Run the prompt (B, S) into the caches (written in place: each self
    layer's K/V, each cross layer's image K/V cast to the cache's dtype)
    and return ``(logits of the last position (B, V), cache)``. The
    prompt's own cross blocks read the UNCAST image K/V, as JAX's do.
    attn_impl: "xla" or "flash"."""
    img = _image(params, extra)
    x = L.embed(params["embedding"], tokens)
    nx, k = _groups(cfg)
    for gi in range(nx):
        for i in range(gi * k, (gi + 1) * k):
            lp = layer_params(params, i)
            h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
            x = x + L.prefill_attention(
                lp["attn"], h, cache.self_kv.layer(i),
                window=cfg.sliding_window, attn_impl=attn_impl,
                **_akw(cfg))[0]
            h = L.rms_norm(x, lp["ln2"], cfg.rms_eps)
            x = x + L.mlp(lp["mlp"], h)
        cp = layer_params(params, gi, "cross_layers")
        ik, iv = _image_kv(cp["attn"], img, cfg.n_kv_heads, cfg.head_dim_)
        cache.img_kv.k[gi].copy_(ik)
        cache.img_kv.v[gi].copy_(iv)
        x = _cross_block(cfg, cp, x, (ik, iv))
    B, S = tokens.shape
    return _logits(cfg, params, x[:, -1:])[:, 0], cache._replace(
        pos=torch.full((B,), S, dtype=torch.int32, device=tokens.device))


def decode_step(cfg: ModelConfig, params, token, cache: VLMCache, *,
                extra=None, attn_impl: str = "xla", advance=None,
                layers=None):
    """One decode step. token: (B,) int. Rows with ``advance=False`` write
    nothing and keep their position. The cross blocks read the cached
    image K/V cast to the activations' dtype. attn_impl: "xla" or
    "pallas" (the split-K decode kernel). ``layers``: ``(self views,
    cross views)`` when the caller has already sliced them."""
    del extra
    B = token.shape[0]
    adv = (torch.ones((B,), dtype=torch.bool, device=token.device)
           if advance is None else advance)
    nx, k = _groups(cfg)
    if layers is None:
        layers = _layer_views(cfg, params)
    selfs, crosses = layers
    x = L.embed(params["embedding"], token[:, None])         # (B,1,D)
    for gi in range(nx):
        for i in range(gi * k, (gi + 1) * k):
            lp = selfs[i]
            h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
            x = x + L.decode_attention(
                lp["attn"], h, cache.self_kv.layer(i), cache.pos,
                window=cfg.sliding_window, attn_impl=attn_impl,
                advance=adv, **_akw(cfg))[0]
            h = L.rms_norm(x, lp["ln2"], cfg.rms_eps)
            x = x + L.mlp(lp["mlp"], h)
        x = _cross_block(cfg, crosses[gi], x,
                         (cache.img_kv.k[gi].to(x.dtype),
                          cache.img_kv.v[gi].to(x.dtype)))
    return _logits(cfg, params, x)[:, 0], cache._replace(
        pos=cache.pos + adv.to(torch.int32))


def _layer_views(cfg: ModelConfig, params):
    return ([layer_params(params, i) for i in range(n_self_layers(cfg))],
            [layer_params(params, i, "cross_layers")
             for i in range(n_cross_layers(cfg))])


def decode_scan_body(cfg: ModelConfig, params, *, attn_impl: str = "xla"):
    """Decode body for in-loop generation: ``decode_step`` wrapped by
    ``transformer.scan_body_over``, as JAX's ``Model`` wraps families
    without a native body (per-layer param views sliced once here)."""
    layers = _layer_views(cfg, params)
    return scan_body_over(
        lambda token, advance, cache: decode_step(
            cfg, params, token, cache, attn_impl=attn_impl, advance=advance,
            layers=layers))
