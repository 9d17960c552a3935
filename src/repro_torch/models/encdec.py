"""Whisper-style encoder-decoder audio backbone (port of
``repro/models/encdec.py``). [arXiv:2212.04356]

As in the JAX package, the mel-spectrogram and conv feature extractor are
stubbed: ``extra["frames"]`` carries precomputed frame embeddings (B,
n_audio_frames, d_model). The backbone is the encoder stack
(bidirectional, RoPE, plain attention) and the decoder stack (causal
self-attention, then cross-attention over the encoder output, per layer),
with JAX's adaptations: RoPE for positions and SwiGLU MLPs.

The encoder's attention and the cross-attention are plain tensor products
(``layers._sdpa``), as the JAX package computes them outside any Pallas
kernel; only the decoder's self-attention takes ``attn_impl``: "flash"
(the flash-attention kernels) in ``forward`` and ``prefill``, "pallas"
(the split-K decode kernel) in ``decode_step``. ``prefill`` and
``decode_step`` write the KV caches IN PLACE and return ``pos`` as a new
tensor.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.param import pdef
from repro_torch.models.transformer import layer_params, scan_body_over


def encoder_block_defs(cfg: ModelConfig):
    n = cfg.n_encoder_layers
    defs = {"ln1": pdef((n, cfg.d_model), ("layers", "embed"), "ones"),
            "ln2": pdef((n, cfg.d_model), ("layers", "embed"), "ones")}
    for k, d in L.attention_defs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.head_dim_, layers=n).items():
        defs[f"attn.{k}"] = d
    for k, d in L.mlp_defs(cfg.d_model, cfg.d_ff, layers=n).items():
        defs[f"mlp.{k}"] = d
    return defs


def decoder_block_defs(cfg: ModelConfig):
    n = cfg.n_layers
    defs = {name: pdef((n, cfg.d_model), ("layers", "embed"), "ones")
            for name in ("ln1", "ln_x", "ln2")}
    for block in ("self_attn", "cross_attn"):
        for k, d in L.attention_defs(cfg.d_model, cfg.n_heads,
                                     cfg.n_kv_heads, cfg.head_dim_,
                                     layers=n).items():
            defs[f"{block}.{k}"] = d
    for k, d in L.mlp_defs(cfg.d_model, cfg.d_ff, layers=n).items():
        defs[f"mlp.{k}"] = d
    return defs


def model_defs(cfg: ModelConfig):
    """Flat ParamDef dict with the JAX tree's dotted paths."""
    defs = {"embedding": L.embedding_defs(cfg.vocab_size, cfg.d_model),
            "enc_ln_f": pdef((cfg.d_model,), ("embed",), "ones"),
            "ln_f": pdef((cfg.d_model,), ("embed",), "ones"),
            "lm_head": pdef((cfg.d_model, cfg.vocab_size),
                            ("embed", "vocab"), "scaled")}
    for k, d in encoder_block_defs(cfg).items():
        defs[f"encoder.{k}"] = d
    for k, d in decoder_block_defs(cfg).items():
        defs[f"decoder.{k}"] = d
    return defs


def _cross_kv(p, enc_out, n_kv_heads, head_dim):
    B, F, _ = enc_out.shape
    k = (enc_out @ p["wk"]).reshape(B, F, n_kv_heads, head_dim)
    v = (enc_out @ p["wv"]).reshape(B, F, n_kv_heads, head_dim)
    return k, v


def _encoder_block(cfg: ModelConfig, p, x):
    """Bidirectional self-attention (RoPE on q and k at ``arange(F)``, a
    zero mask, plain ``_sdpa``) and the MLP."""
    h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
    B, S, _ = h.shape
    q, k, v = L._project_qkv(p["attn"], h, cfg.n_heads, cfg.n_kv_heads,
                             cfg.head_dim_)
    pos = torch.arange(S, device=x.device)[None, :]
    q = L.apply_rope(q, pos, cfg.rope_theta)
    k = L.apply_rope(k, pos, cfg.rope_theta)
    mask = torch.zeros((1, 1, S, S), dtype=torch.float32, device=x.device)
    out = L._sdpa(q, k, v, mask).reshape(B, S, -1)
    x = x + out @ p["attn"]["wo"]
    h = L.rms_norm(x, p["ln2"], cfg.rms_eps)
    return x + L.mlp(p["mlp"], h)


def _remat(cfg: ModelConfig) -> bool:
    return cfg.remat == "full" and torch.is_grad_enabled()


def encode(cfg: ModelConfig, params, frames, *, attn_impl: str = "xla"):
    """frames: (B, F, D) stubbed conv-frontend embeddings -> (B, F, D).
    ``attn_impl`` is accepted and ignored, as in JAX: the encoder's
    attention is always plain. With ``cfg.remat == "full"`` and grad
    enabled, each block keeps only its input for the backward."""
    del attn_impl
    x = frames.to(params["enc_ln_f"].dtype)
    for i in range(cfg.n_encoder_layers):
        lp = layer_params(params, i, "encoder")
        if _remat(cfg):
            x = checkpoint(_encoder_block, cfg, lp, x, use_reentrant=False)
        else:
            x = _encoder_block(cfg, lp, x)
    return L.rms_norm(x, params["enc_ln_f"], cfg.rms_eps)


def _akw(cfg: ModelConfig):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta)


def _cross_attend(cfg: ModelConfig, p, x, ck, cv):
    """The cross-attention half of a decoder block: ``ln_x``, attention
    over the encoder's K/V, the residual."""
    h = L.rms_norm(x, p["ln_x"], cfg.rms_eps)
    return x + L.self_attention(p["cross_attn"], h, cross_kv=(ck, cv),
                                **_akw(cfg))


def _decoder_block(cfg: ModelConfig, p, x, enc_out, *,
                   attn_impl: str = "xla"):
    h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
    x = x + L.self_attention(p["self_attn"], h, window=cfg.sliding_window,
                             attn_impl=attn_impl, **_akw(cfg))
    ck, cv = _cross_kv(p["cross_attn"], enc_out, cfg.n_kv_heads,
                       cfg.head_dim_)
    x = _cross_attend(cfg, p, x, ck, cv)
    h = L.rms_norm(x, p["ln2"], cfg.rms_eps)
    return x + L.mlp(p["mlp"], h)


def _logits(cfg: ModelConfig, params, x):
    x = L.rms_norm(x, params["ln_f"], cfg.rms_eps)
    return L.unembed(params["lm_head"], x)


def forward(cfg: ModelConfig, params, tokens, *, extra=None,
            attn_impl: str = "xla"):
    """tokens: (B, S) decoder tokens; ``extra["frames"]``: (B, F, D) ->
    logits (B, S, V). attn_impl: "xla" or "flash" (the decoder's
    self-attention)."""
    enc_out = encode(cfg, params, extra["frames"], attn_impl=attn_impl)
    x = L.embed(params["embedding"], tokens)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i, "decoder")
        if _remat(cfg):
            x = checkpoint(_decoder_block, cfg, lp, x, enc_out,
                           attn_impl=attn_impl, use_reentrant=False)
        else:
            x = _decoder_block(cfg, lp, x, enc_out, attn_impl=attn_impl)
    return _logits(cfg, params, x)


class EncDecCache(NamedTuple):
    """``self_kv``: ``(L, B, s_max, KV, hd)`` decoder rings
    (``layers.decode_attention``); ``cross_kv``: ``(L, B, F, KV, hd)``,
    fixed after prefill."""
    self_kv: L.KVEntry
    cross_kv: L.KVEntry
    pos: torch.Tensor           # (B,) int32 per-row cache fill


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               dtype=torch.bfloat16, *, device=None):
    """Zeroed caches: a self-attention ring of ``s_max`` slots
    (``min(s_max, window)`` with a sliding window) and the cross K/V."""
    if cfg.sliding_window > 0:
        s_max = min(s_max, cfg.sliding_window)
    shape = (cfg.n_layers, batch, s_max, cfg.n_kv_heads, cfg.head_dim_)
    xshape = (cfg.n_layers, batch, cfg.n_audio_frames, cfg.n_kv_heads,
              cfg.head_dim_)
    z = lambda s: torch.zeros(s, dtype=dtype, device=device)
    return EncDecCache(self_kv=L.KVEntry(z(shape), z(shape)),
                       cross_kv=L.KVEntry(z(xshape), z(xshape)),
                       pos=torch.zeros((batch,), dtype=torch.int32,
                                       device=device))


def prefill(cfg: ModelConfig, params, tokens, cache: EncDecCache, *,
            extra=None, attn_impl: str = "xla"):
    """Encode the frames, run the prompt (B, S) into the caches (written
    in place: the decoder's K/V and each layer's cross K/V, cast to the
    cache's dtype) and return ``(logits of the last position (B, V),
    cache)``. The prompt's own cross-attention reads the UNCAST cross K/V,
    as JAX's does. attn_impl: "xla" or "flash"."""
    enc_out = encode(cfg, params, extra["frames"], attn_impl=attn_impl)
    x = L.embed(params["embedding"], tokens)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i, "decoder")
        h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
        x = x + L.prefill_attention(
            lp["self_attn"], h, cache.self_kv.layer(i),
            window=cfg.sliding_window, attn_impl=attn_impl,
            **_akw(cfg))[0]
        ck, cv = _cross_kv(lp["cross_attn"], enc_out, cfg.n_kv_heads,
                           cfg.head_dim_)
        cache.cross_kv.k[i].copy_(ck)
        cache.cross_kv.v[i].copy_(cv)
        x = _cross_attend(cfg, lp, x, ck, cv)
        h = L.rms_norm(x, lp["ln2"], cfg.rms_eps)
        x = x + L.mlp(lp["mlp"], h)
    B, S = tokens.shape
    return _logits(cfg, params, x[:, -1:])[:, 0], cache._replace(
        pos=torch.full((B,), S, dtype=torch.int32, device=tokens.device))


def decode_step(cfg: ModelConfig, params, token, cache: EncDecCache, *,
                extra=None, attn_impl: str = "xla", advance=None,
                layers=None):
    """One decode step. token: (B,) int. Rows with ``advance=False`` write
    nothing and keep their position. The cross-attention reads the cached
    K/V cast to the activations' dtype. attn_impl: "xla" or "pallas" (the
    split-K decode kernel). ``layers``: the per-layer param views, when
    the caller has already sliced them."""
    del extra
    B = token.shape[0]
    adv = (torch.ones((B,), dtype=torch.bool, device=token.device)
           if advance is None else advance)
    if layers is None:
        layers = [layer_params(params, i, "decoder")
                  for i in range(cfg.n_layers)]
    x = L.embed(params["embedding"], token[:, None])         # (B,1,D)
    for i, lp in enumerate(layers):
        h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
        x = x + L.decode_attention(
            lp["self_attn"], h, cache.self_kv.layer(i), cache.pos,
            window=cfg.sliding_window, attn_impl=attn_impl, advance=adv,
            **_akw(cfg))[0]
        x = _cross_attend(cfg, lp, x, cache.cross_kv.k[i].to(x.dtype),
                          cache.cross_kv.v[i].to(x.dtype))
        h = L.rms_norm(x, lp["ln2"], cfg.rms_eps)
        x = x + L.mlp(lp["mlp"], h)
    return _logits(cfg, params, x)[:, 0], cache._replace(
        pos=cache.pos + adv.to(torch.int32))


def decode_scan_body(cfg: ModelConfig, params, *, attn_impl: str = "xla"):
    """Decode body for in-loop generation: ``decode_step`` wrapped by
    ``transformer.scan_body_over``, as JAX's ``Model`` wraps families
    without a native body (per-layer param views sliced once here)."""
    layers = [layer_params(params, i, "decoder")
              for i in range(cfg.n_layers)]
    return scan_body_over(
        lambda token, advance, cache: decode_step(
            cfg, params, token, cache, attn_impl=attn_impl, advance=advance,
            layers=layers))
