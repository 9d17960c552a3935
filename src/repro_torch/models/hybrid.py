"""Zamba2-style hybrid: a Mamba2 backbone plus ONE shared attention block
applied after every ``cfg.attn_every`` SSM layers (port of
``repro/models/hybrid.py``). [arXiv:2411.15242]

The attention block's weights are shared across all application sites
(the Zamba trick), but each site keeps its own KV cache during decode.
Decode costs O(sites * context) attention reads plus O(1) SSM state
updates.

As in JAX, ``attn_impl`` reaches the shared-attention sites only: the
Mamba layers run the plain chunked form (``forward`` passes the mixer no
``attn_impl``, and ``prefill`` passes an ``initial_state``, which the SSD
scan kernel does not take), so no pass of this family launches the SSD
scan. ``prefill`` and ``decode_step`` write the cache tensors IN PLACE
(in the cache's dtype); positions are returned as new tensors.

Tensor parallelism (``tp=``, a ``models.tensor_parallel.TPContext``):
``init_cache``, ``prefill``, ``decode_step`` and ``decode_scan_body`` run
the Mamba layers on the rank's SSM heads (``models/mamba.py``) and the
shared block as the dense family's tp attention and MLP, with each site's
KV ring at the rank's kv heads.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models.param import pdef
from repro_torch.models.tensor_parallel import heads as _heads
from repro_torch.models.transformer import (_chunk_logits, layer_params,
                                            scan_body_over)


def _group_bounds(cfg: ModelConfig):
    """[(l0, l1, has_attn_after)] covering all n_layers."""
    k = cfg.attn_every
    bounds = []
    l0 = 0
    while l0 < cfg.n_layers:
        l1 = min(l0 + k, cfg.n_layers)
        bounds.append((l0, l1, l1 - l0 == k))
        l0 = l1
    return bounds


def n_attn_sites(cfg: ModelConfig) -> int:
    return sum(1 for _, _, a in _group_bounds(cfg) if a)


def shared_attn_defs(cfg: ModelConfig):
    defs = {"ln1": pdef((cfg.d_model,), ("embed",), "ones"),
            "ln2": pdef((cfg.d_model,), ("embed",), "ones")}
    for k, d in L.attention_defs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.head_dim_,
                                 qkv_bias=cfg.qkv_bias).items():
        defs[f"attn.{k}"] = d
    for k, d in L.mlp_defs(cfg.d_model, cfg.d_ff).items():
        defs[f"mlp.{k}"] = d
    return defs


def model_defs(cfg: ModelConfig):
    """Flat ParamDef dict with the JAX tree's dotted paths: the stacked
    Mamba ``layers`` and the unstacked ``shared_attn`` block."""
    defs = {"embedding": L.embedding_defs(cfg.vocab_size, cfg.d_model),
            "ln_f": pdef((cfg.d_model,), ("embed",), "ones")}
    for k, d in M.block_defs(cfg).items():
        defs[f"layers.{k}"] = d
    for k, d in shared_attn_defs(cfg).items():
        defs[f"shared_attn.{k}"] = d
    if not cfg.tie_embeddings:
        defs["lm_head"] = pdef((cfg.d_model, cfg.vocab_size),
                               ("embed", "vocab"), "scaled")
    return defs


def shared_params(params):
    """The shared block's params as ``{"ln1", "ln2", "attn": {...}, "mlp":
    {...}}``."""
    out = {}
    for path, t in params.items():
        parts = path.split(".")
        if parts[0] != "shared_attn":
            continue
        if len(parts) == 2:
            out[parts[1]] = t
        else:
            out.setdefault(parts[1], {})[parts[2]] = t
    return out


def _attn_kw(cfg: ModelConfig, attn_impl: str, tp=None):
    H, KV = _heads(cfg, tp)
    return dict(n_heads=H, n_kv_heads=KV, head_dim=cfg.head_dim_,
                rope_theta=cfg.rope_theta, window=cfg.sliding_window,
                attn_impl=attn_impl, tp=tp)


def _shared_attn_apply(cfg, p, x, *, attn_impl="xla"):
    h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
    x = x + L.self_attention(p["attn"], h, **_attn_kw(cfg, attn_impl))
    h = L.rms_norm(x, p["ln2"], cfg.rms_eps)
    return x + L.mlp(p["mlp"], h)


def _site_tail(cfg, p, x, attend, tp=None):
    """The shared block around a cached attention ``attend(attn params, h)
    -> h`` (prefill or decode at one site)."""
    h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
    x = x + attend(p["attn"], h)
    h = L.rms_norm(x, p["ln2"], cfg.rms_eps)
    return x + L.mlp(p["mlp"], h, tp)


def forward(cfg: ModelConfig, params, tokens, *, extra=None,
            attn_impl: str = "xla"):
    """Full-sequence forward -> logits (B, S, V). ``attn_impl`` ("xla" or
    "flash") reaches the shared-attention sites only. With ``cfg.remat ==
    "full"`` and grad enabled each Mamba layer keeps only its input for
    the backward (the shared block is not checkpointed, as in JAX)."""
    del extra
    x = L.embed(params["embedding"], tokens)
    shared = shared_params(params)
    for l0, l1, has_attn in _group_bounds(cfg):
        for i in range(l0, l1):
            lp = layer_params(params, i)
            if cfg.remat == "full" and torch.is_grad_enabled():
                x = checkpoint(M._block_apply, cfg, lp, x,
                               use_reentrant=False)
            else:
                x = M._block_apply(cfg, lp, x)
        if has_attn:
            x = _shared_attn_apply(cfg, shared, x, attn_impl=attn_impl)
    return _chunk_logits(cfg, params, x)


class HybridCache(NamedTuple):
    mamba: M.MambaCache
    attn_kv: L.KVEntry          # stacked over sites: (n_sites,B,S_max,KV,hd)
    pos: torch.Tensor           # (B,) int32


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               dtype=torch.bfloat16, *, device=None, tp=None):
    """The Mamba layers' recurrent cache and one KV ring per site (the
    rank's SSM heads and kv heads under ``tp``)."""
    sites = n_attn_sites(cfg)
    shape = (sites, batch, s_max, _heads(cfg, tp)[1], cfg.head_dim_)
    return HybridCache(
        mamba=M.init_cache(cfg, batch, s_max, dtype, device=device, tp=tp),
        attn_kv=L.KVEntry(torch.zeros(shape, dtype=dtype, device=device),
                          torch.zeros(shape, dtype=dtype, device=device)),
        pos=torch.zeros((batch,), dtype=torch.int32, device=device))


def prefill(cfg: ModelConfig, params, tokens, cache: HybridCache, *,
            extra=None, attn_impl: str = "xla", tp=None):
    """Run the prompt (B, S) from the cache's state: each Mamba layer in
    the chunked form from its SSM state (conv tail and final state written
    into the cache), each site's K/V into its own ring (in group order).
    Returns (logits of the last position (B, V), cache). attn_impl: "xla"
    or "flash" at the sites."""
    del extra
    x = L.embed(params["embedding"], tokens, tp)
    mc = cache.mamba
    shared = shared_params(params)
    akw = _attn_kw(cfg, attn_impl, tp)
    site = 0
    for l0, l1, has_attn in _group_bounds(cfg):
        for i in range(l0, l1):
            lp = layer_params(params, i)
            h = L.rms_norm(x, lp["ln"], cfg.rms_eps)
            out, final = M.mamba_mixer(cfg, lp["mixer"], h,
                                       initial_state=mc.ssm[i], tp=tp)
            mc.conv[i].copy_(M._conv_tail(cfg, lp["mixer"], h, tp))
            mc.ssm[i].copy_(final)
            x = x + out
        if has_attn:
            kv = cache.attn_kv.layer(site)
            x = _site_tail(cfg, shared, x, lambda p, h: L.prefill_attention(
                p, h, kv, **akw)[0], tp)
            site += 1
    B, S = tokens.shape
    posv = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    return _chunk_logits(cfg, params, x[:, -1:], tp)[:, 0], HybridCache(
        mamba=mc._replace(pos=posv), attn_kv=cache.attn_kv, pos=posv)


def decode_step(cfg: ModelConfig, params, token, cache: HybridCache, *,
                extra=None, attn_impl: str = "xla", advance=None,
                layers=None, tp=None):
    """One step. token: (B,) int. Rows with ``advance=False`` keep their
    conv and SSM states, site K/V and position. attn_impl: "xla" or
    "pallas" (the split-K decode kernel, once per site). ``layers``: the
    per-layer param views, when the caller has already sliced them."""
    del extra
    x = L.embed(params["embedding"], token[:, None], tp)
    B = token.shape[0]
    pos = cache.pos
    adv = (torch.ones((B,), dtype=torch.bool, device=token.device)
           if advance is None else advance)
    if layers is None:
        layers = [layer_params(params, i) for i in range(cfg.n_layers)]
    mc = cache.mamba
    shared = shared_params(params)
    akw = dict(_attn_kw(cfg, attn_impl, tp), advance=adv)
    site = 0
    for l0, l1, has_attn in _group_bounds(cfg):
        for i in range(l0, l1):
            lp = layers[i]
            h = L.rms_norm(x, lp["ln"], cfg.rms_eps)
            conv_l, ssm_l = mc.conv[i], mc.ssm[i]
            out, new_conv, new_ssm = M.mamba_mixer_decode(
                cfg, lp["mixer"], h, conv_l, ssm_l, tp)
            conv_l.copy_(torch.where(adv[:, None, None], new_conv, conv_l))
            ssm_l.copy_(torch.where(adv[:, None, None, None], new_ssm,
                                    ssm_l))
            x = x + out
        if has_attn:
            kv = cache.attn_kv.layer(site)
            x = _site_tail(cfg, shared, x, lambda p, h: L.decode_attention(
                p, h, kv, pos, **akw)[0], tp)
            site += 1
    new_pos = pos + adv.to(torch.int32)
    return _chunk_logits(cfg, params, x, tp)[:, 0], HybridCache(
        mamba=mc._replace(pos=new_pos), attn_kv=cache.attn_kv, pos=new_pos)


def decode_scan_body(cfg: ModelConfig, params, *, attn_impl: str = "xla",
                     tp=None):
    """Decode body for in-loop generation: ``decode_step`` wrapped by
    ``transformer.scan_body_over``, as JAX's ``Model`` wraps families
    without a native body (per-layer param views sliced once here)."""
    layers = [layer_params(params, i) for i in range(cfg.n_layers)]
    return scan_body_over(
        lambda token, advance, cache: decode_step(
            cfg, params, token, cache, attn_impl=attn_impl, advance=advance,
            layers=layers, tp=tp))
