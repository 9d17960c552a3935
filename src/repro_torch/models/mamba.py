"""Mamba2 (SSD, state-space duality) model (port of
``repro/models/mamba.py``). [arXiv:2405.21060]

The sequence mixer is the chunked SSD algorithm: within a chunk the
recurrence is computed in its dual quadratic "attention" form, across
chunks a linear state recurrence is scanned. ``ssd_chunked`` is also the
plain version of the SSD scan kernel (``kernels/ssd_scan/ref.py``
re-exports it); ``mamba_mixer(attn_impl="pallas")`` runs the kernel on a
pass from zero state, as the JAX mixer does.

Decode is the O(1)-per-token recurrent form over a ``(conv, ssm)`` cache
whose size does not grow with the context. As in the port's transformer,
``prefill`` and ``decode_step`` write the cache tensors IN PLACE (in the
cache's dtype); ``pos`` is returned as a new tensor. Every dtype cast of
the JAX functions is kept, so the fp32 model matches JAX at fp32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.param import pdef
from repro_torch.models.transformer import layer_params, scan_body_over


def softplus(x):
    """``jax.nn.softplus``: ``log(1 + e^x)`` everywhere (torch's
    ``F.softplus`` turns linear above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# SSD core (chunked dual form): the kernel's plain version
# ---------------------------------------------------------------------------

def ssd_chunked(x, dt, A, B, C, chunk_size: int, initial_state=None):
    """Chunked SSD scan.

    x:  (b, s, h, p)   per-head inputs
    dt: (b, s, h)      positive step sizes (already softplus'ed)
    A:  (h,)           negative per-head decay
    B:  (b, s, g, n)   input projections (g groups, h % g == 0)
    C:  (b, s, g, n)   output projections
    Returns (y (b,s,h,p) in x's dtype, final_state (b,h,p,n) f32).
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q = min(chunk_size, s)
    pad = (-s) % q
    if pad:
        x, dt, B, C = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                       for t in (x, dt, B, C))
    sp = s + pad
    nc = sp // q
    rep = h // g
    Bh = torch.repeat_interleave(B, rep, dim=2)              # (b,sp,h,n)
    Ch = torch.repeat_interleave(C, rep, dim=2)
    f32 = torch.float32

    xc = x.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h).to(f32)
    Bc = Bh.reshape(b, nc, q, h, n)
    Cc = Ch.reshape(b, nc, q, h, n)

    dA = dtc * A.to(f32)                                     # (b,nc,q,h) <= 0
    dA_cs = torch.cumsum(dA, dim=2)

    # intra-chunk (dual form): L[i,j] = exp(cs[i]-cs[j]) for j <= i
    diff = dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :]  # (b,nc,i,j,h)
    tril = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    Lmat = torch.where(tril[None, None, :, :, None], torch.exp(diff), 0.0)
    CB = torch.einsum("bcihn,bcjhn->bcijh", Cc.to(f32), Bc.to(f32))
    W = (CB * Lmat * dtc[:, :, None, :, :]).to(x.dtype)      # (b,nc,i,j,h)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", W, xc)

    # chunk-final states: sum_j exp(cs[-1]-cs[j]) * dt[j] * B[j] (x) x[j]
    dA_sum = dA_cs[:, :, -1, :]                              # (b,nc,h)
    decay = torch.exp(dA_sum[:, :, None, :] - dA_cs) * dtc   # (b,nc,q,h)
    chunk_states = torch.einsum("bcjh,bcjhn,bcjhp->bchpn", decay,
                                Bc.to(f32), xc.to(f32))      # (b,nc,h,p,n)

    # inter-chunk recurrence: each chunk reads the state BEFORE it
    state = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if initial_state is None else initial_state.to(f32))
    prev = []
    for c in range(nc):
        prev.append(state)
        state = (torch.exp(dA_sum[:, c])[..., None, None] * state
                 + chunk_states[:, c])
    prev_states = torch.stack(prev, dim=1)                   # (b,nc,h,p,n)

    # off-diagonal contribution from the carried-in state
    y_off = torch.einsum("bcihn,bcih,bchpn->bcihp", Cc.to(f32),
                         torch.exp(dA_cs), prev_states)
    y = (y_diag.to(f32) + y_off).reshape(b, sp, h, p)
    return y[:, :s].to(x.dtype), state


def ssd_decode_step(state, x, dt, A, B, C):
    """O(1) recurrent step. x:(b,h,p) dt:(b,h) B,C:(b,g,n)
    state:(b,h,p,n) f32. Returns (y (b,h,p) in x's dtype, new state)."""
    b, h, p = x.shape
    g = B.shape[1]
    rep = h // g
    f32 = torch.float32
    Bh = torch.repeat_interleave(B, rep, dim=1).to(f32)      # (b,h,n)
    Ch = torch.repeat_interleave(C, rep, dim=1).to(f32)
    dtf = dt.to(f32)
    dA = torch.exp(dtf * A.to(f32))                          # (b,h)
    upd = ((dtf[..., None] * Bh)[:, :, None, :]
           * x.to(f32)[..., None])                           # (b,h,p,n)
    state = dA[..., None, None] * state + upd
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    return y.to(x.dtype), state


# ---------------------------------------------------------------------------
# Mamba2 layer
# ---------------------------------------------------------------------------

def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.n_heads * s.head_dim
    conv_ch = d_inner + 2 * s.n_groups * s.state_size
    proj_out = 2 * d_inner + 2 * s.n_groups * s.state_size + s.n_heads
    return s, d_inner, conv_ch, proj_out


def mamba_layer_defs(cfg: ModelConfig, *, layers=None):
    s, d_inner, conv_ch, proj_out = _dims(cfg)
    n = (layers,) if layers else ()
    ax = ("layers",) if layers else ()
    return {
        "in_proj": pdef(n + (cfg.d_model, proj_out),
                        ax + ("embed", "ssm_inner"), "scaled"),
        "conv_w": pdef(n + (s.conv_width, conv_ch),
                       ax + (None, "ssm_inner"), "scaled"),
        "conv_b": pdef(n + (conv_ch,), ax + ("ssm_inner",), "zeros"),
        "A_log": pdef(n + (s.n_heads,), ax + ("ssm_heads",), "zeros"),
        "D": pdef(n + (s.n_heads,), ax + ("ssm_heads",), "ones"),
        "dt_bias": pdef(n + (s.n_heads,), ax + ("ssm_heads",), "zeros"),
        "norm_w": pdef(n + (d_inner,), ax + ("ssm_inner",), "ones"),
        "out_proj": pdef(n + (d_inner, cfg.d_model),
                         ax + ("ssm_inner", "embed"), "scaled"),
    }


def _split_proj(cfg, proj):
    _, d_inner, conv_ch, _ = _dims(cfg)
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:d_inner + conv_ch]
    dt = proj[..., d_inner + conv_ch:]
    return z, xbc, dt


def _causal_conv(xbc, w, b):
    """Depthwise causal conv. xbc: (B,S,C), w: (W,C). An explicit sum of
    W products in the input dtype, as JAX's (not ``F.conv1d``, which runs
    in TF32 and another order on the card), then ``+ b`` and silu in
    f32."""
    W = w.shape[0]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i] for i in range(W))
    return F.silu((out + b).float()).to(xbc.dtype)


def _gated_out(cfg, p, y, z):
    """The mixer's tail: gate with silu(z), RMSNorm, out projection."""
    y = L.rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm_w"],
                   cfg.rms_eps)
    return y @ p["out_proj"]


def mamba_mixer(cfg: ModelConfig, p, x, *, initial_state=None,
                attn_impl: str = "xla"):
    """Full-sequence Mamba2 mixer. x: (B,S,D) -> (out, final_state).
    attn_impl="pallas" runs the SSD scan kernel (``kernels/ssd_scan``; its
    plain version for CPU tensors) on a pass from zero state, as JAX's
    ``:181``; anything else, or an ``initial_state``, runs
    ``ssd_chunked``."""
    s, d_inner, conv_ch, _ = _dims(cfg)
    Bsz, S, _ = x.shape
    proj = x @ p["in_proj"]
    z, xbc, dt = _split_proj(cfg, proj)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    gn = s.n_groups * s.state_size
    xs = xbc[..., :d_inner].reshape(Bsz, S, s.n_heads, s.head_dim)
    Bmat = xbc[..., d_inner:d_inner + gn].reshape(Bsz, S, s.n_groups,
                                                  s.state_size)
    Cmat = xbc[..., d_inner + gn:].reshape(Bsz, S, s.n_groups, s.state_size)
    dt = softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    if attn_impl == "pallas" and initial_state is None:
        from repro_torch.kernels.ssd_scan import ops as ssd_ops
        y, final = ssd_ops.ssd_scan(xs, dt, A, Bmat, Cmat, s.chunk_size)
    else:
        y, final = ssd_chunked(xs, dt, A, Bmat, Cmat, s.chunk_size,
                               initial_state=initial_state)
    y = y + xs * p["D"][None, None, :, None].to(y.dtype)
    return _gated_out(cfg, p, y.reshape(Bsz, S, d_inner), z), final


def mamba_mixer_decode(cfg: ModelConfig, p, x, conv_state, ssm_state):
    """One-token mixer. x: (B,1,D); conv_state: (B, W-1, conv_ch).
    Returns (out (B,1,D), new conv window, new ssm state)."""
    s, d_inner, conv_ch, _ = _dims(cfg)
    Bsz = x.shape[0]
    proj = (x @ p["in_proj"])[:, 0]                          # (B,E)
    z, xbc, dt = _split_proj(cfg, proj)
    # causal conv over [conv_state ; xbc], in the promoted dtype as JAX's
    window = torch.cat([conv_state, xbc[:, None, :]], dim=1)  # (B,W,C)
    ct = torch.promote_types(window.dtype, p["conv_w"].dtype)
    conv_out = (torch.einsum("bwc,wc->bc", window.to(ct),
                             p["conv_w"].to(ct)) + p["conv_b"])
    xbc_c = F.silu(conv_out.float()).to(x.dtype)
    new_conv_state = window[:, 1:]
    gn = s.n_groups * s.state_size
    xs = xbc_c[..., :d_inner].reshape(Bsz, s.n_heads, s.head_dim)
    Bmat = xbc_c[..., d_inner:d_inner + gn].reshape(Bsz, s.n_groups,
                                                    s.state_size)
    Cmat = xbc_c[..., d_inner + gn:].reshape(Bsz, s.n_groups, s.state_size)
    dt = softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    y, new_ssm = ssd_decode_step(ssm_state, xs, dt, A, Bmat, Cmat)
    y = y + xs * p["D"][None, :, None].to(y.dtype)
    out = _gated_out(cfg, p, y.reshape(Bsz, d_inner), z)
    return out[:, None], new_conv_state, new_ssm


def _conv_tail(cfg, p_layer, x):
    """Recompute the pre-conv xbc tail for the decode conv cache."""
    W = cfg.ssm.conv_width
    _, xbc, _ = _split_proj(cfg, x[:, -(W - 1):] @ p_layer["in_proj"])
    return xbc                                              # (B, W-1, conv_ch)


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def block_defs(cfg: ModelConfig):
    n = cfg.n_layers
    defs = {"ln": pdef((n, cfg.d_model), ("layers", "embed"), "ones")}
    for k, d in mamba_layer_defs(cfg, layers=n).items():
        defs[f"mixer.{k}"] = d
    return defs


def model_defs(cfg: ModelConfig):
    """Flat ParamDef dict with the JAX tree's dotted paths."""
    defs = {"embedding": L.embedding_defs(cfg.vocab_size, cfg.d_model),
            "ln_f": pdef((cfg.d_model,), ("embed",), "ones")}
    for k, d in block_defs(cfg).items():
        defs[f"layers.{k}"] = d
    if not cfg.tie_embeddings:
        defs["lm_head"] = pdef((cfg.d_model, cfg.vocab_size),
                               ("embed", "vocab"), "scaled")
    return defs


def _block_apply(cfg, layer_p, x, *, attn_impl: str = "xla"):
    h = L.rms_norm(x, layer_p["ln"], cfg.rms_eps)
    out, _ = mamba_mixer(cfg, layer_p["mixer"], h, attn_impl=attn_impl)
    return x + out


def _logits(cfg: ModelConfig, params, x):
    x = L.rms_norm(x, params["ln_f"], cfg.rms_eps)
    return L.unembed(params.get("lm_head", params["embedding"]), x)


def forward(cfg: ModelConfig, params, tokens, *, extra=None,
            attn_impl: str = "xla"):
    """Full-sequence forward -> logits (B, S, V). ``attn_impl``: "xla"
    (``ssd_chunked``) or "pallas" (the SSD scan kernel, which has no
    backward: it raises under autograd). With ``cfg.remat == "full"`` and
    grad enabled, each layer keeps only its input for the backward."""
    del extra
    x = L.embed(params["embedding"], tokens)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        if cfg.remat == "full" and torch.is_grad_enabled():
            x = checkpoint(_block_apply, cfg, lp, x, attn_impl=attn_impl,
                           use_reentrant=False)
        else:
            x = _block_apply(cfg, lp, x, attn_impl=attn_impl)
    return _logits(cfg, params, x)


class MambaCache(NamedTuple):
    conv: torch.Tensor     # (L, B, W-1, conv_ch), the cache dtype
    ssm: torch.Tensor      # (L, B, H, P, N) float32
    pos: torch.Tensor      # (B,) int32


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               dtype=torch.bfloat16, *, device=None):
    """A zeroed recurrent cache. ``s_max`` is unused: the state is O(1) in
    sequence length, the SSM advantage."""
    _, _, conv_ch, _ = _dims(cfg)
    del s_max
    s = cfg.ssm
    return MambaCache(
        conv=torch.zeros((cfg.n_layers, batch, s.conv_width - 1, conv_ch),
                         dtype=dtype, device=device),
        ssm=torch.zeros((cfg.n_layers, batch, s.n_heads, s.head_dim,
                         s.state_size), dtype=torch.float32, device=device),
        pos=torch.zeros((batch,), dtype=torch.int32, device=device))


def prefill(cfg: ModelConfig, params, tokens, cache: MambaCache, *,
            extra=None, attn_impl: str = "xla"):
    """Run the prompt (B, S) through the model from the cache's state (the
    chunked form with ``initial_state``; no kernel, as in JAX), writing the
    conv tails and final states into ``cache`` in place. Returns (logits
    of the last position (B, V), cache)."""
    del extra, attn_impl
    x = L.embed(params["embedding"], tokens)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = L.rms_norm(x, lp["ln"], cfg.rms_eps)
        out, final = mamba_mixer(cfg, lp["mixer"], h,
                                 initial_state=cache.ssm[i])
        cache.conv[i].copy_(_conv_tail(cfg, lp["mixer"], h))
        cache.ssm[i].copy_(final)
        x = x + out
    B, S = tokens.shape
    return _logits(cfg, params, x[:, -1:])[:, 0], cache._replace(
        pos=torch.full((B,), S, dtype=torch.int32, device=tokens.device))


def decode_step(cfg: ModelConfig, params, token, cache: MambaCache, *,
                extra=None, attn_impl: str = "xla", advance=None,
                layers=None):
    """One recurrent step. token: (B,) int. Rows with ``advance=False``
    keep their conv and ssm state and position. The cache tensors are
    written in place. ``attn_impl`` is accepted and ignored (there is no
    attention), as in JAX. ``layers``: the per-layer param views, when the
    caller has already sliced them."""
    del extra, attn_impl
    x = L.embed(params["embedding"], token[:, None])
    B = token.shape[0]
    adv = (torch.ones((B,), dtype=torch.bool, device=token.device)
           if advance is None else advance)
    if layers is None:
        layers = [layer_params(params, i) for i in range(cfg.n_layers)]
    for i, lp in enumerate(layers):
        h = L.rms_norm(x, lp["ln"], cfg.rms_eps)
        conv_l, ssm_l = cache.conv[i], cache.ssm[i]
        out, new_conv, new_ssm = mamba_mixer_decode(cfg, lp["mixer"], h,
                                                    conv_l, ssm_l)
        conv_l.copy_(torch.where(adv[:, None, None], new_conv, conv_l))
        ssm_l.copy_(torch.where(adv[:, None, None, None], new_ssm, ssm_l))
        x = x + out
    return _logits(cfg, params, x)[:, 0], cache._replace(
        pos=cache.pos + adv.to(torch.int32))


def decode_scan_body(cfg: ModelConfig, params, *, attn_impl: str = "xla"):
    """Decode body for in-loop generation: ``decode_step`` wrapped by
    ``transformer.scan_body_over`` (per-layer param views are sliced once
    here, not once per token)."""
    layers = [layer_params(params, i) for i in range(cfg.n_layers)]
    return scan_body_over(
        lambda token, advance, cache: decode_step(
            cfg, params, token, cache, attn_impl=attn_impl, advance=advance,
            layers=layers))
