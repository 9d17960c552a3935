"""Plain PyTorch versions of the flash attention kernels (the forward of
``repro/kernels/flash_attention/kernel.py`` and the two-pass backward of
``bwd_kernel.py``, written with whole-tensor ops).

They are the semantic spec the CUDA kernels are held against and what the
wrapper runs for CPU tensors. Both compute in float32, or in float64 when
given float64 inputs (``gradcheck``). Masked scores are the finite
``NEG_INF`` of the JAX kernel, so a row with no allowed key averages V
uniformly, as the JAX kernel and its oracle do.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _compute_dtype(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def allowed_mask(S: int, Sk: int, causal: bool, window: int, device=None,
                 q_offset: int = 0):
    """(S, Sk) bool: query i, at position ``q_offset + i``, may attend to
    key j."""
    qpos = torch.arange(S, device=device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=device)[None, :]
    ok = torch.ones((S, Sk), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= kpos > (qpos - window)
    return ok


def _scores(q, k, causal, window, q_offset: int = 0):
    """q: (B,S,H,hd), k: (B,Sk,KV,hd) -> scaled scores (B,KV,G,S,Sk) in
    the compute dtype, the allowed mask, and q reshaped (B,S,KV,G,hd)."""
    B, S, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    cd = _compute_dtype(q.dtype)
    qf = q.to(cd).reshape(B, S, KV, H // KV, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.to(cd)) / math.sqrt(hd)
    return s, allowed_mask(S, Sk, causal, window, q.device, q_offset), qf


def attention_fwd_ref(q, k, v, causal: bool = True, window: int = 0,
                      q_offset: int = 0):
    """q: (B,S,H,hd); k,v: (B,Sk,KV,hd) with H % KV == 0. Returns
    ``(out (B,S,H,hd) in q's dtype, L (B,H,S))``, L = m + log l the
    row's softmax normaliser in the compute dtype. Query i sits at
    position ``q_offset + i`` (a model rank's rows of a sequence split
    over the model axis); the result is those rows of the whole
    sequence's."""
    B, S, H, hd = q.shape
    s, ok, _ = _scores(q, k, causal, window, q_offset)
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0, 1.0, l)                   # fully masked rows
    out = torch.einsum("bkgqs,bskh->bqkgh", p / l, v.to(s.dtype))
    return (out.reshape(B, S, H, hd).to(q.dtype),
            (m + torch.log(l))[..., 0].reshape(B, H, S))


def attention_bwd_ref(q, k, v, out, dout, L, causal: bool = True,
                      window: int = 0):
    """The two-pass backward with P recomputed from L:
    ``D = rowsum(dO∘O)``, ``P = exp(scale·qkᵀ − L)``, ``dS = P∘(dO Vᵀ −
    D)``, ``dq = scale·dS K``, ``dk = scale·dSᵀQ`` and ``dv = PᵀdO``, dk
    and dv summed over the q heads that share a kv head. Returns ``(dq,
    dk, dv)`` in the dtypes of q, k, v."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    s, ok, qf = _scores(q, k, causal, window)
    cd = s.dtype
    scale = 1.0 / math.sqrt(hd)
    p = torch.where(ok, torch.exp(s - L.to(cd).reshape(B, KV, G, S, 1)),
                    0.0)
    dof = dout.to(cd).reshape(B, S, KV, G, hd)
    D = (dof * out.to(cd).reshape(B, S, KV, G, hd)).sum(-1)   # (B,S,KV,G)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dof, v.to(cd))
    ds = p * (dp - D.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, k.to(cd)) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qf) * scale
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dof)
    return (dq.reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
