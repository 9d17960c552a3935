"""Plain PyTorch version of the decode attention kernel (port of
``repro/kernels/decode_attention/ref.py``).

Single-query GQA attention over a dense ``(B, S, KV, hd)`` cache with a
``(B, S)`` validity mask, in f32. It is the semantic spec the CUDA kernel
is held against, and what the wrapper runs for CPU tensors.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k, v, valid):
    """q: (B,H,hd); k,v: (B,S,KV,hd); valid: (B,S) bool -> (B,H,hd) in q's
    dtype. Masked keys score the finite ``NEG_INF``, so a row with no valid
    key softmaxes equal logits: its output is the mean of V over S."""
    B, H, hd = q.shape
    KV = k.shape[2]
    qf = q.float().reshape(B, KV, H // KV, hd)
    kf = k.float().permute(0, 2, 1, 3)                      # (B,KV,S,hd)
    vf = v.float().permute(0, 2, 1, 3)
    s = torch.einsum("bkgh,bksh->bkgs", qf, kf) / math.sqrt(hd)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bksh->bkgh", p, vf)
    return out.reshape(B, H, hd).to(q.dtype)
