"""Plain PyTorch version of the paged decode attention kernel (port of
``repro/kernels/paged_attention/ref.py``).

Gathers the page pool through the block table into a dense
``(B, NP*ps, KV, hd)`` view and runs the masked GQA softmax in f32. It is
the semantic spec the CUDA kernel is held against, and what the wrapper
runs for CPU tensors.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def paged_decode_attention_ref(q, k_pages, v_pages, block_table, lens,
                               k_scales=None, v_scales=None):
    """q: (B,H,hd); k_pages,v_pages: (P,ps,KV,hd); block_table: (B,NP)
    int32 (-1 = unmapped); lens: (B,) int32 (row b attends to positions
    < lens[b]). k_scales/v_scales: optional (P,ps,KV) f32 scales of int8
    pools (dequantised up front). Returns (B,H,hd) in q's dtype; a row with
    no valid position outputs zeros."""
    B, H, hd = q.shape
    P, ps, KV, _ = k_pages.shape
    NP = block_table.shape[1]
    group = H // KV
    if k_scales is not None:
        k_pages = k_pages.float() * k_scales.float()[..., None]
        v_pages = v_pages.float() * v_scales.float()[..., None]
    bt_c = block_table.clamp(0, P - 1).long()
    k = k_pages[bt_c].reshape(B, NP * ps, KV, hd)
    v = v_pages[bt_c].reshape(B, NP * ps, KV, hd)
    s_idx = torch.arange(NP * ps, device=q.device)[None, :]
    mapped = (block_table >= 0)[:, :, None].expand(B, NP, ps).reshape(
        B, NP * ps)
    valid = (s_idx < lens[:, None]) & mapped                # (B,S)
    qf = q.float().reshape(B, KV, group, hd)
    kf = k.float().permute(0, 2, 1, 3)                      # (B,KV,S,hd)
    vf = v.float().permute(0, 2, 1, 3)
    s = torch.einsum("bkgh,bksh->bkgs", qf, kf) / math.sqrt(hd)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid.any(dim=1)[:, None, None, None], p, 0.0)
    out = torch.einsum("bkgs,bksh->bkgh", p, vf)
    return out.reshape(B, H, hd).to(q.dtype)
