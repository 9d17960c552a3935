"""Plain PyTorch version of the speculative verify attention kernel (port
of ``repro/kernels/spec_verify/ref.py``).

The verify pass scores a chunk of ``K`` candidate tokens per row in one
call; the chunk's K/V is already written into the row's pool pages. Query
``j`` sits at absolute position ``pos[b] + j`` and attends the pool
positions ``<= pos[b] + j`` on mapped pages: the committed context plus
the chunk's own causal prefix. At ``K == 1`` this is the paged decode
version with ``lens = pos + 1``. It is the semantic spec the CUDA kernel
is held against, and what the wrapper runs for CPU tensors.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def spec_verify_attention_ref(q, k_pages, v_pages, block_table, pos,
                              k_scales=None, v_scales=None):
    """q: (B,K,H,hd) K queries per row; k_pages,v_pages: (P,ps,KV,hd) page
    pool holding the chunk K/V at positions ``pos[b] .. pos[b]+K-1``;
    block_table: (B,NP) int32 (-1 = unmapped); pos: (B,) int32 base
    positions. k_scales/v_scales: optional (P,ps,KV) f32 scales of int8
    pools (dequantised up front). f32 math inside; returns (B,K,H,hd) in
    q's dtype. A query with no valid position (its own page unmapped)
    outputs zeros, not the mean of V."""
    B, K, H, hd = q.shape
    P, ps, KV, _ = k_pages.shape
    NP = block_table.shape[1]
    group = H // KV
    if k_scales is not None:
        k_pages = k_pages.float() * k_scales.float()[..., None]
        v_pages = v_pages.float() * v_scales.float()[..., None]
    bt_c = block_table.clamp(0, P - 1).long()
    k = k_pages[bt_c].reshape(B, NP * ps, KV, hd)
    v = v_pages[bt_c].reshape(B, NP * ps, KV, hd)
    s_idx = torch.arange(NP * ps, device=q.device)[None, None, :]
    mapped = (block_table >= 0)[:, :, None].expand(B, NP, ps).reshape(
        B, NP * ps)
    qpos = pos[:, None] + torch.arange(K, device=q.device)[None, :]
    valid = (s_idx <= qpos[:, :, None]) & mapped[:, None, :]   # (B,K,S)
    qf = q.float().reshape(B, K, KV, group, hd)
    kf = k.float().permute(0, 2, 1, 3)                         # (B,KV,S,hd)
    vf = v.float().permute(0, 2, 1, 3)
    s = torch.einsum("bjkgh,bksh->bjkgs", qf, kf) / math.sqrt(hd)
    s = torch.where(valid[:, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid.any(dim=2)[:, :, None, None, None], p, 0.0)
    out = torch.einsum("bjkgs,bksh->bjkgh", p, vf)
    return out.reshape(B, K, H, hd).to(q.dtype)
