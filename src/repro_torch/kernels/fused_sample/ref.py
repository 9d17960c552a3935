"""Plain PyTorch version of the fused sampling kernel (port of
``repro/kernels/fused_sample/ref.py``): the two-read materialised form the
CUDA kernel computes in one streaming pass."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def fused_sample_ref(lg, noise):
    """lg, noise: (B, V) f32. Returns (tokens (B,) int32, logprobs (B,)
    f32) with ``tokens = argmax(lg + noise)`` (earliest index on ties) and
    ``logprobs = lg[tok] - logsumexp(lg)``."""
    lg = lg.float()
    tok = torch.argmax(lg + noise.float(), dim=-1)
    lp = lg.gather(1, tok[:, None])[:, 0] - torch.logsumexp(lg, dim=-1)
    return tok.to(torch.int32), lp


def fused_sample_partial_ref(lg, noise):
    """The partial-state mode over a (B, V) vocab shard: per row ``(m, l,
    bs, bi, bl)`` with ``m`` the row max, ``l = sum(exp(lg - m))``,
    ``bs`` the best score of ``lg + noise``, ``bi`` its earliest local
    index (int32) and ``bl = lg[bi]``."""
    lg = lg.float()
    sc = lg + noise.float()
    bi = torch.argmax(sc, dim=-1)
    m = lg.amax(dim=-1)
    l = torch.exp(lg - m[:, None]).sum(dim=-1)
    return (m, l, sc.gather(1, bi[:, None])[:, 0], bi.to(torch.int32),
            lg.gather(1, bi[:, None])[:, 0])
