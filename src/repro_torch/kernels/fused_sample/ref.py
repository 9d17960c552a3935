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
