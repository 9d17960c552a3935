"""Public wrapper for the fused sampling kernel (``csrc/fused_sample.cu``;
replaces the Pallas ``_fused_sample_kernel`` of
``repro/kernels/fused_sample/kernel.py``).

``fused_sample_tokens`` mirrors the JAX ``fused_sample_tokens``: greedy
when ``temperature <= 0``, else Gumbel-argmax over ``logits /
temperature`` with an optional nucleus filter. Temperature, top-p and the
noise are plain tensor work outside the kernel, as in JAX; the noise is an
operand, so a caller can feed the JAX draws and reproduce its tokens.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_sample.ref import NEG_INF, fused_sample_ref

launches = 0          # kernel launches since the last reset_launches()

_MAX_BLOCKS = 8       # blocks per row: one cluster, the portable size
_THREADS = 256        # threads per block (csrc/fused_sample.cu)
_BLOCKS_PER_SM = 4    # resident blocks an SM holds at the kernel's registers
_MIN_SLICE = 2048     # elements a block streams at least (8 per thread)


def reset_launches() -> None:
    global launches
    launches = 0


@functools.cache
def _bind():
    fn = _build.load("fused_sample").fused_sample_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cluster_plan(B: int, V: int, n_sm: int):
    """``(k, slice)``: blocks per row (one thread-block cluster, at most 8)
    and the elements each streams. As many blocks as fill about four per
    SM over the ``B`` rows, but none with fewer than 8 elements a thread,
    and at least four while the row allows, so that no thread sums more
    terms than about the first design's V/1024 (or 16, in a short row);
    the slice is a whole number of float4s, so each starts 16-byte
    aligned when the row does, and no block is empty. At B=32 on 132 SMs:
    V=151,936 gives 8 blocks of 18,992; V=50,280 gives 8 of 6,288."""
    V = max(V, 1)
    k = min(_MAX_BLOCKS, max(1, V // _MIN_SLICE),
            max(1024 // _THREADS, -(-_BLOCKS_PER_SM * n_sm // max(B, 1))))
    slice_ = 4 * -(-V // (4 * k))
    return -(-V // slice_), slice_


def fused_sample(lg, noise):
    """lg, noise: (B, V) f32. Returns ``(tokens (B,) int32, logprobs (B,)
    f32)``: ``argmax(lg + noise)`` (earliest index on ties) and ``lg[tok] -
    logsumexp(lg)``. CPU tensors use ``ref.py``; CUDA tensors launch the
    kernel."""
    if lg.device.type == "cpu":
        return fused_sample_ref(lg, noise)
    if lg.device.type != "cuda":
        raise ValueError(f"unsupported device {lg.device}")
    if lg.dtype != torch.float32 or noise.dtype != torch.float32:
        raise TypeError(f"logits and noise must be float32, got {lg.dtype} "
                        f"/ {noise.dtype}")
    if lg.dim() != 2 or noise.shape != lg.shape:
        raise ValueError(f"logits {tuple(lg.shape)} and noise "
                         f"{tuple(noise.shape)} must be one (B, V) shape")
    if noise.device != lg.device:
        raise ValueError("logits and noise must share a device")
    if not (lg.is_contiguous() and noise.is_contiguous()):
        raise ValueError("logits and noise must be contiguous")
    B, V = lg.shape
    return _launch(lg, noise, cluster_plan(B, V, _build.sm_count(
        lg.device.index or 0)))


def _launch(lg, noise, plan):
    """One counted launch on checked CUDA inputs under ``plan`` = ``(k,
    slice)``: the wrapper's is ``cluster_plan``'s, and ``chip_smoke.py``'s
    cluster probe times others."""
    B, V = lg.shape
    tok = torch.empty((B,), dtype=torch.int32, device=lg.device)
    lp = torch.empty((B,), dtype=torch.float32, device=lg.device)
    stream = torch.cuda.current_stream(lg.device).cuda_stream
    err = _bind()(lg.data_ptr(), noise.data_ptr(), tok.data_ptr(),
                  lp.data_ptr(), B, V, *plan, stream)
    _build.check(err, "fused_sample")
    global launches
    launches += 1
    return tok, lp


def apply_top_p(lg, top_p: float):
    """Nucleus filter on (B, V) f32 logits: keep the smallest set of
    top-probability tokens whose cumulative mass reaches ``top_p`` (a token
    survives iff the mass strictly above it is < top_p); the rest go to
    ``NEG_INF``."""
    lg = lg.float()
    sorted_lg = torch.sort(lg, dim=-1, descending=True).values
    probs = torch.softmax(sorted_lg, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    keep = (csum - probs) < top_p
    thr = torch.where(keep, sorted_lg, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(lg >= thr, lg, NEG_INF)


def fused_sample_tokens(logits, temperature: float, *, top_p: float = 1.0,
                        noise=None):
    """Sample next tokens from (B, V) logits in one kernel pass. Returns
    ``(tokens, logprobs)``. ``temperature <= 0`` is greedy with log-probs
    of the untempered logits (``noise`` and ``top_p`` unused); otherwise
    ``noise`` is the (B, V) Gumbel draw added to ``logits / temperature``
    after the optional top-p filter."""
    lg = logits.float()
    if temperature <= 0.0:
        return fused_sample(lg.contiguous(), torch.zeros_like(lg))
    if noise is None:
        raise ValueError("sampling at temperature > 0 needs a noise tensor")
    lg = lg / temperature
    if top_p < 1.0:
        lg = apply_top_p(lg, top_p)
    return fused_sample(lg.contiguous(), noise.float().contiguous())
