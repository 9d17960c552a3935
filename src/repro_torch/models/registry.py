"""Model interface (port of ``repro/models/registry.py``, dense and ssm
families).

    model = build_model(cfg)
    params = model.init(generator, device=device)
    logits, aux = model.forward(params, tokens)
    cache = model.init_cache(batch, s_max, device=device)
    logits, cache = model.prefill(params, tokens, cache)
    logits, cache = model.decode_step(params, token, cache)
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba, transformer
from repro_torch.models.param import init_params


@dataclass
class Model:
    cfg: ModelConfig
    defs: Any
    _forward: Callable
    _init_cache: Callable
    _prefill: Callable
    _decode_step: Callable
    _decode_scan_body: Callable

    def init(self, generator: torch.Generator, dtype=torch.bfloat16,
             device=None):
        """Random params from ``generator`` (which lives on ``device``;
        ``None`` means the generator's device)."""
        device = generator.device if device is None else device
        return init_params(self.defs, generator, device, dtype)

    def forward(self, params, tokens, *, extra=None, attn_impl="xla"):
        """Full-sequence forward: ``(logits (B,S,V), aux)``; the ported
        families have no auxiliary losses, so ``aux`` is ``{}``.
        ``attn_impl``: "xla" (the plain paths), "flash" (dense: the
        flash-attention kernels) or "pallas" (ssm: the SSD scan kernel)."""
        return self._forward(self.cfg, params, tokens, extra=extra,
                             attn_impl=attn_impl), {}

    def init_cache(self, batch, s_max, dtype=torch.bfloat16, **layout_kw):
        """``layout_kw``: ``device`` and the cache-layout options
        (``layout="paged"``, ``page_size``, ``n_pages``, ``kv_dtype``) —
        dense-family features; a family whose ``init_cache`` does not take
        one raises ``ValueError``, as JAX's signature check does."""
        params = inspect.signature(self._init_cache).parameters
        unsupported = sorted(k for k in layout_kw if k not in params)
        if unsupported:
            raise ValueError(f"family {self.cfg.family!r} does not support "
                             f"cache layout options {unsupported}")
        return self._init_cache(self.cfg, batch, s_max, dtype, **layout_kw)

    def prefill(self, params, tokens, cache, *, extra=None,
                attn_impl="xla"):
        """The prompt into the cache: ``(last-position logits, cache)``."""
        return self._prefill(self.cfg, params, tokens, cache, extra=extra,
                             attn_impl=attn_impl)

    def decode_step(self, params, token, cache, *, attn_impl="xla",
                    advance=None):
        return self._decode_step(self.cfg, params, token, cache,
                                 attn_impl=attn_impl, advance=advance)

    def decode_scan_body(self, params, *, attn_impl="xla"):
        """``body((logits, cache), (token, advance)) -> ((logits, cache),
        None)`` for in-loop generation: the dense family's own, and for
        ssm ``decode_step`` wrapped by ``transformer.scan_body_over``, as
        JAX's ``Model`` wraps families without a native body."""
        return self._decode_scan_body(self.cfg, params, attn_impl=attn_impl)


_FAMILIES = {
    "dense": (transformer.model_defs, transformer.forward,
              transformer.init_cache, transformer.prefill,
              transformer.decode_step, transformer.decode_scan_body),
    "ssm": (mamba.model_defs, mamba.forward, mamba.init_cache,
            mamba.prefill, mamba.decode_step, mamba.decode_scan_body),
}


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} arrives with ROADMAP Queue 1 item 10; "
            f"ported: {sorted(_FAMILIES)}")
    defs_fn, fwd, ic, pf, ds, body = _FAMILIES[cfg.family]
    return Model(cfg=cfg, defs=defs_fn(cfg), _forward=fwd, _init_cache=ic,
                 _prefill=pf, _decode_step=ds, _decode_scan_body=body)
