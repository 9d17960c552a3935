"""Model interface (port of ``repro/models/registry.py``, dense family).

    model = build_model(cfg)
    params = model.init(generator, device=device)
    logits, aux = model.forward(params, tokens)
    cache = model.init_cache(batch, s_max, device=device)
    logits, cache = model.prefill(params, tokens, cache)
    logits, cache = model.decode_step(params, token, cache)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.param import init_params


@dataclass
class Model:
    cfg: ModelConfig
    defs: Any

    def init(self, generator: torch.Generator, dtype=torch.bfloat16,
             device=None):
        """Random params from ``generator`` (which lives on ``device``;
        ``None`` means the generator's device)."""
        device = generator.device if device is None else device
        return init_params(self.defs, generator, device, dtype)

    def forward(self, params, tokens, *, extra=None, attn_impl="xla"):
        """Full-sequence forward: ``(logits (B,S,V), aux)``; the dense
        family has no auxiliary losses, so ``aux`` is ``{}``.
        ``attn_impl``: "xla" (plain attention) or "flash" (the kernels)."""
        return transformer.forward(self.cfg, params, tokens, extra=extra,
                                   attn_impl=attn_impl), {}

    def init_cache(self, batch, s_max, dtype=torch.bfloat16, **layout_kw):
        return transformer.init_cache(self.cfg, batch, s_max, dtype,
                                      **layout_kw)

    def prefill(self, params, tokens, cache, *, extra=None,
                attn_impl="xla"):
        """The prompt into a dense cache: ``(last-position logits, cache)``.
        ``attn_impl``: "xla" or "flash"."""
        return transformer.prefill(self.cfg, params, tokens, cache,
                                   extra=extra, attn_impl=attn_impl)

    def decode_step(self, params, token, cache, *, attn_impl="xla",
                    advance=None):
        return transformer.decode_step(self.cfg, params, token, cache,
                                       attn_impl=attn_impl, advance=advance)

    def decode_scan_body(self, params, *, attn_impl="xla"):
        """``body((logits, cache), (token, advance)) -> ((logits, cache),
        None)`` for in-loop generation."""
        return transformer.decode_scan_body(self.cfg, params,
                                            attn_impl=attn_impl)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} arrives with ROADMAP Queue 1 item 10; "
            f"only the dense family is ported")
    return Model(cfg=cfg, defs=transformer.model_defs(cfg))
