"""Model interface over every family of the JAX package (port of
``repro/models/registry.py``): dense, ssm, moe, hybrid, audio and vlm.

    model = build_model(cfg)
    params = model.init(generator, device=device)
    extra = model.make_extras(generator, batch)     # audio / vlm, else None
    logits, aux = model.forward(params, tokens, extra=extra)
    cache = model.init_cache(batch, s_max, device=device)
    logits, cache = model.prefill(params, tokens, cache, extra=extra)
    logits, cache = model.decode_step(params, token, cache)

``extra`` carries the stubbed modality inputs (audio frames, image
embeddings); ``input_extras`` gives their shapes and dtypes.
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, mamba, moe, transformer, vlm
from repro_torch.models.param import init_params


class ExtraSpec(NamedTuple):
    """Shape and dtype of one stubbed modality input (JAX's
    ``ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclass
class Model:
    cfg: ModelConfig
    defs: Any
    _forward: Callable
    _init_cache: Callable
    _prefill: Callable
    _decode_step: Callable
    _decode_scan_body: Callable
    has_aux: bool = False

    def init(self, generator: torch.Generator, dtype=torch.bfloat16,
             device=None):
        """Random params from ``generator`` (which lives on ``device``;
        ``None`` means the generator's device)."""
        device = generator.device if device is None else device
        return init_params(self.defs, generator, device, dtype)

    def forward(self, params, tokens, *, extra=None, attn_impl="xla",
                split=None):
        """Full-sequence forward: ``(logits (B,S,V), aux)``. ``aux`` is
        the moe family's ``{"aux_loss": ...}`` (the router's load-balance
        loss) and ``{}`` for the others. ``attn_impl``: "xla" (the plain
        paths), "flash" (the flash-attention kernels: dense, moe, the
        hybrid's attention sites, the audio decoder's and the vlm's self
        layers) or "pallas" (ssm: the SSD scan kernel). ``extra``: the
        audio and vlm families' modality inputs (``make_extras``).
        ``split``: a ``models.tensor_parallel.UpdateSplit`` when a
        data-parallel update splits the batch rows over its ranks
        (``tokens`` are this rank's): the moe family groups its tokens and
        shares its aux loss by the global batch (``moe.moe_mlp``); the
        other families' rows are independent."""
        kw = {"split": split} if self.has_aux else {}
        out = self._forward(self.cfg, params, tokens, extra=extra,
                            attn_impl=attn_impl, **kw)
        return out if self.has_aux else (out, {})

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
                attn_impl="xla", **kw):
        """The prompt into the cache: ``(last-position logits, cache)``.
        ``kw``: the dense family's ``shared_prefix_len`` (paged layout)."""
        return self._prefill(self.cfg, params, tokens, cache, extra=extra,
                             attn_impl=attn_impl, **kw)

    def decode_step(self, params, token, cache, *, extra=None,
                    attn_impl="xla", advance=None, **kw):
        """One token per row; ``kw``: the paged step's ``cow``. ``extra``
        is taken and unused, as in JAX: the audio and vlm caches hold what
        prefill made of it."""
        return self._decode_step(self.cfg, params, token, cache, extra=extra,
                                 attn_impl=attn_impl, advance=advance, **kw)

    def decode_scan_body(self, params, *, extra=None, attn_impl="xla",
                         **kw):
        """``body((logits, cache), (token, advance)) -> ((logits, cache),
        None)`` for in-loop generation: the dense family's own, and for
        the others ``decode_step`` wrapped by ``transformer.
        scan_body_over``, as JAX's ``Model`` wraps families without a
        native body. ``kw``: the paged step's ``cow``. ``extra`` is
        taken and unused: every family's decode step ignores it, as in
        JAX."""
        del extra
        return self._decode_scan_body(self.cfg, params, attn_impl=attn_impl,
                                      **kw)

    def input_extras(self, batch: int) -> Dict[str, ExtraSpec]:
        """The stubbed modality inputs a ``batch``-row call takes: audio
        ``frames`` (B, n_audio_frames, D), vlm ``image_embeds`` (B,
        n_image_tokens, D), both bf16; ``{}`` for the other families."""
        cfg = self.cfg
        if cfg.family == "audio":
            return {"frames": ExtraSpec(
                (batch, cfg.n_audio_frames, cfg.d_model), torch.bfloat16)}
        if cfg.family == "vlm":
            return {"image_embeds": ExtraSpec(
                (batch, cfg.n_image_tokens, cfg.d_model), torch.bfloat16)}
        return {}

    def make_extras(self, generator: torch.Generator, batch: int,
                    device=None) -> Optional[Dict[str, torch.Tensor]]:
        """Random stand-ins for the stubbed frontends, in JAX's sorted key
        order: N(0, 1) drawn in f32 from ``generator``, cast to the spec's
        dtype, then scaled by 0.02 in that dtype (JAX's order). ``None``
        when the family takes no extras. ``device``: the generator's when
        ``None``."""
        device = generator.device if device is None else device
        out = {}
        for name, spec in sorted(self.input_extras(batch).items()):
            x = torch.randn(spec.shape, generator=generator, device=device,
                            dtype=torch.float32).to(spec.dtype)
            out[name] = x * torch.tensor(0.02, dtype=spec.dtype,
                                         device=device)
        return out or None


_FAMILIES = {
    "dense": (transformer.model_defs, transformer.forward,
              transformer.init_cache, transformer.prefill,
              transformer.decode_step, transformer.decode_scan_body, False),
    "moe": (moe.model_defs, moe.forward, moe.init_cache, moe.prefill,
            moe.decode_step, moe.decode_scan_body, True),
    "ssm": (mamba.model_defs, mamba.forward, mamba.init_cache,
            mamba.prefill, mamba.decode_step, mamba.decode_scan_body, False),
    "hybrid": (hybrid.model_defs, hybrid.forward, hybrid.init_cache,
               hybrid.prefill, hybrid.decode_step, hybrid.decode_scan_body,
               False),
    "audio": (encdec.model_defs, encdec.forward, encdec.init_cache,
              encdec.prefill, encdec.decode_step, encdec.decode_scan_body,
              False),
    "vlm": (vlm.model_defs, vlm.forward, vlm.init_cache, vlm.prefill,
            vlm.decode_step, vlm.decode_scan_body, False),
}


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    defs_fn, fwd, ic, pf, ds, body, has_aux = _FAMILIES[cfg.family]
    return Model(cfg=cfg, defs=defs_fn(cfg), _forward=fwd, _init_cache=ic,
                 _prefill=pf, _decode_step=ds, _decode_scan_body=body,
                 has_aux=has_aux)
