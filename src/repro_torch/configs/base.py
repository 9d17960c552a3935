"""Model configs and the registry (the port's own copy of
``repro/configs/base.py``, for the dense and ssm families).

Each config module exposes ``CONFIG`` (the published hyper-parameters,
source cited) and ``SMOKE_CONFIG`` (a reduced variant of the same family
for CPU tests) and registers both.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Optional

ARCH_IDS = ["qwen2-0.5b", "mamba2-370m"]

ARCH_REGISTRY: dict = {}


@dataclass(frozen=True)
class SSMConfig:
    state_size: int             # N: SSM state dimension
    n_heads: int                # value heads (Mamba2 "nheads")
    head_dim: int               # P: channels per head
    conv_width: int = 4
    chunk_size: int = 256       # SSD chunk length
    n_groups: int = 1           # B/C groups (GVA-style)
    expand: int = 2


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                 # dense | ssm (the families ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    source: str = ""
    ssm: Optional[SSMConfig] = None
    sliding_window: int = 0     # 0 = full attention; >0 = window size
    # remat policy for training: "none" | "full" (checkpoint each layer)
    remat: str = "full"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))


def register(cfg: ModelConfig, smoke: ModelConfig):
    ARCH_REGISTRY[cfg.arch_id] = {"full": cfg, "smoke": smoke}
    return cfg


def _load(arch_id: str):
    if arch_id not in ARCH_REGISTRY:
        if arch_id not in ARCH_IDS:
            raise KeyError(f"unknown or unported architecture {arch_id!r}; "
                           f"ported: {ARCH_IDS}")
        mod = arch_id.replace("-", "_").replace(".", "_")
        importlib.import_module(f"repro_torch.configs.{mod}")
    return ARCH_REGISTRY[arch_id]


def get_config(arch_id: str) -> ModelConfig:
    return _load(arch_id)["full"]


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _load(arch_id)["smoke"]
