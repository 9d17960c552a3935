"""Model configs and the registry (the port's own copy of
``repro/configs/base.py``).

Each config module exposes ``CONFIG`` (the published hyper-parameters,
source cited) and ``SMOKE_CONFIG`` (a reduced variant of the same family
for CPU tests) and registers both. Every architecture of the JAX package
has its config here; ``models/registry.build_model`` serves the dense,
ssm, moe and hybrid families, and raises for audio and vlm.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Optional, Tuple

ARCH_IDS = [
    "qwen2-0.5b",
    "stablelm-12b",
    "glm4-9b",
    "granite-moe-3b-a800m",
    "whisper-large-v3",
    "zamba2-1.2b",
    "grok-1-314b",
    "llama-3.2-vision-11b",
    "mamba2-370m",
    "llama3-405b",
    # the paper's own training model (Qwen2.5-72B-Instruct, §3.1)
    "qwen2.5-72b",
]

ARCH_REGISTRY: dict = {}


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int           # hidden size of each expert FFN
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


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
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
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
    source: str = ""            # citation for the config
    # MoE
    moe: Optional[MoEConfig] = None
    moe_every: int = 1          # MoE layer every k layers (1 = all)
    moe_dispatch: str = "onehot"   # "onehot" | "scatter" (models/moe.py)
    # SSM / hybrid
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0         # hybrid: shared attn block every k ssm layers
    # enc-dec (audio)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500  # stubbed conv-frontend output length
    # VLM
    cross_attn_layers: Tuple[int, ...] = ()   # decoder layers w/ image x-attn
    n_image_tokens: int = 0
    # long-context decode policy
    sliding_window: int = 0     # 0 = full attention; >0 = window size
    # numerics
    dtype: str = "bfloat16"
    # remat policy for training: "none" | "full" (checkpoint each layer)
    remat: str = "full"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.vocab_size
        hd = self.head_dim_
        n = v * d                                  # token embedding
        if not self.tie_embeddings:
            n += v * d                             # lm head
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        dense_mlp = 3 * d * self.d_ff              # SwiGLU
        if self.family in ("ssm", "hybrid"):
            s = self.ssm
            d_inner = s.n_heads * s.head_dim
            per = (d * (2 * d_inner + 2 * s.n_groups * s.state_size
                        + s.n_heads)
                   + d_inner * d + s.n_heads)      # in/out proj + dt/A
            n += self.n_layers * (per + 2 * d)
            if self.family == "hybrid":            # one shared attn block
                n += attn + dense_mlp + 2 * d
        elif self.family == "moe":
            m = self.moe
            expert_mlp = 3 * d * m.d_ff_expert
            router = d * m.n_experts
            n += self.n_layers * (attn + m.n_experts * expert_mlp + router
                                  + 2 * d)
        elif self.family == "audio":
            # encoder + decoder blocks; decoder has cross-attn
            n += self.n_encoder_layers * (attn + dense_mlp + 2 * d)
            n += self.n_layers * (2 * attn + dense_mlp + 3 * d)
        elif self.family == "vlm":
            n += self.n_layers * (attn + dense_mlp + 2 * d)
            n += len(self.cross_attn_layers) * (attn + 2 * d)
        else:                                      # dense
            n += self.n_layers * (attn + dense_mlp + 2 * d)
        return int(n)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        if self.family != "moe":
            return self.param_count()
        m = self.moe
        expert_mlp = 3 * self.d_model * m.d_ff_expert
        inactive = self.n_layers * (m.n_experts - m.top_k) * expert_mlp
        return int(self.param_count() - inactive)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def register(cfg: ModelConfig, smoke: ModelConfig):
    ARCH_REGISTRY[cfg.arch_id] = {"full": cfg, "smoke": smoke}
    return cfg


def _load(arch_id: str):
    if arch_id not in ARCH_REGISTRY:
        if arch_id not in ARCH_IDS:
            raise KeyError(f"unknown architecture {arch_id!r}; known: "
                           f"{ARCH_IDS}")
        mod = arch_id.replace("-", "_").replace(".", "_")
        importlib.import_module(f"repro_torch.configs.{mod}")
    return ARCH_REGISTRY[arch_id]


def get_config(arch_id: str) -> ModelConfig:
    return _load(arch_id)["full"]


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _load(arch_id)["smoke"]


def list_archs():
    return list(ARCH_IDS)


def with_sliding_window(cfg: ModelConfig, window: int) -> ModelConfig:
    """Dense-arch long-context decode variant: the same config with a
    sliding attention window."""
    return replace(cfg, sliding_window=window)
