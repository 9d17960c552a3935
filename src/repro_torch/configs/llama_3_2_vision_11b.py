"""llama-3.2-vision-11b [hf:meta-llama/Llama-3.2-11B-Vision] — language
decoder with gated cross-attention image layers every 5th layer; the ViT
vision encoder + projector is STUBBED per the assignment carve-out."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    arch_id="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=128256, head_dim=128, rope_theta=500000.0,
    cross_attn_layers=(3, 8, 13, 18, 23, 28, 33, 38),
    n_image_tokens=1600,
    source="hf:meta-llama/Llama-3.2-11B-Vision model card",
)

SMOKE_CONFIG = ModelConfig(
    arch_id="llama-3.2-vision-11b-smoke", family="vlm",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab_size=512, head_dim=32, remat="none",
    cross_attn_layers=(1,), n_image_tokens=16,
    source="reduced llama-vision family variant",
)

register(CONFIG, SMOKE_CONFIG)
