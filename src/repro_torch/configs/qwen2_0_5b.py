"""qwen2-0.5b [arXiv:2407.10671] — dense GQA, QKV bias, tied embeddings."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    arch_id="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab_size=151936, head_dim=64, qkv_bias=True, rope_theta=1e6,
    tie_embeddings=True,
    source="arXiv:2407.10671 (Qwen2 Technical Report)",
)

SMOKE_CONFIG = ModelConfig(
    arch_id="qwen2-0.5b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab_size=512, head_dim=32, qkv_bias=True, rope_theta=1e6,
    tie_embeddings=True, remat="none",
    source="reduced qwen2 family variant",
)

register(CONFIG, SMOKE_CONFIG)
