"""glm4-9b [hf:THUDM/glm-4-9b] — dense, RoPE, GQA kv=2."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    arch_id="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab_size=151552, head_dim=128, rope_theta=10000.0,
    source="hf:THUDM/glm-4-9b model card",
)

SMOKE_CONFIG = ModelConfig(
    arch_id="glm4-9b-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
    vocab_size=512, head_dim=64, remat="none",
    source="reduced glm4 family variant",
)

register(CONFIG, SMOKE_CONFIG)
