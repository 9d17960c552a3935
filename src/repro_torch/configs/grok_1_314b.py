"""grok-1-314b [hf:xai-org/grok-1] — MoE, 8 experts top-2."""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = ModelConfig(
    arch_id="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=32768,
    vocab_size=131072, head_dim=128, rope_theta=10000.0,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32768),
    source="hf:xai-org/grok-1 model card",
)

SMOKE_CONFIG = ModelConfig(
    arch_id="grok-1-314b-smoke", family="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab_size=512, head_dim=32, remat="none",
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=256, capacity_factor=2.0),
    source="reduced grok family variant",
)

register(CONFIG, SMOKE_CONFIG)
