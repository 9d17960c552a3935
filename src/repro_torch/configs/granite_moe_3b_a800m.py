"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-*-base family] —
MoE, 40 experts top-8, per-expert d_ff=512."""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = ModelConfig(
    arch_id="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab_size=49155, head_dim=64, rope_theta=10000.0,
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base model card (scaled)",
)

SMOKE_CONFIG = ModelConfig(
    arch_id="granite-moe-3b-a800m-smoke", family="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, head_dim=32, remat="none",
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128, capacity_factor=2.0),
    source="reduced granite-moe family variant",
)

register(CONFIG, SMOKE_CONFIG)
