"""zamba2-1.2b [arXiv:2411.15242] — hybrid Mamba2 backbone with a shared
attention block applied every 6 SSM layers."""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = ModelConfig(
    arch_id="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32000, head_dim=64, rope_theta=10000.0, attn_every=6,
    ssm=SSMConfig(state_size=64, n_heads=64, head_dim=64, conv_width=4,
                  chunk_size=256, n_groups=1, expand=2),
    source="arXiv:2411.15242 (Zamba2 suite)",
)

SMOKE_CONFIG = ModelConfig(
    arch_id="zamba2-1.2b-smoke", family="hybrid",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
    vocab_size=512, head_dim=32, attn_every=1, remat="none",
    ssm=SSMConfig(state_size=16, n_heads=8, head_dim=32, conv_width=4,
                  chunk_size=32, n_groups=1, expand=2),
    source="reduced zamba2 family variant",
)

register(CONFIG, SMOKE_CONFIG)
