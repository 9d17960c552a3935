"""mamba2-370m [arXiv:2405.21060] — pure SSM (SSD), attention-free."""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = ModelConfig(
    arch_id="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50280, tie_embeddings=True,
    ssm=SSMConfig(state_size=128, n_heads=32, head_dim=64, conv_width=4,
                  chunk_size=256, n_groups=1, expand=2),
    source="arXiv:2405.21060 (Mamba2 / SSD), mamba2-370m scale",
)

SMOKE_CONFIG = ModelConfig(
    arch_id="mamba2-370m-smoke", family="ssm",
    n_layers=2, d_model=128, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=512, tie_embeddings=True, remat="none",
    ssm=SSMConfig(state_size=16, n_heads=8, head_dim=32, conv_width=4,
                  chunk_size=32, n_groups=1, expand=2),
    source="reduced mamba2 family variant",
)

register(CONFIG, SMOKE_CONFIG)
