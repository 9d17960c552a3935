"""llama3-405b [arXiv:2407.21783] — dense GQA, 128K vocab, 126 layers."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    arch_id="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, d_ff=53248,
    vocab_size=128256, head_dim=128, rope_theta=500000.0,
    source="arXiv:2407.21783 (Llama 3 Herd of Models)",
)

SMOKE_CONFIG = ModelConfig(
    arch_id="llama3-405b-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, d_ff=512,
    vocab_size=512, head_dim=32, remat="none",
    source="reduced llama3 family variant",
)

register(CONFIG, SMOKE_CONFIG)
