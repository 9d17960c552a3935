"""stablelm-12b [hf:stabilityai/stablelm-2-1_6b family] — dense GQA."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    arch_id="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=13824,
    vocab_size=100352, head_dim=160, rope_theta=10000.0,
    source="hf:stabilityai/stablelm-2-12b model card",
)

SMOKE_CONFIG = ModelConfig(
    arch_id="stablelm-12b-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
    vocab_size=512, head_dim=64, remat="none",
    source="reduced stablelm family variant",
)

register(CONFIG, SMOKE_CONFIG)
