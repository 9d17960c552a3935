"""qwen2.5-72b [hf:Qwen/Qwen2.5-72B-Instruct] — the model EARL's own
evaluation trains (paper §3.1, Connect-Four agentic RL)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    arch_id="qwen2.5-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab_size=152064, head_dim=128, qkv_bias=True, rope_theta=1e6,
    source="hf:Qwen/Qwen2.5-72B-Instruct model card (paper §3.1)",
)

SMOKE_CONFIG = ModelConfig(
    arch_id="qwen2.5-72b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab_size=512, head_dim=32, qkv_bias=True, rope_theta=1e6, remat="none",
    source="reduced qwen2.5 family variant",
)

register(CONFIG, SMOKE_CONFIG)
