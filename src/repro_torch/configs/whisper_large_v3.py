"""whisper-large-v3 [arXiv:2212.04356] — encoder-decoder audio backbone.
Conv/mel frontend STUBBED per assignment carve-out (input_specs feeds
1500-frame embeddings). RoPE + SwiGLU adaptations noted in DESIGN.md."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    arch_id="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120,
    vocab_size=51866, head_dim=64, rope_theta=10000.0,
    is_encoder_decoder=True, n_encoder_layers=32, n_audio_frames=1500,
    source="arXiv:2212.04356 (Whisper); hf:openai/whisper-large-v3",
)

SMOKE_CONFIG = ModelConfig(
    arch_id="whisper-large-v3-smoke", family="audio",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
    vocab_size=512, head_dim=32, remat="none",
    is_encoder_decoder=True, n_encoder_layers=2, n_audio_frames=64,
    source="reduced whisper family variant",
)

register(CONFIG, SMOKE_CONFIG)
