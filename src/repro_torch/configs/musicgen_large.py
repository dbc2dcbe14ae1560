"""MusicGen-Large decoder over EnCodec tokens. [arXiv:2306.05284]
48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048.

The EnCodec conv codec is a stub: the input is the discrete codec token
ids (vocab 2048, one codebook stream), so the tower is the dense decoder
over token ids.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    source="arXiv:2306.05284 (MusicGen)",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    head_dim=64,
    block_pattern=("attn",),
    modality="audio_tokens",
    rope_theta=10_000.0,
)

SMOKE_CONFIG = CONFIG.replace(
    name="musicgen-smoke", num_layers=2, d_model=256, num_heads=4,
    num_kv_heads=4, d_ff=512, vocab_size=256, head_dim=64, dtype="float32")
