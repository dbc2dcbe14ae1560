"""TinyLlama-1.1B (llama2-architecture small). [arXiv:2401.02385]
22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    source="arXiv:2401.02385 (TinyLlama)",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    head_dim=64,
    block_pattern=("attn",),
    rope_theta=10_000.0,
)

SMOKE_CONFIG = CONFIG.replace(
    name="tinyllama-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=2, d_ff=512, vocab_size=512, head_dim=32, dtype="float32")
