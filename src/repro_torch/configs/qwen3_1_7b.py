"""Qwen3-1.7B dense decoder with per-head QK-RMSNorm. [hf:Qwen/Qwen3-8B]
28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    source="hf:Qwen/Qwen3-8B (1.7B sibling)",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=6144,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    block_pattern=("attn",),
    rope_theta=1_000_000.0,
)

SMOKE_CONFIG = CONFIG.replace(
    name="qwen3-1.7b-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=4, d_ff=512, vocab_size=512, head_dim=32, dtype="float32")
