"""Qwen3-8B dense decoder with per-head QK-RMSNorm. [hf:Qwen/Qwen3-8B]
36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12288,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    block_pattern=("attn",),
    rope_theta=1_000_000.0,
)

SMOKE_CONFIG = CONFIG.replace(
    name="qwen3-8b-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=2, d_ff=512, vocab_size=512, head_dim=32, dtype="float32")
