"""IBM Granite-3 8B dense decoder. [hf:ibm-granite/granite-3.0-2b-base]
40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    source="hf:ibm-granite/granite-3.0-2b-base (GQA family)",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    head_dim=128,
    block_pattern=("attn",),
    rope_theta=10_000.0,
)

SMOKE_CONFIG = CONFIG.replace(
    name="granite-3-8b-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=2, d_ff=512, vocab_size=512, head_dim=32, dtype="float32")
