"""Zamba2-2.7B hybrid: Mamba2 backbone + periodic shared attention blocks.
[arXiv:2411.15242] 54L d_model=2560 32H (kv=32) d_ff=10240 ssm_state=64.

Mapped onto the stacked-superblock structure as 9 x (5 Mamba2 + 1
attn+FFN) = 54 layers; Zamba2's single *weight-shared* attention block is
approximated by per-superblock attention, as in the reference (weight
sharing is a memory optimization orthogonal to the paper's technique).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    source="arXiv:2411.15242 (Zamba2)",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    block_pattern=("mamba2", "mamba2", "mamba2", "mamba2", "mamba2", "attn"),
    ssm=SSMConfig(state=64, expand=2, conv_width=4, head_dim=64, chunk=128),
    rope_theta=10_000.0,
)

SMOKE_CONFIG = CONFIG.replace(
    name="zamba2-smoke", num_layers=6, d_model=256, num_heads=4,
    num_kv_heads=4, d_ff=512, vocab_size=512, head_dim=64,
    block_pattern=("mamba2", "mamba2", "attn"),
    ssm=SSMConfig(state=16, expand=2, conv_width=4, head_dim=32, chunk=32),
    dtype="float32")
