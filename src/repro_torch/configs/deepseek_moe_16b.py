"""DeepSeekMoE-16B: fine-grained experts + shared-expert isolation.
[arXiv:2401.06066] 28L d_model=2048 16H (kv=16) vocab=102400,
2 shared + 64 routed experts (d_ff=1408) top-6, first layer dense FFN.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    source="arXiv:2401.06066 (DeepSeekMoE-16B)",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    head_dim=128,
    block_pattern=("attn",),
    moe=MoEConfig(num_experts=64, num_shared_experts=2, top_k=6, d_ff=1408,
                  capacity_factor=1.25, balance_weight=0.01,
                  first_k_dense=1, dense_d_ff=10944),
    rope_theta=10_000.0,
)

SMOKE_CONFIG = CONFIG.replace(
    name="deepseek-moe-smoke", num_layers=3, d_model=256, num_heads=4,
    num_kv_heads=4, d_ff=128, vocab_size=512, head_dim=64,
    moe=MoEConfig(num_experts=4, num_shared_experts=1, top_k=2, d_ff=128,
                  capacity_factor=1.5, balance_weight=0.01,
                  first_k_dense=1, dense_d_ff=512),
    dtype="float32")
