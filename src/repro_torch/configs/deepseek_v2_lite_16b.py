"""DeepSeek-V2-Lite (16B total / 2.4B active). [arXiv:2405.04434]
27L d_model=2048, MLA (kv_lora_rank=512, rope_dim=64), MoE: 2 shared +
64 routed experts (fine-grained, d_ff=1408) top-6, first layer dense.

Full DeepSeek-V2 has 160 routed experts; the 16B-Lite model card this
entry cites has 64, and this config follows the Lite card.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    source="arXiv:2405.04434 (DeepSeek-V2-Lite)",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    block_pattern=("attn",),
    moe=MoEConfig(num_experts=64, num_shared_experts=2, top_k=6, d_ff=1408,
                  capacity_factor=1.25, balance_weight=0.01,
                  first_k_dense=1, dense_d_ff=10944),
    rope_theta=10_000.0,
)

SMOKE_CONFIG = CONFIG.replace(
    name="deepseek-v2-lite-smoke", num_layers=3, d_model=256, num_heads=4,
    num_kv_heads=4, d_ff=128, vocab_size=512, kv_lora_rank=64,
    qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32,
    moe=MoEConfig(num_experts=4, num_shared_experts=1, top_k=2, d_ff=128,
                  capacity_factor=1.5, balance_weight=0.01,
                  first_k_dense=1, dense_d_ff=512),
    dtype="float32")
