"""InternVL2-2B language backbone (InternLM2-1.8B) + stub InternViT frontend.
[arXiv:2404.16821] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.

The vision encoder (InternViT-300M) is a stub: the input is precomputed
patch embeddings (vis_dim=1024), which the MLP projector ``vis_proj`` maps
into the language model and prepends to the tokens; the dual-encoder
pairing is cross-modal (paper Fig. 1c): text tower vs vision-patch tower.
"""
from repro_torch.configs.base import DualEncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    source="arXiv:2404.16821 (InternVL2); InternLM2-1.8B backbone",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    head_dim=128,
    block_pattern=("attn",),
    modality="vision_text",
    vis_patches=256,
    vis_dim=1024,
    rope_theta=1_000_000.0,
)

SMOKE_CONFIG = CONFIG.replace(
    name="internvl2-2b-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=4, d_ff=512, vocab_size=512, head_dim=32,
    vis_patches=16, vis_dim=64, dtype="float32")

DUAL_ENCODER = DualEncoderConfig(proj_dims=(2048, 2048, 2048),
                                 shared_towers=True)
