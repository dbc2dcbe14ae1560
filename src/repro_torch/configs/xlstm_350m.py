"""xLSTM-350M: alternating mLSTM / sLSTM blocks. [arXiv:2405.04517]
24L d_model=1024 4H (kv=4) d_ff=0 (gating inside cells) vocab=50304.

Mapped as 12 x (mLSTM, sLSTM) superblocks: mLSTM uses pre-up-projection
(factor 2) and chunkwise-recurrent parallel training; sLSTM uses recurrent
per-head block-diagonal weights + post-up-projection FFN (factor 4/3).
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    source="arXiv:2405.04517 (xLSTM)",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "slstm"),
    xlstm=XLSTMConfig(chunk=128, proj_factor_mlstm=2.0, proj_factor_slstm=1.333),
)

SMOKE_CONFIG = CONFIG.replace(
    name="xlstm-smoke", num_layers=2, d_model=128, num_heads=2,
    num_kv_heads=2, vocab_size=256,
    xlstm=XLSTMConfig(chunk=16, proj_factor_mlstm=2.0, proj_factor_slstm=1.333),
    dtype="float32")
