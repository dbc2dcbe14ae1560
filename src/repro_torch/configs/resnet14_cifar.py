"""The paper's own CIFAR-100 encoder: ResNet-14 with weight standardization
+ GroupNorm(32) (paper Sec 4.2), 3-layer [1024,1024,1024] projection head,
lambda = 20 (Sec 4.3)."""
from repro_torch.configs.base import DualEncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="resnet14-cifar",
    family="resnet",
    source="paper Sec 4.2 (He et al. 2016 ResNet-14, WS+GN variant)",
    num_layers=14,
    d_model=256,                 # final feature width
    vocab_size=0,
    d_ff=0,
    num_heads=1, num_kv_heads=1,
    resnet_stages=(2, 2, 2),
    resnet_channels=(64, 128, 256),
    resnet_groups=32,
    resnet_in_channels=3,
    image_size=32,
    dtype="float32",
)

SMOKE_CONFIG = CONFIG.replace(
    name="resnet14-smoke",
    resnet_stages=(1, 1),
    resnet_channels=(16, 32),
    resnet_groups=8,
    d_model=32,
    image_size=16,
)

DUAL_ENCODER = DualEncoderConfig(proj_dims=(1024, 1024, 1024), lambda_cco=20.0,
                                 shared_towers=True)
