from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS, PORTED_ARCHS, DualEncoderConfig, ModelConfig, get_config,
    get_dual_encoder_config)
