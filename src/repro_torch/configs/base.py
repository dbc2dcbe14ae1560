"""Model configuration dataclasses and the architecture registry.

Only the ResNet family is ported; the fields kept are the ones the ResNet
dual encoder reads, with the reference's names and defaults.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
import importlib
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"
    source: str = ""                # citation for the config values
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    # resnet (paper's own encoder; family == "resnet")
    resnet_stages: Tuple[int, ...] = ()
    resnet_channels: Tuple[int, ...] = ()
    resnet_groups: int = 32
    resnet_in_channels: int = 3
    image_size: int = 32
    dtype: str = "bfloat16"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class DualEncoderConfig:
    """Paper Sec. 4.2: 3-layer projection head on top of pooled encodings."""
    proj_dims: Tuple[int, ...] = (1024, 1024, 1024)
    lambda_cco: float = 20.0        # paper's tradeoff parameter
    shared_towers: bool = True      # Fig 1(a) vs 1(b)/(c)


# the reference's registry; only PORTED_ARCHS have a module here
ARCH_IDS = (
    "internvl2-2b", "granite-3-8b", "qwen3-8b", "qwen3-1.7b",
    "deepseek-v2-lite-16b", "zamba2-2.7b", "musicgen-large",
    "tinyllama-1.1b", "xlstm-350m", "deepseek-moe-16b",
    "resnet14-cifar",
)
PORTED_ARCHS = ("resnet14-cifar",)


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch '{arch_id}'; known: {ARCH_IDS}")
    if arch_id not in PORTED_ARCHS:
        raise NotImplementedError(
            f"arch '{arch_id}' is a transformer-family model; the PyTorch "
            f"port has only {PORTED_ARCHS} so far (ROADMAP §1, 'Transformer "
            f"families')")
    return importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    mod = _module(arch_id)
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def get_dual_encoder_config(arch_id: str) -> DualEncoderConfig:
    return getattr(_module(arch_id), "DUAL_ENCODER", DualEncoderConfig())
