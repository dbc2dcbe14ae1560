"""Model configuration dataclasses and the architecture registry.

Every arch of the reference's registry is ported: the ResNet family, the
dense GQA transformers, the DeepSeek family (MoE FFN, MLA attention), the
recurrent families (zamba2-2.7b's Mamba2 hybrid, xlstm-350m's
mLSTM/sLSTM), the vision-text tower (internvl2-2b: projected patch
embeddings prepended to the tokens) and the audio decoder over codec
tokens (musicgen-large); the fields kept are the ones their dual encoders
read, with the reference's names and defaults.
The knobs the reference's dry run drives are kept with its names and
defaults: ``remat``, ``parallel_block`` and the mesh-only
``act_shard_axes`` and ``fsdp_model_size`` (``models/transformer.py``).
Its layer-scan options ``scan_layers`` and ``layer_chunks`` have no
counterpart (the layers are a Python loop, with no ``while`` loop to
hoist a gather out of), nor do ``attn_block``, ``tie_embeddings`` (every
ported config ties) and the dual encoder's ``pool`` (always the mean):
no config sets them away from the default.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
import importlib
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0            # routed experts
    num_shared_experts: int = 0     # always-on experts (DeepSeek style)
    top_k: int = 0
    d_ff: int = 0                   # per-expert hidden dim
    capacity_factor: float = 1.25
    balance_weight: float = 0.01    # aux load-balance loss weight
    first_k_dense: int = 0          # first K layers use a dense FFN instead
    dense_d_ff: int = 0             # hidden dim of those dense layers


@dataclass(frozen=True)
class SSMConfig:
    state: int = 64                 # N: SSM state size
    expand: int = 2                 # d_inner = expand * d_model
    conv_width: int = 4
    head_dim: int = 64              # Mamba2 head dim (d_inner / heads)
    chunk: int = 128                # chunked-scan block length


@dataclass(frozen=True)
class XLSTMConfig:
    # mLSTM / sLSTM cell sizes; heads come from ModelConfig.num_heads.
    chunk: int = 128                # mLSTM chunkwise-recurrent block length
    proj_factor_mlstm: float = 2.0  # pre-up-projection factor for mLSTM blocks
    proj_factor_slstm: float = 1.333  # post-up-projection (ffn) factor for sLSTM


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
    head_dim: int = 0               # 0 -> d_model // num_heads
    # block pattern, cycled over layers (stacked per superblock slot):
    # "attn" (attention + FFN/MoE), "mamba2", "mlstm", "slstm"
    block_pattern: Tuple[str, ...] = ("attn",)
    # attention details
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0         # 0 = full attention
    # MLA (DeepSeek-V2 multi-head latent attention)
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0            # kept for the reference's configs; no
                                    # config sets it (wq is full rank)
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128
    # routed-expert FFN (DeepSeekMoE); None = a dense SwiGLU FFN
    moe: Optional[MoEConfig] = None
    # recurrent blocks: Mamba2 (SSD) and xLSTM cell sizes
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # decode KV cache storage: "model" (the model's dtype) or "int8"
    # (max-abs per position and head, one f32 scale each); the MLA cache
    # and the recurrent blocks' states ignore it, as the reference's do
    kv_cache_dtype: str = "model"
    # modality ("text" | "vision_text" | "audio_tokens")
    modality: str = "text"
    vis_patches: int = 0            # VLM: number of patch embeddings prepended
    vis_dim: int = 0                # VLM: stub ViT output dim
    # resnet (paper's own encoder; family == "resnet")
    resnet_stages: Tuple[int, ...] = ()
    resnet_channels: Tuple[int, ...] = ()
    resnet_groups: int = 32
    resnet_in_channels: int = 3
    image_size: int = 32
    # norm / numerics
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # attention impl: "blockwise" (the CUDA flash-attention kernel for
    # Sq > 1) or "naive" (materialized scores, plain torch)
    attn_impl: str = "blockwise"
    # remat policy of the layer stack: "none" | "full" (each superblock
    # under torch.utils.checkpoint)
    remat: str = "none"
    # PaLM-style parallel attention + FFN off one norm
    parallel_block: bool = False
    # mesh axes each block's output rows are sharded over (DTensor only)
    act_shard_axes: Optional[Tuple[str, ...]] = None
    # FSDP: the "model" axis size each layer's weights are re-sharded
    # over at superblock entry (0 = off; DTensor only)
    fsdp_model_size: int = 0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def num_prologue(self) -> int:
        return self.moe.first_k_dense if self.moe is not None else 0

    @property
    def num_superblocks(self) -> int:
        scanned = self.num_layers - self.num_prologue
        assert scanned % len(self.block_pattern) == 0, (
            f"{self.name}: scanned layers {scanned} not divisible by "
            f"pattern len {len(self.block_pattern)}")
        return scanned // len(self.block_pattern)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class DualEncoderConfig:
    """Paper Sec. 4.2: 3-layer projection head on top of pooled encodings."""
    proj_dims: Tuple[int, ...] = (1024, 1024, 1024)
    lambda_cco: float = 20.0        # paper's tradeoff parameter
    shared_towers: bool = True      # Fig 1(a) vs 1(b)/(c)


@dataclass(frozen=True)
class TrainConfig:
    """The fused train step's batch and loss path (the reference's
    fields that the step and the CLI read)."""
    global_batch: int = 8
    samples_per_client: int = 1     # clients/round = global_batch //
                                    # samples_per_client
    # D-CCO path: "fused" (centralized-equivalent) | "per_client" (the
    # faithful per-client stop-grad combine) | "shard_map" (the batch
    # sharded over a mesh's ranks, core/dcco.py)
    dcco_impl: str = "fused"


# the reference's registry, every arch with a module here
ARCH_IDS = (
    "internvl2-2b", "granite-3-8b", "qwen3-8b", "qwen3-1.7b",
    "deepseek-v2-lite-16b", "zamba2-2.7b", "musicgen-large",
    "tinyllama-1.1b", "xlstm-350m", "deepseek-moe-16b",
    "resnet14-cifar",
)

def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch '{arch_id}'; known: {ARCH_IDS}")
    return importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    mod = _module(arch_id)
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def get_dual_encoder_config(arch_id: str) -> DualEncoderConfig:
    return getattr(_module(arch_id), "DUAL_ENCODER", DualEncoderConfig())
