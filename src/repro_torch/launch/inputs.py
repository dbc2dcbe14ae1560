"""The assigned input shapes and a stand-in tensor for every model input,
and the shapes-only trees of the parameters, the optimizer state and the
decode cache, on the ``meta`` device: shapes and dtypes only, nothing
allocated and nothing drawn.

The reference's ``ShapeDtypeStruct`` specs (``jax.ShapeDtypeStruct``,
``jax.eval_shape`` of an init) become ``torch.empty(..., device="meta")``
trees: a meta tensor carries the shape and dtype, and a model traced on
it makes meta outputs. Every tree builds in well under a second at full
width (the 16B MoE towers included), which is what the layout rules of
:mod:`repro_torch.sharding.specs` read.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.models import dual_encoder, transformer

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

# the long-context policy per attention family:
#   gqa  -> the sliding-window 8192 variant (a ring-buffer cache)
#   mla  -> the full latent cache (memory and step compute already linear)
#   ssm  -> its native O(1) state
LONG_CONTEXT_WINDOW = 8192


def arch_variant_for_shape(cfg, shape: InputShape):
    """``cfg`` with the long-context variant ``shape`` needs: a GQA tower
    at ``long_500k`` attends over a window of LONG_CONTEXT_WINDOW."""
    if shape.name == "long_500k" and not cfg.use_mla \
            and any(k == "attn" for k in cfg.block_pattern):
        return cfg.replace(sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def _spec(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def _tok(batch, seq):
    return _spec((batch, seq), torch.int32)


def _patches(cfg, batch):
    return _spec((batch, cfg.vis_patches, cfg.vis_dim), torch.bfloat16)


def train_input_specs(cfg, shape: InputShape):
    """Two augmented views for the D-CCO dual-encoder train step.

    VLM (Fig. 1c): view1 = text tokens of the full seq_len; view2 = the
    vision tower's input (stub patch embeddings + 1 BOS token).
    """
    b, s = shape.global_batch, shape.seq_len
    if cfg.modality == "vision_text":
        return {"view1": {"tokens": _tok(b, s)},
                "view2": {"tokens": _tok(b, 1),
                          "patch_embeds": _patches(cfg, b)}}
    return {"view1": {"tokens": _tok(b, s)}, "view2": {"tokens": _tok(b, s)}}


def prefill_input_specs(cfg, shape: InputShape):
    """The prompt: seq_len positions, a VLM's patches among them."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.modality == "vision_text":
        return {"tokens": _tok(b, s - cfg.vis_patches),
                "patch_embeds": _patches(cfg, b)}
    return {"tokens": _tok(b, s)}


def decode_input_specs(cfg, shape: InputShape):
    """One token a sequence."""
    return {"tokens": _tok(shape.global_batch, 1)}


def param_shapes(cfg):
    """The token tower's parameter tree (``transformer.init_params``)."""
    return transformer.init_params(cfg, None, META)


def dual_encoder_shapes(cfg, de_cfg):
    """The dual encoder's parameter tree (``init_dual_encoder``)."""
    return dual_encoder.init_dual_encoder(None, cfg, de_cfg, META)


def opt_state_shapes(opt, params):
    """``opt``'s state for a shapes-only ``params`` (Adam: f32 moments
    ``m`` and ``v`` beside the parameters and an int32 ``step``)."""
    return opt.init(params)


def cache_shapes(cfg, batch: int, max_len: int):
    """The decode cache for ``batch`` sequences of ``max_len`` positions
    (``transformer.init_cache``)."""
    return transformer.init_cache(cfg, batch, max_len, META)
