"""The assigned input shapes and a stand-in tensor for every model input,
on the ``meta`` device: shapes and dtypes only, nothing allocated.

The reference's ``ShapeDtypeStruct`` specs (``jax.ShapeDtypeStruct``)
become ``torch.empty(..., device="meta")``: a meta tensor carries the
shape and dtype, and a model traced on it makes meta outputs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

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
