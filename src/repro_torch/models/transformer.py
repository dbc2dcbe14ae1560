"""Backbone assembly of the dense transformers: embedding, a stack of
``"attn"`` blocks (GQA attention + SwiGLU FFN, pre-RMSNorm), final norm.

As in the reference, the parameters of all superblocks are stacked along a
leading layer axis under ``params["layers"]``; the reference's
``lax.scan`` over that axis becomes a Python loop over the unbound
layers. The reference's activation and FSDP sharding constraints are
mesh-only and have no counterpart; nor do its ``remat`` (a round's phase 2
runs under ``torch.func.grad``, which refuses ``torch.utils.checkpoint``),
its parallel block and its untied unembedding, which no dense config sets.

Public entry points:
  init_params(cfg, gen, device)   -> params
  forward(cfg, params, tokens)    -> hidden (B, S, D)
The MLA/MoE/SSM/xLSTM blocks, the vision-text front end, the logits and
the decode cache are not ported yet (ROADMAP §1).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import utils
from repro_torch.models import attention as attn
from repro_torch.models.common import (dtype_of, embed, embedding_init,
                                       rmsnorm, rmsnorm_init,
                                       swiglu, swiglu_init)


def _require_dense(cfg):
    if tuple(cfg.block_pattern) != ("attn",) or cfg.modality != "text":
        raise NotImplementedError(
            f"{cfg.name}: block pattern {cfg.block_pattern} / modality "
            f"{cfg.modality!r} is not ported; the port runs dense text "
            f"transformers (ROADMAP §1, 'Transformer families')")


def _block_init(gen, cfg, dtype, device):
    d_ff = cfg.d_ff if cfg.d_ff > 0 else 4 * cfg.d_model
    return {"ln1": rmsnorm_init(cfg.d_model, device),
            "ln2": rmsnorm_init(cfg.d_model, device),
            "attn": attn.gqa_init(gen, cfg, dtype, device),
            "ffn": swiglu_init(gen, cfg.d_model, d_ff, dtype, device)}


def _block_forward(cfg, p, x, positions):
    """Full-sequence forward of one ``"attn"`` block."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + attn.gqa_forward(cfg, p["attn"], h, positions)
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + swiglu(p["ffn"], h)


def init_params(cfg, gen, device="cpu") -> Dict[str, Any]:
    """Random parameters from the CPU generator ``gen``, on ``device``;
    each superblock's leaves stacked on a leading axis under
    ``"layers"`` (``{"b0": block}``, the reference's tree)."""
    _require_dense(cfg)
    dtype = dtype_of(cfg.dtype)
    params: Dict[str, Any] = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                                device),
        "final_norm": rmsnorm_init(cfg.d_model, device),
    }
    blocks = [_block_init(gen, cfg, dtype, device)
              for _ in range(cfg.num_superblocks)]
    params["layers"] = {"b0": utils.tree_map(
        lambda *xs: torch.stack(xs), *blocks)}
    return params


def _superblock_forward(cfg, sp, x, positions):
    return _block_forward(cfg, sp["b0"], x, positions)


def _unstack(tree, n: int):
    """The stacked layer tree as ``n`` per-layer trees. ``unbind`` gives
    one backward (a stack) per leaf, where indexing would add n full-size
    gradients of the stacked leaf."""
    parts = [leaf.unbind(0) for leaf in utils.tree_leaves(tree)]
    layers = []
    for i in range(n):
        it = iter([p[i] for p in parts])
        layers.append(utils.tree_map(lambda _: next(it), tree))
    return layers


def forward(cfg, params, tokens):
    """tokens: (B, S) int -> hidden (B, S, D) after the final norm."""
    _require_dense(cfg)
    x = embed(params["embed"], tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    for sp in _unstack(params["layers"], cfg.num_superblocks):
        x = _superblock_forward(cfg, sp, x, positions)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)
