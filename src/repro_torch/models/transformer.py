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
  init_params(cfg, gen, device)              -> params
  forward(cfg, params, tokens)               -> hidden (B, S, D)
  logits_from_hidden(cfg, params, hidden)    -> f32 logits (tied unembed)
  init_cache(cfg, batch, max_len, device)    -> cache
  prefill(cfg, params, tokens, cache)        -> (last logits (B, V), cache)
  decode_step(cfg, params, cache, token_ids) -> (logits (B, V), cache)

The cache is the reference's tree, ``{"layers": {"b0": {leaf: (L, ...)}},
"pos": () int32}``, its per-layer leaves stacked on the layer axis as the
parameters are. Prefill and decode run without autograd and update it in
place, layer by layer through views of the stacked leaves, so no second
stacked copy is made; they return the same dict. The MLA/MoE/SSM/xLSTM
blocks and the vision-text front end are not ported yet (ROADMAP §1).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import utils
from repro_torch.models import attention as attn
from repro_torch.models.common import (dtype_of, embed, embedding_init,
                                       rmsnorm, rmsnorm_init,
                                       swiglu, swiglu_init, unembed)


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


def logits_from_hidden(cfg, params, hidden):
    """f32 logits of the tied unembedding (every ported config ties)."""
    return unembed(params["embed"], hidden)


# ------------------------------------------------------------------ cache ---

def init_cache(cfg, batch: int, max_len: int, device="cpu"):
    """An empty decode cache for ``batch`` sequences of up to ``max_len``
    positions (a ring of ``cfg.sliding_window`` slots with a window)."""
    _require_dense(cfg)
    proto = attn.gqa_cache_init(cfg, batch, max_len, dtype_of(cfg.dtype),
                                device)
    n = cfg.num_superblocks
    return {"layers": {"b0": {k: v.expand((n,) + v.shape).clone()
                              for k, v in proto.items()}},
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _layer_caches(cache, n: int):
    """Per-layer views of the stacked cache leaves (writes reach them)."""
    stacked = cache["layers"]["b0"]
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]


def _block_prefill(cfg, p, x, positions, cache):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    y, cache = attn.gqa_prefill(cfg, p["attn"], h, positions, cache)
    x = x + y
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + swiglu(p["ffn"], h)


def _block_decode(cfg, p, x, pos, cache):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    y, cache = attn.gqa_decode(cfg, p["attn"], h, pos, cache)
    x = x + y
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + swiglu(p["ffn"], h)


@torch.no_grad()
def prefill(cfg, params, tokens, cache):
    """Run the prompt ``tokens`` (B, S), filling ``cache`` from position
    0. Returns (last-position f32 logits (B, V), cache)."""
    _require_dense(cfg)
    x = embed(params["embed"], tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    n = cfg.num_superblocks
    for sp, c in zip(_unstack(params["layers"], n), _layer_caches(cache, n)):
        x = _block_prefill(cfg, sp["b0"], x, positions, c)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    cache["pos"].fill_(s)
    return logits_from_hidden(cfg, params, x[:, -1]), cache


@torch.no_grad()
def decode_step(cfg, params, cache, token_ids):
    """One token a sequence, ``token_ids`` (B, 1), at position
    ``cache["pos"]``. Returns (f32 logits (B, V), cache)."""
    _require_dense(cfg)
    x = embed(params["embed"], token_ids)
    pos = cache["pos"]
    n = cfg.num_superblocks
    for sp, c in zip(_unstack(params["layers"], n), _layer_caches(cache, n)):
        x = _block_decode(cfg, sp["b0"], x, pos, c)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_from_hidden(cfg, params, x[:, 0])
    pos.add_(1)
    return logits, cache
