"""Dual encoding model (paper Fig. 1): tower(s) + pooling + projection head.

Supports the three wirings in the paper:
  (a) shared tower, two augmented views of the same input (self-supervised)
  (b) two different towers over two views
  (c) two modality-specific views (VLM: vision patches vs text tokens)

Towers: the paper's ResNet over images, and the token towers (dense, MoE,
MLA transformers; the Mamba2 hybrid and the xLSTM; the audio decoder over
codec tokens) over tokens, a vision-text tower's view with its patch
embeddings prepended (mean-pooled, with an optional (B, S) mask). The
projection network follows Sec 4.2: a 3-layer MLP that *increases*
dimensionality before the CCO loss.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import resnet as resnet_mod, transformer
from repro_torch.models.common import dtype_of, mlp, mlp_init
from repro_torch.utils import at_least_f32


def is_resnet(cfg) -> bool:
    return getattr(cfg, "family", "") == "resnet"


def input_leaf(cfg) -> str:
    """The view leaf the tower reads: ``"images"`` for the ResNet tower,
    ``"tokens"`` for a transformer tower (a vision-text view always has
    tokens; its ``"patch_embeds"`` ride beside them)."""
    return "images" if is_resnet(cfg) else "tokens"


def init_dual_encoder(gen, cfg, de_cfg, device="cpu"):
    """Random parameters from ``gen`` (a CPU ``torch.Generator`` or an int
    seed), placed on ``device``; on ``"meta"`` the tree of shapes alone,
    nothing drawn."""
    if torch.device(device).type == "meta":
        gen = None
    elif isinstance(gen, int):
        gen = torch.Generator().manual_seed(gen)
    dtype = dtype_of(cfg.dtype)
    if is_resnet(cfg):
        def tower():
            return resnet_mod.resnet_init(gen, cfg, dtype, device)
        d_enc = cfg.resnet_channels[-1]
    else:
        def tower():
            return transformer.init_params(cfg, gen, device)
        d_enc = cfg.d_model
    dims = (d_enc,) + tuple(de_cfg.proj_dims)
    params: Dict[str, Any] = {
        "tower": tower(),
        "proj": mlp_init(gen, dims, dtype, bias=True, device=device),
    }
    if not de_cfg.shared_towers:
        params["tower_g"] = tower()
        params["proj_g"] = mlp_init(gen, dims, dtype, bias=True,
                                    device=device)
    return params


def _pool(hidden, mask=None):
    """Mean-pool token encodings -> (B, D) in f32 (f64 for an f64 model);
    with a (B, S) mask, over the unmasked tokens."""
    h = at_least_f32(hidden)
    if mask is not None:
        m = mask.to(h.dtype)[..., None]
        return (h * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
    return h.mean(dim=1)


def encode(cfg, de_cfg, params, view, tower: str = "f"):
    """Encode one view -> (z (B, d_proj) f32 (f64 for an f64 model), aux).

    view: dict with 'images' (B,H,W,C) for the ResNet tower, or 'tokens'
    (B,S), a vision-text tower's optional 'patch_embeds' (B,P,vis_dim)
    (prepended) and an optional 'mask' (B,S) for a transformer tower.
    ``aux`` is an MoE tower's ``{"balance", "router_z"}`` (its losses
    summed over the layers, as the reference's), and empty for every
    other tower.
    """
    shared = tower == "f" or de_cfg.shared_towers
    tower_p = params["tower"] if shared else params["tower_g"]
    proj_p = params["proj"] if shared else params["proj_g"]
    x = view[input_leaf(cfg)]
    aux = {}
    if is_resnet(cfg):
        pooled = resnet_mod.resnet_forward(cfg, tower_p, x)
    else:
        hidden = transformer.forward(cfg, tower_p, x,
                                     view.get("patch_embeds"),
                                     return_aux=cfg.moe is not None)
        if cfg.moe is not None:
            hidden, aux = hidden
        pooled = _pool(hidden, view.get("mask"))
    z = mlp(proj_p, pooled.to(dtype_of(cfg.dtype)))
    return at_least_f32(z), aux


def encode_pair(cfg, de_cfg, params, view1, view2):
    """Encode both views (towers F and G) -> (zf, zg, aux)."""
    zf, aux1 = encode(cfg, de_cfg, params, view1, tower="f")
    zg, aux2 = encode(cfg, de_cfg, params, view2, tower="g")
    return zf, zg, {k: aux1[k] + aux2[k] for k in aux1}
