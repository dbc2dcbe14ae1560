"""Dual encoding model (paper Fig. 1): tower(s) + pooling + projection head.

The ResNet tower is ported; the transformer towers are not yet (ROADMAP
§1, "Transformer families"). The projection network follows Sec 4.2: a
3-layer MLP that *increases* dimensionality before the CCO loss.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import resnet as resnet_mod
from repro_torch.models.common import dtype_of, mlp, mlp_init
from repro_torch.utils import at_least_f32


def is_resnet(cfg) -> bool:
    return getattr(cfg, "family", "") == "resnet"


def _require_resnet(cfg):
    if not is_resnet(cfg):
        raise NotImplementedError(
            f"the {cfg.family!r} tower is not ported yet (ROADMAP §1, "
            f"'Transformer families'); only the ResNet dual encoder is")


def init_dual_encoder(gen, cfg, de_cfg, device="cpu"):
    """Random parameters from ``gen`` (a CPU ``torch.Generator`` or an int
    seed), placed on ``device``."""
    _require_resnet(cfg)
    if isinstance(gen, int):
        gen = torch.Generator().manual_seed(gen)
    dtype = dtype_of(cfg.dtype)
    d_enc = cfg.resnet_channels[-1]
    dims = (d_enc,) + tuple(de_cfg.proj_dims)
    params: Dict[str, Any] = {
        "tower": resnet_mod.resnet_init(gen, cfg, dtype, device),
        "proj": mlp_init(gen, dims, dtype, bias=True, device=device),
    }
    if not de_cfg.shared_towers:
        params["tower_g"] = resnet_mod.resnet_init(gen, cfg, dtype, device)
        params["proj_g"] = mlp_init(gen, dims, dtype, bias=True,
                                    device=device)
    return params


def encode(cfg, de_cfg, params, view, tower: str = "f"):
    """Encode one view -> (z (B, d_proj) f32 (f64 for an f64 model), aux).

    view: dict with 'images' (B,H,W,C). ``aux`` holds the transformer
    towers' auxiliary losses in the reference and is empty here.
    """
    _require_resnet(cfg)
    shared = tower == "f" or de_cfg.shared_towers
    tower_p = params["tower"] if shared else params["tower_g"]
    proj_p = params["proj"] if shared else params["proj_g"]
    pooled = resnet_mod.resnet_forward(cfg, tower_p, view["images"])
    z = mlp(proj_p, pooled.to(dtype_of(cfg.dtype)))
    return at_least_f32(z), {}
