"""Paper-faithful CIFAR encoder: ResNet-14 with weight standardization
(Qiao et al. 2019) + GroupNorm(32) at every layer (paper Sec 4.2).

Public layout is the reference's (images NHWC in, pooled (B, C) out);
inside, activations are NCHW and conv weights OIHW, the layout of
``torch.nn.functional.conv2d``. ``repro_torch.convert`` maps the
reference's HWIO weights to OIHW.

Config fields used (repro_torch/configs/resnet14_cifar.py):
  resnet_stages:   blocks per stage, e.g. (2, 2, 2)
  resnet_channels: channels per stage, e.g. (64, 128, 256)
  resnet_groups:   GroupNorm group count (32; clipped to channels)
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import F32, groupnorm, truncated_normal
from repro_torch.utils import at_least_f32


def _conv_init(gen, kh, kw, cin, cout, dtype, device):
    w = truncated_normal(gen, (cout, cin, kh, kw)) / math.sqrt(kh * kw * cin)
    return {"w": w.to(device, dtype)}


def _gn_init(c, device):
    return {"scale": torch.ones((c,), dtype=F32, device=device),
            "bias": torch.zeros((c,), dtype=F32, device=device)}


def _std_weight(w):
    """Weight standardization per output channel over (cin, kh, kw), with
    the biased variance and eps 1e-5 inside the rsqrt."""
    wf = at_least_f32(w)
    mu = wf.mean(dim=(1, 2, 3), keepdim=True)
    var = wf.var(dim=(1, 2, 3), correction=0, keepdim=True)
    return ((wf - mu) * torch.rsqrt(var + 1e-5)).to(w.dtype)


def _same_pads(size: int, k: int, stride: int):
    """XLA's "SAME" padding (before, after) of one spatial axis. For a 3x3
    kernel at stride 2 on an even size this is (0, 1), not the symmetric
    (1, 1) of torch's ``padding=1``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(p, x, stride=1):
    w = _std_weight(p["w"])
    top, bottom = _same_pads(x.shape[-2], w.shape[-2], stride)
    left, right = _same_pads(x.shape[-1], w.shape[-1], stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w, stride=stride)


def block_plan(cfg):
    """Static per-block (cin, cout, stride) derived from the config."""
    plan = []
    cin = cfg.resnet_channels[0]
    for si, (n_blocks, c) in enumerate(zip(cfg.resnet_stages,
                                           cfg.resnet_channels)):
        for bi in range(n_blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            plan.append((cin, c, stride))
            cin = c
    return plan


def resnet_init(gen, cfg, dtype, device="cpu"):
    chans = cfg.resnet_channels
    p = {"stem": _conv_init(gen, 3, 3, cfg.resnet_in_channels, chans[0],
                            dtype, device),
         "stem_gn": _gn_init(chans[0], device), "blocks": []}
    for cin, c, stride in block_plan(cfg):
        blk = {
            "conv1": _conv_init(gen, 3, 3, cin, c, dtype, device),
            "gn1": _gn_init(c, device),
            "conv2": _conv_init(gen, 3, 3, c, c, dtype, device),
            "gn2": _gn_init(c, device),
        }
        if stride != 1 or cin != c:
            blk["proj"] = _conv_init(gen, 1, 1, cin, c, dtype, device)
        p["blocks"].append(blk)
    return p


def _gn(x, g, p):
    return groupnorm(x, min(g, x.shape[1]), p["scale"], p["bias"], axis=1)


def resnet_forward(cfg, p, images):
    """images: (B,H,W,C) -> pooled (B, channels[-1]) f32 (f64 for an f64
    model)."""
    g = cfg.resnet_groups
    x = images.to(p["stem"]["w"].dtype).permute(0, 3, 1, 2)
    x = torch.relu(_gn(_conv(p["stem"], x), g, p["stem_gn"]))
    for blk, (cin, c, stride) in zip(p["blocks"], block_plan(cfg)):
        h = torch.relu(_gn(_conv(blk["conv1"], x, stride), g, blk["gn1"]))
        h = _gn(_conv(blk["conv2"], h), g, blk["gn2"])
        sc = _conv(blk["proj"], x, stride) if "proj" in blk else x
        x = torch.relu(h + sc)
    return at_least_f32(x).mean(dim=(2, 3))
