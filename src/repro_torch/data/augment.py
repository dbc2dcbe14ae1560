"""Two-view image augmentations (paper App. B: BYOL augmentations minus
blur): random crop-and-resize (nearest), flip, brightness and contrast.

The random draws are explicit (:class:`AugmentDraws`), made from a
``torch.Generator`` by :func:`draw_augment`, so a test can hand the port
the reference's draws. Everything is batched over a leading axis and runs
on the device the images live on.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AugmentDraws(NamedTuple):
    """Per-image draws, each (B,): crop offsets, flip, and the uniforms of
    brightness and contrast."""
    top: torch.Tensor            # int64
    left: torch.Tensor           # int64
    flip: torch.Tensor           # bool
    u_brightness: torch.Tensor   # f32 in [0, 1)
    u_contrast: torch.Tensor     # f32 in [0, 1)


def draw_augment(gen: torch.Generator, batch: int, h: int, w: int,
                 crop_frac: float = 0.8) -> AugmentDraws:
    """Draws for ``batch`` images of (h, w) on the generator's device."""
    dev = gen.device
    ch, cw = int(h * crop_frac), int(w * crop_frac)
    top = torch.randint(0, h - ch + 1, (batch,), generator=gen, device=dev)
    # the reference draws top and left from ONE key (augment.py:21-22), so
    # on square images the two offsets are equal and every crop lies on
    # the diagonal; a faithful port reproduces that
    left = top if h == w else torch.randint(0, w - cw + 1, (batch,),
                                            generator=gen, device=dev)
    flip = torch.rand(batch, generator=gen, device=dev) < 0.5
    u_b = torch.rand(batch, generator=gen, device=dev)
    u_c = torch.rand(batch, generator=gen, device=dev)
    return AugmentDraws(top, left, flip, u_b, u_c)


def augment_images(imgs: torch.Tensor, draws: AugmentDraws,
                   crop_frac: float = 0.8) -> torch.Tensor:
    """Random crop-and-resize (nearest), flip, color jitter.
    imgs: (B,H,W,C) -> (B,H,W,C)."""
    b, h, w, _ = imgs.shape
    ch, cw = int(h * crop_frac), int(w * crop_frac)
    dev = imgs.device
    # nearest-neighbour resize of the crop back to (h, w)
    ridx = torch.arange(h, device=dev) * ch // h
    cidx = torch.arange(w, device=dev) * cw // w
    rows = draws.top.to(dev)[:, None] + ridx[None, :]           # (B, h)
    cols = draws.left.to(dev)[:, None] + cidx[None, :]          # (B, w)
    bi = torch.arange(b, device=dev)[:, None, None]
    out = imgs[bi, rows[:, :, None], cols[:, None, :]]          # (B,h,w,C)
    out = torch.where(draws.flip.to(dev)[:, None, None, None],
                      out.flip(2), out)
    brightness = 1.0 + 0.4 * (draws.u_brightness.to(dev) - 0.5)
    contrast = 1.0 + 0.4 * (draws.u_contrast.to(dev) - 0.5)
    mean = out.mean(dim=(1, 2, 3), keepdim=True)
    return torch.clamp((out - mean) * contrast[:, None, None, None]
                       + mean * brightness[:, None, None, None], 0.0, 1.0)


def two_views_image(gen: torch.Generator, imgs: torch.Tensor):
    """Two independently augmented views of each image in (B,H,W,C)."""
    b, h, w, _ = imgs.shape
    return (augment_images(imgs, draw_augment(gen, b, h, w)),
            augment_images(imgs, draw_augment(gen, b, h, w)))
