"""Two-view augmentations: for images, paper App. B's BYOL augmentations
minus blur (random crop-and-resize (nearest), flip, brightness and
contrast); for tokens, their analogue (random masking and a random
circular shift).

The random draws are explicit (:class:`AugmentDraws`,
:class:`TokenAugmentDraws`), made from a ``torch.Generator`` by
:func:`draw_augment` and :func:`draw_augment_tokens`, so a test can hand
the port the reference's draws. Everything is batched over a leading axis
and runs on the device the data live on.
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


# ------------------------------------------------------------------ tokens --

class TokenAugmentDraws(NamedTuple):
    """Per-sequence draws: which positions are masked (B, S), whether the
    sequence is rolled (B,), and by how much (B,)."""
    mask: torch.Tensor           # bool
    do_crop: torch.Tensor        # bool
    shift: torch.Tensor          # int64 in [0, max(1, int(S * max_crop_frac)))


def draw_augment_tokens(gen: torch.Generator, batch: int, seq_len: int,
                        mask_prob: float = 0.15, crop_prob: float = 0.5,
                        max_crop_frac: float = 0.25) -> TokenAugmentDraws:
    """Draws for ``batch`` sequences of ``seq_len`` on the generator's
    device (the reference's bernoulli draws are ``uniform < p``)."""
    dev = gen.device
    mask = torch.rand((batch, seq_len), generator=gen, device=dev) < mask_prob
    do_crop = torch.rand(batch, generator=gen, device=dev) < crop_prob
    shift = torch.randint(0, max(1, int(seq_len * max_crop_frac)), (batch,),
                          generator=gen, device=dev)
    return TokenAugmentDraws(mask, do_crop, shift)


def augment_tokens(tokens: torch.Tensor, draws: TokenAugmentDraws,
                   mask_token: int = 0) -> torch.Tensor:
    """Span-mask + random-crop-with-roll: the token analogue of crop and
    jitter. tokens: (B, S) -> (B, S); a rolled row is ``roll(masked,
    shift)``, ``out[i] = masked[(i - shift) mod S]``."""
    s = tokens.shape[-1]
    dev = tokens.device
    masked = torch.where(draws.mask.to(dev),
                         torch.full_like(tokens, mask_token), tokens)
    idx = (torch.arange(s, device=dev)[None, :]
           - draws.shift.to(dev)[:, None]) % s
    rolled = torch.gather(masked, 1, idx)
    return torch.where(draws.do_crop.to(dev)[:, None], rolled, masked)

