"""Synthetic class-structured images (the repository ships no real dataset).

Examples of the same class share a latent prototype, so a linear probe on
good encodings separates classes. numpy ``RandomState`` code, kept equal
to the reference's draw for draw.
"""
from __future__ import annotations

import numpy as np


def synthetic_labeled_images(num_samples: int, num_classes: int,
                             image_size: int = 16, channels: int = 3,
                             noise: float = 0.35, seed: int = 0):
    """Class prototypes + per-sample noise. Returns (images (N,H,W,C) f32 in
    [0,1]-ish, labels (N,))."""
    rng = np.random.RandomState(seed)
    protos = rng.randn(num_classes, image_size, image_size,
                       channels).astype(np.float32)
    labels = rng.randint(0, num_classes, num_samples)
    imgs = protos[labels] + noise * rng.randn(
        num_samples, image_size, image_size, channels).astype(np.float32)
    imgs = (imgs - imgs.min()) / (imgs.max() - imgs.min() + 1e-6)
    return imgs.astype(np.float32), labels.astype(np.int32)
