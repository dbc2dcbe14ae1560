"""Synthetic class-structured images and token sequences (the repository
ships no real dataset).

Examples of the same class share a latent prototype (images) or a
preferred slice of the vocabulary (tokens), so a linear probe on good
encodings separates classes. numpy ``RandomState`` code, kept equal to the
reference's draw for draw.
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


def synthetic_labeled_tokens(num_samples: int, num_classes: int, seq_len: int,
                             vocab: int, class_vocab_frac: float = 0.25,
                             seed: int = 0):
    """Token sequences whose unigram distribution is class-dependent:
    each class prefers a slice of the vocabulary. Returns (tokens (N,S) i32,
    labels (N,))."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, num_samples)
    span = max(2, int(vocab * class_vocab_frac))
    toks = np.zeros((num_samples, seq_len), np.int32)
    for i, y in enumerate(labels):
        lo = (y * span // max(num_classes, 1)) % max(vocab - span, 1)
        mix = rng.rand(seq_len) < 0.8
        toks[i] = np.where(mix, rng.randint(lo, lo + span, seq_len),
                           rng.randint(0, vocab, seq_len))
    return toks, labels.astype(np.int32)
