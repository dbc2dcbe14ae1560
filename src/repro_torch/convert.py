"""Carry parameters between the JAX reference and the port.

The reference's parameters are a tree (dicts and lists) of arrays; after
``jax.tree.map(np.asarray, params)`` it is a tree of numpy arrays, which
is what these functions take and give back. Layouts:

* convolution weights (every 4-D leaf named ``"w"``): the reference's HWIO
  <-> the port's OIHW;
* linear weights keep the reference's ``(d_in, d_out)`` layout in the port
  (``models.common.linear`` is ``x @ w + b``), so they carry across as is;
* every other leaf (GroupNorm scale/bias, biases) is copied unchanged.
"""
from __future__ import annotations

import numpy as np
import torch


def _walk(tree, leaf_fn, name=None):
    if isinstance(tree, dict):
        return {k: _walk(v, leaf_fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, leaf_fn, name) for v in tree]
    return leaf_fn(tree, name)


def params_from_jax(tree, device="cpu"):
    """Reference parameter tree (numpy leaves) -> port parameters."""
    def leaf(x, name):
        x = np.asarray(x)
        if name == "w" and x.ndim == 4:
            x = x.transpose(3, 2, 0, 1)                  # HWIO -> OIHW
        return torch.tensor(np.ascontiguousarray(x), device=device)  # a copy
    return _walk(tree, leaf)


def params_to_jax(state):
    """Port parameters -> reference parameter tree (numpy leaves)."""
    def leaf(t, name):
        x = t.detach().cpu().numpy()
        if name == "w" and x.ndim == 4:
            x = x.transpose(2, 3, 1, 0)                  # OIHW -> HWIO
        return np.ascontiguousarray(x)
    return _walk(state, leaf)
