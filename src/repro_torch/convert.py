"""Carry parameters between the JAX reference and the port.

The reference's parameters are a tree (dicts and lists) of arrays; after
``jax.tree.map(np.asarray, params)`` it is a tree of numpy arrays, which
is what these functions take and give back. Layouts:

* convolution weights (every 4-D leaf named ``"w"``): the reference's HWIO
  <-> the port's OIHW;
* linear weights keep the reference's ``(d_in, d_out)`` layout in the port
  (``models.common.linear`` is ``x @ w + b``), so they carry across as is,
  also stacked on the transformer's leading layer axis (``(L, d_in,
  d_out)`` leaves under ``"layers"``) and in the unstacked ``"prologue"``
  list of an MoE tower's dense layers;
* an MoE layer's expert stacks (4-D ``(L, E, d, d_ff)`` leaves named
  ``"gate"``/``"up"``, ``(L, E, d_ff, d)`` named ``"down"``: not ``"w"``,
  so never transposed) and the MLA weights (the linears ``wq``,
  ``w_dkv``, ``w_uk``, ``w_uv``, ``wo`` and the ``kv_norm`` scale) carry
  across unchanged too;
* the recurrent blocks' leaves carry across unchanged: Mamba2's
  ``conv_w`` (stacked (L, W, conv_dim)) and its f32 ``A_log``, ``D`` and
  ``dt_bias``, and the sLSTM's per-head recurrent matrices ``r_i``,
  ``r_f``, ``r_z``, ``r_o`` (stacked (L, h, dh, dh): 4-D, but not named
  ``"w"``, so never transposed);
* a vision-text tower's patch projector ``vis_proj`` (an MLP whose
  ``"w"`` leaves are 2-D linears) carries across unchanged;
* every other leaf (GroupNorm and RMSNorm scales, biases, the embedding
  table) is copied unchanged, in its own type (bf16 included).
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
        x = np.ascontiguousarray(x)
        if x.dtype.name == "bfloat16":                   # bits as they are
            return torch.tensor(x.view(np.uint16), device=device).view(
                torch.bfloat16)
        return torch.tensor(x, device=device)            # a copy
    return _walk(tree, leaf)


def params_to_jax(state):
    """Port parameters -> reference parameter tree (numpy leaves)."""
    def leaf(t, name):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:                    # bits as they are
            import ml_dtypes
            x = t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        else:
            x = t.numpy()
        if name == "w" and x.ndim == 4:
            x = x.transpose(2, 3, 1, 0)                  # OIHW -> HWIO
        return np.ascontiguousarray(x)
    return _walk(state, leaf)
