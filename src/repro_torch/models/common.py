"""Shared neural-net primitives over parameter dicts of tensors.

Conventions (the reference's): every creator takes a ``torch.Generator``
and returns the param dict; linear weights keep the reference's
``(d_in, d_out)`` layout, so ``linear`` is ``x @ w + b`` and parameters
carry across from JAX without a transpose. Initialisation draws on the
CPU generator and then moves to ``device``, so a seed gives the same
parameters on every device.
"""
from __future__ import annotations

import math

import torch

from repro_torch.utils import at_least_f32

F32 = torch.float32


def dtype_of(name: str):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16, "float64": torch.float64}[name]


def truncated_normal(gen: torch.Generator, shape, lo: float = -2.0,
                     hi: float = 2.0) -> torch.Tensor:
    """Standard normal truncated to [lo, hi], by inverse CDF (f32, CPU)."""
    cdf = lambda v: 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))  # noqa: E731
    u = torch.rand(shape, generator=gen, dtype=torch.float64)
    u = cdf(lo) + u * (cdf(hi) - cdf(lo))
    x = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return x.clamp(lo, hi).to(F32)


# ----------------------------------------------------------------- linear ---

def linear_init(gen, d_in: int, d_out: int, dtype=torch.bfloat16,
                bias: bool = False, device="cpu"):
    std = 1.0 / math.sqrt(d_in)
    p = {"w": (truncated_normal(gen, (d_in, d_out)) * std).to(device, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def linear(p, x):
    """x (..., d_in) @ w (d_in, d_out) + b."""
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y.to(x.dtype)


# ------------------------------------------------------------------ norms ---

def groupnorm(x, num_groups: int, scale, bias, eps: float = 1e-5,
              axis: int = -1):
    """The reference's GroupNorm (paper Sec 4.2): the channel axis ``axis``
    is cut into ``num_groups`` groups of consecutive channels, and each
    group is normalised over its own channels ONLY, at each position (not
    over the spatial axes as ``torch.nn.functional.group_norm`` does),
    with the biased variance and ``eps`` inside the rsqrt."""
    axis = axis % x.dim()
    c = x.shape[axis]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    split = x.shape[:axis] + (num_groups, c // num_groups) + x.shape[axis + 1:]
    xf = at_least_f32(x).reshape(split)
    mu = xf.mean(axis + 1, keepdim=True)
    var = xf.var(axis + 1, correction=0, keepdim=True)
    xf = ((xf - mu) * torch.rsqrt(var + eps)).reshape(x.shape)
    bshape = [1] * x.dim()
    bshape[axis] = c
    return (xf * scale.reshape(bshape) + bias.reshape(bshape)).to(x.dtype)


# ------------------------------------------------------------------- misc ---

def mlp_init(gen, dims, dtype=torch.bfloat16, bias=True, device="cpu"):
    """Plain MLP for projection heads: dims = (d_in, h1, ..., d_out)."""
    return {"layers": [linear_init(gen, dims[i], dims[i + 1], dtype,
                                   bias=bias, device=device)
                       for i in range(len(dims) - 1)]}


def mlp(p, x):
    """ReLU between layers, none after the last."""
    n = len(p["layers"])
    for i, lp in enumerate(p["layers"]):
        x = linear(lp, x)
        if i < n - 1:
            x = torch.relu(x)
    return x
