"""Shared neural-net primitives over parameter dicts of tensors.

Conventions (the reference's): every creator takes a ``torch.Generator``
and returns the param dict; linear weights keep the reference's
``(d_in, d_out)`` layout, so ``linear`` is ``x @ w + b`` and parameters
carry across from JAX without a transpose. Initialisation draws on the
generator's device and then moves to ``device``: with a CPU generator
(the dense towers' and the ResNet's) a seed gives the same parameters on
every device.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from repro_torch.sharding import dtensor
from repro_torch.utils import at_least_f32

F32 = torch.float32


def dtype_of(name: str):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16, "float64": torch.float64}[name]


def randn(gen, shape) -> torch.Tensor:
    """Standard normal f32 draws on the generator's device; with no
    generator an empty ``meta`` tensor (module docstring)."""
    if gen is None:
        return torch.empty(shape, dtype=F32, device="meta")
    return torch.randn(shape, generator=gen, dtype=F32, device=gen.device)


def truncated_normal(gen, shape, lo: float = -2.0,
                     hi: float = 2.0) -> torch.Tensor:
    """Standard normal truncated to [lo, hi], by inverse CDF (f32, on the
    generator's device; with no generator an empty ``meta`` tensor)."""
    if gen is None:
        return torch.empty(shape, dtype=F32, device="meta")
    cdf = lambda v: 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))  # noqa: E731
    u = torch.rand(shape, generator=gen, dtype=torch.float64,
                   device=gen.device)
    # in place, in the order cdf(lo) + u (cdf(hi) - cdf(lo)), then
    # sqrt(2) erfinv(2u - 1): a billion-parameter tower draws in one pass
    u.mul_(cdf(hi) - cdf(lo)).add_(cdf(lo)).mul_(2.0).sub_(1.0)
    torch.erfinv(u, out=u)
    return u.mul_(math.sqrt(2.0)).clamp_(lo, hi).to(F32)


# ----------------------------------------------------------------- linear ---

def linear_init(gen, d_in: int, d_out: int, dtype=torch.bfloat16,
                bias: bool = False, device="cpu"):
    std = 1.0 / math.sqrt(d_in)
    p = {"w": (truncated_normal(gen, (d_in, d_out)) * std).to(device, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


# The type in which a row-parallel product's partial sums cross the wire
# (the reference's ``preferred_element_type``): None is f32. XLA reduces
# a sharded contraction's f32 output before the cast back to the
# activation's type; ``set_matmul_preferred(torch.bfloat16)`` halves
# those all-reduces at a small cost in cross-device accumulation.
_MATMUL_PREFERRED = {"dtype": None}


def set_matmul_preferred(dtype) -> None:
    _MATMUL_PREFERRED["dtype"] = dtype


def linear(p, x):
    """x (..., d_in) @ w (d_in, d_out) + b, in ``x``'s type. Operands of
    two types (an f32 input to bf16 weights under bf16 compute) meet in
    the wider one, as the reference's ``einsum`` promotes them.

    On DTensors a product over a sharded contraction (a row-parallel
    weight) leaves ``Partial`` sums. They are returned pending, in the
    preferred type (:func:`set_matmul_preferred`, f32 by default) and
    not cast back: the caller's ``dtensor.settle`` reduces them (one
    all-reduce in that type) and casts, as XLA reduces the f32 product
    before the cast. A plain tensor takes none of this."""
    w = p["w"]
    if w.dtype != x.dtype:
        wide = torch.promote_types(x.dtype, w.dtype)
        y = x.to(wide) @ w.to(wide)
    else:
        y = x @ w
    if dtensor.is_pending(y):
        y = y.to(_MATMUL_PREFERRED["dtype"] or F32)
        return y + p["b"].to(y.dtype) if "b" in p else y
    if "b" in p:
        y = y + p["b"]
    return y.to(x.dtype)


# ------------------------------------------------------------------ norms ---

def rmsnorm_init(d: int, device="cpu"):
    return {"scale": torch.ones((d,), dtype=F32, device=device)}


def rmsnorm(p, x, eps: float = 1e-6):
    """RMSNorm over the last axis, computed in f32 (f64 for an f64 model)
    and cast back to ``x``'s type."""
    xf = at_least_f32(x)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


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


# ------------------------------------------------------------------- rope ---

def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, Dh), its two halves rotated pairwise by the angles of
    ``positions`` (..., S) or (S,); computed in f32 and cast back."""
    dh = x.shape[-1]
    freqs = dtensor.replicated(torch.as_tensor(
        rope_frequencies(dh, theta), device=x.device), x)
    wide = torch.promote_types(x.dtype, F32)
    angles = positions.to(F32)[..., None] * freqs             # (..., S, dh/2)
    angles = angles[..., None, :].to(wide)                    # (..., S, 1, dh/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    xf1, xf2 = x[..., : dh // 2].to(wide), x[..., dh // 2:].to(wide)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------- scan ---

# Whether ``scan_steps`` folds its steps into the batch (``fold_scans``).
_FOLD_SCANS = {"on": False}


@contextlib.contextmanager
def fold_scans():
    """Within it, :func:`scan_steps` runs its n steps as ONE call of the
    body with the steps folded into the batch (B * n rows, the carry
    broadcast over them): not the recurrence, but its shape. A shape
    trace (``launch/dryrun.py``) asks for it: it has no values, so a
    step's dependence on the one before changes nothing it measures, and
    the products, elementwise ops and saved activations are the n
    steps', shape for shape, where tracing the loop step by step (4k-32k
    positions, a chunk or a time step each) would take hours. A weight
    the body reads is read once, as XLA's cost analysis counts a
    ``while`` body once."""
    prev, _FOLD_SCANS["on"] = _FOLD_SCANS["on"], True
    try:
        yield
    finally:
        _FOLD_SCANS["on"] = prev


def scan_steps(body, carry, xs, n: int):
    """The reference's ``lax.scan`` over the step axis 1 of each of
    ``xs`` (B, n, ...): ``carry, y_t = body(carry, x_t)`` for t < n, a
    Python loop; returns (the last carry, the y_t stacked on axis 1).
    Inside :func:`fold_scans`, one call over the steps folded into the
    batch."""
    if n > 1 and _FOLD_SCANS["on"]:
        b = xs[0].shape[0]

        def spread(c):
            return c[:, None].expand(b, n, *c.shape[1:]).reshape(
                b * n, *c.shape[1:])

        out, y = body(tuple(spread(c) for c in carry),
                      tuple(x.reshape(b * n, *x.shape[2:]) for x in xs))
        return (tuple(c.reshape(b, n, *c.shape[1:])[:, -1] for c in out),
                y.reshape(b, n, *y.shape[1:]))
    ys = []
    for t in range(n):
        carry, y = body(carry, tuple(x[:, t] for x in xs))
        ys.append(y)
    return carry, torch.stack(ys, dim=1)


# -------------------------------------------------------------- embedding ---

def embedding_init(gen, vocab: int, d_model: int, dtype=torch.bfloat16,
                   device="cpu"):
    emb = randn(gen, (vocab, d_model)) * 0.02
    return {"table": emb.to(device, dtype)}


def embed(p, tokens):
    """Rows of the table: (...,) int tokens -> (..., d_model). On a
    DTensor table, :func:`_embed_spmd`."""
    if dtensor.is_dtensor(p["table"]):
        return _embed_spmd(p["table"], tokens)
    return torch.nn.functional.embedding(tokens, p["table"])


def _embed_spmd(table, tokens):
    """The vocab-parallel lookup under ``local_map``: each rank looks its
    rows' tokens up in its block of the vocabulary (zeros for the others)
    and the blocks' outputs are pending sums over the mesh dimensions
    that split the vocabulary; the caller's ``settle`` reduces them (the
    masked gather and all-reduce XLA compiles). DTensor's own rule leaves
    a masked partial whose gradient it cannot lay out in bf16."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    vocab = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    rows = dtensor.row_placements(tokens) if dtensor.is_dtensor(tokens) \
        else [Replicate()] * mesh.ndim
    tok_pl = [Replicate() if vocab[i] else rows[i] for i in range(mesh.ndim)]
    tab_pl = [Shard(0) if vocab[i] else Replicate() for i in range(mesh.ndim)]
    out_pl = [Partial() if vocab[i] else tok_pl[i] for i in range(mesh.ndim)]
    grad_pl = [Shard(0) if vocab[i] else
               (Partial() if isinstance(tok_pl[i], Shard) else Replicate())
               for i in range(mesh.ndim)]
    tokens = dtensor.replicated(tokens, table)
    v_off = dtensor.offset(table, 0)

    def local(tok, tab):
        idx = tok.long() - v_off
        hit = (idx >= 0) & (idx < tab.shape[0])
        rows_ = torch.nn.functional.embedding(
            torch.where(hit, idx, torch.zeros_like(idx)), tab)
        return rows_ * hit[..., None].to(rows_.dtype)

    return dtensor.local_map_tree(
        local, mesh, [(tokens, tok_pl, None), (table, tab_pl, grad_pl)],
        [out_pl])


def unembed(p, x):
    """Tied unembedding: (..., D) @ (V, D)^T -> f32 logits (..., V), the
    products of the model's values summed in f32 (f64 for an f64
    model)."""
    wide = torch.promote_types(x.dtype, F32)
    return torch.matmul(x.to(wide), p["table"].to(wide).T)


# ------------------------------------------------------------------- misc ---

def swiglu_init(gen, d_model: int, d_ff: int, dtype=torch.bfloat16,
                device="cpu"):
    return {"gate": linear_init(gen, d_model, d_ff, dtype, device=device),
            "up": linear_init(gen, d_model, d_ff, dtype, device=device),
            "down": linear_init(gen, d_ff, d_model, dtype, device=device)}


def swiglu(p, x):
    return linear(p["down"],
                  torch.nn.functional.silu(linear(p["gate"], x))
                  * linear(p["up"], x))


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
