"""Stochastic-rounding integer quantization for wire payloads.

The encode/decode pair simulates the uplink of a federated client: a
payload tensor is mapped to ``bits``-wide signed integers with one f32
scale per tensor (symmetric, amax-calibrated), shipped, and dequantized
server-side. Stochastic rounding ``floor(v + u), u ~ U[0,1)`` makes the
round trip unbiased, ``E[decode(encode(x))] = x``, so quantization noise
averages out across clients and rounds instead of accumulating as bias.

Randomness comes from an explicit ``torch.Generator``; every function also
takes the uniforms themselves (``u=`` / ``uniforms=``), which is how the
tests feed the port the reference's draws. The stacked per-client forms
run the CUDA kernel of :mod:`repro_torch.kernels.quantize`, which runs its
plain version only on CPU tensors; given the same uniforms the two are
bit-identical.
"""
from __future__ import annotations

import torch

from repro_torch import utils
from repro_torch.kernels import quantize as quantize_kernel

F32 = torch.float32

# the quantize -> dequantize arithmetic on (K, n) rows, with scales (K,)
# per row or (K, n) column-mapped: the kernel's wrapper
_qdq_formula = quantize_kernel.quant_dequant


def qmax_for_bits(bits: int) -> float:
    """Largest representable magnitude of a signed ``bits``-wide integer."""
    if not 2 <= bits <= 16:
        raise ValueError(f"bits must be in [2, 16], got {bits}")
    return float(2 ** (bits - 1) - 1)


def quant_scale(x, bits: int):
    """Per-tensor symmetric scale: amax / qmax (1/qmax for all-zero x)."""
    amax = x.to(F32).abs().max()
    return torch.where(amax > 0, amax, 1.0) / qmax_for_bits(bits)


def _uniforms(gen, shape, device):
    return torch.rand(shape, generator=gen, dtype=F32, device=device)


def quantize(gen, x, bits: int = 8, u=None):
    """Encode: x -> (q, scale) with stochastic rounding.

    q is int8 for bits <= 8 else int32; the wire cost is ``bits`` per
    element plus one f32 scale per tensor. ``u`` (uniforms of x's shape)
    replaces the draw from ``gen``.
    """
    qmax = qmax_for_bits(bits)
    scale = quant_scale(x, bits)
    if u is None:
        u = _uniforms(gen, x.shape, x.device)
    q = torch.clamp(torch.floor(x.to(F32) / scale + u), -qmax, qmax)
    return q.to(torch.int8 if bits <= 8 else torch.int32), scale


def dequantize(q, scale):
    """Decode: q * scale, always f32."""
    return q.to(F32) * scale


def quant_dequant(gen, x, bits: int = 8, u=None):
    """The full wire round trip for one tensor. |out - x| <= scale."""
    q, scale = quantize(gen, x, bits, u)
    return dequantize(q, scale)


def quant_dequant_clients(gen, xk, bits: int = 8, u=None):
    """Wire round trip for a stacked per-client payload leaf (K, ...).

    Each client row gets its own amax scale (a client only sees its own
    payload): the per-row form of the kernel. ``u`` (uniforms of xk's
    shape) replaces the draw from ``gen``.
    """
    qmax = qmax_for_bits(bits)
    k = xk.shape[0]
    flat = xk.reshape(k, -1).to(F32).contiguous()
    amax = flat.abs().amax(1)
    scales = torch.where(amax > 0, amax, 1.0) / qmax
    u = (_uniforms(gen, flat.shape, flat.device) if u is None
         else u.reshape(k, -1).to(F32).contiguous())
    return _qdq_formula(flat, u, scales, qmax).reshape(xk.shape)


def quant_dequant_payload(gen, tree_k, bits: int = 8, uniforms=None):
    """Wire round trip for a WHOLE payload tree of stacked per-client
    leaves (each (K, ...)) in one pass: the column-mapped form of the
    kernel.

    Wire semantics are those of quantizing each leaf separately: every
    client gets one amax scale PER LEAF. The leaves are concatenated to one
    (K, n_total) matrix, per-leaf scales are column-mapped across it, and
    one kernel pass covers the whole payload. ``uniforms``, a
    tree of the payload's own structure and shapes, replaces the one draw
    of (K, n_total) uniforms from ``gen``; since every element takes its
    own leaf's scale and its own uniform, the result does not depend on the
    order in which the leaves are concatenated.
    """
    qmax = qmax_for_bits(bits)
    leaves = utils.tree_leaves(tree_k)
    if not leaves:
        return tree_k
    k = leaves[0].shape[0]
    flats = [leaf.reshape(k, -1).to(F32) for leaf in leaves]
    sizes = [f.shape[1] for f in flats]
    flat = torch.cat(flats, dim=1) if len(flats) > 1 else flats[0]
    flat = flat.contiguous()
    # per-leaf per-client symmetric scales, column-mapped over the concat
    amax = torch.stack([f.abs().amax(1) for f in flats], dim=1)   # (K, L)
    scales = torch.where(amax > 0, amax, 1.0) / qmax
    col_leaf = torch.repeat_interleave(
        torch.arange(len(flats), device=flat.device),
        torch.tensor(sizes, device=flat.device))
    scol = scales[:, col_leaf]                                    # (K, n)
    if uniforms is None:
        u = _uniforms(gen, flat.shape, flat.device)
    else:
        # the payload's leaf order, whatever the order of the draws' keys
        u = torch.cat([x.reshape(k, -1).to(F32) for x in utils.tree_leaves(
            utils.tree_map(lambda _, x: x, tree_k, uniforms))], dim=1)
        if u.shape != flat.shape:
            raise ValueError(f"uniforms of shape {tuple(u.shape)} for a "
                             f"payload of {tuple(flat.shape)}")
        u = u.contiguous()
    out = _qdq_formula(flat, u, scol, qmax)
    parts = iter(torch.split(out, sizes, dim=1))
    return utils.tree_map(lambda leaf: next(parts).reshape(leaf.shape),
                          tree_k)


def payload_bytes(num_elements: int, bits: int) -> float:
    """Wire bytes for one quantized tensor: packed ``bits``-wide codes
    (sub-byte codes pack on the wire) plus the f32 scale."""
    return num_elements * bits / 8.0 + 4.0
