"""Plain PyTorch versions of the port's kernels: the CPU path of each
wrapper, and what ``chip_smoke.py`` holds each kernel against on the card."""
from __future__ import annotations

import torch

F32 = torch.float32

MOMENT_SETS = ("cross", "full")


def _mirror_upper(m):
    """``m`` with its strict lower triangle replaced by the transpose of its
    strict upper one: exactly symmetric, as the kernel writes it."""
    upper = torch.triu(m)
    return upper + torch.triu(m, 1).T


def cco_stats_ref(zf, zg, num_valid=None, moments: str = "cross"):
    """The fused statistics kernel's function, in either moment set.

    zf, zg: (N, d). Returns a dict of f32: mean_f/sq_f/mean_g/sq_g (d,) and
    cross = zf^T zg * inv_n (d, d), with ``inv_n = 1 / max(num_valid, 1)``
    when ``num_valid`` (a scalar tensor, for pre-masked rows) is given,
    else ``1 / N``. ``moments="full"`` adds the within-view moments
    cov_f = zf^T zf * inv_n and cov_g = zg^T zg * inv_n (d, d), each
    mirrored from its upper triangle so that it is exactly symmetric.
    """
    if moments not in MOMENT_SETS:
        raise ValueError(f"unknown moment set {moments!r}; expected one of "
                         f"{MOMENT_SETS}")
    zf = zf.to(F32)
    zg = zg.to(F32)
    if num_valid is None:
        inv_n = 1.0 / zf.shape[0]
    else:
        inv_n = 1.0 / torch.clamp(torch.as_tensor(num_valid, dtype=F32,
                                                  device=zf.device), min=1.0)
    st = {
        "mean_f": zf.sum(0) * inv_n,
        "sq_f": (zf * zf).sum(0) * inv_n,
        "mean_g": zg.sum(0) * inv_n,
        "sq_g": (zg * zg).sum(0) * inv_n,
        "cross": (zf.T @ zg) * inv_n,
    }
    if moments == "full":
        st["cov_f"] = _mirror_upper((zf.T @ zf) * inv_n)
        st["cov_g"] = _mirror_upper((zg.T @ zg) * inv_n)
    return st


def quant_dequant_ref(flat, u, scales, qmax: float):
    """Stochastic-rounding quantize -> dequantize of (K, n) f32 rows:
    ``clip(floor(flat / s + u), -qmax, qmax) * s``, with ``s`` one scale per
    row (``scales`` of shape (K,)) or column-mapped (``scales`` of shape
    (K, n)). ``u`` holds the uniforms in [0, 1). The formula of
    ``repro/comm/quantize.py::_qdq_formula``; IEEE division, so it is
    bit-identical to the kernel given the same inputs."""
    s = scales[:, None] if scales.dim() == 1 else scales
    q = torch.clamp(torch.floor(flat / s + u), -qmax, qmax)
    return q * s


def segment_sum_ref(rows, ids, num_segments: int, weights=None):
    """Weighted segment sum: ``out[e] = sum_{k: ids[k] == e} w_k * rows[k]``
    for e in [0, num_segments); ids outside that range (the padding id
    ``num_segments``) contribute nothing, an empty segment is zeros.

    rows: (K, D), ids: (K,) int, weights: (K,) or None (w = 1) -> (E, D)
    f32. Each element is summed over k in ascending order as
    ``acc + (w_k * x)`` from ``acc = 0``, two separate roundings with no
    fused multiply-add, which is what the kernel does: the two are equal
    bit for bit. One vectorised step per rank within a segment (the
    largest segment's size), so no index repeats inside a step."""
    rows = rows.to(F32)
    k, d = rows.shape
    out = torch.zeros((num_segments, d), dtype=F32, device=rows.device)
    ids = ids.to(torch.int64)
    valid = (ids >= 0) & (ids < num_segments)
    if k == 0 or not bool(valid.any()):
        return out
    w = (torch.ones((k,), dtype=F32, device=rows.device) if weights is None
         else weights.to(F32))
    safe = torch.where(valid, ids, 0)
    onehot = torch.nn.functional.one_hot(safe, num_segments) * valid[:, None]
    rank = onehot.cumsum(0).gather(1, safe[:, None])[:, 0] - 1
    for r in range(int(rank[valid].max()) + 1):
        sel = valid & (rank == r)
        e = ids[sel]
        out[e] = out[e] + w[sel][:, None] * rows[sel]
    return out
