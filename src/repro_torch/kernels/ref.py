"""Plain PyTorch versions of the port's kernels: the CPU path of each
wrapper, and what ``chip_smoke.py`` holds each kernel against on the card."""
from __future__ import annotations

import torch

F32 = torch.float32


def cco_stats_ref(zf, zg, num_valid=None):
    """The ``"cross"`` moment set of the fused statistics kernel.

    zf, zg: (N, d). Returns a dict of f32: mean_f/sq_f/mean_g/sq_g (d,) and
    cross = zf^T zg * inv_n (d, d), with ``inv_n = 1 / max(num_valid, 1)``
    when ``num_valid`` (a scalar tensor, for pre-masked rows) is given,
    else ``1 / N``.
    """
    zf = zf.to(F32)
    zg = zg.to(F32)
    if num_valid is None:
        inv_n = 1.0 / zf.shape[0]
    else:
        inv_n = 1.0 / torch.clamp(torch.as_tensor(num_valid, dtype=F32,
                                                  device=zf.device), min=1.0)
    return {
        "mean_f": zf.sum(0) * inv_n,
        "sq_f": (zf * zf).sum(0) * inv_n,
        "mean_g": zg.sum(0) * inv_n,
        "sq_g": (zg * zg).sum(0) * inv_n,
        "cross": (zf.T @ zg) * inv_n,
    }
