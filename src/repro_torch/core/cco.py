"""Cross Correlation Optimization (CCO) loss and encoding statistics.

Paper Eq. 1-3. The five statistics
    <F_i>, <F_i^2>, <G_j>, <G_j^2>, <F_i G_j>
are linear in samples, so large-batch statistics are exactly weighted
averages of per-client statistics (Eq. 3) — the insight DCCO is built on.

All statistics math is at least f32 regardless of model dtype (f64 stays
f64): correlation coefficients divide near-cancelling quantities.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.sharding import dtensor
from repro_torch.utils import at_least_f32

F32 = torch.float32
Stats = Dict[str, torch.Tensor]  # mean_f/sq_f/mean_g/sq_g: (d,), cross: (d,d)

STAT_KEYS = ("mean_f", "sq_f", "mean_g", "sq_g", "cross")
# the optional within-view second moments (VICReg / W-MSE moment set)
SECOND_MOMENT_KEYS = ("cov_f", "cov_g")


def moment_stats(zf, zg, mask=None, *, second_moments: bool = False) -> Stats:
    """The five CCO statistics, dense or masked; with ``second_moments``
    also the within-view second moments cov_f = <F F^T>, cov_g = <G G^T>
    (d, d) that the VICReg-family objectives need.

    ``mask`` is ``(N,)`` in {0, 1}; rows with 0 contribute nothing and the
    normalizer is the valid-sample count (floored at 1).
    """
    zf = at_least_f32(zf)
    zg = at_least_f32(zg)
    if mask is None:
        n = zf.shape[0]
        st = {
            "mean_f": zf.mean(0),
            "sq_f": (zf * zf).mean(0),
            "mean_g": zg.mean(0),
            "sq_g": (zg * zg).mean(0),
            "cross": zf.T @ zg / n,
        }
        if second_moments:
            st["cov_f"] = zf.T @ zf / n
            st["cov_g"] = zg.T @ zg / n
        # on DTensors whose rows are sharded: each statistic reduced over
        # the ranks here (its all-reduce), so that no pending mean meets a
        # pending sum downstream
        return {k: dtensor.settle(v) for k, v in st.items()}
    w = mask.to(F32)
    n = torch.clamp(w.sum(), min=1.0)
    zf_m = zf * w[:, None]
    zg_m = zg * w[:, None]
    st = {
        "mean_f": zf_m.sum(0) / n,
        "sq_f": (zf_m * zf).sum(0) / n,
        "mean_g": zg_m.sum(0) / n,
        "sq_g": (zg_m * zg).sum(0) / n,
        "cross": zf_m.T @ zg / n,
    }
    if second_moments:
        st["cov_f"] = zf_m.T @ zf / n
        st["cov_g"] = zg_m.T @ zg / n
    return st


def encoding_stats(zf, zg) -> Stats:
    """Five batch statistics of encodings zf, zg: (N, d) -> Stats."""
    return moment_stats(zf, zg)


def encoding_stats_masked(zf, zg, mask) -> Stats:
    """Statistics over valid samples only (mask: (N,) in {0,1})."""
    return moment_stats(zf, zg, mask)


def per_client_stats(zf, zg, clients: int) -> Stats:
    """A round's encodings (N, d) as per-client stats (K leading).

    Assumes equal-size clients laid out contiguously: N = K * n_k.
    """
    n, d = zf.shape
    if n % clients:
        raise ValueError(f"{n} encodings do not split into {clients} "
                         f"equal clients")
    return torch.vmap(encoding_stats)(zf.reshape(clients, n // clients, d),
                                      zg.reshape(clients, n // clients, d))


def weighted_average_stats(stats: Stats, weights) -> Stats:
    """Aggregate stacked per-client stats (leading axis K) with weights
    N_k/N. Implements paper Eq. 3 exactly. On DTensor statistics (the
    clients' axis sharded) the weights are laid out replicated on their
    mesh and each weighted sum is reduced over the ranks (its
    all-reduce)."""
    w = weights.to(F32) / weights.to(F32).sum()
    return {k: dtensor.settle(torch.tensordot(
        dtensor.replicated(w.to(v.dtype), v), v, dims=1))
        for k, v in stats.items()}


def correlation_matrix(stats: Stats, eps: float = 1e-8,
                       var_floor: float = 1e-6):
    """C_ij per paper Eq. 2, from the five statistics.

    The variance is floored at ``var_floor * (1 + |sq|)``, a *relative*
    floor: with ``local_steps >= 2`` on tiny clients the stale stop-grad
    combine can cancel to a variance of ~0 or below while the covariance
    does not, and an absolute floor then lets |C| explode. For any healthy
    variance the max resolves to the variance and the floor is invisible.
    """
    floor_f = var_floor * (1.0 + stats["sq_f"].abs())
    floor_g = var_floor * (1.0 + stats["sq_g"].abs())
    var_f = torch.maximum(stats["sq_f"] - stats["mean_f"] ** 2, floor_f)
    var_g = torch.maximum(stats["sq_g"] - stats["mean_g"] ** 2, floor_g)
    cov = stats["cross"] - torch.outer(stats["mean_f"], stats["mean_g"])
    denom = torch.sqrt(var_f + eps)[:, None] * torch.sqrt(var_g + eps)[None, :]
    return cov / denom


def cco_loss_from_stats(stats: Stats, lam: float = 20.0) -> torch.Tensor:
    """Paper Eq. 1 with the 1/(d-1) off-diagonal normalization. On
    DTensor statistics (reduced, so replicated) each rank computes it on
    its copy (``dtensor.replicated_call``)."""
    if dtensor.is_dtensor(stats["cross"]):
        return dtensor.replicated_call(
            lambda st: cco_loss_from_stats(st, lam), stats)
    c = correlation_matrix(stats)
    d = c.shape[0]
    diag = torch.diagonal(c)
    on = ((1.0 - diag) ** 2).sum()
    off = ((c * c).sum() - (diag * diag).sum()) / (d - 1)
    return on + lam * off


def cco_loss(zf, zg, lam: float = 20.0) -> torch.Tensor:
    """Centralized large-batch CCO loss (the paper's upper-bound baseline)."""
    return cco_loss_from_stats(encoding_stats(zf, zg), lam)


def dcco_combine(local: Stats, agg: Stats) -> Stats:
    """Combined statistics <.>_C = <.>_k + sg(<.>_A - <.>_k) (paper Fig. 2).

    Value equals the aggregated statistics; gradients flow only through the
    local statistics.
    """
    return {k: local[k] + (agg[k] - local[k]).detach() for k in local}
