"""D-WMSE: whitening-style decorrelation through the aggregated-statistics
strategy, the third registered objective.

W-MSE (Ermolov et al. 2021) aligns the two views with an MSE term and
prevents collapse by whitening the encodings. Its penalty form — align the
views and penalise the Frobenius distance of the within-view covariance
from the identity — needs the same seven linear-in-samples statistics as
VICReg:

  invariance:  <|F - G|^2>            from <F^2>, <G^2>, diag<F G^T>
  whitening:   |Cov(F) - I|_F^2 / d   from <F F^T>, <F>   (and G likewise)
"""
from __future__ import annotations

import torch

from repro_torch.core import cco

F32 = torch.float32

WMSE_STAT_KEYS = cco.STAT_KEYS + cco.SECOND_MOMENT_KEYS


def wmse_stats(zf, zg):
    """Same seven statistics as VICReg (the within-view moment set)."""
    return cco.moment_stats(zf, zg, second_moments=True)


def wmse_stats_masked(zf, zg, mask):
    return cco.moment_stats(zf, zg, mask, second_moments=True)


def wmse_loss_from_stats(st, *, inv_weight: float = 1.0,
                         whiten_weight: float = 1.0):
    """Whitening-penalty W-MSE computed purely from statistics."""
    d = st["mean_f"].shape[0]
    # invariance: E|F-G|^2 = E F^2 + E G^2 - 2 diag(E F G^T)
    inv = (st["sq_f"] + st["sq_g"]
           - 2.0 * torch.diagonal(st["cross"])).sum() / d

    def whiten_term(cov2, mean):
        cov = cov2 - torch.outer(mean, mean)
        eye = torch.eye(d, dtype=cov.dtype, device=cov.device)
        return ((cov - eye) ** 2).sum() / d

    whiten = (whiten_term(st["cov_f"], st["mean_f"])
              + whiten_term(st["cov_g"], st["mean_g"]))
    return inv_weight * inv + whiten_weight * whiten


def wmse_loss(zf, zg, **kw):
    """Centralized large-batch W-MSE (the upper-bound baseline)."""
    return wmse_loss_from_stats(wmse_stats(zf, zg), **kw)
