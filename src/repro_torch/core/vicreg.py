"""D-VICReg: the paper's distributed-statistics strategy applied to VICReg
(Bardes et al. 2022), the extension the paper names as future work
(Sec. 6).

VICReg needs seven linear-in-samples statistics (DCCO's five plus the two
within-view second-moment matrices), so the same aggregate / redistribute
/ stop-grad-combine machinery, and the Appendix-A equivalence, apply:

  invariance:  <|F - G|^2>        from <F^2>, <G^2>, diag<F G^T>
  variance:    hinge(g - std(F)) from <F>, <F^2> (and G likewise)
  covariance:  off-diag Cov(F)^2 from <F F^T>, <F> (and G likewise)
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import cco

VICREG_STAT_KEYS = cco.STAT_KEYS + cco.SECOND_MOMENT_KEYS


def vicreg_stats(zf, zg) -> Dict[str, torch.Tensor]:
    """Seven statistics: DCCO's five + within-view second moments."""
    return cco.moment_stats(zf, zg, second_moments=True)


def vicreg_stats_masked(zf, zg, mask) -> Dict[str, torch.Tensor]:
    """Masked variant, through the same shared accumulator as CCO's."""
    return cco.moment_stats(zf, zg, mask, second_moments=True)


def vicreg_loss_from_stats(st, *, inv_weight: float = 25.0,
                           var_weight: float = 25.0, cov_weight: float = 1.0,
                           gamma: float = 1.0, eps: float = 1e-4):
    """VICReg (Bardes et al. 2022 Eq. 6) computed purely from statistics."""
    d = st["mean_f"].shape[0]
    # invariance: E|F-G|^2 = E F^2 + E G^2 - 2 diag(E F G^T)
    inv = (st["sq_f"] + st["sq_g"]
           - 2.0 * torch.diagonal(st["cross"])).sum() / d

    def var_term(sq, mean):
        var = torch.clamp(sq - mean ** 2, min=0.0)
        return torch.relu(gamma - torch.sqrt(var + eps)).mean()

    var = (var_term(st["sq_f"], st["mean_f"])
           + var_term(st["sq_g"], st["mean_g"]))

    def cov_term(cov2, mean):
        cov = cov2 - torch.outer(mean, mean)
        off = (cov * cov).sum() - (torch.diagonal(cov) ** 2).sum()
        return off / d

    covp = (cov_term(st["cov_f"], st["mean_f"])
            + cov_term(st["cov_g"], st["mean_g"]))
    return inv_weight * inv + var_weight * var + cov_weight * covp


def vicreg_loss(zf, zg, **kw):
    """Centralized large-batch VICReg."""
    return vicreg_loss_from_stats(vicreg_stats(zf, zg), **kw)


def dvicreg_loss_per_client(zf, zg, clients: int, **kw):
    """Faithful D-VICReg objective: per-client stats, weighted aggregate,
    stop-grad combine (paper Fig. 2 with VICReg's seven statistics)."""
    # objectives.standard imports this module, so the objective is looked
    # up at call time
    from repro_torch.objectives import base, standard
    return base.per_client_loss(standard.VicRegObjective(**kw), zf, zg,
                                clients)
