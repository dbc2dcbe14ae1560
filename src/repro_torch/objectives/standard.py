"""The three registered objectives: D-CCO, D-VICReg, D-WMSE.

Each wraps its loss module (``repro_torch.core.{cco,vicreg,wmse}``) behind
the :class:`~repro_torch.objectives.base.StatsObjective` protocol. D-CCO
ships the paper's five statistics; D-VICReg and D-WMSE add the two
within-view second moments (``second_moments=True``, the kernel's
``"full"`` moment set), so their wire payload is the 7-stat dict.
"""
from __future__ import annotations

from repro_torch.core import cco, vicreg, wmse
from repro_torch.objectives.base import StatsObjective


class CCOObjective(StatsObjective):
    """Cross-correlation optimization (paper Eq. 1-3) — the default."""

    name = "dcco"
    stat_keys = cco.STAT_KEYS
    second_moments = False

    def __init__(self, lam: float = 20.0):
        self.lam = float(lam)

    def loss_from_stats(self, st):
        return cco.cco_loss_from_stats(st, self.lam)

    def __repr__(self):
        return f"CCOObjective(lam={self.lam})"


class VicRegObjective(StatsObjective):
    """VICReg (Bardes et al. 2022) from seven statistics — the extension
    the paper names as future work (Sec. 6)."""

    name = "dvicreg"
    stat_keys = vicreg.VICREG_STAT_KEYS
    second_moments = True

    def __init__(self, inv_weight: float = 25.0, var_weight: float = 25.0,
                 cov_weight: float = 1.0, gamma: float = 1.0,
                 eps: float = 1e-4):
        self.inv_weight = float(inv_weight)
        self.var_weight = float(var_weight)
        self.cov_weight = float(cov_weight)
        self.gamma = float(gamma)
        self.eps = float(eps)

    def loss_from_stats(self, st):
        return vicreg.vicreg_loss_from_stats(
            st, inv_weight=self.inv_weight, var_weight=self.var_weight,
            cov_weight=self.cov_weight, gamma=self.gamma, eps=self.eps)

    def __repr__(self):
        return (f"VicRegObjective(inv={self.inv_weight}, "
                f"var={self.var_weight}, cov={self.cov_weight})")


class WMSEObjective(StatsObjective):
    """Whitening-penalty W-MSE from the same seven statistics."""

    name = "dwmse"
    stat_keys = wmse.WMSE_STAT_KEYS
    second_moments = True

    def __init__(self, inv_weight: float = 1.0, whiten_weight: float = 1.0):
        self.inv_weight = float(inv_weight)
        self.whiten_weight = float(whiten_weight)

    def loss_from_stats(self, st):
        return wmse.wmse_loss_from_stats(
            st, inv_weight=self.inv_weight,
            whiten_weight=self.whiten_weight)

    def __repr__(self):
        return (f"WMSEObjective(inv={self.inv_weight}, "
                f"whiten={self.whiten_weight})")
