"""The registered objectives. Only D-CCO is ported so far; D-VICReg and
D-WMSE need the ``"full"`` moment set (ROADMAP §1, first item)."""
from __future__ import annotations

from repro_torch.core import cco
from repro_torch.objectives.base import StatsObjective


class CCOObjective(StatsObjective):
    """Cross-correlation optimization (paper Eq. 1-3) — the default."""

    name = "dcco"

    def __init__(self, lam: float = 20.0):
        self.lam = float(lam)

    def loss_from_stats(self, st):
        return cco.cco_loss_from_stats(st, self.lam)

    def __repr__(self):
        return f"CCOObjective(lam={self.lam})"
