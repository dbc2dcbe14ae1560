"""StatsObjective — the protocol behind every stats-based federated loss.

A :class:`StatsObjective` accumulates its statistics through the one
shared accumulator (:func:`repro_torch.core.cco.moment_stats`, linear in
samples so the Eq.-3 aggregation and the flattened-cohort kernel path stay
exact), computes its loss as a pure function of statistics, and combines
local with aggregate statistics by the stop-grad rule of paper Fig. 2.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import cco

Stats = Dict[str, torch.Tensor]


class StatsObjective:
    """A dual-encoding loss computable from linear-in-samples statistics."""

    name: str = "stats"

    def stats(self, zf, zg) -> Stats:
        """Batch statistics of encodings zf, zg: (N, d) -> Stats."""
        return cco.moment_stats(zf, zg)

    def stats_masked(self, zf, zg, mask) -> Stats:
        """Statistics over valid samples only (mask: (N,) in {0,1})."""
        return cco.moment_stats(zf, zg, mask)

    def loss_from_stats(self, st: Stats) -> torch.Tensor:
        raise NotImplementedError

    def combine(self, local: Stats, agg: Stats) -> Stats:
        """Stop-grad combine <.>_C = <.>_k + sg(<.>_A - <.>_k) (Fig. 2)."""
        return cco.dcco_combine(local, agg)

    def encoding_std(self, agg: Stats) -> torch.Tensor:
        """Collapse probe on aggregated stats (mean per-dim std of F)."""
        return torch.sqrt(torch.clamp(agg["sq_f"] - agg["mean_f"] ** 2,
                                      min=0.0)).mean()

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"
