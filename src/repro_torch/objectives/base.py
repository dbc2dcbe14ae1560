"""StatsObjective — the protocol behind every stats-based federated loss.

A :class:`StatsObjective` declares which statistics ride the wire
(``stat_keys``, ``stat_spec``) and whether the within-view second moments
are among them (``second_moments``, the kernel's moment-set flag). It
accumulates its statistics through the one shared accumulator
(:func:`repro_torch.core.cco.moment_stats`, linear in samples so the
Eq.-3 aggregation and the flattened-cohort kernel path stay exact),
computes its loss as a pure function of statistics, and combines local
with aggregate statistics by the stop-grad rule of paper Fig. 2.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import cco

F32 = torch.float32
Stats = Dict[str, torch.Tensor]


class StatsObjective:
    """A dual-encoding loss computable from linear-in-samples statistics."""

    name: str = "stats"
    stat_keys: Tuple[str, ...] = cco.STAT_KEYS
    second_moments: bool = False

    def stats(self, zf, zg) -> Stats:
        """Batch statistics of encodings zf, zg: (N, d) -> Stats."""
        return cco.moment_stats(zf, zg, second_moments=self.second_moments)

    def stats_masked(self, zf, zg, mask) -> Stats:
        """Statistics over valid samples only (mask: (N,) in {0,1})."""
        return cco.moment_stats(zf, zg, mask,
                                second_moments=self.second_moments)

    def stat_spec(self, d: int) -> Dict[str, Tuple[int, ...]]:
        """Wire payload spec: stat key -> shape, for encoding dim ``d``.

        Derived from ``stats`` itself on the ``meta`` device (shapes only,
        no memory, no arithmetic), as the reference does with
        ``jax.eval_shape``."""
        z = torch.empty((1, d), dtype=F32, device="meta")
        return {k: tuple(v.shape) for k, v in self.stats(z, z).items()}

    def stat_template(self, d: int) -> Stats:
        """Zero payload matching ``stat_spec`` (bytes accounting)."""
        return {k: torch.zeros(s, dtype=F32)
                for k, s in self.stat_spec(d).items()}

    def loss_from_stats(self, st: Stats) -> torch.Tensor:
        raise NotImplementedError

    def combine(self, local: Stats, agg: Stats) -> Stats:
        """Stop-grad combine <.>_C = <.>_k + sg(<.>_A - <.>_k) (Fig. 2)."""
        return cco.dcco_combine(local, agg)

    def loss(self, zf, zg) -> torch.Tensor:
        """Centralized large-batch loss (the paper's upper-bound baseline)."""
        return self.loss_from_stats(self.stats(zf, zg))

    def encoding_std(self, agg: Stats) -> torch.Tensor:
        """Collapse probe on aggregated stats (mean per-dim std of F)."""
        return torch.sqrt(torch.clamp(agg["sq_f"] - agg["mean_f"] ** 2,
                                      min=0.0)).mean()

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


def per_client_loss(objective: StatsObjective, zf, zg,
                    clients: int) -> torch.Tensor:
    """Faithful per-client federated objective for any StatsObjective:
    L = sum_k (N_k/N) L(<.>_k + sg(<.>_A - <.>_k)) with equal-size clients
    laid out contiguously. Gradient-equivalent to the centralized
    ``objective.loss`` by the Appendix-A argument."""
    n, d = zf.shape
    if n % clients:
        raise ValueError(f"{n} rows do not split into {clients} equal "
                         f"clients")
    st_k = torch.func.vmap(objective.stats)(
        zf.reshape(clients, n // clients, d),
        zg.reshape(clients, n // clients, d))
    w = torch.full((clients,), 1.0 / clients, dtype=F32, device=zf.device)
    agg = cco.weighted_average_stats(st_k, w)

    def client_loss(stats_k):
        return objective.loss_from_stats(objective.combine(stats_k, agg))

    return (w * torch.func.vmap(client_loss)(st_k)).sum()
