"""D-CCO loss paths of the fused (single-program) train step.

  fused      — centralized-equivalent: CCO on the differentiable global
               batch statistics. By the paper's Appendix-A theorem this
               equals one D-CCO round with one local step.
  per_client — the faithful per-client formulation: per-client statistics,
               their weighted aggregate, the stop-grad combine per client
               and the weighted per-client losses. It mirrors the
               protocol's math; its gradient equals the fused one (tested).

The reference's third path, ``shard_map`` (each device shard plays a
client cohort, its statistics summed over the mesh), needs the cohort
sharded over devices and waits for ROADMAP §1, item 6, 'Sharded and
streaming cohorts'.
"""
from __future__ import annotations

import torch

from repro_torch.core import cco

F32 = torch.float32
IMPLS = ("fused", "per_client")


def dcco_loss_fused(zf, zg, lam: float) -> torch.Tensor:
    return cco.cco_loss(zf, zg, lam)


def dcco_loss_per_client(zf, zg, lam: float, clients: int) -> torch.Tensor:
    """Faithful per-client D-CCO objective (equal-size clients laid out
    contiguously): L = sum_k (N_k/N) L_CCO(<.>_k + sg(<.>_A - <.>_k))."""
    st_k = cco.per_client_stats(zf, zg, clients)          # stacked (K, ...)
    w = torch.full((clients,), 1.0 / clients, dtype=F32, device=zf.device)
    agg = cco.weighted_average_stats(st_k, w)

    def client_loss(stats_k):
        return cco.cco_loss_from_stats(cco.dcco_combine(stats_k, agg), lam)

    return (w * torch.func.vmap(client_loss)(st_k)).sum()


def dcco_loss(zf, zg, lam: float, impl: str = "fused",
              clients: int = 0) -> torch.Tensor:
    if impl == "fused":
        return dcco_loss_fused(zf, zg, lam)
    if impl == "per_client":
        if clients < 1:
            raise ValueError(f"impl 'per_client' needs clients >= 1, got "
                             f"{clients}")
        return dcco_loss_per_client(zf, zg, lam, clients)
    if impl == "shard_map":
        raise NotImplementedError(
            "the shard_map D-CCO loss runs the cohort sharded over devices, "
            "which the port does not do yet (ROADMAP §1, item 6, 'Sharded "
            "and streaming cohorts'); use impl='fused' or 'per_client'")
    raise ValueError(f"unknown dcco impl {impl!r}; expected one of "
                     f"{IMPLS}")
