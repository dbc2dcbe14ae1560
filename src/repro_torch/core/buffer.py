"""Staleness-weighted server-side stats buffer (FedBuff-style).

The semi-synchronous engine (``EngineConfig.async_k``) decouples client
dispatch from the server update: every scheduler tick dispatches a cohort,
each client's contribution (phase-1 stats + phase-2 delta) "arrives"
``delay`` ticks later (:mod:`repro_torch.data.latency`), and the server
applies its update as soon as ``K`` contributions have accumulated.

This module owns the two pieces of state that ride the engine's carry
(``EngineCarry.buffer``) and the folds over them:

  * an in-flight ring (:class:`StalenessBuffer` with a leading
    ``(horizon,)`` axis): slot ``j`` holds the staleness-weighted partial
    sums of contributions arriving ``j`` ticks from now, plus per-slot
    counters (mass / count / staleness mass). Dispatch scatters a cohort
    into its delay buckets with ONE weighted segment-sum launch
    (:func:`repro_torch.hierarchy.fold_to_edges`, the fold the hierarchy
    uses) and the count with one more; the staleness weight rides the
    fold's weight vector. Memory is O(horizon * (stats + params));
  * the arrived buffer (:class:`StalenessBuffer`, scalar counters): each
    tick pops ring slot 0 into it; when ``count >= K`` the engine applies
    ``server_update.step`` on the mass-normalized delta and resets it.

Every update is a device ``torch.where`` on a device condition: nothing
here waits for the host. The reference runs this fold through
``jax.ops.segment_sum``; the port has one route, the kernel's wrapper
(deterministic on the card, the plain version on CPU tensors).

Exactness (paper Eq. 3): statistics are linear in samples, so the buffer
re-associates the flat weighted sum ``sum_i w_i s(tau_i) x_i``. With unit
staleness weights, zero latency and ``K = cohort`` the fold IS the
synchronous round's fold, which is why that configuration collapses to the
sync body bit-identically.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import utils
from repro_torch.hierarchy.aggregation import fold_to_edges

F32 = torch.float32

# staleness-weight registry: tick delay tau -> down-weight s(tau).
# "poly" is the FedBuff choice (Nguyen et al., 2022): s = (1 + tau)^-1/2.
STALENESS_FNS = {
    "unit": lambda tau: torch.ones_like(tau),
    "poly": lambda tau: (1.0 + tau) ** -0.5,
    "inv": lambda tau: 1.0 / (1.0 + tau),
}


def resolve_staleness(spec):
    """Coerce None / registry name / callable into a staleness weight fn."""
    if spec is None:
        spec = "unit"
    if callable(spec):
        return spec
    if spec not in STALENESS_FNS:
        raise ValueError(f"unknown staleness fn {spec!r}; expected one of "
                         f"{tuple(STALENESS_FNS)} or a callable")
    return STALENESS_FNS[spec]


class StalenessBuffer(NamedTuple):
    """Weighted partial sums of client contributions + counters.

    As the arrived buffer every field is a scalar counter or an unweighted
    sum tree; as the in-flight ring every field carries a leading
    ``(horizon,)`` slot axis. ``mass`` is ``sum_i w_i * s(tau_i)`` (the
    normalizer), ``count`` the participating-contribution count (what the
    K-trigger compares), ``tau`` the staleness mass ``sum_i w_i s_i tau_i``.
    """
    stats: Any
    delta: Any
    loss: torch.Tensor
    mass: torch.Tensor
    count: torch.Tensor
    tau: torch.Tensor


class AsyncState(NamedTuple):
    """The ``EngineCarry.buffer`` extension of the buffered engine."""
    buffer: StalenessBuffer      # arrived, awaiting the K-trigger
    pending: StalenessBuffer     # in-flight ring, leading (horizon,) axis
    applied_total: torch.Tensor  # int32: server updates applied so far


def _map(fn, buf: StalenessBuffer, *rest) -> StalenessBuffer:
    return StalenessBuffer(*(utils.tree_map(fn, x, *(r[i] for r in rest))
                             for i, x in enumerate(buf)))


def init_state(stat_spec, params, horizon: int) -> AsyncState:
    """Zero AsyncState for ``stat_spec`` (stat key -> shape, from
    ``StatsObjective.stat_spec``), a params tree (its shapes and device),
    and ring depth ``horizon``."""
    device = utils.tree_leaves(params)[0].device

    def z(shape):
        return torch.zeros(shape, dtype=F32, device=device)

    def zeros(lead=()):
        return StalenessBuffer(
            stats={k: z(lead + tuple(s)) for k, s in stat_spec.items()},
            delta=utils.tree_map(lambda p: z(lead + tuple(p.shape)), params),
            loss=z(lead), mass=z(lead), count=z(lead), tau=z(lead))

    return AsyncState(zeros(), zeros((horizon,)),
                      torch.zeros((), dtype=torch.int32, device=device))


def dispatch_fold(pending: StalenessBuffer, st_k, deltas, losses_k, w_eff,
                  mask, delays) -> StalenessBuffer:
    """Scatter one dispatched cohort into its delay buckets.

    ``w_eff`` (K,) is the full per-contribution weight, participation
    weight times staleness weight, riding the segment-sum fold; ``mask``
    (K,) in {0,1} feeds the K-trigger count (a dropped client contributes
    neither mass nor count); ``delays`` (K,) int32 in [0, horizon) are the
    bucket ids. Two kernel launches: the payload with its scalars, and
    the count.
    """
    horizon = pending.mass.shape[0]
    ones = torch.ones_like(w_eff)
    f = fold_to_edges(
        {"stats": st_k, "delta": deltas, "loss": losses_k, "mass": ones,
         "tau": delays.to(F32)}, w_eff, delays, horizon)
    cnt = fold_to_edges({"c": ones}, mask, delays, horizon)["c"]
    folded = StalenessBuffer(f["stats"], f["delta"], f["loss"], f["mass"],
                             cnt, f["tau"])
    return _map(torch.add, pending, folded)


def ring_pop(pending: StalenessBuffer):
    """Pop slot 0 (this tick's arrivals) and advance the ring.

    Returns ``(arrived, pending')``: ``arrived`` is a scalar-counter
    StalenessBuffer and ``pending'`` has every slot shifted one tick
    closer with a zeroed tail slot."""
    arrived = _map(lambda x: x[0], pending)

    def shift(x):
        out = torch.roll(x, -1, dims=0)
        out[-1] = 0.0
        return out

    return arrived, _map(shift, pending)


def buffer_add(buf: StalenessBuffer, arrived: StalenessBuffer):
    """Fold arrived contributions into the server buffer (exact by Eq.-3
    linearity: addition of weighted partial sums)."""
    return _map(torch.add, buf, arrived)


def buffer_aggregate(buf: StalenessBuffer, floor: float = 1e-12):
    """Mass-normalized aggregate ``(avg_stats, avg_delta, mean_staleness)``.

    The normalizer is floored, so an empty or outage-starved buffer yields
    zeros, never NaN."""
    denom = torch.clamp(buf.mass, min=floor)
    avg_stats = utils.tree_map(lambda v: v / denom, buf.stats)
    avg_delta = utils.tree_map(lambda v: v / denom, buf.delta)
    return avg_stats, avg_delta, buf.tau / denom


def buffer_reset_where(buf: StalenessBuffer, cond):
    """Zero the buffer where the scalar device bool ``cond`` holds (the
    reset after an apply)."""
    return _map(lambda x: torch.where(cond, torch.zeros_like(x), x), buf)
