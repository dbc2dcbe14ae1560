"""Client-level federated simulator — the paper's training runtime.

The *protocol-faithful* implementation of the two-phase DCCO round (paper
Fig. 2): phase 1 aggregates the clients' encoding statistics, phase 2
runs each client's local steps against the stop-grad combine of its own
and the aggregate statistics, and the server applies the FedOpt update
from the weighted average of the client deltas.

Client data layout: a dict whose leaves have leading dims (K, n, ...) —
K clients, n samples each (padded; per-client ``client_sizes`` mark the
real samples). ``encoder_apply(params, batch) -> (zf, zg)`` abstracts the
dual encoding model: batch is one client's (n, ...) slice holding both
views. Per-client gradients come from ``torch.func.vmap`` over K of
``torch.func.grad_and_value``; parameters are trees of tensors that never
require grad themselves.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.func import grad_and_value, vmap

from repro_torch import objectives as objectives_lib
from repro_torch import utils
from repro_torch.core import cco
from repro_torch.optim import optimizers as opt_lib
from repro_torch.server import update as server_update_lib

F32 = torch.float32


def resolve_objective(objective, lam: float = 20.0):
    """Resolve an objective name/instance; ``None`` or ``"dcco"`` -> CCO
    with ``lam``."""
    if objective is None or objective == "dcco":
        return objectives_lib.CCOObjective(lam=lam)
    return objectives_lib.get_objective(objective)


class RoundMetrics(NamedTuple):
    loss: torch.Tensor
    encoding_std: torch.Tensor
    wire_bytes: torch.Tensor        # uplink bytes of the round (0: no channel)


def _client_masks(client_sizes, n_pad: int):
    idx = torch.arange(n_pad, device=client_sizes.device)[None, :]
    return (idx < client_sizes[:, None]).to(F32)


def _flatten_clients(tree):
    """(K, n, ...) leaves -> (K*n, ...)."""
    return utils.tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])),
                          tree)


def client_local_steps(loss_fn, params, client_lr: float, local_steps: int):
    """Run a client's local plain-GD steps (paper: lr 1.0, 1 step).

    Returns (delta in f32, first-step loss). Works under ``vmap``."""
    p_local = params
    loss0 = None
    for step in range(local_steps):
        g, loss_val = grad_and_value(loss_fn)(p_local)
        if step == 0:
            loss0 = loss_val
        p_local = utils.tree_map(
            lambda p_, g_: (p_.to(F32) - client_lr * g_.to(F32)).to(p_.dtype),
            p_local, g)
    delta = utils.tree_sub(utils.tree_cast(p_local, F32),
                           utils.tree_cast(params, F32))
    return delta, loss0


# ---------------------------------------------------------------------------
# two-phase stats round (paper Sec 3.3, Fig. 2)
# ---------------------------------------------------------------------------

def stats_round(encoder_apply: Callable, params, opt_state, server_opt,
                client_data, client_sizes, *, objective,
                client_lr: float = 1.0, local_steps: int = 1,
                agg_stats_fn: Optional[Callable] = None,
                channel=None, channel_key: Optional[int] = None,
                channel_draws=None):
    """One two-phase aggregated-statistics round for any StatsObjective.
    Returns (params, opt_state, metrics).

    Phase 1 is never differentiated. The cohort is encoded as one (K*n)
    batch — exact, because GroupNorm and weight standardization couple no
    two samples. ``agg_stats_fn(zf_flat, zg_flat, mask_flat) -> Stats``, if
    given, computes the aggregate statistics in one pass over the
    flattened cohort (the engine routes it through the CUDA ``cco_stats``
    kernel, in the objective's moment set); by Eq. 3 this equals the
    weighted average of per-client statistics, which is what runs
    otherwise. The flat path needs a channel that ``supports_flat_stats``,
    since per-client payloads never materialise.

    ``channel`` (:mod:`repro_torch.comm`) routes both uplinks, the phase-1
    statistics and the phase-2 deltas, through an explicit wire:
    participation and aggregation weights come from
    ``channel.begin_round(channel_key, ...)``, payloads go through its
    encode/decode, and ``metrics.wire_bytes`` reports the round's uplink
    bytes. ``channel_draws`` (a dict with optional ``"begin"``,
    ``"stats"`` and ``"update"`` entries) replaces the channel's random
    draws, for tests that feed the reference's. With ``channel=None`` the
    lossless path runs; DenseChannel is bit-identical to it.

    ``server_opt`` may be a :class:`repro_torch.optim.Optimizer` (wrapped
    as the ``fedavg_sgd`` delegate) or a ServerUpdate.
    """
    server_update = server_update_lib.as_server_update(server_opt)
    k, n_pad = utils.tree_leaves(client_data)[0].shape[:2]
    masks = _client_masks(client_sizes, n_pad)               # (K, n)
    draws = channel_draws or {}
    if channel is None:
        ctx = None
        w = client_sizes.to(F32) / client_sizes.to(F32).sum()
    else:
        if channel_key is None:
            raise ValueError("channel requires channel_key")
        if agg_stats_fn is not None and not channel.supports_flat_stats:
            raise ValueError(
                f"agg_stats_fn needs per-client payloads, incompatible "
                f"with {channel!r}")
        ctx = channel.begin_round(channel_key, client_sizes,
                                  draws.get("begin"))
        w = ctx.weights
    wire = torch.zeros((), dtype=F32, device=masks.device)

    # ---- phase 1: clients compute local stats; server aggregates (Eq. 3)
    with torch.no_grad():
        zf, zg = encoder_apply(params, _flatten_clients(client_data))
        if agg_stats_fn is None:
            d = zf.shape[-1]
            st_k = vmap(objective.stats_masked)(
                zf.reshape(k, n_pad, d), zg.reshape(k, n_pad, d), masks)
            if ctx is None:
                agg = cco.weighted_average_stats(st_k, client_sizes)
            else:
                agg = channel.aggregate(ctx, st_k, "stats",
                                        draws.get("stats"))
        else:
            agg = agg_stats_fn(zf, zg, masks.reshape(-1))
        if ctx is not None:
            wire = wire + channel.round_bytes(ctx, agg)

    # ---- phase 2: server redistributes agg stats; clients run local steps
    def client_update(batch, mask):
        def loss_fn(p):
            zf_k, zg_k = encoder_apply(p, batch)
            local = objective.stats_masked(zf_k, zg_k, mask)
            return objective.loss_from_stats(objective.combine(local, agg))

        return client_local_steps(loss_fn, params, client_lr, local_steps)

    deltas, losses_k = vmap(client_update)(client_data, masks)

    # ---- server: weighted average of deltas -> FedOpt pseudo-gradient
    if ctx is None:
        avg_delta = utils.tree_map(lambda dl: torch.tensordot(w, dl, dims=1),
                                   deltas)
    else:
        with torch.no_grad():
            avg_delta = channel.aggregate(ctx, deltas, "update",
                                          draws.get("update"))
            wire = wire + channel.round_bytes(ctx, avg_delta)
    params, opt_state = server_update.step(params, opt_state, avg_delta)
    return params, opt_state, RoundMetrics((w * losses_k).sum(),
                                           objective.encoding_std(agg), wire)


def dcco_round(encoder_apply: Callable, params, opt_state, server_opt,
               client_data, client_sizes, *, lam: float = 20.0,
               objective=None, **round_kw):
    """One DCCO round == ``stats_round`` with the CCO objective (``lam`` is
    CCO's off-diagonal weight)."""
    return stats_round(encoder_apply, params, opt_state, server_opt,
                       client_data, client_sizes,
                       objective=resolve_objective(objective, lam),
                       **round_kw)


# ---------------------------------------------------------------------------
# Centralized step (the paper's upper bound) — for equivalence checks
# ---------------------------------------------------------------------------

def centralized_step(encoder_apply: Callable, params, opt_state, server_opt,
                     batch, mask=None, *, lam: float = 20.0, objective=None):
    """One centralized large-batch step of a stats objective (default: CCO
    with ``lam``). batch leaves: (N, ...). The raw gradient goes straight
    to the wrapped optimizer."""
    server_opt = server_update_lib.as_server_update(server_opt).opt
    objective = resolve_objective(objective, lam)

    def loss_fn(p):
        zf, zg = encoder_apply(p, batch)
        if mask is not None:
            st = objective.stats_masked(zf, zg, mask)
        else:
            st = objective.stats(zf, zg)
        return objective.loss_from_stats(st)

    g, loss = grad_and_value(loss_fn)(params)
    updates, opt_state = server_opt.update(g, opt_state, params)
    params = opt_lib.apply_updates(params, updates)
    zero = torch.zeros((), dtype=F32, device=loss.device)
    return params, opt_state, RoundMetrics(loss.detach(), zero, zero)
