"""Client-level federated simulator — the paper's training runtime.

The *protocol-faithful* implementation of the two-phase DCCO round (paper
Fig. 2): phase 1 aggregates the clients' encoding statistics, phase 2
runs each client's local steps against the stop-grad combine of its own
and the aggregate statistics, and the server applies the FedOpt update
from the weighted average of the client deltas. The FedAvg baselines the
paper compares against (``fedavg_round``) train a within-client loss and
exchange nothing but the deltas.

Client data layout: a dict whose leaves have leading dims (K, n, ...) —
K clients, n samples each (padded; per-client ``client_sizes`` mark the
real samples). ``encoder_apply(params, batch) -> (zf, zg)`` abstracts the
dual encoding model: batch is one client's (n, ...) slice holding both
views. Per-client gradients come from ``torch.func.vmap`` over K of
``torch.func.grad_and_value``; parameters are trees of tensors that never
require grad themselves.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.func import grad_and_value, vmap

from repro_torch import objectives as objectives_lib
from repro_torch import utils
from repro_torch.core import cco, losses
from repro_torch.optim import optimizers as opt_lib
from repro_torch.server import drift as drift_lib
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
    edge_bytes: Any = 0.0           # of which the edge->server hop of a
                                    # two-level tree (0: a flat channel)


def channel_bytes(channel, ctx, payload_template):
    """``(all hops, edge->server hop)`` uplink bytes of one payload this
    round; the second is 0 unless the channel is a two-level tree."""
    total = channel.round_bytes(ctx, payload_template)
    hop_bytes = getattr(channel, "hop_bytes", None)
    edge = 0.0 if hop_bytes is None else hop_bytes(
        ctx, payload_template)["edge_server"]
    return total, edge


def sample_clients(gen: torch.Generator, num_clients: int,
                   clients_per_round: int) -> torch.Tensor:
    """Server samples K clients without replacement, on ``gen``'s device."""
    return torch.randperm(num_clients, generator=gen,
                          device=gen.device)[:clients_per_round]


def _client_masks(client_sizes, n_pad: int):
    idx = torch.arange(n_pad, device=client_sizes.device)[None, :]
    return (idx < client_sizes[:, None]).to(F32)


def _flatten_clients(tree):
    """(K, n, ...) leaves -> (K*n, ...)."""
    return utils.tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])),
                          tree)


def _vmap_clients(client_update, client_data, masks, scaffold_state):
    """``client_update`` vmapped over the K clients: ``(deltas, losses)``.
    With a ``scaffold_state`` each client also takes its slot's SCAFFOLD
    correction, a vmapped input like its data."""
    if scaffold_state is None:
        return vmap(client_update)(client_data, masks)
    return vmap(client_update)(
        client_data, masks, drift_lib.scaffold_corrections(scaffold_state))


def client_local_steps(loss_fn, params, client_lr: float, local_steps: int,
                       *, prox_mu: float = 0.0, correction=None):
    """Run a client's local plain-GD steps (paper: lr 1.0, 1 step).

    Returns (delta in f32, first-step loss). Works under ``vmap``. Under
    ``vmap`` over K clients every tree here holds K copies of the model,
    so the gradient is dropped once it is applied and the delta is formed
    leaf by leaf: no f32 copy of the whole stepped tree is held (at
    TinyLlama-1.1B's full width that copy is 4.1 GB a client).

    Drift correction (:mod:`repro_torch.server.drift`), applied leaf by
    leaf inside the step for the same reason:
      ``prox_mu``    FedProx: the proximal gradient ``mu * (p_local -
                     p_broadcast)`` is added in f32 each step; ``0`` takes
                     the plain step, bit for bit.
      ``correction`` SCAFFOLD: a params-shaped tree (``c - c_k``) added to
                     every local gradient in f32; ``None`` skips it.
    """
    def step_leaf(p_, g_, p0, c_=None):
        g_ = g_.to(F32)
        if prox_mu:
            g_ = g_ + prox_mu * (p_.to(F32) - p0.to(F32))
        if c_ is not None:
            g_ = g_ + c_
        return (p_.to(F32) - client_lr * g_).to(p_.dtype)

    fixed = (params,) if correction is None else (params, correction)
    p_local = params
    loss0 = None
    for step in range(local_steps):
        g, loss_val = grad_and_value(loss_fn)(p_local)
        if step == 0:
            loss0 = loss_val
        p_local = utils.tree_map(step_leaf, p_local, g, *fixed)
        del g
    delta = utils.tree_map(lambda a, b: a.to(F32) - b.to(F32), p_local,
                           params)
    return delta, loss0


def check_variate_noise(channel) -> None:
    """A noising channel (DP) that does not noise the ``"variate"`` phase
    would release the aggregated SCAFFOLD variate delta, a deterministic
    clipped function of every client's raw update, un-noised while its
    accountant still reports a finite epsilon: refuse the combination."""
    noise_phases = getattr(channel, "noise_phases", None)
    if noise_phases is not None and "variate" not in noise_phases:
        raise ValueError(
            f"{channel!r} noises only {noise_phases}, but SCAFFOLD ships "
            f"per-client variate deltas too; construct it with "
            f"noise_phases including 'variate' so the epsilon it reports "
            f"covers everything it releases")


def _scaffold_round_tail(scaffold_state, deltas, client_lr, local_steps,
                         w, ctx, channel, draws=None):
    """The SCAFFOLD round tail shared by the round bodies: refresh the
    slot variates from the *raw* client deltas (the refresh is
    client-side and never crosses the wire), ship the variate deltas
    through the channel's ``"variate"`` phase (``draws``: that phase's
    draws) and fold the aggregate into the state.

    Returns (new ScaffoldState, extra uplink bytes, of which the
    edge->server hop's)."""
    with torch.no_grad():
        c_slots_new = drift_lib.scaffold_new_slot_variates(
            scaffold_state, deltas, client_lr, local_steps)
        dc = utils.tree_map(lambda new, old: new - old, c_slots_new,
                            scaffold_state.c_slots)
        if ctx is None:
            agg_dc = utils.tree_map(
                lambda d: torch.tensordot(w, d, dims=1), dc)
            extra, edge, pmask = 0.0, 0.0, None
        else:
            agg_dc = channel.aggregate(ctx, dc, "variate", draws)
            extra, edge = channel_bytes(channel, ctx, agg_dc)
            pmask = ctx.mask
        del dc
        return (drift_lib.scaffold_apply_round(scaffold_state, c_slots_new,
                                               agg_dc, pmask), extra, edge)


# ---------------------------------------------------------------------------
# two-phase stats round (paper Sec 3.3, Fig. 2)
# ---------------------------------------------------------------------------

def stats_round(encoder_apply: Callable, params, opt_state, server_opt,
                client_data, client_sizes, *, objective,
                client_lr: float = 1.0, local_steps: int = 1,
                agg_stats_fn: Optional[Callable] = None,
                channel=None, channel_key: Optional[int] = None,
                channel_draws=None, prox_mu: float = 0.0,
                scaffold_state=None):
    """One two-phase aggregated-statistics round for any StatsObjective.
    Returns (params, opt_state, metrics), or with a ``scaffold_state``
    (params, opt_state, scaffold_state, metrics).

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
    bytes (``metrics.edge_bytes`` the edge->server hop's share of them
    through a :class:`repro_torch.hierarchy.HierarchicalChannel`).
    ``channel_draws`` (a dict with optional ``"begin"``, ``"stats"``,
    ``"update"`` and ``"variate"`` entries) replaces the channel's random
    draws, for tests that feed the reference's. With ``channel=None`` the
    lossless path runs; DenseChannel is bit-identical to it.

    ``server_opt`` may be a :class:`repro_torch.optim.Optimizer` (wrapped
    as the ``fedavg_sgd`` delegate) or a ServerUpdate.

    Drift correction (:mod:`repro_torch.server.drift`): ``prox_mu`` adds
    the FedProx proximal term to every local step (0: off, bit for bit).
    A ``scaffold_state`` turns on SCAFFOLD: each client's local gradient
    takes its slot's correction ``c - c_k``, the slot variates refresh
    from the deltas, and their deltas ride the channel's ``"variate"``
    phase (bytes counted in ``metrics.wire_bytes``).
    """
    server_update = server_update_lib.as_server_update(server_opt)
    if scaffold_state is not None and channel is not None:
        check_variate_noise(channel)
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
    edge_wire = torch.zeros((), dtype=F32, device=masks.device)

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
            total, edge = channel_bytes(channel, ctx, agg)
            wire, edge_wire = wire + total, edge_wire + edge

    # ---- phase 2: server redistributes agg stats; clients run local steps
    def client_update(batch, mask, corr=None):
        def loss_fn(p):
            zf_k, zg_k = encoder_apply(p, batch)
            local = objective.stats_masked(zf_k, zg_k, mask)
            return objective.loss_from_stats(objective.combine(local, agg))

        return client_local_steps(loss_fn, params, client_lr, local_steps,
                                  prox_mu=prox_mu, correction=corr)

    deltas, losses_k = _vmap_clients(client_update, client_data, masks,
                                     scaffold_state)

    # ---- server: weighted average of deltas -> FedOpt pseudo-gradient
    if ctx is None:
        avg_delta = utils.tree_map(lambda dl: torch.tensordot(w, dl, dims=1),
                                   deltas)
    else:
        with torch.no_grad():
            avg_delta = channel.aggregate(ctx, deltas, "update",
                                          draws.get("update"))
            total, edge = channel_bytes(channel, ctx, avg_delta)
            wire, edge_wire = wire + total, edge_wire + edge
    params, opt_state = server_update.step(params, opt_state, avg_delta)
    loss, enc_std = (w * losses_k).sum(), objective.encoding_std(agg)
    if scaffold_state is None:
        return params, opt_state, RoundMetrics(loss, enc_std, wire,
                                               edge_wire)
    scaffold_state, extra, edge = _scaffold_round_tail(
        scaffold_state, deltas, client_lr, local_steps, w, ctx, channel,
        draws.get("variate"))
    return params, opt_state, scaffold_state, RoundMetrics(
        loss, enc_std, wire + extra, edge_wire + edge)


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
# FedAvg baselines (within-client loss, no stats exchange)
# ---------------------------------------------------------------------------

LOSS_KINDS = ("stats", "cco", "contrastive", "byol")


def fedavg_round(encoder_apply: Callable, params, opt_state, server_opt,
                 client_data, client_sizes, *, loss_kind: str = "cco",
                 lam: float = 20.0, temperature: float = 0.1,
                 objective=None, client_lr: float = 1.0,
                 local_steps: int = 1, channel=None,
                 channel_key: Optional[int] = None, channel_draws=None,
                 prox_mu: float = 0.0, scaffold_state=None):
    """FedAvg with a within-client loss: 'stats' | 'cco' | 'contrastive'
    | 'byol'. Returns (params, opt_state, metrics), or with a
    ``scaffold_state`` (params, opt_state, scaffold_state, metrics).

    ``'stats'`` runs any StatsObjective as a *within-client* loss (no
    statistics exchange: the baseline D-CCO is compared against);
    ``'cco'`` is the same bound to the CCO objective with ``lam``.
    ``'contrastive'`` is NT-Xent at ``temperature`` and ``'byol'`` the
    predictive loss, each over the client's own two views; padding samples
    count as (weak) negatives in NT-Xent, as in the reference.

    ``channel`` routes the single uplink (the client deltas, phase
    ``"update"``) through the wire, with ``channel_draws`` (``"begin"``,
    ``"update"``, ``"variate"``) as in ``stats_round``, as are
    ``prox_mu`` and ``scaffold_state``. The metrics carry the weighted
    client loss and an ``encoding_std`` of 0, as the reference's do.
    """
    if loss_kind not in LOSS_KINDS:
        raise ValueError(f"unknown loss_kind {loss_kind!r}; expected one of "
                         f"{LOSS_KINDS}")
    server_update = server_update_lib.as_server_update(server_opt)
    if loss_kind in ("cco", "stats"):
        objective = resolve_objective(objective, lam)
    if scaffold_state is not None and channel is not None:
        check_variate_noise(channel)
    n_pad = utils.tree_leaves(client_data)[0].shape[1]
    masks = _client_masks(client_sizes, n_pad)
    draws = channel_draws or {}
    if channel is None:
        ctx = None
        w = client_sizes.to(F32) / client_sizes.to(F32).sum()
    else:
        if channel_key is None:
            raise ValueError("channel requires channel_key")
        ctx = channel.begin_round(channel_key, client_sizes,
                                  draws.get("begin"))
        w = ctx.weights
    zero = torch.zeros((), dtype=F32, device=masks.device)

    def client_loss(p, batch, mask):
        zf, zg = encoder_apply(p, batch)
        if loss_kind == "contrastive":
            return losses.ntxent_loss(zf, zg, temperature)
        if loss_kind == "byol":
            return losses.byol_predictive_loss(zf, zg)
        return objective.loss_from_stats(objective.stats_masked(zf, zg, mask))

    def client_update(batch, mask, corr=None):
        return client_local_steps(lambda p: client_loss(p, batch, mask),
                                  params, client_lr, local_steps,
                                  prox_mu=prox_mu, correction=corr)

    deltas, losses_k = _vmap_clients(client_update, client_data, masks,
                                     scaffold_state)
    wire, edge_wire = zero, zero
    if ctx is None:
        avg_delta = utils.tree_map(lambda dl: torch.tensordot(w, dl, dims=1),
                                   deltas)
    else:
        with torch.no_grad():
            avg_delta = channel.aggregate(ctx, deltas, "update",
                                          draws.get("update"))
            total, edge = channel_bytes(channel, ctx, avg_delta)
            wire, edge_wire = zero + total, zero + edge
    if scaffold_state is not None:
        # before the server step, so that the deltas go before it
        scaffold_state, extra, edge = _scaffold_round_tail(
            scaffold_state, deltas, client_lr, local_steps, w, ctx, channel,
            draws.get("variate"))
        wire, edge_wire = wire + extra, edge_wire + edge
    del deltas
    params, opt_state = server_update.step(params, opt_state, avg_delta)
    metrics = RoundMetrics((w * losses_k).sum(), zero, wire, edge_wire)
    if scaffold_state is None:
        return params, opt_state, metrics
    return params, opt_state, scaffold_state, metrics


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
