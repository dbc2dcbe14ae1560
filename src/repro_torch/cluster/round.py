"""Cluster-aware aggregation: the engine's clustered two-phase round.

Global aggregation averages every client into ONE correlation target and
ONE server model, which is what hurts when the population is a mixture of
heterogeneous client distributions. This module keeps the paper's
two-phase protocol and makes the aggregation cluster-aware:

  1. phase 1 runs unchanged: every cohort client ships its Eq.-3 stats
     dict, computed under the shared readout params;
  2. the server flattens the per-client stats into the (K, D) row matrix
     and runs cosine k-means on the device (warm-started from the carried
     centroids), assigning each cohort client a cluster id;
  3. per-cluster stats fold in ONE weighted segment-sum launch
     (:func:`repro_torch.hierarchy.fold_to_edges`), giving each cluster
     its own correlation target for the phase-2 stop-grad combine;
  4. each cluster owns a server-update slot: a params copy + optimizer
     state, stepped by its own cluster-folded delta average; clusters that
     received no cohort clients this round are left untouched;
  5. with a :class:`repro_torch.hierarchy.HierarchicalChannel`
     (``num_edges == num_clusters``) the cluster ids BECOME the edge
     assignment: the client hop encodes per-client payloads, the fold
     lands per-cluster partials, and the edge hop encodes one payload per
     cluster.

Phase 2 trains a different parameter slot per client: the slots are
gathered by cluster id into a (K, ...) stack and ``torch.func.vmap`` runs
over it with ``in_dims=0``, as the reference's ``vmap`` over
``_take_cluster`` does. That keeps the cluster ids on the device (a loop
over clusters would need them on the host, a sync every round) at the
price of K gathered parameter copies.

``num_clusters <= 1`` never builds this body: the engine routes to the
ordinary global round, so a single cluster is bit-identical (``== 0.0``)
to the global path.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.func import vmap

from repro_torch import utils
from repro_torch.cluster import kmeans
from repro_torch.core import fed_sim
from repro_torch.hierarchy.aggregation import (HierarchicalChannel,
                                               fold_to_edges, segment_mass)
from repro_torch.server import update as server_update_lib

F32 = torch.float32


class ClusterState(NamedTuple):
    """The clustered engine's carry: per-cluster server-update slots and
    the warm-start centroids."""
    params_c: Any                   # params tree, leading axis C
    opt_c: Any                      # server-update state, leading axis C
    centroids: torch.Tensor         # (C, D) unit rows; zeros before the
                                    # first round (seeded from its stats)
    initialized: torch.Tensor       # () bool, centroids seeded yet?


def init_cluster_state(params, opt_state, num_clusters: int,
                       dim: int) -> ClusterState:
    """Fresh slots: every cluster starts from the same params and
    optimizer state; centroids seed from the first round's stats."""
    device = utils.tree_leaves(params)[0].device

    def stack(tree):
        return utils.tree_map(
            lambda x: x[None].repeat((num_clusters,) + (1,) * x.dim()), tree)

    return ClusterState(stack(params), stack(opt_state),
                        torch.zeros((num_clusters, dim), dtype=F32,
                                    device=device),
                        torch.zeros((), dtype=torch.bool, device=device))


def _per_cluster(v, num_clusters, ndim):
    return v.reshape((num_clusters,) + (1,) * (ndim - 1))


def fold_to_clusters(tree_k, weights, cluster_ids, num_clusters: int):
    """Per-cluster weighted average of stacked per-client payloads:
    ``(avg (C, ...) tree, mass (C,))``. The sums land in one segment-sum
    launch over the whole flattened payload, the per-cluster mass (one
    more launch) normalizes them; an empty cluster has mass 0 and average
    0."""
    sums = fold_to_edges(tree_k, weights, cluster_ids, num_clusters)
    mass = segment_mass(weights, cluster_ids, num_clusters)
    denom = torch.clamp(mass, min=1e-12)
    avg = utils.tree_map(
        lambda v: v / _per_cluster(denom, num_clusters, v.dim()), sums)
    return avg, mass


def _take(tree_c, ids):
    """Gather the (C, ...) slots of a tree by (K,) ids -> (K, ...)."""
    idx = ids.long()
    return utils.tree_map(lambda x: x[idx], tree_c)


def make_cluster_round_body(encoder_apply: Callable, server_opt,
                            cfg) -> Callable:
    """Build ``round_fn(params, opt_state, cstate, batch, sizes,
    channel_key=None, channel_draws=None) -> (params, opt_state, cstate,
    metrics)`` for ``cfg.num_clusters > 1``. ``params`` is the
    mass-weighted readout model (what probes and evaluations see); the
    training state is the per-cluster slots in ``cstate``.

    ``channel_draws`` takes a channel's draws as ``stats_round`` takes
    them (``"begin"``, ``"stats"``, ``"update"``), plus ``"edges"``, the
    edge hop's begin draws when the cluster ids re-route a hierarchy.
    FedProx (``cfg.prox_mu``) pulls each client toward its cluster's
    slot; SCAFFOLD is refused, as in the reference."""
    from repro_torch.core import round_engine as engine_lib

    num_clusters = int(cfg.num_clusters)
    if cfg.algorithm != "dcco":
        raise ValueError(
            f"num_clusters clusters the two-phase stats round only "
            f"(algorithm 'dcco'), got {cfg.algorithm!r}")
    if cfg.stats_kernel == "fused":
        raise ValueError(
            "stats_kernel='fused' aggregates phase-1 stats from the "
            "flattened cohort; clustering assigns PER-CLIENT stats, so it "
            "needs per-client payloads")
    if cfg.scaffold:
        raise ValueError(
            "SCAFFOLD variates assume one shared broadcast model; the "
            "clustered round broadcasts per-cluster params, so disable "
            "scaffold for clustered aggregation")
    encoder_apply = engine_lib.cast_encoder_apply(encoder_apply,
                                                  cfg.compute_dtype)
    objective = fed_sim.resolve_objective(cfg.objective, cfg.lam)
    server_update = server_update_lib.as_server_update(
        cfg.server_update if cfg.server_update is not None else server_opt)
    channel = cfg.channel
    hier = isinstance(channel, HierarchicalChannel) and not channel.collapses
    if channel is not None:
        if getattr(channel, "noise_phases", None) is not None:
            raise ValueError(
                f"{channel!r} with num_clusters: per-cluster aggregates "
                f"change the DP sensitivity, so the accountant's epsilon "
                f"would not cover what the round releases; run DP on the "
                f"global path")
        if isinstance(channel, HierarchicalChannel) and \
                channel.num_edges != num_clusters:
            raise ValueError(
                f"cluster ids route clients through their own edge, so "
                f"the tree needs one edge per cluster: num_edges="
                f"{channel.num_edges} != num_clusters={num_clusters}")

    def _cluster_fold(ctx, tree_k, w, ids, phase, draws):
        """Per-cluster (avg, mass): the flat fold, or, through a
        non-collapsing hierarchical channel, client-hop encode, fold BY
        CLUSTER ID, edge-hop encode of one payload per cluster."""
        if ctx is None:
            return fold_to_clusters(tree_k, w, ids, num_clusters)
        if not hier:
            dec = channel.encode_decode(ctx, tree_k, phase, draws)
            return fold_to_clusters(dec, w, ids, num_clusters)
        draws = draws or {}
        dec = channel.encode_decode(ctx, tree_k, phase, draws.get("client"))
        sums = fold_to_edges(dec, w, ids, num_clusters)
        enc = channel.edge_channel.encode_decode(ctx.edge_ctx, sums, phase,
                                                 draws.get("edge"))
        emask = ctx.edge_ctx.mask                                # (C,)
        mass = segment_mass(w, ids, num_clusters) * emask
        denom = torch.clamp(mass, min=1e-12)
        avg = utils.tree_map(
            lambda v: v * _per_cluster(emask, num_clusters, v.dim())
            / _per_cluster(denom, num_clusters, v.dim()), enc)
        return avg, mass

    def round_fn(params, opt_state, cstate, batch, sizes, channel_key=None,
                 channel_draws=None):
        k, n_pad = utils.tree_leaves(batch)[0].shape[:2]
        if num_clusters > k:
            raise ValueError(
                f"num_clusters={num_clusters} exceeds the cohort of {k} "
                f"clients: every cluster needs a chance of cohort members")
        draws = channel_draws or {}
        masks = fed_sim._client_masks(sizes, n_pad)
        if channel is None:
            ctx = None
            w = sizes.to(F32) / sizes.to(F32).sum()
        else:
            if channel_key is None:
                raise ValueError("channel requires channel_key")
            ctx = channel.begin_round(channel_key, sizes, draws.get("begin"))
            w = ctx.weights
        wire = torch.zeros((), dtype=F32, device=masks.device)
        edge_wire = torch.zeros((), dtype=F32, device=masks.device)

        with torch.no_grad():
            # ---- phase 1: per-client stats under the shared readout
            # params (the cohort encoded as one batch, as in stats_round)
            zf, zg = encoder_apply(params, fed_sim._flatten_clients(batch))
            d = zf.shape[-1]
            st_k = vmap(objective.stats_masked)(
                zf.reshape(k, n_pad, d), zg.reshape(k, n_pad, d), masks)

            # ---- cluster assignment on the flattened stats rows
            rows = kmeans.flatten_stats(st_k)
            cent_prev = torch.where(cstate.initialized, cstate.centroids,
                                    kmeans.seed_centroids(rows, num_clusters))
            ids, cents = kmeans.cosine_kmeans(
                rows, num_clusters, iters=cfg.cluster_iters,
                centroids=cent_prev)
            del rows
            if hier:
                # semantic hierarchy: this round's edge assignment IS the
                # cluster assignment (effective mask/weights recomputed)
                ctx = channel.with_edge_ids(ctx, ids, draws.get("edges"))
                w = ctx.weights

            # ---- per-cluster correlation targets: one weighted fold
            agg_c, mass_c = _cluster_fold(ctx, st_k, w, ids, "stats",
                                          draws.get("stats"))
            if ctx is not None:
                one = utils.tree_map(lambda v: v[0], agg_c)
                total, edge = fed_sim.channel_bytes(channel, ctx, one)
                wire, edge_wire = wire + total, edge_wire + edge

        # ---- phase 2: client k trains ITS cluster's slot against ITS
        # cluster's target
        def client_update(b, m, p_k, agg_k):
            def loss_fn(p):
                zf_k, zg_k = encoder_apply(p, b)
                local = objective.stats_masked(zf_k, zg_k, m)
                return objective.loss_from_stats(
                    objective.combine(local, agg_k))

            return fed_sim.client_local_steps(loss_fn, p_k, cfg.client_lr,
                                              cfg.local_steps,
                                              prox_mu=cfg.prox_mu)

        deltas, losses_k = vmap(client_update)(
            batch, masks, _take(cstate.params_c, ids), _take(agg_c, ids))

        with torch.no_grad():
            # ---- per-cluster server-update slots (empty clusters frozen)
            dbar_c, _ = _cluster_fold(ctx, deltas, w, ids, "update",
                                      draws.get("update"))
            del deltas
            if ctx is not None:
                one = utils.tree_map(lambda v: v[0], dbar_c)
                total, edge = fed_sim.channel_bytes(channel, ctx, one)
                wire, edge_wire = wire + total, edge_wire + edge
            live = mass_c > 1e-12                                # (C,)
            p_cols, o_cols = [], []
            for c in range(num_clusters):
                p_new, o_new = server_update.step(
                    utils.tree_map(lambda x: x[c], cstate.params_c),
                    utils.tree_map(lambda x: x[c], cstate.opt_c),
                    utils.tree_map(lambda x: x[c], dbar_c))
                p_cols.append(p_new)
                o_cols.append(o_new)

            def keep(cols, old):
                new = utils.tree_map(lambda *xs: torch.stack(xs), *cols)
                return utils.tree_map(
                    lambda a, b: torch.where(
                        _per_cluster(live, num_clusters, a.dim()), a, b),
                    new, old)

            params_c = keep(p_cols, cstate.params_c)
            opt_c = keep(o_cols, cstate.opt_c)

            # ---- readout model: this round's mass-weighted mean of slots
            m_norm = mass_c / torch.clamp(mass_c.sum(), min=1e-12)
            params_out = utils.tree_map(
                lambda x: torch.tensordot(m_norm, x.to(F32), dims=1).to(
                    x.dtype), params_c)
            agg_g = utils.tree_map(lambda v: torch.tensordot(w, v, dims=1),
                                   st_k)
        metrics = fed_sim.RoundMetrics((w * losses_k).sum(),
                                       objective.encoding_std(agg_g), wire,
                                       edge_wire)
        new_state = ClusterState(params_c, opt_c, cents,
                                 torch.ones((), dtype=torch.bool,
                                            device=cents.device))
        return params_out, opt_state, new_state, metrics

    return round_fn
