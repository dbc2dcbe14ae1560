"""Federated round engine.

The reference compiles the multi-round loop into one ``lax.scan``; PyTorch
runs eagerly, so here it is a Python loop over rounds that never waits for
the host inside a segment: cohort sampling, augmentation, both phases, the
server step and the per-round metrics all stay on the device, and metrics
come back to the host once per segment of ``chunk_rounds`` rounds, where
``on_segment`` hooks in (evaluation, logging).

Round randomness: round ``r`` of a run seeded ``seed`` draws from a fresh
generator on the parameters' device seeded ``seed * 1_000_003 + r``, so
``start_round`` resumes the same stream. The sampler is injected —
``sampler(gen) -> (batch, sizes)`` — so a test can replay cohorts drawn by
the reference. A channel's draws come from its own per-round seed,
``utils.fold_in(round_seed, _CHANNEL_SALT)``, so the sampler's stream is
the same with and without a channel.

Round bodies (``EngineConfig.algorithm``): ``dcco``, the two-phase
statistics round; the FedAvg baselines ``fedavg_cco`` (the objective as a
within-client loss), ``fedavg_contrastive`` (NT-Xent at
``EngineConfig.temperature``) and ``fedavg_byol`` (the predictive loss),
which ship client deltas only; and ``centralized``, one large-batch step on
the cohort's union. ``EngineConfig.server_update`` selects the server
strategy (:mod:`repro_torch.server`: the FedAvg delegate, FedAvgM,
FedAdagrad, FedAdam, FedYogi) in place of the engine's ``server_opt``.

Phase-1 aggregate statistics go through the CUDA ``cco_stats`` kernel
when ``EngineConfig.stats_kernel == "fused"``, in the objective's moment
set: exact by Eq. 3, since statistics are linear in samples. The default
(``None``) takes that route unless the channel needs per-client payloads,
and then the per-client average; the reference makes the caller choose.
``EngineConfig.channel`` routes every client uplink through a
:mod:`repro_torch.comm` channel, with per-round ``wire_bytes``.

Client drift (:mod:`repro_torch.server.drift`): ``EngineConfig.prox_mu``
adds FedProx's proximal term to every local step, and
``EngineConfig.scaffold`` carries SCAFFOLD's control variates from round
to round (``EngineCarry.drift``; ``run(drift_state=)`` resumes them, and
``self.drift_state`` holds them after a run), their deltas an uplink of
their own (the channel's ``"variate"`` phase). ``EngineConfig.
compute_dtype="bfloat16"`` runs the encoder in bf16
(:func:`cast_encoder_apply`) while parameters, optimizer state, deltas,
variates and every statistic stay f32.

Two more round bodies ride the same loop, each with its state in the
carry. ``num_clusters > 1`` runs the cluster-aware round
(:mod:`repro_torch.cluster`, ``EngineCarry.cluster``). ``async_k > 0``
runs the FedBuff-style buffered engine (:mod:`repro_torch.core.buffer`,
``EngineCarry.buffer``): each tick dispatches a cohort whose
contributions arrive after per-client delays (the sampler emits
``(batch, sizes, delays)``, :mod:`repro_torch.data.latency`), and the
server applies an update once ``async_k`` contributions have arrived, on
a device condition. Both size their state from the objective's
``stat_spec`` and shapes traced on the ``meta`` device (no arithmetic),
at the first round. Provably-equal configurations collapse to the sync
body: one cluster, and zero latency with unit staleness and ``async_k``
equal to the cohort.

``EngineConfig.retrieval_eval`` (:mod:`repro_torch.retrieval`) scores
retrieval after each round on the cadence ``retrieval_every``, on the
round's updated params, into ``EngineMetrics.retrieval`` (NaN off the
cadence). It only observes: the parameters and losses are the same bits
with and without it.

``EngineConfig.cohort_chunk`` streams the cohort through the two-phase
round in chunks of that many clients (:mod:`repro_torch.hierarchy.
streaming`): peak memory O(cohort_chunk) instead of O(cohort). Its sampler
is chunkable (``FederatedDataset.make_streaming_sampler``), and the
streaming body samples inside the round from the round's generator, one
chunk at a time. There ``stats_kernel=None`` resolves to the per-chunk
average and ``"fused"`` is refused: the cohort the kernel would read never
materializes. SCAFFOLD, ``num_clusters > 1`` and ``async_k`` are refused
beside it, as in the reference.

``EngineConfig.cohort_axis`` shards the cohort over devices
(:func:`stats_round_sharded`, the reference's ``shard_map`` body as SPMD
over ``torch.distributed``): every rank draws the same cohort from the
same round generator and works on its contiguous block of K / S clients,
and the phase-1 aggregate, the phase-2 delta average and the loss are
all-reduces over the axis of the engine's ``mesh`` (a ``DeviceMesh``;
:mod:`repro_torch.sharding`). The sharded body computes per-client
statistics, never the flattened cohort's, so there ``stats_kernel=None``
resolves to ``"off"`` and ``"fused"`` is refused. Other algorithms,
``cohort_chunk``, ``num_clusters > 1`` and a real buffered ``async_k``
are refused beside it, as in the reference.

``run(ckpt_dir=, ckpt_every=, ckpt_name=)`` writes the reference's
checkpoint blob at segment boundaries (:mod:`repro_torch.checkpoint`);
restored and passed back in with ``start_round``, it continues the run
bit for bit.
"""
from __future__ import annotations

import os
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.func import vmap

from repro_torch import cluster as cluster_lib
from repro_torch import utils
from repro_torch.checkpoint import save_checkpoint
from repro_torch.comm.channel import ChannelContext, _weighted_sum
from repro_torch.core import buffer as buffer_lib
from repro_torch.core import cco, fed_sim
from repro_torch.data import latency as latency_lib
from repro_torch.kernels.cco_stats import cco_stats
from repro_torch.server import drift as drift_lib
from repro_torch.server import update as server_update_lib
from repro_torch.sharding import collectives

F32 = torch.float32

ALGORITHMS = ("dcco", "fedavg_cco", "fedavg_contrastive", "fedavg_byol",
              "centralized")
# the FedAvg bodies' within-client loss kinds (fed_sim.fedavg_round)
_FEDAVG_KINDS = {"fedavg_cco": "stats", "fedavg_contrastive": "contrastive",
                 "fedavg_byol": "byol"}
STATS_KERNELS = ("off", "fused")
_ROUND_SEED_STRIDE = 1_000_003
_CHANNEL_SALT = 0xC0                # fold_in salt of the per-round channel seed

# EngineConfig.compute_dtype spellings -> torch dtype. Only the encoder's
# forward and backward run in the compute dtype (cast_encoder_apply).
COMPUTE_DTYPES = {
    "float32": torch.float32, "f32": torch.float32, "fp32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
}


def resolve_compute_dtype(compute_dtype):
    """An EngineConfig.compute_dtype spelling -> its torch dtype."""
    if compute_dtype in COMPUTE_DTYPES:
        return COMPUTE_DTYPES[compute_dtype]
    raise ValueError(f"unknown compute_dtype {compute_dtype!r}; expected one "
                     f"of {sorted(COMPUTE_DTYPES)}")


def cast_encoder_apply(encoder_apply: Callable, compute_dtype) -> Callable:
    """Run the encoder's forward and backward in ``compute_dtype`` while
    the Eq.-3 statistics stay f32.

    The losses divide near-cancelling sums of per-sample statistics, so
    the accumulation is the precision-critical path, not the encoder. The
    wrapper casts float params and float batch leaves to ``compute_dtype``
    at the encoder boundary and returns the encoder's outputs unchanged;
    ``cco.moment_stats`` and the ``cco_stats`` kernel's wrapper upcast to
    f32 before any reduction, so every statistic, loss, delta and
    optimizer buffer is f32. The cast is differentiable, so the gradient
    of a master parameter is f32. ``float32`` returns ``encoder_apply``
    itself. Integer leaves (token ids) pass through.
    """
    dtype = resolve_compute_dtype(compute_dtype)
    if dtype == torch.float32:
        return encoder_apply

    def cast_tree(tree):
        return utils.tree_map(
            lambda x: x.to(dtype) if x.is_floating_point() else x, tree)

    def apply(params, batch):
        return encoder_apply(cast_tree(params), cast_tree(batch))

    return apply


class EngineConfig(NamedTuple):
    """Configuration of the round loop (the fields this slice reads)."""
    algorithm: str = "dcco"
    objective: Any = None           # StatsObjective or registered name;
                                    # None = CCO with ``lam``
    lam: float = 20.0
    temperature: float = 0.1        # NT-Xent's (fedavg_contrastive)
    client_lr: float = 1.0
    local_steps: int = 1
    chunk_rounds: int = 20          # rounds per metrics segment
    stats_kernel: Optional[str] = None
                                    # "fused": phase-1 aggregate through the
                                    # CUDA cco_stats kernel (its plain
                                    # version on CPU tensors); "off": the
                                    # per-client Eq.-3 average; None:
                                    # "fused" unless the channel needs
                                    # per-client payloads
    channel: Any = None             # repro_torch.comm.Channel or None (the
                                    # lossless wire)
    server_update: Any = None       # repro_torch.server ServerUpdate; None
                                    # = the engine's server_opt argument
                                    # (an Optimizer becomes the fedavg_sgd
                                    # delegate)
    compute_dtype: str = "float32"  # the encoder's forward/backward type
                                    # ("float32" | "bfloat16"; aliases f32,
                                    # fp32, bf16); statistics, losses,
                                    # deltas, optimizer state and master
                                    # params stay f32 (cast_encoder_apply)
    prox_mu: float = 0.0            # FedProx proximal coefficient (0: off)
    scaffold: bool = False          # SCAFFOLD control variates, carried
                                    # in EngineCarry.drift
    cohort_chunk: int = 0           # >0: stream the cohort through the
                                    # round in chunks of this many clients
                                    # (repro_torch.hierarchy.streaming):
                                    # peak memory O(cohort_chunk) instead
                                    # of O(cohort); needs a chunkable
                                    # sampler (make_streaming_sampler)
    cohort_axis: Any = None         # mesh axis (or tuple of axes: the
                                    # multi-host ("data", "client") mesh)
                                    # to shard the K client axis over; the
                                    # engine takes the mesh (RoundEngine(
                                    # mesh=))
    # --- cluster-aware aggregation (repro_torch.cluster) ---
    num_clusters: int = 0           # >1: cosine k-means on the per-client
                                    # stats assigns each cohort client a
                                    # cluster every round; per-cluster
                                    # targets + server slots (ClusterState
                                    # rides the carry). 0/1 = the global
                                    # path, bit-identical
    cluster_iters: int = 2          # Lloyd iterations per round (warm-
                                    # started from the carried centroids)
    # --- semi-synchronous buffered engine (repro_torch.core.buffer) ---
    async_k: int = 0                # >0: apply the server update when this
                                    # many contributions have ARRIVED
                                    # (staleness-weighted buffer); 0 =
                                    # synchronous rounds
    staleness_fn: Any = "unit"      # core.buffer.STALENESS_FNS name or
                                    # callable tau -> weight
    latency: Any = None             # data.latency model (None/"zero"/
                                    # "uniform"/"heavytail"/LatencyModel);
                                    # must match the async sampler's
    async_collapse: bool = True     # K = cohort, zero latency and unit
                                    # staleness run the sync body (bit-
                                    # identical); False forces the buffer
    # --- periodic retrieval eval (repro_torch.retrieval) ---
    retrieval_eval: Any = None      # params -> {metric: scalar}
                                    # (retrieval.make_retrieval_eval:
                                    # recall@k / MRR on a held-out corpus),
                                    # run after the round on its updated
                                    # params. A stateful eval (.stateful,
                                    # called as (params, state) ->
                                    # (metrics, state), with
                                    # .init_state(params)) threads its
                                    # index state through the carry
    retrieval_every: int = 1        # evaluate on rounds where
                                    # round % retrieval_every == 0; other
                                    # rounds record NaN and run no eval


class EngineCarry(NamedTuple):
    params: Any
    opt_state: Any
    buffer: Any = ()                # core.buffer.AsyncState when the real
                                    # buffered path runs, else empty
    cluster: Any = ()               # cluster.ClusterState when
                                    # num_clusters > 1, else empty
    reval: Any = ()                 # a stateful retrieval eval's state
                                    # (the refreshing eval's encoded
                                    # corpus), else empty
    drift: Any = ()                 # server.drift.ScaffoldState when
                                    # EngineConfig.scaffold, else empty


class EngineMetrics(NamedTuple):
    """Stacked per-round metrics, leading axis = rounds (= scheduler ticks
    on the buffered engine)."""
    loss: torch.Tensor
    encoding_std: torch.Tensor
    wire_bytes: torch.Tensor        # uplink bytes/round (0: no channel)
    edge_bytes: torch.Tensor        # of which the edge->server hop of a
                                    # two-level tree (0: flat)
    applied: torch.Tensor           # server updates applied this round
                                    # (1 on sync rounds; K-triggers on the
                                    # buffered engine)
    staleness: torch.Tensor         # mean staleness (ticks) of the applied
                                    # aggregate, 0 when none applied
    retrieval: Any = ()             # {"recall_at_k": (rounds,), "mrr":
                                    # (rounds,), ...} f32 when
                                    # retrieval_eval is set (NaN on rounds
                                    # off the cadence), else {}


def _sync_metrics(m, device) -> EngineMetrics:
    """A sync round's RoundMetrics as one row of EngineMetrics."""
    def f32(x):
        return torch.as_tensor(x, dtype=F32, device=device)
    return EngineMetrics(m.loss, m.encoding_std, f32(m.wire_bytes),
                         f32(m.edge_bytes), f32(1.0), f32(0.0), {})


def make_kernel_agg_stats(second_moments: bool = False) -> Callable:
    """Aggregate cohort stats in one pass of the fused ``cco_stats`` kernel.

    ``second_moments`` selects the kernel's moment set (the objective's
    ``second_moments`` flag): ``"full"`` adds the within-view moments the
    VICReg-family objectives need, still in one pass.

    Rows are pre-masked (zeroed) and the normalizer is the valid-sample
    count, read by the kernel on the device: exact for binary masks, since
    (m*f)^2 = m*f^2 and (m*f)(m*g) = m*f*g.
    """
    moments = "full" if second_moments else "cross"

    def agg_stats(zf, zg, mask):
        m = mask.to(F32)[:, None]
        return cco_stats(zf.to(F32) * m, zg.to(F32) * m, mask.to(F32).sum(),
                         moments=moments)

    return agg_stats


def _resolve_agg_stats_fn(cfg: EngineConfig, objective) -> Optional[Callable]:
    kernel = cfg.stats_kernel
    if kernel is None:
        flat = cfg.channel is None or cfg.channel.supports_flat_stats
        kernel = "fused" if flat else "off"
    if kernel == "off":
        return None
    if kernel == "fused":
        return make_kernel_agg_stats(objective.second_moments)
    raise ValueError(f"unknown stats_kernel {kernel!r}; expected one of "
                     f"{STATS_KERNELS} or None")


def _server_update_of(cfg: EngineConfig, server_opt):
    """The round's server strategy: ``cfg.server_update`` if set, else
    ``server_opt``, as a ServerUpdate."""
    return server_update_lib.as_server_update(
        cfg.server_update if cfg.server_update is not None else server_opt)


def _required_drift(drift):
    """A SCAFFOLD body's ``drift=``, which it cannot run without."""
    if drift is None:
        raise ValueError("EngineConfig.scaffold needs the ScaffoldState as "
                         "drift= (server.drift.scaffold_init)")
    return drift


# ---------------------------------------------------------------------------
# sharded-cohort stats round (the client axis over a mesh axis, or over a
# tuple of axes on the multi-host ("data", "client") mesh)
# ---------------------------------------------------------------------------

def stats_round_sharded(encoder_apply: Callable, params, opt_state,
                        server_opt, client_data, client_sizes, mesh, *,
                        objective, client_lr: float = 1.0,
                        local_steps: int = 1, axis="data", channel=None,
                        channel_key: Optional[int] = None,
                        channel_draws=None, prox_mu: float = 0.0,
                        scaffold_state=None):
    """One two-phase stats round (any StatsObjective) with the (K, n, ...)
    client axis sharded over ``axis`` of ``mesh`` (a DeviceMesh; a tuple
    of axes shards it over their product). ``dcco_round_sharded`` is the
    CCO-bound alias. Returns what ``fed_sim.stats_round`` returns.

    SPMD over ``torch.distributed``: every rank calls it with the same
    arguments (the whole cohort, the replicated parameters, optimizer and
    SCAFFOLD states) and works on its contiguous block of K / S clients,
    its block the rank's linear index over ``axis`` (row-major over a
    tuple). The phase-1 aggregate, the phase-2 delta average and the loss
    are all-reduces over ``axis``: the wire collectives of Fig. 2. The
    result is ``fed_sim.stats_round``'s (weights N_k / the all-reduced N)
    up to the regrouping of the Eq.-3 sums; on a world of one, bit for bit
    the unsharded round with ``agg_stats_fn=None``.

    With a ``channel``, ``begin_round`` runs on the whole cohort on every
    rank (participation and weights replicated, no renormalization);
    rank r draws its payloads' randomness from the round's seed folded
    with r; ``post_aggregate`` takes the whole context, whose seed is
    replicated, so every rank adds the same DP noise. ``channel_draws``
    replaces the draws as in ``stats_round``, for this rank: ``"begin"``
    and a DP channel's aggregate-shaped normals as there, a quantized
    wire's uniforms for this rank's K / S clients, and a two-level tree's
    ``{"client": ..., "edge": ...}`` for its clients and its E / S edges.

    SCAFFOLD: the slot variates shard with the clients, the variate-delta
    average is one more all-reduce (the ``"variate"`` phase), and the
    refreshed slots are all-gathered so that ``scaffold_apply_round``
    runs once on the (K, ...) slots, on every rank: the state equals the
    unsharded one. ``wire_bytes`` and ``edge_bytes`` come from the whole
    context, as in the reference.
    """
    server_update = server_update_lib.as_server_update(server_opt)
    if scaffold_state is not None and channel is not None:
        fed_sim.check_variate_noise(channel)
    collectives.check_mesh(mesh, axis)
    nshards = collectives.axis_size(mesh, axis)
    rank = collectives.axis_index(mesh, axis)
    k, n_pad = utils.tree_leaves(client_data)[0].shape[:2]
    if k % nshards:
        raise ValueError(f"a cohort of {k} clients does not split into the "
                         f"{nshards} shards of mesh axis {axis!r}")
    lo, hi = rank * (k // nshards), (rank + 1) * (k // nshards)

    def block(tree):
        return utils.tree_map(lambda x: x[lo:hi], tree)

    batch_l, sizes_l = block(client_data), client_sizes[lo:hi]
    masks = fed_sim._client_masks(sizes_l, n_pad)
    draws = channel_draws or {}
    two_hops = hasattr(channel, "hop_bytes")
    if channel is None:
        ctx = ctx_l = None
        w_l = sizes_l.to(F32) / collectives.psum_tree(
            sizes_l.to(F32).sum(), mesh, axis)
    else:
        if channel_key is None:
            raise ValueError("channel requires channel_key")
        ctx = channel.begin_round(channel_key, client_sizes,
                                  draws.get("begin"))
        ctx_l = ChannelContext(utils.fold_in(ctx.key, rank), ctx.mask[lo:hi],
                               ctx.weights[lo:hi], ctx.num_participants)
        w_l = ctx_l.weights
    wire = torch.zeros((), dtype=F32, device=masks.device)
    edge_wire = torch.zeros((), dtype=F32, device=masks.device)

    def aggregate(tree_k, phase):
        """The server aggregate of one payload: this rank's fold of its
        clients, then the all-reduce over ``axis``."""
        if ctx is None:
            return collectives.psum_tree(_weighted_sum(w_l, tree_k), mesh,
                                         axis)
        pd = draws.get(phase)
        if two_hops:
            enc_d, fold_d = (pd or {}).get("client"), (pd or {}).get("edge")
            post_d = fold_d
        else:
            enc_d, fold_d, post_d = pd, None, pd
        dec = channel.encode_decode(ctx_l, tree_k, phase, enc_d)
        part = channel.local_fold(ctx_l, dec, phase, num_shards=nshards,
                                  draws=fold_d)
        return channel.post_aggregate(
            ctx, collectives.psum_tree(part, mesh, axis), phase, post_d)

    def count_bytes(payload):
        nonlocal wire, edge_wire
        if ctx is not None:
            total, edge = fed_sim.channel_bytes(channel, ctx, payload)
            wire, edge_wire = wire + total, edge_wire + edge

    # ---- phase 1: this rank's clients' stats; all-reduced aggregate
    with torch.no_grad():
        zf, zg = encoder_apply(params, fed_sim._flatten_clients(batch_l))
        d = zf.shape[-1]
        st_k = vmap(objective.stats_masked)(
            zf.reshape(hi - lo, n_pad, d), zg.reshape(hi - lo, n_pad, d),
            masks)
        del zf, zg
        agg = aggregate(st_k, "stats")
        count_bytes(agg)

    # ---- phase 2: local steps against the aggregate; all-reduced deltas
    def client_update(batch, mask, corr=None):
        def loss_fn(p):
            zf_k, zg_k = encoder_apply(p, batch)
            local = objective.stats_masked(zf_k, zg_k, mask)
            return objective.loss_from_stats(objective.combine(local, agg))

        return fed_sim.client_local_steps(loss_fn, params, client_lr,
                                          local_steps, prox_mu=prox_mu,
                                          correction=corr)

    state_l = None
    if scaffold_state is not None:
        state_l = drift_lib.ScaffoldState(scaffold_state.c,
                                          block(scaffold_state.c_slots))
    deltas, losses_k = fed_sim._vmap_clients(client_update, batch_l, masks,
                                             state_l)
    with torch.no_grad():
        avg_delta = aggregate(deltas, "update")
        count_bytes(avg_delta)
        loss = collectives.psum_tree((w_l * losses_k).sum(), mesh, axis)
    params, opt_state = server_update.step(params, opt_state, avg_delta)
    enc_std = objective.encoding_std(agg)
    if scaffold_state is None:
        return params, opt_state, fed_sim.RoundMetrics(loss, enc_std, wire,
                                                       edge_wire)
    with torch.no_grad():
        ck_new = drift_lib.scaffold_new_slot_variates(
            state_l, deltas, client_lr, local_steps)
        del deltas
        agg_dc = aggregate(utils.tree_map(torch.sub, ck_new,
                                          state_l.c_slots), "variate")
        count_bytes(agg_dc)
        scaffold_state = drift_lib.scaffold_apply_round(
            scaffold_state, collectives.all_gather_tree(ck_new, mesh, axis),
            agg_dc, None if ctx is None else ctx.mask)
    return params, opt_state, scaffold_state, fed_sim.RoundMetrics(
        loss, enc_std, wire, edge_wire)


def dcco_round_sharded(encoder_apply: Callable, params, opt_state, server_opt,
                       client_data, client_sizes, mesh, *, lam: float = 20.0,
                       objective=None, **round_kw):
    """Sharded D-CCO == ``stats_round_sharded`` with the CCO objective
    (``lam``); ``objective=`` selects another registered one."""
    return stats_round_sharded(
        encoder_apply, params, opt_state, server_opt, client_data,
        client_sizes, mesh,
        objective=fed_sim.resolve_objective(objective, lam), **round_kw)


def make_round_body(encoder_apply: Callable, server_opt,
                    cfg: EngineConfig, mesh=None) -> Callable:
    """Build round_fn(params, opt_state, batch, sizes, channel_key=None,
    drift=None) -> (params, opt_state, metrics) for ``cfg.algorithm``;
    with ``cfg.scaffold`` it takes the ScaffoldState as ``drift=`` and
    returns (params, opt_state, drift, metrics). With ``cfg.cohort_axis``
    the round is ``stats_round_sharded`` over that axis of ``mesh``."""
    if cfg.algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {cfg.algorithm!r}; "
                         f"expected one of {ALGORITHMS}")
    if cfg.cohort_axis is not None and cfg.algorithm != "dcco":
        raise NotImplementedError(
            "sharded cohorts are implemented for the dcco body only")
    encoder_apply = cast_encoder_apply(encoder_apply, cfg.compute_dtype)
    objective = fed_sim.resolve_objective(cfg.objective, cfg.lam)
    if cfg.objective is not None and cfg.algorithm in (
            "fedavg_contrastive", "fedavg_byol"):
        raise ValueError(
            f"algorithm {cfg.algorithm!r} trains a non-stats loss; "
            f"objective={objective!r} would be silently ignored")
    if cfg.algorithm == "centralized" and (cfg.scaffold or cfg.prox_mu):
        raise ValueError(
            "the centralized body has no local client training, so "
            "drift correction (scaffold / prox_mu) does not apply")
    server_update = _server_update_of(cfg, server_opt)
    channel = cfg.channel
    if channel is not None:
        if cfg.scaffold:
            fed_sim.check_variate_noise(channel)
        if cfg.algorithm == "centralized":
            raise ValueError(
                "the centralized body has no client->server wire; "
                "channel is not applicable")
        if cfg.stats_kernel == "fused" and not channel.supports_flat_stats:
            raise ValueError(
                f"stats_kernel={cfg.stats_kernel!r} aggregates phase-1 "
                f"stats from the flattened cohort, which is incompatible "
                f"with {channel!r} (needs per-client payloads; use "
                f"stats_kernel='off' or None)")
        noise_phases = getattr(channel, "noise_phases", None)
        if (noise_phases is not None and cfg.algorithm in _FEDAVG_KINDS
                and "update" not in noise_phases):
            # fedavg has no stats uplink: a stats-only DP channel would add
            # zero noise while the accountant still reports a finite epsilon
            raise ValueError(
                f"{channel!r} noises only {noise_phases}, but "
                f"{cfg.algorithm!r} ships client updates only — construct "
                f"it with noise_phases=('update',) to noise the aggregate "
                f"it actually releases")

    if cfg.algorithm == "dcco" and cfg.cohort_axis is not None:
        if mesh is None:
            raise ValueError("cohort_axis requires a mesh")
        if cfg.stats_kernel not in (None, "off"):
            raise ValueError(
                f"stats_kernel={cfg.stats_kernel!r} aggregates phase-1 "
                f"stats from the flattened cohort; a sharded cohort "
                f"all-reduces per-client statistics, so use "
                f"stats_kernel='off' or None")

        def round_fn(params, opt_state, batch, sizes, channel_key=None,
                     drift=None):
            return stats_round_sharded(
                encoder_apply, params, opt_state, server_update, batch,
                sizes, mesh, objective=objective, client_lr=cfg.client_lr,
                local_steps=cfg.local_steps, axis=cfg.cohort_axis,
                channel=channel, channel_key=channel_key,
                prox_mu=cfg.prox_mu,
                scaffold_state=_required_drift(drift) if cfg.scaffold
                else None)
        return round_fn

    if cfg.algorithm == "dcco":
        agg_stats_fn = _resolve_agg_stats_fn(cfg, objective)

        def round_fn(params, opt_state, batch, sizes, channel_key=None,
                     drift=None):
            return fed_sim.stats_round(
                encoder_apply, params, opt_state, server_update, batch,
                sizes, objective=objective, client_lr=cfg.client_lr,
                local_steps=cfg.local_steps, agg_stats_fn=agg_stats_fn,
                channel=channel, channel_key=channel_key,
                prox_mu=cfg.prox_mu,
                scaffold_state=_required_drift(drift) if cfg.scaffold
                else None)
        return round_fn

    if cfg.algorithm in _FEDAVG_KINDS:
        kind = _FEDAVG_KINDS[cfg.algorithm]

        def round_fn(params, opt_state, batch, sizes, channel_key=None,
                     drift=None):
            return fed_sim.fedavg_round(
                encoder_apply, params, opt_state, server_update, batch,
                sizes, loss_kind=kind, objective=objective,
                temperature=cfg.temperature, client_lr=cfg.client_lr,
                local_steps=cfg.local_steps, channel=channel,
                channel_key=channel_key, prox_mu=cfg.prox_mu,
                scaffold_state=_required_drift(drift) if cfg.scaffold
                else None)
        return round_fn

    # centralized: union of the cohort, one large-batch stats step
    def round_fn(params, opt_state, batch, sizes, channel_key=None):
        n_pad = utils.tree_leaves(batch)[0].shape[1]
        union = fed_sim._flatten_clients(batch)
        mask = fed_sim._client_masks(sizes, n_pad).reshape(-1)
        return fed_sim.centralized_step(
            encoder_apply, params, opt_state, server_update, union,
            mask=mask, objective=objective)
    return round_fn


# ---------------------------------------------------------------------------
# streaming round body (repro_torch.hierarchy.streaming)
# ---------------------------------------------------------------------------

def make_streaming_round_body(encoder_apply: Callable, server_opt,
                              cfg: EngineConfig, sampler) -> Callable:
    """Build the streaming round body: ``round_fn(params, opt_state, gen,
    channel_key=None) -> (params, opt_state, metrics)``. Unlike the
    materialized bodies it samples INSIDE the round from the round's
    generator ``gen``, one cohort chunk at a time, so the engine never
    holds more than ``cfg.cohort_chunk`` clients of batch data; the
    ``sampler`` must be chunkable (``FederatedDataset.
    make_streaming_sampler`` or a :class:`repro_torch.hierarchy.
    StreamingSampler`)."""
    from repro_torch.hierarchy import streaming as streaming_lib

    if cfg.algorithm != "dcco":
        raise ValueError(
            f"cohort_chunk streams the two-phase stats round only "
            f"(algorithm 'dcco'), got {cfg.algorithm!r}")
    if cfg.cohort_axis is not None:
        raise ValueError(
            "cohort_chunk and cohort_axis are two layouts for the same "
            "client axis; stream it or shard it, not both")
    if cfg.scaffold:
        raise ValueError(
            "SCAFFOLD keeps per-cohort-slot variates resident, which is "
            "exactly the O(cohort) state cohort_chunk removes; disable "
            "scaffold for streaming rounds")
    if cfg.stats_kernel not in (None, "off"):
        raise ValueError(
            "stats_kernel aggregates phase-1 stats from the flattened "
            "materialized cohort; with cohort_chunk the cohort never "
            "materializes, so use the default per-chunk accumulation")
    if not hasattr(sampler, "sample_chunk"):
        raise ValueError(
            "cohort_chunk needs a chunkable sampler "
            "(FederatedDataset.make_streaming_sampler or a "
            "repro_torch.hierarchy.StreamingSampler), got a plain round "
            "sampler")
    if sampler.cohort_chunk != cfg.cohort_chunk:
        raise ValueError(
            f"sampler chunks {sampler.cohort_chunk} clients but "
            f"EngineConfig.cohort_chunk={cfg.cohort_chunk}")
    num_chunks = sampler.num_chunks
    encoder_apply = cast_encoder_apply(encoder_apply, cfg.compute_dtype)
    objective = fed_sim.resolve_objective(cfg.objective, cfg.lam)
    server_update = _server_update_of(cfg, server_opt)
    channel = cfg.channel

    def round_fn(params, opt_state, gen, channel_key=None):
        # the round's O(K)-scalar sampling state, drawn once for both
        # phases
        state = sampler.prepare(gen)
        return streaming_lib.streaming_stats_round(
            encoder_apply, params, opt_state, server_update,
            lambda c: sampler.sample_chunk(state, c), num_chunks,
            sampler.cohort_sizes(state), objective=objective,
            client_lr=cfg.client_lr, local_steps=cfg.local_steps,
            channel=channel, channel_key=channel_key, prox_mu=cfg.prox_mu)

    return round_fn


# ---------------------------------------------------------------------------
# semi-synchronous buffered round body (repro_torch.core.buffer)
# ---------------------------------------------------------------------------

def make_async_round_body(encoder_apply: Callable, server_opt,
                          cfg: EngineConfig) -> Callable:
    """Build the buffered round body: ``round_fn(params, opt_state, astate,
    batch, sizes, delays, channel_key=None, channel_draws=None,
    drift=None) -> (params, opt_state, astate, EngineMetrics row)``; with
    ``cfg.scaffold`` it takes the ScaffoldState as ``drift=`` and returns
    (params, opt_state, astate, drift, metrics).

    Each scheduler tick dispatches a full cohort through the two-phase
    round's math (phase-1 stats, the dispatch cohort's aggregate, phase-2
    deltas), but the server update is DEFERRED: per-client contributions
    are scattered into the in-flight ring at their arrival delay with a
    staleness weight ``s(delay)`` riding the weighted segment-sum fold,
    this tick's arrivals fold into the server buffer, and the update
    applies only when ``cfg.async_k`` contributions have accumulated (then
    the buffer resets). The step is computed every tick and kept by a
    device ``torch.where``, so no tick waits for the host. SCAFFOLD's
    variate refresh is client-side state, so it stays
    dispatch-synchronous: it runs every tick on that tick's deltas, its
    uplink on this tick's wire, and is never buffered.
    """
    if cfg.algorithm != "dcco":
        raise ValueError(
            f"async_k buffers the two-phase stats round only "
            f"(algorithm 'dcco'), got {cfg.algorithm!r}")
    if cfg.cohort_axis is not None:
        raise ValueError(
            "async_k and cohort_axis are not composed: the buffered "
            "scheduler folds per-client contributions on one host; shard "
            "the cohort or buffer it, not both")
    if cfg.stats_kernel == "fused":
        raise ValueError(
            "stats_kernel='fused' aggregates phase-1 stats from the "
            "flattened cohort; the async buffer scatters per-client "
            "contributions by arrival delay, so it needs per-client "
            "payloads")
    encoder_apply = cast_encoder_apply(encoder_apply, cfg.compute_dtype)
    objective = fed_sim.resolve_objective(cfg.objective, cfg.lam)
    staleness_fn = buffer_lib.resolve_staleness(cfg.staleness_fn)
    server_update = _server_update_of(cfg, server_opt)
    channel = cfg.channel
    if channel is not None:
        if getattr(channel, "noise_phases", None) is not None:
            raise ValueError(
                f"{channel!r} with async_k: DP noise calibration across "
                f"staleness-weighted multi-tick aggregates is undefined "
                f"(the per-contribution weights change the sensitivity); "
                f"run DP on the synchronous engine")
        if hasattr(channel, "hop_bytes") and not channel.collapses:
            raise ValueError(
                f"{channel!r} with async_k: a lossy edge hop folds "
                f"per-EDGE aggregates, but the buffer scatters per-CLIENT "
                f"contributions; use a collapsing (ideal-hop) tree or a "
                f"flat channel")
    k_trigger = float(cfg.async_k)

    def round_fn(params, opt_state, astate, batch, sizes, delays,
                 channel_key=None, channel_draws=None, drift=None):
        if cfg.scaffold:
            _required_drift(drift)
        k, n_pad = utils.tree_leaves(batch)[0].shape[:2]
        masks = fed_sim._client_masks(sizes, n_pad)
        draws = channel_draws or {}
        dev = masks.device
        if channel is None:
            ctx = None
            w = sizes.to(F32) / sizes.to(F32).sum()
            pmask = torch.ones((k,), dtype=F32, device=dev)
        else:
            if channel_key is None:
                raise ValueError("channel requires channel_key")
            ctx = channel.begin_round(channel_key, sizes, draws.get("begin"))
            w, pmask = ctx.weights, ctx.mask
        wire = torch.zeros((), dtype=F32, device=dev)
        edge_wire = torch.zeros((), dtype=F32, device=dev)

        # ---- phase 1 (dispatch-synchronous): cohort stats -> aggregate.
        # The dispatch cohort's OWN aggregate drives phase 2: the stop-grad
        # combine needs the round's population estimate at dispatch time.
        with torch.no_grad():
            zf, zg = encoder_apply(params, fed_sim._flatten_clients(batch))
            d = zf.shape[-1]
            st_k = vmap(objective.stats_masked)(
                zf.reshape(k, n_pad, d), zg.reshape(k, n_pad, d), masks)
            if ctx is None:
                st_wire = st_k
                agg = cco.weighted_average_stats(st_k, sizes)
            else:
                # channel.aggregate's math, keeping the decoded per-client
                # payloads: they are what the ring scatters
                st_wire = channel.encode_decode(ctx, st_k, "stats",
                                                draws.get("stats"))
                agg = utils.tree_map(
                    lambda v: torch.tensordot(w, v, dims=1), st_wire)
                agg = channel.post_aggregate(ctx, agg, "stats")
                total, edge = fed_sim.channel_bytes(channel, ctx, agg)
                wire, edge_wire = wire + total, edge_wire + edge

        # ---- phase 2: local steps against the dispatch aggregate
        def client_update(b, m, corr=None):
            def loss_fn(p):
                zf_k, zg_k = encoder_apply(p, b)
                local = objective.stats_masked(zf_k, zg_k, m)
                return objective.loss_from_stats(
                    objective.combine(local, agg))

            return fed_sim.client_local_steps(
                loss_fn, params, cfg.client_lr, cfg.local_steps,
                prox_mu=cfg.prox_mu, correction=corr)

        deltas, losses_k = fed_sim._vmap_clients(
            client_update, batch, masks, drift if cfg.scaffold else None)

        with torch.no_grad():
            if ctx is None:
                d_wire = deltas
            else:
                d_wire = channel.encode_decode(ctx, deltas, "update",
                                               draws.get("update"))
                total, edge = fed_sim.channel_bytes(
                    channel, ctx, utils.tree_map(lambda x: x[0], deltas))
                wire, edge_wire = wire + total, edge_wire + edge
            if cfg.scaffold:
                drift, extra, edge = fed_sim._scaffold_round_tail(
                    drift, deltas, cfg.client_lr, cfg.local_steps, w, ctx,
                    channel, draws.get("variate"))
                wire, edge_wire = wire + extra, edge_wire + edge

            # ---- staleness-weighted scatter into the in-flight ring
            s_w = staleness_fn(delays.to(F32))
            w_eff = w * s_w * pmask
            pending = buffer_lib.dispatch_fold(
                astate.pending, st_wire, d_wire, losses_k, w_eff, pmask,
                delays)
            del d_wire, deltas
            arrived, pending = buffer_lib.ring_pop(pending)
            buf = buffer_lib.buffer_add(astate.buffer, arrived)

            # ---- apply the server update once K contributions arrived
            do_apply = buf.count >= k_trigger
            _, avg_delta, mean_tau = buffer_lib.buffer_aggregate(buf)
            p_new, o_new = server_update.step(params, opt_state, avg_delta)

            def sel(new, old):
                return utils.tree_map(
                    lambda a, b: torch.where(do_apply, a, b), new, old)

            params2, opt2 = sel(p_new, params), sel(o_new, opt_state)
            buf = buffer_lib.buffer_reset_where(buf, do_apply)
            astate2 = buffer_lib.AsyncState(
                buf, pending,
                astate.applied_total + do_apply.to(torch.int32))
        metrics = EngineMetrics(
            (w * losses_k).sum(), objective.encoding_std(agg), wire,
            edge_wire, do_apply.to(F32),
            torch.where(do_apply, mean_tau, torch.zeros_like(mean_tau)), {})
        if cfg.scaffold:
            return params2, opt2, astate2, drift, metrics
        return params2, opt2, astate2, metrics

    return round_fn


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


class RoundEngine:
    """Drives rounds of ``cfg.algorithm``; see the module docstring."""

    def __init__(self, encoder_apply: Callable, server_opt,
                 sampler: Callable, config: EngineConfig = EngineConfig(),
                 mesh=None):
        if config.chunk_rounds < 1:
            raise ValueError(
                f"chunk_rounds must be >= 1, got {config.chunk_rounds}")
        if config.num_clusters < 0:
            raise ValueError(
                f"num_clusters must be >= 0, got {config.num_clusters}")
        if config.retrieval_every < 1:
            raise ValueError(
                f"retrieval_every must be >= 1, got {config.retrieval_every}")
        if config.retrieval_eval is not None and \
                not callable(config.retrieval_eval):
            raise ValueError(
                "retrieval_eval must be a params -> {metric: scalar} "
                "callable (repro_torch.retrieval.make_retrieval_eval) or a "
                "stateful (params, state) -> (metrics, state) one "
                "(repro_torch.retrieval.make_refreshing_retrieval_eval)")
        self._retrieval_stateful = bool(
            getattr(config.retrieval_eval, "stateful", False))
        if self._retrieval_stateful and \
                not callable(getattr(config.retrieval_eval, "init_state",
                                     None)):
            raise ValueError(
                "a stateful retrieval_eval must expose init_state(params) "
                "to seed its index state "
                "(repro_torch.retrieval.make_refreshing_retrieval_eval does)")
        self._retrieval_keys = None  # metric names, from the first eval
        # a sharded engine runs on every rank; rank 0 writes checkpoints
        self._writes_checkpoints = (
            mesh is None or torch.distributed.get_rank() == 0)
        self.config = config
        self.sampler = sampler
        self._encoder_apply = encoder_apply
        self._objective = fed_sim.resolve_objective(config.objective,
                                                    config.lam)
        self.drift_state = None      # final ScaffoldState of the last run()
        self.buffer_state = None     # final AsyncState of the last run()
        self.cluster_state = None    # final ClusterState of the last run()
        if config.cohort_chunk < 0:
            raise ValueError(
                f"cohort_chunk must be >= 0, got {config.cohort_chunk}")
        self._streaming = config.cohort_chunk > 0
        self._async = config.async_k > 0
        self._async_real = False     # True when the buffered path runs
        # num_clusters <= 1: ONE cluster is the global aggregate, so the
        # global body runs (bit-identical)
        self._clustered = config.num_clusters > 1
        if self._clustered and self._async:
            raise ValueError(
                "num_clusters and async_k are not composed: the buffered "
                "scheduler re-associates contributions across ticks, but "
                "cluster targets and slots are per-dispatch; cluster the "
                "synchronous engine")
        if self._clustered and self._streaming:
            raise ValueError(
                "num_clusters assigns clusters from the materialized "
                "cohort's per-client stats; cohort_chunk never "
                "materializes the cohort; drop one")
        if self._clustered and config.cohort_axis is not None:
            raise ValueError(
                "num_clusters and cohort_axis are not composed: the "
                "k-means assignment and per-cluster slots fold on one "
                "host; shard the cohort or cluster it, not both")
        if self._async and self._streaming:
            raise ValueError(
                "async_k and cohort_chunk are two schedulers for the same "
                "round (buffered arrivals vs streamed chunks) and are not "
                "composed; drop one")
        if self._streaming:
            self.round_fn = make_streaming_round_body(
                encoder_apply, server_opt, config, sampler)
            return
        if self._async:
            if not hasattr(sampler, "latency"):
                raise ValueError(
                    "async_k needs a latency-aware sampler emitting "
                    "(batch, sizes, delays): use FederatedDataset."
                    "make_async_round_sampler or repro_torch.data.latency."
                    "make_async_sampler, got a plain round sampler")
            lat = latency_lib.resolve_latency(config.latency)
            if sampler.latency != lat:
                raise ValueError(
                    f"sampler draws delays from {sampler.latency} but "
                    f"EngineConfig.latency resolves to {lat}: the ring "
                    f"horizon and the delay stream must agree")
            k_cohort = sampler.clients_per_round
            if not 1 <= config.async_k <= k_cohort:
                raise ValueError(
                    f"async_k={config.async_k} must be in [1, "
                    f"clients_per_round={k_cohort}]: fewer than one "
                    f"contribution never triggers, more than one cohort "
                    f"can never accumulate before the first apply")
            buffer_lib.resolve_staleness(config.staleness_fn)
            collapsed = (config.async_collapse and lat.kind == "zero"
                         and config.staleness_fn in (None, "unit")
                         and config.async_k == k_cohort)
            if not collapsed:
                # K = cohort, zero latency and unit staleness: every
                # dispatch arrives at once and triggers one apply, so the
                # buffered round IS the sync round and runs as one
                self.round_fn = make_async_round_body(encoder_apply,
                                                      server_opt, config)
                self._async_real = True
                self._horizon = lat.horizon
                return
        if self._clustered:
            self.round_fn = cluster_lib.make_cluster_round_body(
                encoder_apply, server_opt, config)
        else:
            self.round_fn = make_round_body(encoder_apply, server_opt,
                                            config, mesh)

    def _stat_spec(self, params, batch):
        """The objective's stat spec at the encoder's output width, which
        a trace on the ``meta`` device gives without arithmetic."""
        client0 = utils.tree_map(lambda x: _meta(x[0]), batch)
        zf, _ = self._encoder_apply(utils.tree_map(_meta, params), client0)
        return self._objective.stat_spec(zf.shape[-1])

    def _init_async_state(self, params, batch=None):
        """Zero buffered-engine state; without ``batch``, its shapes come
        from one cohort the sampler draws with seed 0 (a template for
        restoring a checkpoint's ``"buffer"``)."""
        if batch is None:
            device = utils.tree_leaves(params)[0].device
            batch = self.sampler(utils.generator(0, device))[0]
        return buffer_lib.init_state(self._stat_spec(params, batch), params,
                                     self._horizon)

    def _init_cluster_state(self, params, opt_state, batch):
        dim = cluster_lib.stats_dim(self._stat_spec(params, batch))
        return cluster_lib.init_cluster_state(
            params, opt_state, self.config.num_clusters, dim)

    def _retrieval_metrics(self, params, r, state):
        """The periodic retrieval eval on round ``r``'s updated params:
        (metrics dict or None off the cadence, state). It only observes:
        no gradient, no randomness, nothing written to ``params``."""
        eval_fn = self.config.retrieval_eval
        if eval_fn is None or r % self.config.retrieval_every != 0:
            return None, state
        with torch.no_grad():
            if self._retrieval_stateful:
                m, state = eval_fn(params, state)
            else:
                m = eval_fn(params)
        m = {k: torch.as_tensor(v, dtype=F32) for k, v in m.items()}
        if self._retrieval_keys is None:
            self._retrieval_keys = tuple(m)
        return m, state

    def _stack_retrieval(self, rows, device) -> dict:
        """Per-round retrieval dicts (None off the cadence) -> {metric:
        (rounds,) f32}, NaN where no eval ran; {} with no eval set, no
        rounds, or before any eval has named the metrics."""
        if not (self.config.retrieval_eval and self._retrieval_keys
                and rows):
            return {}
        nan = torch.tensor(float("nan"), dtype=F32, device=device)
        return {k: torch.stack([nan if m is None else m[k].to(device)
                                for m in rows])
                for k in self._retrieval_keys}

    def run(self, params, opt_state, seed: int, rounds: int, *,
            start_round: int = 0, on_segment: Optional[Callable] = None,
            ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
            ckpt_name: str = "engine", drift_state=None, buffer_state=None,
            cluster_state=None):
        """Run ``rounds`` rounds; returns (params, opt_state, EngineMetrics).

        ``on_segment(round_end, carry, seg_metrics)`` fires after each
        segment of ``chunk_rounds`` rounds, with an :class:`EngineCarry`.
        SCAFFOLD (``EngineConfig.scaffold``), the buffered and the
        clustered paths carry their state from round to round: pass
        ``drift_state=`` / ``buffer_state=`` / ``cluster_state=`` to
        resume it (fresh state otherwise: zero variates for the first
        batch's K slots) and read the final one from ``self.drift_state``
        / ``self.buffer_state`` / ``self.cluster_state``.

        With ``ckpt_dir`` and ``ckpt_every``, ``{ckpt_dir}/{ckpt_name}.
        msgpack`` is written (:mod:`repro_torch.checkpoint`, at step = the
        round reached) at the first segment boundary at or past each
        ``ckpt_every`` rounds: ``{"params", "opt"}``, with ``"drift"``
        under SCAFFOLD, ``"buffer"`` on the buffered path and
        ``"cluster"`` on the clustered one, the reference's blob. Resuming
        is ``run(restored params, restored opt, seed, rest, start_round=
        step, drift_state=..., buffer_state=..., cluster_state=...)``: the
        rounds' draws depend only on ``seed`` and the round number.

        With ``EngineConfig.retrieval_eval`` the ``retrieval`` field of
        the metrics carries per-round recall@k / MRR (NaN on rounds the
        ``retrieval_every`` cadence skips), evaluated after each round on
        its updated params; a stateful eval's state is seeded from the
        initial params and rides the carry (``EngineCarry.reval``)."""
        device = utils.tree_leaves(params)[0].device
        channel = self.config.channel
        scaffold = self.config.scaffold
        drift, buffer, cluster = drift_state, buffer_state, cluster_state
        reval = ()
        if self._retrieval_stateful:
            with torch.no_grad():
                reval = self.config.retrieval_eval.init_state(params)
        cols = tuple([] for _ in EngineMetrics._fields[:-1])
        retrieval_rows = []
        done = last_ckpt = 0
        while done < rounds:
            seg = min(self.config.chunk_rounds, rounds - done)
            per_round = tuple([] for _ in EngineMetrics._fields[:-1])
            seg_retrieval = []
            for r in range(start_round + done, start_round + done + seg):
                round_seed = seed * _ROUND_SEED_STRIDE + r
                gen = utils.generator(round_seed, device)
                key = (None if channel is None
                       else utils.fold_in(round_seed, _CHANNEL_SALT))
                # the streaming body samples inside the round, one chunk
                # at a time: the cohort never materializes here
                out = (None, None) if self._streaming else self.sampler(gen)
                batch, sizes = out[:2]
                if scaffold and drift is None:
                    drift = drift_lib.scaffold_init(params, sizes.shape[0])
                drift_kw = {"drift": drift} if scaffold else {}
                if self._streaming:
                    params, opt_state, m = self.round_fn(params, opt_state,
                                                         gen, key)
                    res = [_sync_metrics(m, device)]
                elif self._async_real:
                    if buffer is None:
                        buffer = self._init_async_state(params, batch)
                    params, opt_state, buffer, *res = self.round_fn(
                        params, opt_state, buffer, batch, sizes, out[2], key,
                        **drift_kw)
                elif self._clustered:
                    if cluster is None:
                        cluster = self._init_cluster_state(params, opt_state,
                                                           batch)
                    params, opt_state, cluster, m = self.round_fn(
                        params, opt_state, cluster, batch, sizes, key)
                    res = [_sync_metrics(m, device)]
                else:
                    # a collapsed async config draws its delays and
                    # ignores them: same cohorts, the sync body
                    params, opt_state, *res = self.round_fn(
                        params, opt_state, batch, sizes, key, **drift_kw)
                    res[-1] = _sync_metrics(res[-1], device)
                if scaffold:
                    drift = res[0]
                m = res[-1]
                for col, x in zip(per_round, m[:-1]):
                    col.append(x)
                rm, reval = self._retrieval_metrics(params, r, reval)
                seg_retrieval.append(rm)
            done += seg
            retrieval_rows.extend(seg_retrieval)
            m = EngineMetrics(*(torch.stack(c) for c in per_round),
                              self._stack_retrieval(seg_retrieval, device))
            for col, x in zip(cols, m[:-1]):
                col.append(x)
            if on_segment is not None:
                on_segment(start_round + done,
                           EngineCarry(params, opt_state,
                                       () if buffer is None else buffer,
                                       () if cluster is None else cluster,
                                       reval,
                                       () if drift is None else drift),
                           m)
            if (ckpt_dir and ckpt_every and done - last_ckpt >= ckpt_every
                    and self._writes_checkpoints):
                blob = {"params": params, "opt": opt_state}
                if scaffold:
                    blob["drift"] = drift
                if self._async_real:
                    blob["buffer"] = buffer
                if self._clustered:
                    blob["cluster"] = cluster
                save_checkpoint(os.path.join(ckpt_dir, f"{ckpt_name}.msgpack"),
                                blob, start_round + done)
                last_ckpt = done
        if channel is not None:
            # host-side bookkeeping (the DP epsilon accountant)
            channel.finalize_rounds(done)
        self.drift_state = drift if scaffold else None
        self.buffer_state = buffer if self._async_real else None
        self.cluster_state = cluster if self._clustered else None
        metrics = EngineMetrics(*(torch.cat(c) if c else torch.zeros((0,))
                                  for c in cols),
                                self._stack_retrieval(retrieval_rows, device))
        return params, opt_state, metrics
