"""D-CCO loss paths of the fused (single-program) train step.

  fused      — centralized-equivalent: CCO on the differentiable global
               batch statistics. By the paper's Appendix-A theorem this
               equals one D-CCO round with one local step.
  per_client — the faithful per-client formulation: per-client statistics,
               their weighted aggregate, the stop-grad combine per client
               and the weighted per-client losses. It mirrors the
               protocol's math; its gradient equals the fused one (tested).
  shard_map  — protocol-faithful at the device level: each rank of a mesh
               plays a client cohort over its rows of the batch. Local
               statistics, their mean over the data axes (one all-reduce,
               the wire aggregation of Fig. 2), the stop-grad combine, the
               loss; the same value on every rank.

The shard_map gradient is the reference's: ``shard_map``'s transpose hands
each shard 1/S of the replicated loss's cotangent and sums the shards'
parameter gradients, which is the fused gradient (Appendix A at device
granularity). ``torch.distributed``'s all-reduce is not differentiable, so
the statistics are reduced as values and the loss carries the 1/S in its
graph (``_rank_share``): autograd on a rank gives its share of the global
gradient, and the caller sums the parameter gradients over the axes
(``launch/steps.py`` does).
"""
from __future__ import annotations

import torch

from repro_torch.core import cco
from repro_torch.sharding import collectives, dtensor

F32 = torch.float32
IMPLS = ("fused", "per_client", "shard_map")


def dcco_loss_fused(zf, zg, lam: float) -> torch.Tensor:
    return cco.cco_loss(zf, zg, lam)


def dcco_loss_per_client(zf, zg, lam: float, clients: int) -> torch.Tensor:
    """Faithful per-client D-CCO objective (equal-size clients laid out
    contiguously): L = sum_k (N_k/N) L_CCO(<.>_k + sg(<.>_A - <.>_k))."""
    st_k = cco.per_client_stats(zf, zg, clients)          # stacked (K, ...)
    w = torch.full((clients,), 1.0 / clients, dtype=F32, device=zf.device)
    agg = cco.weighted_average_stats(st_k, w)

    def client_losses(st, agg):
        return torch.func.vmap(lambda stats_k: cco.cco_loss_from_stats(
            cco.dcco_combine(stats_k, agg), lam))(st)

    if not dtensor.is_dtensor(st_k["cross"]):
        return (w * client_losses(st_k, agg)).sum()
    # DTensor statistics, the clients sharded as the batch's rows: each
    # rank takes the losses of its clients against its copy of the
    # aggregate, and the weighted sum is reduced over the ranks
    losses = dtensor.rows_map(client_losses, st_k, agg)
    return dtensor.settle((dtensor.replicated(w, losses) * losses).sum())


def _rank_share(loss, mesh, data_axes) -> torch.Tensor:
    """``loss``'s value, with a gradient 1/S of its own (S the ranks over
    ``data_axes``): a rank's share of the replicated loss's gradient."""
    s = collectives.axis_size(mesh, data_axes)
    return loss.detach() + (loss - loss.detach()) / s


def dcco_loss_shard_map_local(zf_local, zg_local, lam: float, mesh,
                              data_axes=("data",)) -> torch.Tensor:
    """The body each rank runs over its rows ``zf_local``/``zg_local``
    (equal shards): local statistics, their mean over ``data_axes`` (one
    all-reduce of the detached values), the stop-grad combine, the local
    loss; its value is the global loss's on every rank."""
    local = cco.encoding_stats(zf_local, zg_local)
    agg = collectives.pmean_tree(local, mesh, data_axes)
    return cco.cco_loss_from_stats(cco.dcco_combine(local, agg), lam)


def make_shard_map_dcco_loss(mesh, lam: float, data_axes=("data",)):
    """``loss_fn(zf_local, zg_local)`` over this rank's rows of a batch
    sharded over ``data_axes`` of ``mesh`` (a DeviceMesh): the D-CCO loss
    of the whole batch on every rank, whose autograd gradient summed over
    the ranks is the fused loss's gradient."""
    collectives.check_mesh(mesh, data_axes)

    def loss_fn(zf_local, zg_local):
        return _rank_share(dcco_loss_shard_map_local(
            zf_local, zg_local, lam, mesh, data_axes), mesh, data_axes)

    return loss_fn


def dcco_loss_shard_map_dtensor(zf, zg, lam: float,
                                data_axes=("data",)) -> torch.Tensor:
    """The shard_map loss of DTensor encodings (N, d), as the reference
    runs it inside one SPMD program: under ``local_map`` each rank takes
    its rows over ``data_axes`` (``Shard(0)`` there, replicated over the
    other axes of their mesh) and runs the body of
    :func:`make_shard_map_dcco_loss` on them as plain tensors, so the
    statistics are reduced once, by its all-reduce over the data axes'
    group; the loss is replicated. The body's 1/S gradient share, summed
    by DTensor over the ranks that shard the rows, is the fused loss's
    gradient."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = zf.device_mesh
    axes = collectives.axis_names(data_axes)
    loss_fn = make_shard_map_dcco_loss(mesh, lam, axes)
    rows = [Shard(0) if n in axes else Replicate()
            for n in mesh.mesh_dim_names]
    return dtensor.local_map_tree(
        loss_fn, mesh, [(zf, rows, None), (zg, rows, None)],
        [[Replicate()] * mesh.ndim])


def dcco_loss(zf, zg, lam: float, impl: str = "fused", clients: int = 0,
              mesh=None, data_axes=("data",)) -> torch.Tensor:
    """The D-CCO loss by ``impl``; ``"shard_map"`` takes this rank's rows
    and the ``mesh`` they are sharded over, or DTensor encodings, which
    carry their mesh."""
    if impl == "fused":
        return dcco_loss_fused(zf, zg, lam)
    if impl == "per_client":
        if clients < 1:
            raise ValueError(f"impl 'per_client' needs clients >= 1, got "
                             f"{clients}")
        return dcco_loss_per_client(zf, zg, lam, clients)
    if impl == "shard_map":
        if dtensor.is_dtensor(zf):
            return dcco_loss_shard_map_dtensor(zf, zg, lam, data_axes)
        if mesh is None:
            raise ValueError(
                "impl 'shard_map' needs the mesh the batch is sharded over "
                "(a DeviceMesh: repro_torch.launch.mesh.make_debug_mesh or "
                "repro_torch.sharding.make_multihost_mesh)")
        return make_shard_map_dcco_loss(mesh, lam, data_axes)(zf, zg)
    raise ValueError(f"unknown dcco impl {impl!r}; expected one of "
                     f"{IMPLS}")
