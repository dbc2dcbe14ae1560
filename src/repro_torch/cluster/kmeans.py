"""Cosine k-means over per-client encoding statistics, all on the device,
so cluster assignment costs the round no host sync.

The feature vector of client k is its flattened phase-1 stats dict. Those
statistics are *already transmitted* under the paper's Eq.-3 protocol,
which is what makes stats-based clustering privacy-neutral: the server
learns nothing a global round did not already ship.

Everything is deterministic given the rows: seeding is farthest-point
(row 0, then repeatedly the row least similar to any chosen seed),
assignment is argmax cosine similarity (ties toward the lowest cluster
id), and Lloyd updates renormalize per-cluster means onto the sphere with
empty clusters keeping their previous centroid. The per-cluster sums and
counts go through the segment-sum kernel's wrapper, like every fold of
the port: deterministic on the card, where ``index_add_`` adds with
atomics.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.segment_sum import segment_sum

F32 = torch.float32


def stats_dim(spec) -> int:
    """Row width D of a flattened stats dict, from the objective's
    ``stat_spec(d)`` ({key: shape}), with no arithmetic."""
    total = 0
    for shape in spec.values():
        size = 1
        for s in shape:
            size *= int(s)
        total += size
    return total


def flatten_stats(st_k) -> torch.Tensor:
    """Stacked per-client stats dict (leaves (K, ...)) -> one (K, D) f32
    row matrix, leaves in sorted-key order (the reference's
    ``jax.tree.leaves`` layout, so centroids compare column by column)."""
    k = next(iter(st_k.values())).shape[0]
    return torch.cat([st_k[key].to(F32).reshape(k, -1)
                      for key in sorted(st_k)], dim=1)


def _unit(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def assign_clusters(rows, centroids) -> torch.Tensor:
    """(K, D) rows x (C, D) centroids -> (K,) int32 cosine assignment
    (``torch.argmax`` returns the first maximum: ties go to the lowest
    cluster id)."""
    sims = _unit(rows.to(F32)) @ _unit(centroids.to(F32)).T
    return torch.argmax(sims, dim=1).to(torch.int32)


def seed_centroids(rows, num_clusters: int) -> torch.Tensor:
    """Deterministic farthest-point seeding on the unit sphere: seed 0 is
    row 0; each next seed is the row whose best similarity to the chosen
    seeds is lowest. (K, D) -> (C, D) unit rows."""
    rows_n = _unit(rows.to(F32))
    cents = torch.zeros((num_clusters, rows.shape[1]), dtype=F32,
                        device=rows.device)
    cents[0] = rows_n[0]
    neg_inf = torch.tensor(float("-inf"), device=rows.device)
    for j in range(1, num_clusters):
        sims = rows_n @ cents.T                                  # (K, C)
        picked = torch.arange(num_clusters, device=rows.device) < j
        best = torch.where(picked[None, :], sims, neg_inf).amax(dim=1)
        cents[j] = rows_n[torch.argmin(best)]
    return cents


def cosine_kmeans(rows, num_clusters: int, *, iters: int = 2,
                  centroids=None):
    """Spherical k-means: ``(assignments (K,) int32, centroids (C, D) unit
    f32)``. ``centroids`` warm-starts Lloyd's (the clustered round passes
    the previous round's: streaming k-means); ``None`` seeds by farthest
    point. Empty clusters keep their previous centroid."""
    rows_n = _unit(rows.to(F32)).contiguous()
    cents = (seed_centroids(rows, num_clusters) if centroids is None
             else centroids.to(F32))
    ones = torch.ones((rows_n.shape[0], 1), dtype=F32, device=rows.device)
    for _ in range(max(1, iters)):
        ids = assign_clusters(rows_n, cents)
        sums = segment_sum(rows_n, ids, num_clusters)
        counts = segment_sum(ones, ids, num_clusters)               # (C, 1)
        cents = torch.where(counts > 0, _unit(sums), cents)
    return assign_clusters(rows_n, cents), cents
