"""IVF pruning tier: coarse-quantized inverted lists over the encoded
corpus, the recall-vs-qps knob of retrieval serving.

  * **coarse quantizer**: ``num_centroids`` spherical k-means centroids
    trained on the encoded corpus (``train_centroids``: Lloyd's
    iterations, inner-product assignment, re-normalized means). The
    per-centroid sums and counts go through the segment-sum kernel's
    wrapper, deterministic on the card, where ``index_add_`` adds with
    atomics;
  * **inverted lists, contiguous and padded**: items are bucketed by
    nearest centroid into one (C, L, d) embedding block and one (C, L)
    int32 global-index block, L the longest list rounded up to
    ``list_pad``; pad slots hold (zero rows, ``BIG_IDX``) and never enter;
  * **nprobe search** (``_ivf_search``, plain torch as the reference's is
    plain jnp): per query, score the C centroids, take the ``nprobe``
    closest lists, gather them ``probe_chunk`` probes at a time and merge
    into a running top-k with ``select_topk`` (score descending, lowest
    global index on ties);
  * **exact fallback**: ``search_exact`` and any request the probed lists
    cannot honour go to the MIPS kernel's wrapper.

``nprobe == num_centroids`` scans every list once, so it recovers the
exact tier's result.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels.mips_topk import mips_topk
from repro_torch.kernels.ref import BIG_IDX, NEG_INF, select_topk
from repro_torch.kernels.segment_sum import segment_sum
from repro_torch.retrieval.index import (CorpusIndex, encode_corpus_chunked,
                                         l2_normalize)

F32 = torch.float32
I32 = torch.int32


def train_centroids(embeddings, *, num_centroids: int, iters: int = 8,
                    seed: int = 0, init_idx=None):
    """Spherical k-means on (N, d) normalized embeddings -> (C, d)
    normalized centroids. ``init_idx`` (C,) picks the initial centroids
    (a test passes the reference's ``jax.random.permutation`` draw, which
    no torch generator reproduces); by default they are the first C of a
    permutation drawn from ``seed``. Empty clusters keep their previous
    centroid."""
    emb = embeddings.to(F32).contiguous()
    n = emb.shape[0]
    if init_idx is None:
        gen = torch.Generator().manual_seed(int(seed))
        init_idx = torch.randperm(n, generator=gen)[:num_centroids]
    cent = emb[torch.as_tensor(init_idx, device=emb.device).long()]
    ones = torch.ones((n, 1), dtype=F32, device=emb.device)
    for _ in range(iters):
        # torch.argmax returns the first maximum: ties go to the lowest
        # centroid, as jnp.argmax's do
        assign = torch.argmax(emb @ cent.T, dim=1).to(I32)
        sums = segment_sum(emb, assign, num_centroids)
        counts = segment_sum(ones, assign, num_centroids)           # (C, 1)
        new = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                          cent)
        cent = l2_normalize(new)
    return cent


def _ivf_search(q, centroids, lists_emb, lists_idx, *, k: int, nprobe: int,
                n_total: int, probe_chunk: int):
    """The pruned search: coarse top-nprobe, then a running top-k over
    groups of ``probe_chunk`` probe ranks, each group gathered as one
    (Q, probe_chunk * L, d) tile and merged once."""
    q = q.to(F32)
    qn, d = q.shape
    c, ll = lists_idx.shape
    cent_ids = torch.arange(c, dtype=I32, device=q.device).expand(qn, -1)
    _, probes = select_topk(q @ centroids.T, cent_ids, nprobe)   # (Q, np)
    probes = probes.long()
    pc = max(1, min(probe_chunk, nprobe))
    pad = (-nprobe) % pc
    if pad:
        # repeat the last probe to fill the group; select_topk takes a
        # repeated (value, index) pair once
        probes = torch.cat([probes, probes[:, -1:].expand(-1, pad)], dim=1)
    vals = torch.full((qn, k), NEG_INF, dtype=F32, device=q.device)
    idxs = torch.full((qn, k), BIG_IDX, dtype=I32, device=q.device)
    for g in range(probes.shape[1] // pc):
        cols = probes[:, g * pc:(g + 1) * pc]                    # (Q, pc)
        ce = lists_emb[cols].to(F32).reshape(qn, pc * ll, d)
        ci = lists_idx[cols].reshape(qn, pc * ll)
        s = torch.bmm(ce, q[:, :, None])[..., 0]                 # (Q, pc*L)
        s = torch.where(ci < n_total, s, torch.full_like(s, NEG_INF))
        vals, idxs = select_topk(torch.cat([vals, s], dim=1),
                                 torch.cat([idxs, ci], dim=1), k)
    return vals, idxs


class IVFIndex:
    """Inverted-file approximate index over an encoded corpus."""

    def __init__(self, embeddings, centroids, *, nprobe: int = 8,
                 list_pad: int = 8, normalized: bool = True):
        if embeddings.dim() != 2:
            raise ValueError(f"embeddings must be (N, d), "
                             f"got {tuple(embeddings.shape)}")
        self.embeddings = embeddings
        self.centroids = centroids.to(F32)
        self.nprobe = int(nprobe)
        self.normalized = normalized
        n, d = embeddings.shape
        c = self.centroids.shape[0]
        if not 1 <= self.nprobe <= c:
            raise ValueError(f"nprobe={nprobe} must be in [1, "
                             f"num_centroids={c}]")
        # contiguous padded inverted lists, members in ascending index
        dev = embeddings.device
        assign = torch.argmax(embeddings.to(F32) @ self.centroids.T, dim=1)
        counts = torch.bincount(assign, minlength=c)
        pad_to = max(1, int(list_pad))
        ll = int(-(-max(int(counts.max()), 1) // pad_to) * pad_to)
        order = torch.sort(assign, stable=True).indices        # by list, asc
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.arange(n, device=dev) - starts[assign[order]]
        lists_idx = torch.full((c, ll), BIG_IDX, dtype=I32, device=dev)
        lists_idx[assign[order], rank] = order.to(I32)
        lists_emb = torch.zeros((c, ll, d), dtype=embeddings.dtype,
                                device=dev)
        lists_emb[assign[order], rank] = embeddings[order]
        self.list_len = ll
        self.list_counts = counts.cpu().numpy()
        self.lists_idx = lists_idx
        self.lists_emb = lists_emb

    @property
    def num_items(self) -> int:
        return self.embeddings.shape[0]

    @property
    def dim(self) -> int:
        return self.embeddings.shape[1]

    @property
    def num_centroids(self) -> int:
        return self.centroids.shape[0]

    @property
    def fill(self) -> float:
        """Occupied fraction of the padded (C, L) layout."""
        return self.num_items / float(self.num_centroids * self.list_len)

    @classmethod
    def from_index(cls, index: CorpusIndex, *, num_centroids: int,
                   nprobe: int = 8, iters: int = 8, seed: int = 0,
                   list_pad: int = 8) -> "IVFIndex":
        cent = train_centroids(index.embeddings, num_centroids=num_centroids,
                               iters=iters, seed=seed)
        return cls(index.embeddings, cent, nprobe=nprobe, list_pad=list_pad,
                   normalized=index.normalized)

    @classmethod
    def build(cls, encode_fn: Callable, params, corpus, *,
              num_centroids: int, nprobe: int = 8, iters: int = 8,
              seed: int = 0, chunk: int = 256, normalize: bool = True,
              dtype=F32) -> "IVFIndex":
        z = encode_corpus_chunked(encode_fn, params, corpus, chunk=chunk,
                                  normalize=normalize, dtype=dtype)
        cent = train_centroids(z, num_centroids=num_centroids, iters=iters,
                               seed=seed)
        return cls(z, cent, nprobe=nprobe, normalized=normalize)

    def search_exact(self, queries, k: int):
        """The exact tier: the MIPS kernel over the flat embeddings."""
        return mips_topk(queries.to(F32), self.embeddings, k)

    def search(self, queries, k: int, *, nprobe: Optional[int] = None,
               probe_chunk: int = 8):
        """Approximate top-k: queries (Q, d) -> ((Q, k) f32 scores, (Q, k)
        int32 global item indices). ``nprobe`` overrides the index
        default; ``nprobe <= 0``, or k beyond the probed lists' slots,
        falls back to the exact tier."""
        p = self.nprobe if nprobe is None else int(nprobe)
        p = min(p, self.num_centroids)
        if p <= 0 or p * self.list_len < k:
            return self.search_exact(queries, k)
        if not 1 <= k <= self.num_items:
            raise ValueError(f"k={k} must be in [1, corpus size "
                             f"{self.num_items}]")
        return _ivf_search(queries, self.centroids, self.lists_emb,
                           self.lists_idx, k=k, nprobe=p,
                           n_total=self.num_items,
                           probe_chunk=int(probe_chunk))
