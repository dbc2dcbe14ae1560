"""Corpus search over a contiguously partitioned index, with the bits of
the unsharded search.

The (N, d) embedding matrix is cut into S contiguous shards of
ceil(N / S) rows (the last one zero-padded):

  1. every shard runs the MIPS kernel's shard-local form, told its place
     in the corpus by ``index_offset``/``n_total``: each score is the
     kernel's own sum over d of the same two vectors, emitted indices are
     global, and the last shard's padding rows (past ``n_total``) never
     enter;
  2. the S (Q, k) candidate lists are merged by ``select_topk`` on (score
     descending, global index ascending), outside the kernel as in the
     reference.

Every global top-k item is in its shard's top-k, and the merge picks by
the key the unsharded search orders by, so the result equals the
unsharded search bit for bit, ties between duplicated rows in different
shards included.

``mesh=None`` simulates the S shards on one device: one launch of the
kernel's shard-local form per shard. With a ``mesh`` (a DeviceMesh with a
``"corpus"`` axis of S ranks, :func:`repro_torch.sharding.
make_corpus_mesh`) rank r holds only shard r and searches it in one
launch of the shard-local form at ``index_offset = r * shard_size``; the
(Q, k) candidates are all-gathered over the axis (S * Q * k entries,
never rows) and merged on every rank: the reference's ``shard_map``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.mips_topk import mips_topk
from repro_torch.kernels.ref import select_topk
from repro_torch.retrieval.index import (CorpusIndex, encode_corpus_chunked,
                                         refresh_embeddings)
from repro_torch.sharding import collectives

F32 = torch.float32
I32 = torch.int32


def _check_corpus_mesh(mesh, axis: str, num_shards: int) -> None:
    collectives.check_mesh(mesh, axis)
    size = collectives.axis_size(mesh, axis)
    if size != num_shards:
        raise ValueError(f"num_shards={num_shards} must equal the mesh "
                         f"{axis!r} axis size {size} (one shard per rank)")


def stack_shards(embeddings, num_shards: int):
    """Contiguously partition (N, d) into (S, shard_size, d), zero-padding
    the last shard up to shard_size = ceil(N / S): shard s owns global rows
    [s * shard_size, ...), so its padding rows lie past the global end."""
    n, d = embeddings.shape
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if num_shards > n:
        raise ValueError(f"num_shards={num_shards} exceeds corpus size {n}")
    shard_size = -(-n // num_shards)
    pad = num_shards * shard_size - n
    if pad:
        embeddings = torch.cat([embeddings, embeddings.new_zeros((pad, d))])
    return embeddings.reshape(num_shards, shard_size, d)


def merge_topk(vals, idxs, k: int):
    """Merge (S, Q, k) per-shard candidates into the global (Q, k) top-k
    by (value, lowest global index): invariant to shard order."""
    s, qn, kk = vals.shape
    cand_v = vals.permute(1, 0, 2).reshape(qn, s * kk)
    cand_i = idxs.permute(1, 0, 2).reshape(qn, s * kk)
    return select_topk(cand_v.to(F32), cand_i.to(I32), k)


def sharded_mips_topk(q, shards, k: int, *, n_total: int, mesh=None,
                      axis: str = "corpus"):
    """Top-k MIPS over a stacked (S, shard_size, d) contiguous partition
    of an ``n_total``-row corpus; equal bit for bit to ``mips_topk`` on
    the concatenated corpus (scores, indices, ties). With a ``mesh``,
    ``shards`` is this rank's (1, shard_size, d) and the candidates of the
    S ranks of ``axis`` are all-gathered before the merge."""
    s, shard_size, _ = shards.shape
    if not 1 <= k <= min(shard_size, n_total):
        raise ValueError(
            f"k={k} must be in [1, min(shard_size={shard_size}, "
            f"n_total={n_total})]: every shard must be able to emit k "
            f"candidates; use fewer shards for larger k")
    if mesh is not None:
        collectives.check_mesh(mesh, axis)
        if s != 1:
            raise ValueError(f"with a mesh, shards is this rank's one "
                             f"shard (1, shard_size, d), got {s}")
        r = collectives.axis_index(mesh, axis)
        v, i = mips_topk(q, shards[0], k, index_offset=r * shard_size,
                         n_total=n_total)
        got = collectives.all_gather_tree({"v": v[None], "i": i[None]},
                                          mesh, axis)
        return merge_topk(got["v"], got["i"], k)
    parts = [mips_topk(q, shards[i], k, index_offset=i * shard_size,
                       n_total=n_total) for i in range(s)]
    return merge_topk(torch.stack([v for v, _ in parts]),
                      torch.stack([i for _, i in parts]), k)


class ShardedCorpusIndex:
    """A :class:`CorpusIndex` cut into contiguous shards: simulated on one
    device, or with a ``mesh`` one shard a rank over its ``axis`` (each
    rank keeps only its own). Drop-in for ``QueryServer``: the same
    ``num_items``/``dim``/``search`` surface and the same results bit for
    bit."""

    def __init__(self, embeddings, num_shards: int, *, mesh=None,
                 axis: str = "corpus", normalized: bool = True):
        if embeddings.dim() != 2:
            raise ValueError(f"embeddings must be (N, d), "
                             f"got {tuple(embeddings.shape)}")
        self.num_shards = int(num_shards)
        if mesh is not None:
            _check_corpus_mesh(mesh, axis, self.num_shards)
        self.mesh = mesh
        self.axis = axis
        self.normalized = normalized
        self._n, self._d = embeddings.shape
        self.shards = self._place(stack_shards(embeddings, self.num_shards))

    def _place(self, stacked):
        """With a mesh, this rank's (1, shard_size, d) of the stack."""
        if self.mesh is None:
            return stacked
        r = collectives.axis_index(self.mesh, self.axis)
        return stacked[r:r + 1].clone()

    @property
    def num_items(self) -> int:
        return self._n

    @property
    def dim(self) -> int:
        return self._d

    @property
    def shard_size(self) -> int:
        return self.shards.shape[1]

    @classmethod
    def from_index(cls, index: CorpusIndex, num_shards: int, *, mesh=None,
                   axis: str = "corpus") -> "ShardedCorpusIndex":
        return cls(index.embeddings, num_shards, mesh=mesh, axis=axis,
                   normalized=index.normalized)

    @classmethod
    def build(cls, encode_fn: Callable, params, corpus, *, num_shards: int,
              mesh=None, axis: str = "corpus", chunk: int = 256,
              normalize: bool = True, dtype=F32):
        z = encode_corpus_chunked(encode_fn, params, corpus, chunk=chunk,
                                  normalize=normalize, dtype=dtype)
        return cls(z, num_shards, mesh=mesh, axis=axis, normalized=normalize)

    def refresh(self, encode_fn: Callable, params, corpus, *,
                threshold: float, block: int = 64,
                probes_per_block: int = 4) -> dict:
        """Drift-gated in-place update (see
        :func:`repro_torch.retrieval.index.refresh_embeddings`), then the
        shards are stacked again. A rank of a mesh of more than one shard
        holds only its own, so there it is refused: rebuild with
        ``build``."""
        if self.mesh is not None and self.num_shards > 1:
            raise NotImplementedError(
                "ShardedCorpusIndex.refresh needs every shard; a rank of a "
                "corpus mesh holds one: rebuild with ShardedCorpusIndex."
                "build")
        flat = self.shards.reshape(-1, self._d)[:self._n]
        new_emb, stats = refresh_embeddings(
            encode_fn, params, corpus, flat, threshold=threshold,
            block=block, probes_per_block=probes_per_block,
            normalize=self.normalized)
        self.shards = stack_shards(new_emb.to(self.shards.dtype),
                                   self.num_shards)
        return {k: float(v) for k, v in stats.items()}

    def search(self, queries, k: int):
        """Global top-k: queries (Q, d) -> ((Q, k) f32 scores, (Q, k)
        int32 global item indices), equal bit for bit to the unsharded
        ``CorpusIndex.search``."""
        return sharded_mips_topk(queries.to(F32), self.shards, k,
                                 n_total=self._n, mesh=self.mesh,
                                 axis=self.axis)
