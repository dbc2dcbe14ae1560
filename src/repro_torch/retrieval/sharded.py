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
kernel's shard-local form per shard. A multi-device corpus (the
reference's ``shard_map`` over a mesh axis) needs ``torch.distributed``
and waits for ROADMAP §1, item 6.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.mips_topk import mips_topk
from repro_torch.kernels.ref import select_topk
from repro_torch.retrieval.index import (CorpusIndex, encode_corpus_chunked,
                                         refresh_embeddings)

F32 = torch.float32
I32 = torch.int32

_MESH_PENDING = (
    "a corpus sharded over devices needs torch.distributed, which the port "
    "does not use yet (ROADMAP §1, item 6, 'Sharded and streaming "
    "cohorts'); pass mesh=None to simulate the shards on one device")


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


def sharded_mips_topk(q, shards, k: int, *, n_total: int, mesh=None):
    """Top-k MIPS over a stacked (S, shard_size, d) contiguous partition
    of an ``n_total``-row corpus; equal bit for bit to ``mips_topk`` on
    the concatenated corpus (scores, indices, ties)."""
    if mesh is not None:
        raise NotImplementedError(_MESH_PENDING)
    s, shard_size, _ = shards.shape
    if not 1 <= k <= min(shard_size, n_total):
        raise ValueError(
            f"k={k} must be in [1, min(shard_size={shard_size}, "
            f"n_total={n_total})]: every shard must be able to emit k "
            f"candidates; use fewer shards for larger k")
    parts = [mips_topk(q, shards[i], k, index_offset=i * shard_size,
                       n_total=n_total) for i in range(s)]
    return merge_topk(torch.stack([v for v, _ in parts]),
                      torch.stack([i for _, i in parts]), k)


class ShardedCorpusIndex:
    """A :class:`CorpusIndex` cut into contiguous shards, simulated on one
    device. Drop-in for ``QueryServer``: the same ``num_items``/``dim``/
    ``search`` surface and the same results bit for bit."""

    def __init__(self, embeddings, num_shards: int, *, mesh=None,
                 normalized: bool = True):
        if mesh is not None:
            raise NotImplementedError(_MESH_PENDING)
        if embeddings.dim() != 2:
            raise ValueError(f"embeddings must be (N, d), "
                             f"got {tuple(embeddings.shape)}")
        self.num_shards = int(num_shards)
        self.mesh = None
        self.normalized = normalized
        self._n, self._d = embeddings.shape
        self.shards = stack_shards(embeddings, self.num_shards)

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
    def from_index(cls, index: CorpusIndex, num_shards: int, *,
                   mesh=None) -> "ShardedCorpusIndex":
        return cls(index.embeddings, num_shards, mesh=mesh,
                   normalized=index.normalized)

    @classmethod
    def build(cls, encode_fn: Callable, params, corpus, *, num_shards: int,
              mesh=None, chunk: int = 256, normalize: bool = True,
              dtype=F32):
        if mesh is not None:
            raise NotImplementedError(_MESH_PENDING)
        z = encode_corpus_chunked(encode_fn, params, corpus, chunk=chunk,
                                  normalize=normalize, dtype=dtype)
        return cls(z, num_shards, normalized=normalize)

    def refresh(self, encode_fn: Callable, params, corpus, *,
                threshold: float, block: int = 64,
                probes_per_block: int = 4) -> dict:
        """Drift-gated in-place update (see
        :func:`repro_torch.retrieval.index.refresh_embeddings`), then the
        shards are stacked again."""
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
                                 n_total=self._n)
