"""Corpus index: the offline half of dual-encoder retrieval serving.

A deployed dual encoder answers nearest-neighbour queries against a corpus
encoded once (paper Sec. 1's use case). ``CorpusIndex`` owns that encoded
corpus:

  * **chunked build**: the corpus is encoded ``chunk`` items at a time
    under ``torch.no_grad``, so the encoder never sees more than one chunk;
    the item axis is padded to a chunk multiple by repeating item 0, as
    the reference pads, and the padding is sliced off;
  * **normalized storage**: embeddings are L2-normalized (cosine == inner
    product, the MIPS kernel's contract) and stored f32 or bf16 (the
    kernel upcasts bf16 rows to f32 as it reads them);
  * **search**: the MIPS top-k kernel's wrapper
    (:mod:`repro_torch.kernels.mips_topk`), which never writes the (Q, N)
    score matrix.

``make_retrieval_eval`` packages index build + search + label-match
metrics (:mod:`repro_torch.core.eval`) into one ``params -> metrics``
function, the periodic in-training eval the RoundEngine runs.

**Streaming refresh** (``refresh_embeddings`` / ``CorpusIndex.refresh`` /
``make_refreshing_retrieval_eval``): a probe re-encodes a strided sample
of each block, and only blocks whose largest probe drift exceeds
``threshold`` are re-encoded in full. Where the reference decides each
block with ``lax.cond`` inside a scan, the port reads the block decisions
to the host once and loops over the blocks to re-encode.

**Persistence** (``CorpusIndex.save`` / ``load``): the reference's
checkpoint layout (:mod:`repro_torch.checkpoint`), ``{"embeddings",
"normalized": int32}`` at step ``num_items``, so an index saved by either
package loads in the other, bf16 storage included.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch import utils
from repro_torch.checkpoint import restore_checkpoint_flat, save_checkpoint
from repro_torch.core import eval as eval_lib
from repro_torch.kernels.mips_topk import mips_topk

F32 = torch.float32


def l2_normalize(z, eps: float = 1e-8):
    z = z.to(F32)
    return z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True),
                           min=eps)


def _pad_items(tree, multiple: int):
    """Pad a corpus tree's item axis up to a ``multiple`` (repeating item
    0). Returns (padded tree, real item count n)."""
    n = utils.tree_leaves(tree)[0].shape[0]
    pad = (-n) % multiple

    def pad_leaf(x):
        x = torch.as_tensor(x)
        if not pad:
            return x
        return torch.cat([x, x[:1].expand((pad,) + tuple(x.shape[1:]))])

    return utils.tree_map(pad_leaf, tree), n


def encode_corpus_chunked(encode_fn: Callable, params, corpus, *,
                          chunk: int = 256, normalize: bool = True,
                          dtype=F32):
    """Encode a corpus tree (leading axis = items) ``chunk`` items at a
    time, under ``torch.no_grad``. Returns (N, d) embeddings in
    ``dtype``."""
    n = utils.tree_leaves(corpus)[0].shape[0]
    ch = min(chunk, n)
    padded, _ = _pad_items(corpus, ch)
    total = utils.tree_leaves(padded)[0].shape[0]
    out = []
    with torch.no_grad():
        for start in range(0, total, ch):
            batch = utils.tree_map(lambda x: x[start:start + ch], padded)
            z = encode_fn(params, batch).to(F32)
            if normalize:
                z = l2_normalize(z)
            out.append(z.to(dtype))
    return torch.cat(out)[:n]


def _block_stack(tree, block: int):
    """Pad a corpus tree's item axis up to a ``block`` multiple (repeating
    item 0) and reshape to (num_blocks, block, ...). Returns (stacked
    tree, real item count n)."""
    n = utils.tree_leaves(tree)[0].shape[0]
    b = min(block, n)
    padded, _ = _pad_items(tree, b)
    return utils.tree_map(
        lambda x: x.reshape((-1, b) + tuple(x.shape[1:])), padded), n


def refresh_embeddings(encode_fn: Callable, params, corpus, embeddings, *,
                       threshold: float, block: int = 64,
                       probes_per_block: int = 4, normalize: bool = True):
    """Drift-gated partial re-encode of an encoded corpus.

      1. **probe**: ``probes_per_block`` strided items per ``block``-item
         block are re-encoded in one batch and compared with their stored
         rows; a block's drift is its largest probe L2 distance;
      2. **targeted re-encode**: blocks whose drift exceeds ``threshold``
         are re-encoded in full (the decisions are read to the host once);
         the others keep their stored rows.

    Returns ``(new_embeddings, stats)`` with scalar tensors in ``stats``:
    ``blocks_refreshed``, ``refresh_fraction`` (of blocks),
    ``items_encoded`` (probes + refreshed blocks), ``max_drift``,
    ``mean_drift``."""
    if not 0 < probes_per_block:
        raise ValueError(f"probes_per_block must be >= 1, "
                         f"got {probes_per_block}")
    stacked, n = _block_stack(corpus, block)
    nb, b = utils.tree_leaves(stacked)[0].shape[:2]
    d = embeddings.shape[1]
    emb_pad, _ = _pad_items(embeddings, b)
    emb_blocks = emb_pad.reshape(nb, b, d)
    dev = embeddings.device

    p = min(probes_per_block, b)
    probe_pos = torch.arange(p, device=dev) * (b // p)

    def enc(batch):
        with torch.no_grad():
            z = encode_fn(params, batch).to(F32)
        return l2_normalize(z) if normalize else z

    probe_items = utils.tree_map(
        lambda x: x[:, probe_pos].reshape((nb * p,) + tuple(x.shape[2:])),
        stacked)
    z_probe = enc(probe_items).reshape(nb, p, d)
    drift = torch.linalg.vector_norm(
        z_probe - emb_blocks[:, probe_pos].to(F32), dim=-1)      # (nb, p)
    # pad slots repeat item 0, whose drift must not refresh the tail block
    probe_global = torch.arange(nb, device=dev)[:, None] * b + probe_pos
    drift = torch.where(probe_global < n, drift, torch.zeros_like(drift))
    block_drift = drift.amax(dim=1)
    do_refresh = block_drift > threshold

    new_blocks = emb_blocks.clone()
    for i in torch.nonzero(do_refresh.cpu()).flatten().tolist():
        items = utils.tree_map(lambda x: x[i], stacked)
        new_blocks[i] = enc(items).to(emb_blocks.dtype)
    new_emb = new_blocks.reshape(nb * b, d)[:n]
    refreshed = do_refresh.sum().to(F32)
    stats = {
        "blocks_refreshed": refreshed,
        "refresh_fraction": refreshed / nb,
        "items_encoded": nb * p + refreshed * b,
        "max_drift": block_drift.max(),
        "mean_drift": drift.mean(),
    }
    return new_emb, stats


class CorpusIndex:
    """An encoded corpus: (N, d) normalized embeddings + top-k search."""

    def __init__(self, embeddings, *, normalized: bool = True):
        if embeddings.dim() != 2:
            raise ValueError(f"embeddings must be (N, d), "
                             f"got {tuple(embeddings.shape)}")
        self.embeddings = embeddings
        self.normalized = normalized

    @property
    def num_items(self) -> int:
        return self.embeddings.shape[0]

    @property
    def dim(self) -> int:
        return self.embeddings.shape[1]

    @classmethod
    def build(cls, encode_fn: Callable, params, corpus, *, chunk: int = 256,
              normalize: bool = True, dtype=F32) -> "CorpusIndex":
        """Encode ``corpus`` (tree, leading axis = items) with
        ``encode_fn(params, chunk_batch) -> (chunk, d)`` a chunk at a time;
        store as ``dtype`` (f32 or bf16)."""
        z = encode_corpus_chunked(encode_fn, params, corpus, chunk=chunk,
                                  normalize=normalize, dtype=dtype)
        return cls(z, normalized=normalize)

    def refresh(self, encode_fn: Callable, params, corpus, *,
                threshold: float, block: int = 64,
                probes_per_block: int = 4) -> dict:
        """Drift-gated in-place update toward the current params (see
        :func:`refresh_embeddings`); returns the stats as floats."""
        new_emb, stats = refresh_embeddings(
            encode_fn, params, corpus, self.embeddings,
            threshold=threshold, block=block,
            probes_per_block=probes_per_block, normalize=self.normalized)
        self.embeddings = new_emb
        return {k: float(v) for k, v in stats.items()}

    def search(self, queries, k: int):
        """Top-k inner-product search: queries (Q, d) -> ((Q, k) f32
        scores, (Q, k) int32 item indices)."""
        return mips_topk(queries.to(F32), self.embeddings, k)

    def save(self, path: str) -> None:
        save_checkpoint(path, {
            "embeddings": self.embeddings,
            "normalized": torch.tensor(int(self.normalized),
                                       dtype=torch.int32),
        }, step=self.num_items)

    @classmethod
    def load(cls, path: str, device=None) -> "CorpusIndex":
        """The index saved at ``path``, its embeddings on ``device`` (the
        card unless ``device="cpu"``) in the type they were saved in."""
        flat, _ = restore_checkpoint_flat(path, utils.resolve_device(device))
        return cls(flat["embeddings"],
                   normalized=bool(int(flat["normalized"])))


def make_retrieval_eval(encode_fn: Callable, corpus, corpus_labels, queries,
                        query_labels, *, ks=(1, 5, 10), chunk: int = 256,
                        index_dtype=F32) -> Callable[[Any], dict]:
    """The periodic in-training retrieval eval: ``eval_fn(params) ->
    {"recall_at_k": ..., "mrr": ...}``. Re-encodes the held-out corpus (a
    chunk at a time) and the queries with the current params, searches at
    k = max(ks) and scores label-match relevance. Everything stays on the
    device."""
    kmax = max(ks)

    def eval_fn(params):
        cz = encode_corpus_chunked(encode_fn, params, corpus, chunk=chunk,
                                   normalize=True, dtype=index_dtype)
        with torch.no_grad():
            qz = l2_normalize(encode_fn(params, queries))
        _, idx = mips_topk(qz, cz, kmax)
        return eval_lib.retrieval_metrics(idx, query_labels, corpus_labels,
                                          ks=ks)

    return eval_fn


def make_refreshing_retrieval_eval(
        encode_fn: Callable, corpus, corpus_labels, queries, query_labels, *,
        threshold: float, block: int = 64, probes_per_block: int = 4,
        ks=(1, 5, 10), chunk: int = 256, index_dtype=F32) -> Callable:
    """Stateful variant of :func:`make_retrieval_eval`: the encoded corpus
    is engine eval state, refreshed drift-gated instead of rebuilt.

    Returns ``eval_fn(params, state) -> (metrics, new_state)`` with
    ``eval_fn.stateful = True`` and ``eval_fn.init_state(params)`` (the
    one full chunked encode). Metrics gain ``refresh_fraction`` and
    ``items_encoded`` beside recall@k and MRR."""
    kmax = max(ks)

    def init_state(params):
        return encode_corpus_chunked(encode_fn, params, corpus, chunk=chunk,
                                     normalize=True, dtype=index_dtype)

    def eval_fn(params, state):
        emb, rstats = refresh_embeddings(
            encode_fn, params, corpus, state, threshold=threshold,
            block=block, probes_per_block=probes_per_block, normalize=True)
        emb = emb.to(index_dtype)
        with torch.no_grad():
            qz = l2_normalize(encode_fn(params, queries))
        _, idx = mips_topk(qz, emb, kmax)
        metrics = dict(eval_lib.retrieval_metrics(
            idx, query_labels, corpus_labels, ks=ks))
        metrics["refresh_fraction"] = rstats["refresh_fraction"]
        metrics["items_encoded"] = rstats["items_encoded"]
        return metrics, emb

    eval_fn.stateful = True
    eval_fn.init_state = init_state
    return eval_fn
