"""Retrieval serving: corpus index + MIPS top-k search + eval.

The serving half of the dual-encoder story (paper Sec. 1): encode an item
corpus once (:class:`CorpusIndex`, chunked build, f32/bf16 normalized
storage), answer batched top-k queries through the hand-written MIPS
kernel (``csrc/mips_topk.cu``, no (Q, N) score matrix), measure serving
throughput and latency (:class:`QueryServer`), and score retrieval
quality during training (``make_retrieval_eval`` -> recall@k / MRR, run
periodically by the RoundEngine).

Scaling tiers on the same index:

  * :class:`ShardedCorpusIndex`: contiguous shards searched by the
    kernel's shard-local form and merged, equal bit for bit to the
    unsharded search (simulated on one device);
  * :class:`IVFIndex`: inverted-file approximate tier with an ``nprobe``
    recall-vs-qps knob and an exact fallback;
  * drift-gated refresh (``CorpusIndex.refresh`` /
    ``make_refreshing_retrieval_eval``): re-encode only the blocks that
    moved.
"""
from repro_torch.retrieval.index import (  # noqa: F401
    CorpusIndex,
    encode_corpus_chunked,
    l2_normalize,
    make_refreshing_retrieval_eval,
    make_retrieval_eval,
    refresh_embeddings,
)
from repro_torch.retrieval.ivf import IVFIndex, train_centroids  # noqa: F401
from repro_torch.retrieval.server import QueryServer  # noqa: F401
from repro_torch.retrieval.sharded import (  # noqa: F401
    ShardedCorpusIndex,
    sharded_mips_topk,
)
