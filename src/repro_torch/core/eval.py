"""Evaluation protocols (paper Sec. 4): linear evaluation on frozen
encodings, by a closed-form ridge classifier on one-hot targets; the
retrieval metrics (recall@k, MRR) of a ranked index matrix; and a cosine
k-NN probe."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import select_topk

F32 = torch.float32


def ridge_linear_probe(train_z, train_y, test_z, test_y, num_classes: int,
                       l2: float = 1e-2):
    """Fit W on (train_z -> one-hot) in closed form; return test accuracy
    (a scalar tensor on the encodings' device). A system that cannot be
    solved (the encodings of a diverged run are not finite) gives NaN
    rather than raising on the GPU or scoring weights made of garbage."""
    z = train_z.to(F32)
    z = torch.cat([z, torch.ones((z.shape[0], 1), dtype=F32,
                                 device=z.device)], dim=1)      # bias
    y = F.one_hot(train_y.long(), num_classes).to(F32)
    d = z.shape[1]
    a = z.T @ z + l2 * torch.eye(d, dtype=F32, device=z.device)
    w, info = torch.linalg.solve_ex(a, z.T @ y)
    zt = torch.cat([test_z.to(F32), torch.ones((test_z.shape[0], 1),
                                               dtype=F32, device=z.device)],
                   dim=1)
    pred = torch.argmax(zt @ w, dim=-1)
    acc = (pred == test_y.long()).to(F32).mean()
    solved = (info == 0) & torch.isfinite(w).all()
    return torch.where(solved, acc, torch.full_like(acc, float("nan")))


def recall_at_k(retrieved_relevant, ks=(1, 5, 10)):
    """Recall@k over a (Q, K) boolean relevance matrix of ranked retrievals
    (column j = "the rank-j item is relevant to query i"). Returns
    {k: fraction of queries with >= 1 relevant item in the top k} as f32
    scalars. Every k must be <= K: silently truncated recall would read
    as a real score."""
    rel = torch.as_tensor(retrieved_relevant)
    for k in ks:
        if k > rel.shape[1]:
            raise ValueError(f"recall@{k} needs >= {k} ranked items, "
                             f"got {rel.shape[1]}")
    return {k: rel[:, :k].any(dim=1).to(F32).mean() for k in ks}


def mean_reciprocal_rank(retrieved_relevant):
    """MRR over a (Q, K) boolean relevance matrix of ranked retrievals:
    mean of 1/rank of each query's first relevant item (0 for queries with
    none in the top K)."""
    rel = torch.as_tensor(retrieved_relevant)
    first = torch.argmax(rel.to(torch.int32), dim=1)   # first True, 0 if none
    found = rel.any(dim=1)
    rr = 1.0 / (first.to(F32) + 1.0)
    return torch.where(found, rr, torch.zeros_like(rr)).mean()


def retrieval_metrics(retrieved_idx, query_labels, corpus_labels,
                      ks=(1, 5, 10)):
    """Label-match retrieval quality of a ranked (Q, K) index matrix: an
    item is relevant to a query when their labels agree. Returns
    {"recall_at_<k>": ..., "mrr": ...} f32 scalars; MRR is computed within
    the K retrieved ranks."""
    rel = corpus_labels[retrieved_idx.long()] == query_labels[:, None]
    out = {f"recall_at_{k}": v for k, v in recall_at_k(rel, ks).items()}
    out["mrr"] = mean_reciprocal_rank(rel)
    return out


def knn_probe(train_z, train_y, test_z, test_y, k: int = 5,
              num_classes: int = None):
    """Cosine k-NN accuracy, a second, parameter-free probe. The
    neighbours are the k most similar training rows, ties to the lowest
    row (``select_topk``); the vote's ties go to the lowest class."""
    if num_classes is None:
        num_classes = int(train_y.max()) + 1

    def norm(z):
        z = z.to(F32)
        return z / torch.clamp(torch.linalg.vector_norm(z, dim=-1,
                                                        keepdim=True),
                               min=1e-8)

    sim = norm(test_z) @ norm(train_z).T                     # (T, N)
    ids = torch.arange(sim.shape[1], dtype=torch.int32,
                       device=sim.device).expand(sim.shape[0], -1)
    _, idx = select_topk(sim, ids, k)
    votes = train_y.long()[idx.long()]                       # (T, k)
    counts = F.one_hot(votes, num_classes).sum(dim=1)
    pred = torch.argmax(counts, dim=-1)
    return (pred == test_y.long()).to(F32).mean()
