"""Batched retrieval query server: the online half of serving.

Wraps a :class:`repro_torch.retrieval.CorpusIndex` (or its sharded / IVF
drop-ins: anything with ``dim`` and ``search``) behind a fixed-batch
search: ragged request batches pad up to ``batch`` and slice back, so the
kernel always sees one shape. Each call keeps one latency sample, the
host clock around the search and a ``torch.cuda.synchronize`` (on a CUDA
index), so a sample covers the dispatch, compute and readback a caller
would see.

Two throughput numbers: ``qps`` is wall-clock (queries / window from the
first sample's start to the last sample's end, gaps between requests
included), ``qps_serial`` the serve-time-only rate (queries / sum of
per-batch latencies, the capacity if requests arrived back to back).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

F32 = torch.float32


def _index_device(index) -> torch.device:
    for name in ("embeddings", "shards"):
        t = getattr(index, name, None)
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


class QueryServer:
    """Fixed-batch top-k query serving over a CorpusIndex."""

    def __init__(self, index, *, k: int = 10, batch: int = 64):
        self.index = index
        self.k = k
        self.batch = batch
        self.device = _index_device(index)
        self._samples: list[tuple[float, float]] = []   # (start_s, end_s)
        self._queries = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self):
        """Run one search outside the measured path (the first call builds
        and loads the kernel)."""
        q = torch.zeros((self.batch, self.index.dim), dtype=F32,
                        device=self.device)
        self.index.search(q, self.k)
        self._sync()
        return self

    def query(self, queries):
        """Serve one request batch: (B, d) with B <= batch -> ((B, k)
        scores, (B, k) indices). Pads B up to the serving batch and
        records one end-to-end latency sample."""
        b = queries.shape[0]
        if b > self.batch:
            raise ValueError(f"request batch {b} exceeds the serving batch "
                             f"{self.batch}")
        if queries.dim() != 2 or queries.shape[-1] != self.index.dim:
            raise ValueError(
                f"queries must be (B, {self.index.dim}) to match the "
                f"index embedding dim, got {tuple(queries.shape)}")
        queries = queries.to(F32)
        if b < self.batch:
            queries = torch.cat([queries, queries.new_zeros(
                (self.batch - b, queries.shape[1]))])
        t0 = time.perf_counter()
        vals, idxs = self.index.search(queries, self.k)
        self._sync()
        self._samples.append((t0, time.perf_counter()))
        self._queries += b
        return vals[:b], idxs[:b]

    def stats(self) -> Optional[dict]:
        """Serving stats over every recorded batch: wall-clock ``qps``,
        serve-time-only ``qps_serial``, and p50/p99 per-batch latency
        (us). None before any query."""
        if not self._samples:
            return None
        lat = np.asarray([(t1 - t0) * 1e6 for t0, t1 in self._samples])
        serial_s = float(lat.sum()) / 1e6
        wall_s = self._samples[-1][1] - self._samples[0][0]
        return {
            "batches": len(self._samples),
            "queries": self._queries,
            "qps": self._queries / max(wall_s, 1e-12),
            "qps_serial": self._queries / max(serial_s, 1e-12),
            "p50_us": float(np.percentile(lat, 50)),
            "p99_us": float(np.percentile(lat, 99)),
        }

    def reset_stats(self):
        self._samples.clear()
        self._queries = 0
