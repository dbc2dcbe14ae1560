"""Serving example: the two inference paths of the framework.

1. Dual-encoder retrieval through the ``repro_torch.retrieval`` subsystem
   (paper Sec 1's use case): build a ``CorpusIndex`` from the
   (pre)trained tower (chunked encode — O(chunk) activation memory), serve
   batched top-k queries via the MIPS top-k kernel behind a
   ``QueryServer``, and score recall@k / MRR against the corpus labels.
   Then the scaling tiers on the same embeddings: a ``ShardedCorpusIndex``
   simulated on one device (must match bit-for-bit), an ``IVFIndex``
   pruning tier (recall vs the exact tier at small nprobe), and a
   drift-gated ``refresh`` after perturbing the tower (re-encodes only
   drifted blocks).
2. Generative decode: batched prefill + autoregressive serve_step with a KV
   cache updated in place (the decode shapes of the dry-run, at smoke
   scale).

Run: PYTHONPATH=src python -m repro_torch.examples.serve_retrieval
     [--docs 256] [--device cpu] (CI smoke: --docs 64 --queries 8)
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import utils
from repro_torch.configs.base import DualEncoderConfig, get_config
from repro_torch.core import eval as eval_lib
from repro_torch.data import synthetic
from repro_torch.examples import _common
from repro_torch.launch import steps as steps_lib
from repro_torch.models import dual_encoder
from repro_torch.retrieval import (CorpusIndex, IVFIndex, QueryServer,
                                   ShardedCorpusIndex, l2_normalize)
from repro_torch.utils import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--docs", type=int, default=256)
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--k", type=int, default=10)
    _common.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=True)
    de = DualEncoderConfig(proj_dims=(64, 64))
    params = dual_encoder.init_dual_encoder(0, cfg, de, device)
    with torch.no_grad():
        return _serve(args, device, cfg, de, params)


def _serve(args, device, cfg, de, params) -> dict:
    # ------------------------------------------------------------ retrieval
    corpus, labels = synthetic.synthetic_labeled_tokens(
        args.docs, 4, 32, vocab=cfg.vocab_size)
    queries, qlabels = synthetic.synthetic_labeled_tokens(
        args.queries, 4, 32, vocab=cfg.vocab_size, seed=9)
    corpus = {"tokens": torch.as_tensor(corpus, device=device)}
    queries = torch.as_tensor(queries, device=device)

    def embed(p, batch):
        z, _ = dual_encoder.encode(cfg, de, p, batch)
        return z

    t0 = time.time()
    index = CorpusIndex.build(embed, params, corpus, chunk=64)
    _common.sync(device)
    print(f"indexed {index.num_items} docs (d={index.dim}) "
          f"in {time.time() - t0:.2f}s")

    server = QueryServer(index, k=args.k, batch=args.queries).warmup()
    q_z = l2_normalize(embed(params, {"tokens": queries}))
    _, top_idx = server.query(q_z)
    metrics = eval_lib.retrieval_metrics(
        top_idx, torch.as_tensor(qlabels, device=device),
        torch.as_tensor(labels, device=device), ks=(1, 5, 10))
    metrics = {k: float(v) for k, v in metrics.items()}
    stats = server.stats()
    print(f"batched retrieval: recall@1={metrics['recall_at_1']:.2f} "
          f"recall@5={metrics['recall_at_5']:.2f} "
          f"recall@10={metrics['recall_at_10']:.2f} "
          f"mrr={metrics['mrr']:.2f} "
          f"(random recall@1 ~0.25; improves with DCCO pretraining)")
    print(f"served {stats['queries']} queries at p50={stats['p50_us']:.0f}us "
          f"(qps={stats['qps']:.0f} wall, {stats['qps_serial']:.0f} serial)")

    # --------------------------------------------- scaling tiers (same index)
    sharded = ShardedCorpusIndex.from_index(index, num_shards=4)
    _, si = sharded.search(q_z, args.k)
    if not torch.equal(si, top_idx):
        raise AssertionError(
            "sharded search must match the flat index bit-for-bit")
    print(f"sharded tier: 4 shards of {sharded.shard_size} rows, "
          f"top-{args.k} bitwise == flat index")

    ivf = IVFIndex.from_index(index, num_centroids=max(8, args.docs // 16),
                              nprobe=4)
    _, ai = ivf.search(q_z, args.k)
    ai, exact = ai.cpu().tolist(), top_idx.cpu().tolist()
    overlap = sum(len(set(a) & set(e)) / args.k
                  for a, e in zip(ai, exact)) / args.queries
    print(f"ivf tier: {ivf.num_centroids} lists (fill {ivf.fill:.2f}), "
          f"nprobe=4 scans ~{4 * ivf.list_len}/{index.num_items} rows, "
          f"recall@{args.k} vs exact = {overlap:.2f}")

    # drift-gated refresh: perturb the tower (training moved the checkpoint)
    # and re-encode only the blocks whose drift probes cross the threshold —
    # drift is heterogeneous across the corpus, so a threshold between the
    # mean and max block drift refreshes the hot blocks and skips the rest.
    # Every leaf takes its noise from one seed, as the reference's key 3.
    def nudge(x):
        gen = utils.generator(3, x.device)
        return x + 0.003 * torch.randn(x.shape, generator=gen,
                                       device=x.device).to(x.dtype)

    moved = utils.tree_map(nudge, params)
    rstats = index.refresh(embed, moved, corpus, threshold=0.3, block=32)
    print(f"refresh: {rstats['blocks_refreshed']:.0f} blocks re-encoded "
          f"({rstats['items_encoded']:.0f} items incl. probes, vs "
          f"{index.num_items} for a full rebuild)")

    # --------------------------------------------------------------- decode
    serve = steps_lib.make_serve_step(cfg)     # updates the cache in place
    prefill = steps_lib.make_prefill_step(cfg, max_len=48)
    logits, cache = prefill(params["tower"], {"tokens": queries[:4, :16]})
    tok = torch.argmax(logits, -1, keepdim=True).to(torch.int32)
    outs = [tok]
    t0 = time.time()
    for _ in range(7):
        logits, cache = serve(params["tower"], cache, {"tokens": tok})
        tok = torch.argmax(logits, -1, keepdim=True).to(torch.int32)
        outs.append(tok)
    _common.sync(device)
    gen = torch.cat(outs, dim=1)
    print(f"decoded 8 tokens x 4 seqs in {time.time() - t0:.2f}s: "
          f"{gen[0].tolist()}")
    return {"metrics": metrics, "stats": stats, "ivf_overlap": overlap,
            "refresh": rstats, "generated": gen}


if __name__ == "__main__":
    main()
