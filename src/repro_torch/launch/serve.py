"""Serving entry point: batched prefill and autoregressive decode of a
transformer tower, or dual-encoder retrieval serving.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch tinyllama-1.1b --smoke --batch 2 --prompt-len 16 --gen 8

(``--arch tinyllama-1.1b`` is the default; the dense configs
``qwen3-1.7b``, ``qwen3-8b`` and ``granite-3-8b``, the DeepSeek towers
``deepseek-moe-16b`` and ``deepseek-v2-lite-16b``, the recurrent
towers ``zamba2-2.7b`` and ``xlstm-350m``, the audio decoder
``musicgen-large`` and the vision-text tower ``internvl2-2b`` serve too;
the last with ``vis_patches`` random patch embeddings a prompt, drawn
bf16 from ``torch.randn``, projected and prepended.) Prefill runs the
prompt through the tower, every attention layer on the CUDA
flash-attention kernel, and fills the cache: the KV cache of each
attention layer (``ModelConfig.kv_cache_dtype``: the model's dtype or
int8), the O(1) state of each recurrent layer; each decode step feeds
one token a sequence against the cache, sized ``--prompt-len + --gen +
1`` positions as the reference sizes it: a vision-text prompt's P
patches do not fit beside the text, so the attention cache keeps the
last positions and decode no longer sees the first patches (the
reference's behaviour; ``generate(max_len=)`` sizes it whole). Decoding
is greedy (``argmax``), or samples at ``--temperature`` with ``torch.multinomial``
on a generator seeded ``--seed``. ``--ckpt FILE`` restores the tower's
parameters from a checkpoint (:mod:`repro_torch.checkpoint`) as the
reference does, from a file whose leaves sit under ``params/``.

``--retrieval`` serves the dual encoder instead (paper Sec. 1's deployed
use case): for each ``--corpus-sizes`` entry it encodes a corpus of
synthetic token sequences into a
:class:`repro_torch.retrieval.CorpusIndex` (a chunk of 256 at a time),
answers ``--serve-batches`` batches of encoded queries through a
``QueryServer`` (the MIPS top-k kernel), and reports build seconds, qps
and p50/p99 latency:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --retrieval --corpus-sizes 512,2048 --serve-batches 8

``--shards S`` serves a ``ShardedCorpusIndex`` (S shards simulated on one
device, the kernel's shard-local form, the unsharded result bit for
bit); ``--ivf C`` the approximate ``IVFIndex`` with C k-means lists
(k-means on the segment-sum kernel), ``--nprobe`` lists scanned a query.

Runs on the GPU unless ``--device cpu`` is given; without a GPU and
without ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs.base import DualEncoderConfig, get_config
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer
from repro_torch.utils import resolve_device


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _restore(path, params, device, what):
    blob, step = restore_checkpoint(path, {"params": params}, device)
    print(f"restored {what} from {path} @ {step}")
    return blob["params"]


def run_retrieval(args) -> list:
    """Retrieval serving: an index build and a QueryServer latency sweep
    per corpus size. Returns one summary dict per size: ``n``,
    ``build_s``, the ``index``, the ``query_embeddings`` and the
    server's ``stats()``."""
    from repro_torch.data import synthetic
    from repro_torch.models import dual_encoder
    from repro_torch.retrieval import (CorpusIndex, IVFIndex, QueryServer,
                                       ShardedCorpusIndex, l2_normalize)

    if args.shards > 0 and args.ivf > 0:
        raise SystemExit("--shards and --ivf are separate serving tiers; "
                         "pick one per run")
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    de = DualEncoderConfig(proj_dims=(64, 64))
    params = dual_encoder.init_dual_encoder(args.seed, cfg, de, device)
    if args.ckpt:
        params = _restore(args.ckpt, params, device, "dual encoder")

    def embed(p, batch):
        z, _ = dual_encoder.encode(cfg, de, p, batch)
        return z

    sizes = [int(s) for s in args.corpus_sizes.split(",")]
    toks, _ = synthetic.synthetic_labeled_tokens(
        max(sizes), 4, args.prompt_len, vocab=cfg.vocab_size, seed=args.seed)
    qtoks, _ = synthetic.synthetic_labeled_tokens(
        args.batch * args.serve_batches, 4, args.prompt_len,
        vocab=cfg.vocab_size, seed=args.seed + 1)
    toks = torch.as_tensor(toks, device=device)
    with torch.no_grad():
        qz = l2_normalize(embed(params, {
            "tokens": torch.as_tensor(qtoks, device=device)}))
    print(f"retrieval serving: {args.arch} d={qz.shape[1]} "
          f"k={args.k} batch={args.batch}")
    if args.shards > 0:
        print(f"  tier: sharded x{args.shards} (simulated on one device)")
    elif args.ivf > 0:
        print(f"  tier: ivf C={args.ivf} nprobe={args.nprobe}")

    out = []
    for n in sizes:
        _sync(device)
        t0 = time.perf_counter()
        corpus = {"tokens": toks[:n]}
        if args.shards > 0:
            idx = ShardedCorpusIndex.build(embed, params, corpus,
                                           num_shards=args.shards,
                                           chunk=min(256, n))
        elif args.ivf > 0:
            idx = IVFIndex.build(embed, params, corpus,
                                 num_centroids=min(args.ivf, n),
                                 nprobe=min(args.nprobe, args.ivf),
                                 chunk=min(256, n))
        else:
            idx = CorpusIndex.build(embed, params, corpus,
                                    chunk=min(256, n))
        _sync(device)
        t_build = time.perf_counter() - t0
        srv = QueryServer(idx, k=args.k, batch=args.batch).warmup()
        for i in range(args.serve_batches):
            srv.query(qz[i * args.batch:(i + 1) * args.batch])
        s = srv.stats()
        print(f"  corpus {n:6d}: built {t_build:6.2f}s | "
              f"qps={s['qps']:8.0f} (serial {s['qps_serial']:8.0f}) "
              f"p50={s['p50_us']:7.0f}us p99={s['p99_us']:7.0f}us "
              f"({s['batches']} batches)")
        out.append({"n": n, "build_s": t_build, "index": idx,
                    "query_embeddings": qz, **s})
    return out


def generate(cfg, params, prompt, gen: int, *, temperature: float = 0.0,
             generator=None, patch_embeds=None, max_len=None) -> dict:
    """Prefill ``prompt`` (B, S), after a vision-text tower's
    ``patch_embeds`` (B, P, vis_dim) where given, and decode ``gen``
    tokens a sequence (the first from the prefill's logits), over a cache
    of ``max_len`` positions (by default S + gen + 1, the reference's).
    Returns ``tokens`` (B, gen) int32, the f32 ``logits`` each token was
    picked from (gen of (B, V)), ``prefill_ms`` and ``decode_ms`` (per
    decoded token), host clock around a synchronised device."""
    device = prompt.device
    if max_len is None:
        max_len = prompt.shape[1] + gen + 1
    prefill = steps_lib.make_prefill_step(cfg, max_len)
    serve = steps_lib.make_serve_step(cfg)

    def pick(logits):
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator).to(
                torch.int32)
        return torch.argmax(logits, -1, keepdim=True).to(torch.int32)

    _sync(device)
    t0 = time.perf_counter()
    batch = {"tokens": prompt}
    if patch_embeds is not None:
        batch["patch_embeds"] = patch_embeds
    logits, cache = prefill(params, batch)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    tok = pick(logits)
    generated, all_logits = [tok], [logits]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = serve(params, cache, {"tokens": tok})
        tok = pick(logits)
        generated.append(tok)
        all_logits.append(logits)
    _sync(device)
    t_dec = time.perf_counter() - t0
    return {"tokens": torch.cat(generated, dim=1), "logits": all_logits,
            "prefill_ms": t_prefill * 1e3,
            "decode_ms": t_dec * 1e3 / max(gen - 1, 1), "cache": cache}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Prefill/decode or retrieval serving (PyTorch port)")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; without a GPU only "
                         "--device cpu runs")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--retrieval", action="store_true",
                    help="serve dual-encoder retrieval (CorpusIndex + MIPS "
                         "QueryServer) instead of generative decode; "
                         "reports qps and p50/p99 latency per "
                         "--corpus-sizes entry")
    ap.add_argument("--corpus-sizes", default="512,2048",
                    help="comma-separated corpus sizes for --retrieval")
    ap.add_argument("--serve-batches", type=int, default=8,
                    help="timed query batches per corpus size "
                         "(--retrieval)")
    ap.add_argument("--k", type=int, default=10,
                    help="retrieved neighbours per query (--retrieval)")
    ap.add_argument("--shards", type=int, default=0,
                    help="partition each index into this many shards, "
                         "simulated on one device (--retrieval; 0 = "
                         "unsharded)")
    ap.add_argument("--ivf", type=int, default=0,
                    help="serve the approximate IVF tier with this many "
                         "k-means centroids (--retrieval; 0 = exact)")
    ap.add_argument("--nprobe", type=int, default=8,
                    help="inverted lists scanned per query (--ivf)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    """Serve; returns ``run_retrieval``'s summaries with ``--retrieval``,
    else ``generate``'s result with the ``prompt`` (and a vision-text
    tower's ``patch_embeds``)."""
    ap = build_parser()
    args = ap.parse_args(argv)

    if args.retrieval:
        if args.batch == ap.get_default("batch"):
            args.batch = 16        # a serving batch, not a decode batch
        return run_retrieval(args)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    gen = torch.Generator().manual_seed(args.seed)
    params = transformer.init_params(cfg, gen, device)
    if args.ckpt:
        params = _restore(args.ckpt, params, device, "tower")
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, dtype=torch.int32).to(device)
    patches = None
    if cfg.modality == "vision_text":
        patches = torch.randn((args.batch, cfg.vis_patches, cfg.vis_dim),
                              generator=gen).to(device, torch.bfloat16)
    sampler = torch.Generator(device=device).manual_seed(args.seed)
    out = generate(cfg, params, prompt, args.gen,
                   temperature=args.temperature, generator=sampler,
                   patch_embeds=patches)
    print(f"prefill: {args.batch}x{args.prompt_len} in "
          f"{out['prefill_ms']:.1f}ms")
    print(f"decode: {args.gen} tokens x {args.batch} "
          f"({out['decode_ms']:.1f} ms/tok)")
    for b in range(args.batch):
        print(f"  seq{b}: prompt={prompt[b, :8].tolist()}... "
              f"-> {out['tokens'][b].tolist()}")
    out["prompt"] = prompt
    if patches is not None:
        out["patch_embeds"] = patches
    return out


if __name__ == "__main__":
    main()
