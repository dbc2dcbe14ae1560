"""Where the time of a training round goes.

Builds the same run as :mod:`repro_torch.launch.train` on one of its
paths (``--path``: the plain DCCO round; the two-level tree over 8 edges
with an int8 client hop; clustered aggregation over 4 clusters; the
buffered engine with async_k 32 and heavy-tail delays; the plain round
with the retrieval eval after it, corpus the first three quarters of the
dataset and queries the rest; the FedAvg baselines ``fedavg_contrastive``
and ``fedavg_cco``, which have no phase 1) for the ``--arch`` tower (the ResNet-14, or a
dense transformer over ``--seq-len`` tokens), runs ``--warmup``
rounds, times ``--rounds`` more on the host clock (synchronised, no
profiler), then profiles as many again with ``torch.profiler`` and prints
the device's busy share of the profiled wall time and the kernels that
took the device time, grouped by layer. Only device-side events (kernels,
copies) are read, so a kernel is not counted again under the operator
that launched it; a record the profiler holds twice (same kernel, same
start and end) is read once, and busy time is the union of the
intervals, so kernels that overlap on two streams do not count twice.
The summed kernel time, and its share on each stream, are printed beside
it. ``--fedprox-mu``, ``--scaffold``, ``--compute-dtype``,
``--local-steps``, ``--client-lr`` and ``--cohort-chunk`` (the cohort
streamed through the round in chunks of that many clients) set the round
as train's flags of those names do.

  PYTHONPATH=src python -m repro_torch.launch.profile_round --full \\
      --clients-per-round 64 --dataset-size 2048 [--path clustered]
  PYTHONPATH=src python -m repro_torch.launch.profile_round --full \\
      --arch tinyllama-1.1b --seq-len 128 --clients-per-round 8
  PYTHONPATH=src python -m repro_torch.launch.profile_round --full \\
      --scaffold --local-steps 2 [--compute-dtype bfloat16]

On the CPU (``--device cpu``) there is no device time to read; the
profile then lists host operator times only.
"""
from __future__ import annotations

import argparse
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import comm, hierarchy, retrieval
from repro_torch.configs.base import (DualEncoderConfig, get_config,
                                      get_dual_encoder_config)
from repro_torch.core import round_engine
from repro_torch.data import latency as latency_lib
from repro_torch.launch import train
from repro_torch.models import dual_encoder
from repro_torch.optim import optimizers as opt_lib
from repro_torch.server import update as server_update_lib
from repro_torch.utils import resolve_device

# kernel-name fragments -> layer (first match wins)
LAYERS = (
    ("cco_stats", "phase-1 statistics kernel (cco_stats)"),
    ("flash_fwd", "flash-attention kernel (flash_attention)"),
    ("flash_bwd", "flash-attention backward kernel (flash_attention_bwd)"),
    # Hopper cuBLAS (nvjet), a gemm through xmma, and gemv are products;
    # cuDNN's implicit-gemm convolutions are named xmma_fprop/dgrad/wgrad
    ("nvjet", "matrix products (cuBLAS)"),
    ("xmma_gemm", "matrix products (cuBLAS)"),
    ("gemv", "matrix products (cuBLAS)"),
    ("mips", "MIPS top-k kernel (mips_topk)"),
    ("segment_sum", "segment-sum kernel (segment_sum)"),
    ("qdq_kernel", "quantize kernel (quant_dequant)"),
    ("conv", "convolutions (cuDNN)"), ("xmma", "convolutions (cuDNN)"),
    ("cudnn", "convolutions (cuDNN)"), ("dgrad", "convolutions (cuDNN)"),
    ("wgrad", "convolutions (cuDNN)"),
    ("gemm", "matrix products (cuBLAS)"), ("cutlass", "matrix products "
                                          "(cuBLAS)"),
    ("reduce", "reductions (norms, statistics)"),
)


def _layer(name: str) -> str:
    low = name.lower()
    for frag, layer in LAYERS:
        if frag in low:
            return layer
    return "elementwise and other"


def device_time(records):
    """Read device-side records ``(name, start_us, end_us)``: drop exact
    duplicates, then return ``(kernels, union_us, summed_us, dropped)``
    with ``kernels`` a list of ``(name, count, us)``, ``union_us`` the
    time in which at least one record ran, ``summed_us`` their summed
    durations and ``dropped`` the number of duplicates."""
    unique = set(records)
    per_name: dict = {}
    for name, a, b in unique:
        count, us = per_name.get(name, (0, 0.0))
        per_name[name] = (count + 1, us + (b - a))
    union_us, reach = 0.0, float("-inf")
    for _, a, b in sorted(unique, key=lambda r: r[1]):
        if b > reach:
            union_us += b - max(a, reach)
            reach = b
    kernels = [(name, count, us) for name, (count, us) in per_name.items()]
    return (kernels, union_us, sum(us for *_, us in kernels),
            len(records) - len(unique))


PATHS = ("dcco", "hierarchical", "clustered", "buffered", "retrieval",
         "fedavg_contrastive", "fedavg_cco")


def _path_config(path: str, seed: int) -> dict:
    """EngineConfig fields of ``path``, as ``chip_smoke.py``'s training
    paths set them through train's flags."""
    if path == "hierarchical":
        return {"channel": hierarchy.HierarchicalChannel(
            8, client_channel=comm.QuantizedChannel(8),
            edge_channel=comm.DenseChannel())}
    if path == "clustered":
        return {"num_clusters": 4}
    if path == "buffered":
        return {"async_k": 32, "staleness_fn": "poly",
                "latency": latency_lib.LatencyModel(
                    "heavytail", horizon=8, tail=1.0, seed=seed)}
    if path.startswith("fedavg_"):
        return {"algorithm": path}
    return {}


def _retrieval_eval(cfg, de_cfg, ds, labels, device):
    """The retrieval path's eval, as train's ``--retrieval-eval`` builds
    it: the first three quarters of the dataset indexed, the rest
    queried."""
    leaf = dual_encoder.input_leaf(cfg)
    data = torch.as_tensor(ds.data[leaf], device=device)
    labels = torch.as_tensor(labels, device=device)
    nc = len(labels) * 3 // 4

    def embed(p, batch):
        return dual_encoder.encode(cfg, de_cfg, p, batch)[0]

    return retrieval.make_retrieval_eval(
        embed, {leaf: data[:nc]}, labels[:nc],
        {leaf: data[nc:]}, labels[nc:], chunk=min(256, nc))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="resnet14-cifar")
    ap.add_argument("--seq-len", type=int, default=64,
                    help="tokens a sequence (token archs)")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default=None)
    ap.add_argument("--clients-per-round", type=int, default=64)
    ap.add_argument("--samples-per-client", type=int, default=2)
    ap.add_argument("--dataset-size", type=int, default=2048)
    ap.add_argument("--num-classes", type=int, default=5)
    ap.add_argument("--path", default="dcco", choices=list(PATHS))
    ap.add_argument("--stats-kernel", default=None,
                    choices=list(round_engine.STATS_KERNELS),
                    help="as train's flag; default: 'fused' where the "
                         "path allows it")
    ap.add_argument("--compute-dtype", default="float32",
                    choices=sorted(round_engine.COMPUTE_DTYPES),
                    help="as train's flag")
    ap.add_argument("--fedprox-mu", type=float, default=0.0,
                    help="as train's flag")
    ap.add_argument("--scaffold", action="store_true",
                    help="as train's flag")
    ap.add_argument("--local-steps", type=int, default=1,
                    help="as train's flag")
    ap.add_argument("--client-lr", type=float, default=1.0,
                    help="as train's flag")
    ap.add_argument("--cohort-chunk", type=int, default=0,
                    help="as train's flag (the dcco and hierarchical "
                         "paths)")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=10)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    de_cfg = DualEncoderConfig(
        proj_dims=(64, 64) if args.smoke else
        get_dual_encoder_config(args.arch).proj_dims, lambda_cco=5.0)
    params = dual_encoder.init_dual_encoder(args.seed, cfg, de_cfg, device)
    opt = server_update_lib.get_server_update(
        "fedavg_sgd", base_opt=opt_lib.adam(2e-3))
    opt_state = opt.init(params)
    data_args = argparse.Namespace(
        dataset_size=args.dataset_size, num_classes=args.num_classes,
        seed=args.seed, samples_per_client=args.samples_per_client,
        seq_len=args.seq_len, partition=None, severity=None, alpha=None)
    ds, labels = train.build_dataset(cfg, data_args)
    fields = _path_config(args.path, args.seed)
    if args.path == "retrieval":
        fields["retrieval_eval"] = _retrieval_eval(cfg, de_cfg, ds, labels,
                                                   device)
    ecfg = round_engine.EngineConfig(
        lam=5.0, chunk_rounds=1, stats_kernel=args.stats_kernel,
        compute_dtype=args.compute_dtype, prox_mu=args.fedprox_mu,
        scaffold=args.scaffold, local_steps=args.local_steps,
        client_lr=args.client_lr, cohort_chunk=args.cohort_chunk, **fields)
    if ecfg.cohort_chunk:
        sampler = ds.make_streaming_sampler(args.clients_per_round,
                                            ecfg.cohort_chunk, device)
    elif ecfg.async_k:
        sampler = ds.make_async_round_sampler(args.clients_per_round, device,
                                              ecfg.latency)
    else:
        sampler = ds.make_round_sampler(args.clients_per_round, device)
    engine = round_engine.RoundEngine(train.make_apply(cfg, de_cfg), opt,
                                      sampler, ecfg)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def rounds(n):
        # SCAFFOLD, the buffered and the clustered paths carry their state
        engine.run(params, opt_state, args.seed, n, start_round=args.warmup,
                   drift_state=engine.drift_state,
                   buffer_state=engine.buffer_state,
                   cluster_state=engine.cluster_state)

    params, opt_state, _ = engine.run(params, opt_state, args.seed,
                                      args.warmup)
    sync()
    t0 = time.perf_counter()
    rounds(args.rounds)
    sync()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.rounds
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        rounds(args.rounds)
        sync()
        prof_ms = (time.perf_counter() - t0) * 1e3 / args.rounds
    device_events = [e for e in prof.events()
                     if getattr(e, "device_type", None) == DeviceType.CUDA]
    records = [(e.name, e.time_range.start, e.time_range.end)
               for e in device_events]
    kernels, union_us, summed_us, dropped = device_time(records)
    per_stream: dict = {}            # the profiler's resource id: a stream
    for e in device_events:
        sid = getattr(e, "device_resource_id", None)
        per_stream[sid] = per_stream.get(sid, 0.0) + e.time_range.elapsed_us()
    kernels = sorted(((name, count, us / 1e3 / args.rounds)
                      for name, count, us in kernels), key=lambda x: -x[2])
    busy_ms = union_us / 1e3 / args.rounds
    summed_ms = summed_us / 1e3 / args.rounds
    drift = "".join(f"; {flag}" for flag, on in (
        (f"fedprox mu {args.fedprox_mu}", args.fedprox_mu),
        ("scaffold", args.scaffold),
        (f"compute {args.compute_dtype}", args.compute_dtype != "float32"),
        (f"local steps {args.local_steps}", args.local_steps != 1),
        (f"client lr {args.client_lr!r}", args.client_lr != 1.0),
        (f"cohort chunk {args.cohort_chunk}", args.cohort_chunk)) if on)
    print(f"path {args.path}{drift}; arch {args.arch}; device {device}; "
          f"{args.clients_per_round} "
          f"clients x "
          f"{args.samples_per_client}; wall {wall_ms:.3f} ms/round over "
          f"{args.rounds} rounds ({prof_ms:.3f} ms/round under the "
          f"profiler)")
    by_layer: dict = {}
    for name, _, ms in kernels:
        by_layer[_layer(name)] = by_layer.get(_layer(name), 0.0) + ms
    if kernels:
        launches = sum(count for _, count, _ in kernels) / args.rounds
        print(f"device busy {busy_ms:.3f} ms/round = "
              f"{100 * busy_ms / prof_ms:.1f}% of the profiled wall (idle "
              f"{100 * (1 - busy_ms / prof_ms):.1f}%; the union of the "
              f"kernels' intervals), {launches:.0f} device events/round; "
              f"kernel time summed {summed_ms:.3f} ms/round; "
              f"{dropped / args.rounds:.0f} duplicate records/round dropped")
        print(f"device records on {len(per_stream)} stream(s), summed ms/"
              f"round: " + ", ".join(
                  f"{sid}: {us / 1e3 / args.rounds:.3f}" for sid, us in
                  sorted(per_stream.items(), key=lambda x: -x[1])))
        for layer, ms in sorted(by_layer.items(), key=lambda x: -x[1]):
            print(f"  {layer:40s} {ms:9.3f} ms/round "
                  f"{100 * ms / summed_ms:5.1f}% of summed kernel time")
        print(f"top {args.top} kernels (device ms/round, launches/round):")
        for name, count, ms in kernels[:args.top]:
            print(f"  {ms:9.4f} {count / args.rounds:6.1f}  {name[:90]}")
    else:
        print("no device time recorded (CPU run, or the profiler saw no "
              "kernels): device busy share not measured")
    return {"wall_ms": wall_ms, "profiled_ms": prof_ms,
            "busy_ms": busy_ms if kernels else None,
            "summed_ms": summed_ms if kernels else None,
            "by_layer": by_layer, "kernels": kernels}


if __name__ == "__main__":
    main()
