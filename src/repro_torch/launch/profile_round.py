"""Where the time of a DCCO training round goes.

Builds the same run as :mod:`repro_torch.launch.train`, runs ``--warmup``
rounds, times ``--rounds`` more on the host clock (synchronised, no
profiler), then profiles as many again with ``torch.profiler`` and prints
the device's busy share of the profiled wall time and the kernels that
took the device time, grouped by layer. Only device-side events (kernels,
copies) are summed, so a kernel is not counted again under the operator
that launched it.

  PYTHONPATH=src python -m repro_torch.launch.profile_round --full \\
      --clients-per-round 64 --dataset-size 2048

On the CPU (``--device cpu``) there is no device time to read; the
profile then lists host operator times only.
"""
from __future__ import annotations

import argparse
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import (DualEncoderConfig, get_config,
                                      get_dual_encoder_config)
from repro_torch.core import round_engine
from repro_torch.launch import train
from repro_torch.models import dual_encoder
from repro_torch.optim import optimizers as opt_lib
from repro_torch.server import update as server_update_lib
from repro_torch.utils import resolve_device

# kernel-name fragments -> layer (first match wins)
LAYERS = (
    ("cco_stats", "phase-1 statistics kernel (cco_stats)"),
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


def _device_us(evt) -> float:
    """Device time of a device-side event (a kernel or a copy); 0 for the
    host-side operators, whose device time is their kernels' again."""
    if getattr(evt, "device_type", None) != DeviceType.CUDA:
        return 0.0
    return float(evt.device_time_total)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default=None)
    ap.add_argument("--clients-per-round", type=int, default=64)
    ap.add_argument("--samples-per-client", type=int, default=2)
    ap.add_argument("--dataset-size", type=int, default=2048)
    ap.add_argument("--num-classes", type=int, default=5)
    ap.add_argument("--stats-kernel", default="fused",
                    choices=list(round_engine.STATS_KERNELS))
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=10)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config("resnet14-cifar", smoke=args.smoke)
    de_cfg = DualEncoderConfig(
        proj_dims=(64, 64) if args.smoke else
        get_dual_encoder_config("resnet14-cifar").proj_dims, lambda_cco=5.0)
    params = dual_encoder.init_dual_encoder(args.seed, cfg, de_cfg, device)
    opt = server_update_lib.get_server_update(
        "fedavg_sgd", base_opt=opt_lib.adam(2e-3))
    opt_state = opt.init(params)
    data_args = argparse.Namespace(
        dataset_size=args.dataset_size, num_classes=args.num_classes,
        seed=args.seed, samples_per_client=args.samples_per_client,
        partition=None, severity=None, alpha=None)
    ds, _ = train.build_dataset(cfg, data_args)
    engine = round_engine.RoundEngine(
        train.make_apply(cfg, de_cfg), opt,
        ds.make_round_sampler(args.clients_per_round, device),
        round_engine.EngineConfig(lam=5.0, chunk_rounds=1,
                                  stats_kernel=args.stats_kernel))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    params, opt_state, _ = engine.run(params, opt_state, args.seed,
                                      args.warmup)
    sync()
    t0 = time.perf_counter()
    engine.run(params, opt_state, args.seed, args.rounds,
               start_round=args.warmup)
    sync()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.rounds
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.run(params, opt_state, args.seed, args.rounds,
                   start_round=args.warmup)
        sync()
        prof_ms = (time.perf_counter() - t0) * 1e3 / args.rounds
    events = prof.key_averages()
    kernels = sorted(((e.key, e.count, _device_us(e) / 1e3 / args.rounds)
                      for e in events if _device_us(e) > 0),
                     key=lambda x: -x[2])
    busy_ms = sum(ms for _, _, ms in kernels)
    print(f"device {device}; {args.clients_per_round} clients x "
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
              f"{100 * (1 - busy_ms / prof_ms):.1f}%), {launches:.0f} device "
              f"events/round")
        for layer, ms in sorted(by_layer.items(), key=lambda x: -x[1]):
            print(f"  {layer:40s} {ms:9.3f} ms/round "
                  f"{100 * ms / busy_ms:5.1f}% of device time")
        print(f"top {args.top} kernels (device ms/round, launches/round):")
        for name, count, ms in kernels[:args.top]:
            print(f"  {ms:9.4f} {count / args.rounds:6.1f}  {name[:90]}")
    else:
        print("no device time recorded (CPU run, or the profiler saw no "
              "kernels): device busy share not measured")
    return {"wall_ms": wall_ms, "profiled_ms": prof_ms,
            "busy_ms": busy_ms if kernels else None,
            "by_layer": by_layer, "kernels": kernels}


if __name__ == "__main__":
    main()
