"""Training driver: federated DCCO pretraining of the ResNet-14 dual
encoder, rounds driven by :class:`repro_torch.core.round_engine.RoundEngine`
(the reference CLI's ``--mode engine`` path).

Runs on the GPU unless ``--device cpu`` is given; without a GPU and
without ``--device cpu`` it raises. ``--full`` trains the full-width
model (channels (64, 128, 256), 32x32 images, projection head
(1024, 1024, 1024)); the default ``--smoke`` config is the reduced one.

Example (full width, on the GPU):
  PYTHONPATH=src python -m repro_torch.launch.train --full --rounds 5 \\
      --clients-per-round 64 --dataset-size 2048 --eval-every 5
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import (DualEncoderConfig, get_config,
                                      get_dual_encoder_config)
from repro_torch.core import eval as eval_lib, round_engine
from repro_torch.data import partition as partition_lib
from repro_torch.data import pipeline, synthetic
from repro_torch.models import dual_encoder, resnet as resnet_mod
from repro_torch.objectives import CCOObjective
from repro_torch.optim import optimizers as opt_lib, schedules
from repro_torch.server import update as server_update_lib
from repro_torch.utils import resolve_device


def build_dataset(cfg, args):
    imgs, labels = synthetic.synthetic_labeled_images(
        args.dataset_size, args.num_classes, image_size=cfg.image_size,
        noise=0.5, seed=args.seed)
    num_clients = max(args.dataset_size // args.samples_per_client, 4)
    if args.partition is not None:
        spec = partition_lib.PartitionSpec(
            args.partition,
            severity=1.0 if args.severity is None else args.severity)
    elif args.alpha is not None:
        spec = partition_lib.PartitionSpec("dirichlet", alpha=args.alpha)
    else:
        # legacy default: the paper's fully non-IID partition (alpha=0)
        spec = partition_lib.PartitionSpec("dirichlet", alpha=0.0)
    return pipeline.FederatedDataset.build(
        {"images": imgs}, labels, num_clients=num_clients,
        samples_per_client=args.samples_per_client, partition=spec,
        seed=args.seed), labels


def validate_flags(args) -> None:
    if args.partition is not None and args.alpha is not None:
        raise SystemExit("--alpha is the deprecated spelling of --partition "
                         "dirichlet; pass one, not both")
    if args.partition is None and args.severity is not None:
        raise SystemExit("--severity needs --partition")
    if args.severity is not None and not 0.0 <= args.severity <= 1.0:
        raise SystemExit(f"--severity {args.severity} must be in [0, 1]")


def make_apply(cfg, de_cfg):
    def apply(p, batch):
        zf, _ = dual_encoder.encode(cfg, de_cfg, p, {"images": batch["v1"]})
        zg, _ = dual_encoder.encode(cfg, de_cfg, p, {"images": batch["v2"]})
        return zf, zg
    return apply


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Federated DCCO pretraining of the ResNet-14 dual "
                    "encoder (PyTorch port)")
    ap.add_argument("--arch", default="resnet14-cifar")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; without a GPU only "
                         "--device cpu runs")
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--clients-per-round", type=int, default=16)
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)

    g = ap.add_argument_group("data & partition")
    g.add_argument("--partition", default=None,
                   choices=list(partition_lib.PARTITIONS))
    g.add_argument("--severity", type=float, default=None)
    g.add_argument("--alpha", type=float, default=None,
                   help="DEPRECATED: raw Dirichlet concentration")
    g.add_argument("--samples-per-client", type=int, default=2)
    g.add_argument("--dataset-size", type=int, default=600)
    g.add_argument("--num-classes", type=int, default=5)

    g = ap.add_argument_group("engine")
    g.add_argument("--chunk-rounds", type=int, default=0,
                   help="rounds per metrics segment (0 = --eval-every)")
    g.add_argument("--stats-kernel", choices=list(round_engine.STATS_KERNELS),
                   default="fused",
                   help="'fused': phase-1 aggregate statistics through the "
                        "CUDA cco_stats kernel; 'off': per-client average")

    g = ap.add_argument_group("server & client optimization")
    g.add_argument("--server-optimizer", default="adam",
                   choices=["sgd", "adam", "lars"])
    g.add_argument("--server-lr", type=float, default=2e-3)
    g.add_argument("--client-lr", type=float, default=1.0)
    g.add_argument("--local-steps", type=int, default=1)
    g.add_argument("--lam", type=float, default=5.0)
    return ap


def main(argv=None) -> dict:
    """Train; returns a summary (losses, ms per round, probe accuracy,
    final params) for callers that drive it in-process."""
    ap = build_parser()
    args = ap.parse_args(argv)
    validate_flags(args)
    device = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=args.smoke)
    de_cfg = DualEncoderConfig(
        proj_dims=(64, 64) if args.smoke else
        get_dual_encoder_config(args.arch).proj_dims,
        lambda_cco=args.lam)
    params = dual_encoder.init_dual_encoder(args.seed, cfg, de_cfg, device)
    sched = schedules.cosine_decay(args.server_lr, args.rounds)
    opt = server_update_lib.get_server_update(
        "fedavg_sgd",
        base_opt=opt_lib.get_optimizer(args.server_optimizer, sched))
    opt_state = opt.init(params)

    ds, labels = build_dataset(cfg, args)
    images = torch.as_tensor(ds.data["images"], device=device)
    labels_t = torch.as_tensor(labels, device=device)
    cut = int(len(labels) * 0.7)

    def evaluate(p):
        with torch.no_grad():
            z = resnet_mod.resnet_forward(cfg, p["tower"], images)
            return float(eval_lib.ridge_linear_probe(
                z[:cut], labels_t[:cut], z[cut:], labels_t[cut:],
                args.num_classes))

    ecfg = round_engine.EngineConfig(
        algorithm="dcco", objective=CCOObjective(lam=args.lam),
        lam=args.lam, client_lr=args.client_lr,
        local_steps=args.local_steps,
        chunk_rounds=args.chunk_rounds or args.eval_every or 25,
        stats_kernel=args.stats_kernel)
    sampler = ds.make_round_sampler(args.clients_per_round, device)
    engine = round_engine.RoundEngine(make_apply(cfg, de_cfg), opt, sampler,
                                      ecfg)

    history, round_ms, probes = [], [], []

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t_seg = [time.perf_counter()]

    def on_segment(round_end, carry, m):
        sync()
        seg_ms = (time.perf_counter() - t_seg[0]) * 1e3 / m.loss.shape[0]
        round_ms.extend([seg_ms] * m.loss.shape[0])
        history.extend(float(x) for x in m.loss.cpu())
        acc = evaluate(carry.params)
        probes.append(acc)
        print(f"round {round_end:5d} loss={history[-1]:9.4f} "
              f"enc_std={float(m.encoding_std[-1]):.4f} "
              f"probe_acc={acc:.3f} ({seg_ms:.1f} ms/round)", flush=True)
        sync()
        t_seg[0] = time.perf_counter()

    params, opt_state, _ = engine.run(params, opt_state, args.seed,
                                      args.rounds, on_segment=on_segment)
    probe = evaluate(params)
    if history:
        print(f"final loss {history[-1]:.4f}; first {history[0]:.4f}; "
              f"probe {probe:.3f}")
    return {"history": history, "round_ms": round_ms, "probe": probe,
            "probes": probes, "params": params, "device": str(device),
            "loss_finite": bool(np.all(np.isfinite(history)))}


if __name__ == "__main__":
    main()
