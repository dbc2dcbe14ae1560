"""Training driver: federated stats-objective pretraining
(``--objective dcco|dvicreg|dwmse``) of the ResNet-14 dual encoder, rounds
driven by :class:`repro_torch.core.round_engine.RoundEngine` (the
reference CLI's ``--mode engine`` path), optionally over a lossy client
uplink (``--channel``).

Runs on the GPU unless ``--device cpu`` is given; without a GPU and
without ``--device cpu`` it raises. ``--full`` trains the full-width
model (channels (64, 128, 256), 32x32 images, projection head
(1024, 1024, 1024)); the default ``--smoke`` config is the reduced one.

Examples (full width, on the GPU):
  PYTHONPATH=src python -m repro_torch.launch.train --full --rounds 5 \\
      --clients-per-round 64 --dataset-size 2048 --eval-every 5
  PYTHONPATH=src python -m repro_torch.launch.train --full --rounds 5 \\
      --objective dvicreg --clients-per-round 64 --dataset-size 2048
  PYTHONPATH=src python -m repro_torch.launch.train --full --rounds 5 \\
      --channel int8 --clients-per-round 64 \\
      --dataset-size 2048
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import comm, objectives as objectives_lib
from repro_torch.configs.base import (DualEncoderConfig, get_config,
                                      get_dual_encoder_config)
from repro_torch.core import eval as eval_lib, round_engine
from repro_torch.data import partition as partition_lib
from repro_torch.data import pipeline, synthetic
from repro_torch.models import dual_encoder, resnet as resnet_mod
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


def _forbid_ignored_flags(ap, args, attrs, why: str) -> None:
    """Exit loudly when a flag was set but the selected objective or
    channel would silently ignore it (e.g. --quant-bits without --channel
    quant)."""
    flagged = ["--" + a.replace("_", "-") for a in attrs
               if getattr(args, a) != ap.get_default(a)]
    if flagged:
        raise SystemExit(f"{', '.join(flagged)} would be silently ignored: "
                         f"{why}")


def validate_flags(ap, args) -> None:
    if args.partition is not None and args.alpha is not None:
        raise SystemExit("--alpha is the deprecated spelling of --partition "
                         "dirichlet; pass one, not both")
    if args.partition is None and args.severity is not None:
        raise SystemExit("--severity needs --partition")
    if args.severity is not None and not 0.0 <= args.severity <= 1.0:
        raise SystemExit(f"--severity {args.severity} must be in [0, 1]")
    if args.objective != "dcco":
        _forbid_ignored_flags(
            ap, args, ["lam"],
            f"--lam is the CCO off-diagonal weight; --objective "
            f"{args.objective} has its own hyperparameters")
    if args.channel != "quant":
        _forbid_ignored_flags(
            ap, args, ["quant_bits"],
            f"--quant-bits only applies to --channel quant "
            f"(got --channel {args.channel})")
    if args.channel != "dp":
        _forbid_ignored_flags(
            ap, args, ["dp_sigma", "dp_clip", "dp_delta"],
            f"DP flags only apply to --channel dp (got --channel "
            f"{args.channel})")
    if args.channel != "dropout":
        _forbid_ignored_flags(
            ap, args, ["dropout_p"],
            f"--dropout-p only applies to --channel dropout (got --channel "
            f"{args.channel})")


def make_apply(cfg, de_cfg):
    def apply(p, batch):
        zf, _ = dual_encoder.encode(cfg, de_cfg, p, {"images": batch["v1"]})
        zg, _ = dual_encoder.encode(cfg, de_cfg, p, {"images": batch["v2"]})
        return zf, zg
    return apply


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Federated stats-objective pretraining of the ResNet-14 "
                    "dual encoder (PyTorch port)")
    ap.add_argument("--arch", default="resnet14-cifar")
    ap.add_argument("--objective", default="dcco",
                    choices=list(objectives_lib.OBJECTIVES),
                    help="stats objective trained by the two-phase round")
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
                   default=None,
                   help="'fused': phase-1 aggregate statistics through the "
                        "CUDA cco_stats kernel; 'off': per-client average. "
                        "Default: 'fused' unless --channel needs per-client "
                        "payloads (the lossy channels), then 'off'")

    g = ap.add_argument_group("communication")
    g.add_argument("--channel", default="none",
                   choices=["none", *comm.CHANNELS],
                   help="client->server channel: 'none' = ideal lossless "
                        "wire; 'dense' = f32 wire; 'int8' = 8-bit "
                        "stochastic-rounding quantization; 'quant' = "
                        "--quant-bits quantization; 'dp' = clipped + "
                        "Gaussian-noised aggregation; 'dropout' = "
                        "Bernoulli client dropout")
    g.add_argument("--quant-bits", type=int, default=8,
                   help="wire width for --channel quant")
    g.add_argument("--quant-kernel", choices=["fused"], default="fused",
                   help="quantize->dequantize through the CUDA quantize "
                        "kernel, the only route on the card (the reference's "
                        "'off' and 'interpret' have no counterpart)")
    g.add_argument("--dp-sigma", type=float, default=1.0,
                   help="DP noise multiplier (--channel dp)")
    g.add_argument("--dp-clip", type=float, default=1.0,
                   help="per-client L2 clip norm (--channel dp)")
    g.add_argument("--dp-delta", type=float, default=1e-5,
                   help="target delta for the epsilon accountant")
    g.add_argument("--dropout-p", type=float, default=0.1,
                   help="per-round client dropout probability "
                        "(--channel dropout)")

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
    uplink bytes, final params) for callers that drive it in-process."""
    ap = build_parser()
    args = ap.parse_args(argv)
    validate_flags(ap, args)
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

    objective = objectives_lib.get_objective(
        args.objective,
        **({"lam": args.lam} if args.objective == "dcco" else {}))
    channel = comm.get_channel(
        args.channel, quant_bits=args.quant_bits, dp_sigma=args.dp_sigma,
        dp_clip=args.dp_clip, dp_delta=args.dp_delta,
        dropout_p=args.dropout_p)
    ecfg = round_engine.EngineConfig(
        algorithm="dcco", objective=objective, lam=args.lam,
        client_lr=args.client_lr, local_steps=args.local_steps,
        chunk_rounds=args.chunk_rounds or args.eval_every or 25,
        stats_kernel=args.stats_kernel, channel=channel)
    sampler = ds.make_round_sampler(args.clients_per_round, device)
    engine = round_engine.RoundEngine(make_apply(cfg, de_cfg), opt, sampler,
                                      ecfg)

    history, round_ms, probes, wire = [], [], [], []

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
        wire.extend(float(x) for x in m.wire_bytes.cpu())
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
    wire_bytes = float(sum(wire))
    if channel is not None:
        line = f"channel {channel!r}: uplink {wire_bytes / 1e6:.3f} MB total"
        acct = getattr(channel, "accountant", None)
        if acct is not None:
            line += (f"; DP epsilon={acct.epsilon():.2f} "
                     f"@ delta={acct.delta:g}")
        print(line)
    return {"history": history, "round_ms": round_ms, "probe": probe,
            "probes": probes, "params": params, "device": str(device),
            "wire_bytes": wire_bytes,
            "loss_finite": bool(np.all(np.isfinite(history)))}


if __name__ == "__main__":
    main()
