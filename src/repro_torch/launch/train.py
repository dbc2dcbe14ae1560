"""Training driver: federated stats-objective pretraining
(``--objective dcco|dvicreg|dwmse``) of the ResNet-14 dual encoder or, with
``--arch tinyllama-1.1b|qwen3-1.7b|qwen3-8b|granite-3-8b`` (dense),
``deepseek-moe-16b|deepseek-v2-lite-16b`` (MoE, MLA),
``zamba2-2.7b|xlstm-350m`` (Mamba2 hybrid, mLSTM/sLSTM),
``musicgen-large`` (codec tokens) or ``internvl2-2b`` (its text views,
as the reference trains it; the patch projector gets no gradient), of a
token tower's dual encoder (``--seq-len`` tokens a sequence,
``--num-layers`` to cut its depth to a whole number of superblocks),
rounds
driven by :class:`repro_torch.core.round_engine.RoundEngine` (``--mode
engine``, the default; the other modes are below), optionally over a
lossy client uplink (``--channel``), through a two-level client -> edge
-> server tree
(``--edges``, ``--edge-channel``), with cluster-aware aggregation
(``--clusters``) or on the FedBuff-style buffered engine (``--async-k``,
``--staleness``, ``--latency-tail``), optionally scoring retrieval of a
held-out split every few rounds (``--retrieval-eval``: recall@1/5/10 and
MRR, searched by the MIPS top-k kernel). ``--server-opt`` selects the
server strategy (the FedAvg delegate of ``--server-optimizer``, or FedAvgM,
FedAdagrad, FedAdam, FedYogi with ``--server-tau``). ``--fedprox-mu`` and
``--scaffold`` correct client drift (FedProx's proximal term, SCAFFOLD's
control variates, their deltas an uplink through ``--channel``), and
``--compute-dtype bfloat16`` runs the encoder in bf16 with f32 statistics
and state. The ridge probe reads the ResNet tower; for a token tower it
reports NaN, as the reference's does.

Checkpoints (:mod:`repro_torch.checkpoint`, the reference's msgpack
layout): the engine writes ``{--ckpt-dir}/{--arch}.msgpack`` at the first
segment boundary at or past every ``--ckpt-every`` rounds (``{"params",
"opt"}``, plus ``"drift"`` with ``--scaffold``, ``"buffer"`` on the
buffered engine and ``"cluster"`` with ``--clusters``), and the run's
losses go to ``{--ckpt-dir}/history.json``. ``--resume FILE`` restores
the parameters, the server state, SCAFFOLD's variates and the buffered
engine's buffer, then runs the rounds from the checkpoint's step to
``--rounds``: the same rounds, bit for bit, as a run that never stopped.
As in the reference, the clustered state is written but not resumed.

``--cohort-chunk N`` streams each round's cohort through the engine in
chunks of N clients (:mod:`repro_torch.hierarchy.streaming`): peak memory
O(N) instead of O(cohort), so a round can hold many more clients.

Three execution modes, as in the reference:
  * ``--mode engine``   (default) the round engine
                        (:class:`repro_torch.core.round_engine.RoundEngine`),
                        every path above;
  * ``--mode fused``    the fused D-CCO train step
                        (:func:`repro_torch.launch.steps.
                        make_dcco_train_step`) on the flattened cohort: one
                        step == one federated round by the Appendix-A
                        theorem; ``--micro M`` runs it as exact microbatched
                        large-batch CCO over M microbatches;
  * ``--mode protocol`` one ``fed_sim.stats_round`` a round on the cohort
                        ``round_batch`` gathers on the host (the
                        reference's per-round loop; no statistics kernel,
                        as the reference passes none).
Round seeds of the fused and protocol loops: round ``r`` draws from a
generator on the device seeded ``--seed * 1_000_003 + r`` and a channel
from ``utils.fold_in`` of that seed, the engine's convention (the
reference's loops use ``PRNGKey(seed * 100003 + r)``, a stream of their
own), so ``--mode protocol`` trains on the engine's cohorts for the same
``--seed``. They evaluate every ``--eval-every`` rounds and checkpoint
(``{"params", "opt"}``, plus ``"drift"`` with ``--scaffold``) every
``--ckpt-every`` rounds, as the reference's loops do.

The CLI trains the two-phase ``dcco`` round, as the reference's does.
``run(args, algorithm=...)`` drives the same run through another
:class:`repro_torch.core.round_engine.EngineConfig` body (the FedAvg
baselines ``fedavg_cco``, ``fedavg_contrastive``, ``fedavg_byol``, or
``centralized``) for callers in Python.

Runs on the GPU unless ``--device cpu`` is given; without a GPU and
without ``--device cpu`` it raises. ``main`` first joins the process
group that the REPRO_* environment describes, if one is set
(:func:`repro_torch.sharding.maybe_initialize_distributed`: NCCL, or
gloo with ``--device cpu``), as the reference's does; each process then
runs the same training. ``--full`` trains the full-width
model (channels (64, 128, 256), 32x32 images, projection head
(1024, 1024, 1024); for a token arch its published widths and depth, in
bf16); the default ``--smoke`` config is the reduced one.

Examples (full width, on the GPU):
  PYTHONPATH=src python -m repro_torch.launch.train --full --rounds 5 \\
      --clients-per-round 64 --dataset-size 2048 --eval-every 5
  PYTHONPATH=src python -m repro_torch.launch.train --full --rounds 5 \\
      --objective dvicreg --clients-per-round 64 --dataset-size 2048
  PYTHONPATH=src python -m repro_torch.launch.train --full --rounds 5 \\
      --channel int8 --clients-per-round 64 \\
      --dataset-size 2048
  PYTHONPATH=src python -m repro_torch.launch.train --full --rounds 3 \\
      --edges 8 --channel int8 --edge-channel dense \\
      --clients-per-round 64 --dataset-size 2048
  PYTHONPATH=src python -m repro_torch.launch.train --full --rounds 3 \\
      --clusters 4 --clients-per-round 64 --dataset-size 2048
  PYTHONPATH=src python -m repro_torch.launch.train --full --rounds 3 \\
      --async-k 32 --latency-tail 1.0 --staleness poly \\
      --clients-per-round 64 --dataset-size 2048
  PYTHONPATH=src python -m repro_torch.launch.train --full --rounds 3 \\
      --retrieval-eval --retrieval-every 1 --retrieval-corpus 1536 \\
      --retrieval-queries 512 --clients-per-round 64 --dataset-size 2048
  PYTHONPATH=src python -m repro_torch.launch.train --full --rounds 3 \\
      --server-opt fedadam --clients-per-round 64 --dataset-size 2048
  PYTHONPATH=src python -m repro_torch.launch.train --full --rounds 3 \\
      --scaffold --local-steps 2 --clients-per-round 64 --dataset-size 2048
  PYTHONPATH=src python -m repro_torch.launch.train --full --rounds 3 \\
      --compute-dtype bfloat16 --clients-per-round 64 --dataset-size 2048
  PYTHONPATH=src python -m repro_torch.launch.train --full --rounds 3 \\
      --arch tinyllama-1.1b --seq-len 128 --clients-per-round 4 \\
      --samples-per-client 2 --stats-kernel fused
  PYTHONPATH=src python -m repro_torch.launch.train --full --rounds 2 \\
      --arch tinyllama-1.1b --seq-len 128 --clients-per-round 16 \\
      --samples-per-client 2 --cohort-chunk 4
  PYTHONPATH=src python -m repro_torch.launch.train --full --rounds 3 \\
      --cohort-chunk 64 --clients-per-round 512 --dataset-size 2048
  PYTHONPATH=src python -m repro_torch.launch.train --full --rounds 3 \\
      --arch tinyllama-1.1b --seq-len 128 --clients-per-round 16 \\
      --samples-per-client 2 --mode fused --micro 4
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import comm, objectives as objectives_lib
from repro_torch import hierarchy, retrieval as retrieval_lib
from repro_torch import utils
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs.base import (DualEncoderConfig, TrainConfig,
                                      get_config, get_dual_encoder_config)
from repro_torch.core import buffer as buffer_lib
from repro_torch.core import eval as eval_lib, fed_sim, round_engine
from repro_torch.data import latency as latency_lib
from repro_torch.data import partition as partition_lib
from repro_torch.data import pipeline, synthetic
from repro_torch.launch import steps as steps_lib
from repro_torch.models import dual_encoder, resnet as resnet_mod
from repro_torch.models.dual_encoder import input_leaf, is_resnet
from repro_torch.optim import optimizers as opt_lib, schedules
from repro_torch.server import drift as drift_lib
from repro_torch.server import update as server_update_lib
from repro_torch.sharding import maybe_initialize_distributed
from repro_torch.utils import resolve_device


MODES = ("engine", "fused", "protocol")


def build_dataset(cfg, args):
    if is_resnet(cfg):
        imgs, labels = synthetic.synthetic_labeled_images(
            args.dataset_size, args.num_classes, image_size=cfg.image_size,
            noise=0.5, seed=args.seed)
        x = imgs
    else:
        x, labels = synthetic.synthetic_labeled_tokens(
            args.dataset_size, args.num_classes, args.seq_len,
            vocab=cfg.vocab_size, seed=args.seed)
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
        {input_leaf(cfg): x}, labels, num_clients=num_clients,
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
    if args.partition == "dirichlet_quantity" and args.mode == "fused":
        raise SystemExit(
            "--partition dirichlet_quantity yields variable-size clients "
            "(padded rows masked by per-client sizes); the fused step "
            "flattens the cohort without a mask; use --mode engine or "
            "protocol")
    if args.objective != "dcco" and args.mode == "fused":
        raise SystemExit(
            f"--objective {args.objective} needs the objective-parametric "
            f"round bodies; the fused step hardcodes the CCO loss; use "
            f"--mode engine or protocol")
    if args.mode != "engine":
        for flag, what in (("clusters", "the cluster-aware round"),
                           ("async_k", "the buffered scheduler"),
                           ("retrieval_eval", "the in-loop retrieval eval")):
            if getattr(args, flag):
                raise SystemExit(
                    f"--{flag.replace('_', '-')} runs {what} of the round "
                    f"engine; --mode {args.mode} has none; use --mode "
                    f"engine")
        _forbid_ignored_flags(
            ap, args, ["stats_kernel", "chunk_rounds", "cohort_chunk",
                       "compute_dtype"],
            f"--mode {args.mode} does not run the round engine")
    if args.mode == "fused":
        if args.channel != "none":
            raise SystemExit(
                "--channel models the client uplink; the fused step has no "
                "per-client wire; use --mode engine or protocol")
        if args.edges:
            raise SystemExit(
                "--edges models the client->edge->server wire; the fused "
                "step has no per-client wire; use --mode engine or "
                "protocol")
        _forbid_ignored_flags(
            ap, args, ["server_opt", "fedprox_mu", "scaffold", "local_steps"],
            "the fused step hardcodes the FedOpt delegate with one local "
            "step; use --mode engine or protocol for server or drift "
            "strategies")
        batch = args.clients_per_round * args.samples_per_client
        if args.micro < 1 or batch % args.micro:
            raise SystemExit(
                f"--micro {args.micro} must be >= 1 and divide the global "
                f"batch of {batch} (--clients-per-round x "
                f"--samples-per-client)")
    else:
        _forbid_ignored_flags(
            ap, args, ["micro"],
            "--micro splits the fused step's batch (--mode fused)")
    if args.cohort_chunk:
        if args.clusters:
            raise SystemExit(
                "--clusters with --cohort-chunk: cluster assignment reads "
                "the whole cohort's stats at once; the streamed cohort "
                "never materializes them; drop one")
        if args.async_k:
            raise SystemExit(
                "--async-k with --cohort-chunk: the staleness buffer and "
                "the streamed cohort are two schedulers for the same round "
                "and are not composed; drop one")
        if args.cohort_chunk < 0 or \
                args.clients_per_round % args.cohort_chunk:
            raise SystemExit(
                f"--cohort-chunk {args.cohort_chunk} does not divide "
                f"--clients-per-round {args.clients_per_round}")
        if args.edges and args.cohort_chunk % max(
                args.clients_per_round // args.edges, 1):
            raise SystemExit(
                f"--cohort-chunk {args.cohort_chunk} does not hold whole "
                f"edges of {args.clients_per_round // args.edges} clients "
                f"(--edges {args.edges})")
        _forbid_ignored_flags(
            ap, args, ["scaffold", "stats_kernel"],
            "streaming rounds keep no cohort-resident state: SCAFFOLD "
            "slot variates and the flattened-cohort stats kernel both "
            "need the materialized cohort")
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
    if args.channel != "dropout" and not (args.edges
                                          and args.edge_channel == "dropout"):
        _forbid_ignored_flags(
            ap, args, ["dropout_p"],
            f"--dropout-p only applies to --channel dropout or an "
            f"--edge-channel dropout hop (got --channel {args.channel})")
    if args.clusters:
        if args.async_k:
            raise SystemExit(
                "--clusters with --async-k: the staleness buffer folds "
                "contributions into ONE server aggregate as they arrive; "
                "per-cluster aggregation needs the materialized "
                "synchronous cohort; drop one")
        if args.scaffold:
            raise SystemExit(
                "--clusters with --scaffold: SCAFFOLD variates assume one "
                "shared broadcast model, the clustered round broadcasts "
                "per-cluster params; drop one")
        if args.stats_kernel == "fused":
            raise SystemExit(
                "--clusters needs PER-CLIENT phase-1 stats for the "
                "k-means assignment; --stats-kernel fused aggregates the "
                "flattened cohort and never materializes them; drop one")
        if args.channel == "dp":
            raise SystemExit(
                "--clusters refuses --channel dp: per-cluster aggregates "
                "change the DP sensitivity, the accountant's epsilon "
                "would not cover the release; run DP on the global path")
        if args.edges and args.edges != args.clusters:
            raise SystemExit(
                f"--clusters {args.clusters} with --edges {args.edges}: "
                f"cluster ids route clients through their own edge, so "
                f"the tree needs exactly one edge per cluster "
                f"(--edges == --clusters)")
        if args.clusters > args.clients_per_round:
            raise SystemExit(
                f"--clusters {args.clusters} exceeds --clients-per-round "
                f"{args.clients_per_round}: every cluster needs a chance "
                f"of cohort members")
    else:
        _forbid_ignored_flags(
            ap, args, ["cluster_iters"],
            "--cluster-iters tunes the k-means of --clusters")
    if args.async_k:
        if args.channel == "dp":
            raise SystemExit(
                "--async-k refuses --channel dp: DP noise calibration "
                "across staleness-weighted multi-tick aggregates is "
                "undefined; run DP on the synchronous engine")
        if args.stats_kernel == "fused":
            raise SystemExit(
                "--async-k scatters per-client contributions by arrival "
                "delay; --stats-kernel fused aggregates the flattened "
                "cohort and never materializes them; drop one")
        if not 1 <= args.async_k <= args.clients_per_round:
            raise SystemExit(
                f"--async-k {args.async_k} must be in [1, "
                f"--clients-per-round {args.clients_per_round}]")
    else:
        _forbid_ignored_flags(
            ap, args, ["staleness", "latency_tail"],
            "--staleness / --latency-tail shape the buffered "
            "(--async-k) engine's arrival model; the synchronous engine "
            "ignores them")
    if args.retrieval_eval:
        if args.retrieval_every < 1:
            raise SystemExit(f"--retrieval-every {args.retrieval_every} "
                             f"must be >= 1")
        if args.retrieval_corpus < 10:
            raise SystemExit(
                f"--retrieval-corpus {args.retrieval_corpus} is smaller "
                f"than the largest reported cutoff (recall@10)")
        held_out = args.retrieval_corpus + args.retrieval_queries
        if held_out > args.dataset_size:
            raise SystemExit(
                f"--retrieval-corpus {args.retrieval_corpus} + "
                f"--retrieval-queries {args.retrieval_queries} = "
                f"{held_out} exceeds --dataset-size {args.dataset_size}")
    else:
        _forbid_ignored_flags(
            ap, args, ["retrieval_every", "retrieval_corpus",
                       "retrieval_queries", "retrieval_dtype"],
            "retrieval flags configure the --retrieval-eval loop")
    if args.server_opt != "fedavg_sgd":
        _forbid_ignored_flags(
            ap, args, ["server_optimizer"],
            f"--server-opt {args.server_opt} builds its own server "
            f"optimizer; the base --server-optimizer is unused")
    if args.server_opt in ("fedavg_sgd", "fedavgm"):
        _forbid_ignored_flags(
            ap, args, ["server_tau"],
            "--server-tau only applies to the adaptive --server-opt "
            "strategies (fedadagrad / fedadam / fedyogi)")
    if args.edges:
        if args.clients_per_round % args.edges and not args.clusters:
            raise SystemExit(
                f"--edges {args.edges} does not divide --clients-per-round "
                f"{args.clients_per_round}: edges are contiguous "
                f"equal-size client groups (unless --clusters routes "
                f"clients to edges by cluster id)")
        if args.channel == "dp":
            raise SystemExit(
                "--edges refuses a DP client hop: noise calibration and "
                "epsilon accounting across a two-level tree are undefined "
                "(repro_torch.hierarchy); drop --edges or use a flat "
                "--channel dp")
    else:
        _forbid_ignored_flags(
            ap, args, ["edge_channel"],
            "--edge-channel configures the edge->server hop of --edges")


def make_apply(cfg, de_cfg):
    leaf = input_leaf(cfg)

    def apply(p, batch):
        zf, _ = dual_encoder.encode(cfg, de_cfg, p, {leaf: batch["v1"]})
        zg, _ = dual_encoder.encode(cfg, de_cfg, p, {leaf: batch["v2"]})
        return zf, zg
    return apply


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Federated stats-objective pretraining of the ResNet-14 "
                    "or dense-transformer dual encoder (PyTorch port)")
    ap.add_argument("--arch", default="resnet14-cifar")
    ap.add_argument("--objective", default="dcco",
                    choices=list(objectives_lib.OBJECTIVES),
                    help="stats objective trained by the two-phase round")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--mode", choices=list(MODES), default="engine",
                    help="'engine': the round engine; 'fused': the fused "
                         "D-CCO step on the flattened cohort (--micro); "
                         "'protocol': one fed_sim.stats_round a round")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; without a GPU only "
                         "--device cpu runs")
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--clients-per-round", type=int, default=16)
    ap.add_argument("--ckpt-dir", default=None,
                    help="where checkpoints and history.json go (default: "
                         "repro_ckpt in the temporary directory, the "
                         "reference's /tmp/repro_ckpt)")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="rounds between checkpoints (0 = none)")
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--resume", default=None,
                    help="a checkpoint file to resume from")
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
    g.add_argument("--seq-len", type=int, default=64,
                   help="tokens a sequence (token archs)")
    g.add_argument("--num-layers", type=int, default=0,
                   help="cut a token arch's depth to this many layers, its "
                        "widths kept (0 = the config's depth; an MoE "
                        "arch's dense prologue stays, so it needs more "
                        "layers than its prologue, and the layers after "
                        "it must fill whole superblocks of the block "
                        "pattern)")

    g = ap.add_argument_group("engine")
    g.add_argument("--chunk-rounds", type=int, default=0,
                   help="rounds per metrics segment (0 = --eval-every)")
    g.add_argument("--cohort-chunk", type=int, default=0,
                   help="stream the cohort through each round in chunks "
                        "of this many clients (engine mode; peak memory "
                        "O(chunk) instead of O(cohort); 0 = materialized)")
    g.add_argument("--compute-dtype", default="float32",
                   choices=sorted(round_engine.COMPUTE_DTYPES),
                   help="encoder forward/backward compute dtype. "
                        "'bfloat16' halves activation traffic and runs the "
                        "convolutions and products on bf16 tensor cores; "
                        "the Eq.-3 statistics, parameters and server state "
                        "stay float32")
    g.add_argument("--stats-kernel", choices=list(round_engine.STATS_KERNELS),
                   default=None,
                   help="'fused': phase-1 aggregate statistics through the "
                        "CUDA cco_stats kernel; 'off': per-client average. "
                        "Default: 'fused' unless --channel needs per-client "
                        "payloads (the lossy channels), then 'off'; "
                        "--clusters and --async-k always take per-client "
                        "payloads")

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
                        "(--channel dropout or --edge-channel dropout)")
    g.add_argument("--edges", type=int, default=0,
                   help="fan the cohort in through this many edge "
                        "aggregators (repro_torch.hierarchy): clients -> "
                        "edges -> server, --channel on the client->edge "
                        "hop and --edge-channel on the edge->server hop, "
                        "both hops' bytes accounted (0 = flat)")
    g.add_argument("--edge-channel", default="dense",
                   choices=["dense", "int8", "dropout"],
                   help="edge->server hop channel for --edges ('dropout' "
                        "models a regional edge outage taking all its "
                        "clients down at once, p = --dropout-p)")

    g = ap.add_argument_group("clustered aggregation")
    g.add_argument("--clusters", type=int, default=0,
                   help="number of server-side client clusters: cosine "
                        "k-means on the phase-1 stats assigns cohort "
                        "clients to clusters every round, each with its "
                        "own correlation target and server slot (0/1 = "
                        "the global path, --clusters 1 bit-identical to "
                        "0). With --edges, each cluster routes through "
                        "its own edge (--edges == --clusters)")
    g.add_argument("--cluster-iters", type=int, default=2,
                   help="Lloyd iterations per round of the k-means "
                        "(warm-started from the previous round's "
                        "centroids)")

    g = ap.add_argument_group("asynchrony")
    g.add_argument("--async-k", type=int, default=0,
                   help="FedBuff-style buffered engine "
                        "(repro_torch.core.buffer): apply the server "
                        "update once this many client contributions have "
                        "ARRIVED, staleness-weighted (0 = synchronous "
                        "rounds)")
    g.add_argument("--staleness", default="unit",
                   choices=list(buffer_lib.STALENESS_FNS),
                   help="down-weight s(tau) of a contribution arriving tau "
                        "ticks after dispatch: 'unit' = none, 'poly' = "
                        "(1+tau)^-1/2 (FedBuff's), 'inv' = 1/(1+tau)")
    g.add_argument("--latency-tail", type=float, default=0.0,
                   help="heavy-tail straggler severity (Pareto exponent "
                        "of the persistent per-client arrival delay, ring "
                        "horizon 8, repro_torch.data.latency); 0 = every "
                        "contribution arrives the tick it was dispatched")

    g = ap.add_argument_group(
        "retrieval eval", "periodic in-training retrieval eval "
        "(repro_torch.retrieval)")
    g.add_argument("--retrieval-eval", action="store_true",
                   help="encode a held-out corpus and query split with the "
                        "current params every --retrieval-every rounds, "
                        "search it with the MIPS top-k kernel and report "
                        "recall@{1,5,10} / MRR beside the probe")
    g.add_argument("--retrieval-every", type=int, default=5,
                   help="rounds between retrieval evals (--retrieval-eval); "
                        "skipped rounds record NaN")
    g.add_argument("--retrieval-corpus", type=int, default=256,
                   help="held-out items indexed as the retrieval corpus")
    g.add_argument("--retrieval-queries", type=int, default=64,
                   help="held-out query items scored against the corpus")
    g.add_argument("--retrieval-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="storage type of the corpus embeddings (bfloat16 "
                        "halves the index; scores still sum in f32)")

    g = ap.add_argument_group("server & client optimization")
    g.add_argument("--server-optimizer", default="adam",
                   choices=["sgd", "adam", "lars"],
                   help="base optimizer of the fedavg_sgd server strategy "
                        "(refused with an adaptive --server-opt)")
    g.add_argument("--server-opt", default="fedavg_sgd",
                   choices=list(server_update_lib.SERVER_UPDATES),
                   help="server update strategy (repro_torch.server): "
                        "'fedavg_sgd' = delegate to --server-optimizer; "
                        "'fedavgm' = server momentum; 'fedadagrad' / "
                        "'fedadam' / 'fedyogi' = Reddi et al.'s adaptive "
                        "server optimizers with --server-tau adaptivity")
    g.add_argument("--server-tau", type=float, default=1e-3,
                   help="adaptivity epsilon tau of the adaptive server "
                        "optimizers")
    g.add_argument("--fedprox-mu", type=float, default=0.0,
                   help="FedProx proximal coefficient mu on the client "
                        "local loss (0 = off; only bites at "
                        "--local-steps > 1)")
    g.add_argument("--scaffold", action="store_true",
                   help="SCAFFOLD control variates (per-cohort-slot) for "
                        "client-drift correction; the variate uplink is "
                        "routed through --channel")
    g.add_argument("--server-lr", type=float, default=2e-3)
    g.add_argument("--client-lr", type=float, default=1.0)
    g.add_argument("--local-steps", type=int, default=1,
                   help="client local GD steps per round")
    g.add_argument("--lam", type=float, default=5.0)
    g.add_argument("--micro", type=int, default=1,
                   help="microbatches of the fused step's exact "
                        "microbatched CCO (--mode fused)")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """The CLI's arguments, with its refusals of ignored flags applied."""
    ap = build_parser()
    args = ap.parse_args(argv)
    validate_flags(ap, args)
    cfg = get_config(args.arch, smoke=args.smoke)
    if is_resnet(cfg):
        _forbid_ignored_flags(
            ap, args, ["seq_len", "num_layers"],
            f"--seq-len and --num-layers set the token archs' sequences "
            f"and depth; {args.arch} encodes images")
    elif args.seq_len < 1:
        raise SystemExit(f"--seq-len {args.seq_len} must be >= 1")
    elif args.num_layers and not args.num_layers > cfg.num_prologue:
        raise SystemExit(f"--num-layers {args.num_layers} must exceed the "
                         f"{cfg.num_prologue} dense prologue layers of "
                         f"{args.arch} (and be >= 1)")
    elif (args.num_layers
          and (args.num_layers - cfg.num_prologue) % len(cfg.block_pattern)):
        raise SystemExit(
            f"--num-layers {args.num_layers}: the "
            f"{args.num_layers - cfg.num_prologue} layers after the "
            f"{cfg.num_prologue} prologue layers of "
            f"{args.arch} are not a whole number of superblocks of its "
            f"block pattern of length {len(cfg.block_pattern)} "
            f"{cfg.block_pattern}")
    return args


def main(argv=None) -> dict:
    """Train; returns a summary (losses, ms per round, probe accuracy,
    uplink bytes, final params) for callers that drive it in-process.
    Joins the REPRO_* world first (a no-op without that environment);
    parsing the flags touches no device."""
    args = parse_args(argv)
    maybe_initialize_distributed(device=args.device)
    return run(args)


class _RunLog:
    """What a run records a round (losses, ms, probes, uplink bytes,
    server updates, retrieval metrics) and its progress line."""

    def __init__(self, device, evaluate):
        self.device, self.evaluate = device, evaluate
        self.history, self.round_ms, self.probes = [], [], []
        self.wire, self.edge_wire, self.applied = [], [], []
        self.retrieval = {}
        self.sync()
        self.t0 = time.perf_counter()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def lap_ms(self) -> float:
        """Host ms since the last lap, the device synchronised."""
        self.sync()
        t = time.perf_counter()
        ms, self.t0 = (t - self.t0) * 1e3, t
        return ms

    def line(self, round_end, params, enc_std, ms, extra=""):
        """Probe ``params`` and print the progress line of ``round_end``."""
        acc = self.evaluate(params)
        self.probes.append(acc)
        if self.device.type == "cuda":
            peak = torch.cuda.max_memory_allocated(self.device) / 2**30
            extra = f" peak_mem={peak:.2f}GiB{extra}"
        print(f"round {round_end:5d} loss={self.history[-1]:9.4f} "
              f"enc_std={enc_std:.4f} probe_acc={acc:.3f}{extra} "
              f"({ms:.1f} ms/round)", flush=True)
        self.sync()
        self.t0 = time.perf_counter()


def _engine_rounds(args, algorithm, cfg, de_cfg, ds, data, labels_t, params,
                   opt, opt_state, objective, channel, drift_state,
                   start_round, ckpt_dir, log):
    """``--mode engine``: the rounds through the round engine; returns
    (params, opt_state)."""
    device, leaf = log.device, input_leaf(cfg)
    latency = None
    if args.async_k and args.latency_tail > 0:
        latency = latency_lib.LatencyModel(
            "heavytail", horizon=8, tail=args.latency_tail, seed=args.seed)
    retrieval_eval = None
    if args.retrieval_eval:
        # held-out split: the first nc items are indexed as the corpus,
        # the next nq serve as queries (label-match relevance)
        nc, nq = args.retrieval_corpus, args.retrieval_queries

        def embed(p, batch):
            z, _ = dual_encoder.encode(cfg, de_cfg, p, batch)
            return z

        retrieval_eval = retrieval_lib.make_retrieval_eval(
            embed, {leaf: data[:nc]}, labels_t[:nc],
            {leaf: data[nc:nc + nq]}, labels_t[nc:nc + nq],
            chunk=min(256, nc),
            index_dtype=(torch.bfloat16 if args.retrieval_dtype
                         == "bfloat16" else torch.float32))
    if algorithm in ("fedavg_contrastive", "fedavg_byol"):
        objective = None
    ecfg = round_engine.EngineConfig(
        algorithm=algorithm, objective=objective, lam=args.lam,
        client_lr=args.client_lr, local_steps=args.local_steps,
        chunk_rounds=args.chunk_rounds or args.eval_every or 25,
        stats_kernel=args.stats_kernel, channel=channel, server_update=opt,
        compute_dtype=args.compute_dtype, prox_mu=args.fedprox_mu,
        scaffold=args.scaffold, cohort_chunk=args.cohort_chunk,
        num_clusters=args.clusters, cluster_iters=args.cluster_iters,
        async_k=args.async_k, staleness_fn=args.staleness, latency=latency,
        retrieval_eval=retrieval_eval,
        retrieval_every=args.retrieval_every)
    if args.cohort_chunk:
        sampler = ds.make_streaming_sampler(args.clients_per_round,
                                            args.cohort_chunk, device)
    elif args.async_k:
        sampler = ds.make_async_round_sampler(args.clients_per_round, device,
                                              latency)
    else:
        sampler = ds.make_round_sampler(args.clients_per_round, device)
    engine = round_engine.RoundEngine(make_apply(cfg, de_cfg), opt, sampler,
                                      ecfg)
    buffer_state = None
    if args.resume and engine._async_real:
        # second pass over the blob: the buffer's template needs the built
        # engine, whose sampler sizes it
        try:
            b, _ = restore_checkpoint(
                args.resume, {"buffer": engine._init_async_state(params)},
                device)
            buffer_state = b["buffer"]
        except KeyError:
            print("resume checkpoint holds no buffer state (written by the "
                  "synchronous engine) — starting the buffered run with an "
                  "empty buffer", flush=True)

    def on_segment(round_end, carry, m):
        rounds = m.loss.shape[0]
        seg_ms = log.lap_ms() / rounds
        log.round_ms.extend([seg_ms] * rounds)
        log.history.extend(float(x) for x in m.loss.cpu())
        log.wire.extend(float(x) for x in m.wire_bytes.cpu())
        log.edge_wire.extend(float(x) for x in m.edge_bytes.cpu())
        log.applied.extend(float(x) for x in m.applied.cpu())
        extra = ""
        if args.async_k:
            extra = (f" updates={int(sum(log.applied[-rounds:]))}"
                     f"/{rounds}t")
        for key, x in m.retrieval.items():
            log.retrieval.setdefault(key, []).extend(float(v)
                                                     for v in x.cpu())
        if m.retrieval:
            # latest evaluated round in this segment (skipped = NaN)
            r1 = m.retrieval["recall_at_1"].cpu().numpy()
            live = np.flatnonzero(~np.isnan(r1))
            if live.size:
                i = live[-1]
                extra += (
                    f" recall@1={r1[i]:.3f}"
                    f" recall@10={float(m.retrieval['recall_at_10'][i]):.3f}"
                    f" mrr={float(m.retrieval['mrr'][i]):.3f}")
        log.line(round_end, carry.params, float(m.encoding_std[-1]), seg_ms,
                 extra)

    log.lap_ms()
    params, opt_state, _ = engine.run(
        params, opt_state, args.seed, args.rounds - start_round,
        start_round=start_round, on_segment=on_segment,
        ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every,
        ckpt_name=args.arch, drift_state=drift_state,
        buffer_state=buffer_state)
    return params, opt_state


def _loop_rounds(args, cfg, de_cfg, ds, params, opt, opt_state, objective,
                 channel, drift_state, start_round, ckpt_dir, log):
    """``--mode fused|protocol``: one Python iteration a round, each
    round's loss read on the host, as the reference's loops do; returns
    (params, opt_state)."""
    device, leaf = log.device, input_leaf(cfg)
    k = args.clients_per_round
    if args.mode == "fused":
        tcfg = TrainConfig(global_batch=k * args.samples_per_client,
                           samples_per_client=args.samples_per_client,
                           dcco_impl="fused")
        step = steps_lib.make_dcco_train_step(
            cfg, de_cfg, tcfg, opt.opt, num_microbatches=args.micro)
    else:
        apply = make_apply(cfg, de_cfg)
    log.lap_ms()
    for r in range(start_round, args.rounds):
        # the engine's round seeds (module docstring)
        round_seed = args.seed * round_engine._ROUND_SEED_STRIDE + r
        gen = utils.generator(round_seed, device)
        if args.mode == "protocol":
            batch, sizes = ds.round_batch(gen, k, device)
            out = fed_sim.stats_round(
                apply, params, opt_state, opt, batch, sizes,
                objective=objective, client_lr=args.client_lr,
                local_steps=args.local_steps, prox_mu=args.fedprox_mu,
                scaffold_state=drift_state, channel=channel,
                channel_key=None if channel is None else utils.fold_in(
                    round_seed, round_engine._CHANNEL_SALT))
            del batch
            if args.scaffold:
                params, opt_state, drift_state, m = out
            else:
                params, opt_state, m = out
            if channel is not None:
                channel.finalize_rounds(1)
            loss, enc_std = m.loss, m.encoding_std
            log.wire.append(float(m.wire_bytes))
            log.edge_wire.append(float(m.edge_bytes))
        else:
            flat, _ = ds.flat_round_batch(gen, k, device)
            batch = {"view1": {leaf: flat["v1"]},
                     "view2": {leaf: flat["v2"]}}
            del flat
            params, opt_state, m = step(params, opt_state, batch)
            del batch
            loss, enc_std = m["loss"], m["encoding_std"]
        log.history.append(float(loss))
        log.applied.append(1.0)
        log.round_ms.append(log.lap_ms())
        if args.eval_every and (r + 1) % args.eval_every == 0:
            log.line(r + 1, params, float(enc_std), log.round_ms[-1])
        if args.ckpt_every and (r + 1) % args.ckpt_every == 0:
            blob = {"params": params, "opt": opt_state}
            if args.scaffold:
                blob["drift"] = drift_state
            save_checkpoint(os.path.join(ckpt_dir, f"{args.arch}.msgpack"),
                            blob, r + 1)
            log.lap_ms()
    return params, opt_state


def run(args: argparse.Namespace, *, algorithm: str = "dcco") -> dict:
    """Train the run ``args`` describes (``--mode``) with the engine's
    ``algorithm`` body (``round_engine.ALGORITHMS``; the fused and
    protocol modes train "dcco" only); returns ``main``'s summary. The
    non-stats bodies (``fedavg_contrastive``, ``fedavg_byol``) refuse an
    ``--objective``."""
    if (algorithm in ("fedavg_contrastive", "fedavg_byol")
            and args.objective != "dcco"):
        raise SystemExit(f"--objective {args.objective} would be silently "
                         f"ignored: {algorithm} trains a non-stats loss")
    if args.mode != "engine" and algorithm != "dcco":
        raise SystemExit(f"--mode {args.mode} trains D-CCO; the {algorithm} "
                         f"body runs on the round engine only")
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.num_layers:
        cfg = cfg.replace(num_layers=args.num_layers)
    de_cfg = DualEncoderConfig(
        proj_dims=(64, 64) if args.smoke else
        get_dual_encoder_config(args.arch).proj_dims,
        lambda_cco=args.lam)
    params = dual_encoder.init_dual_encoder(args.seed, cfg, de_cfg, device)
    sched = schedules.cosine_decay(args.server_lr, args.rounds)
    if args.server_opt == "fedavg_sgd":
        opt = server_update_lib.get_server_update(
            "fedavg_sgd",
            base_opt=opt_lib.get_optimizer(args.server_optimizer, sched))
    else:
        opt = server_update_lib.get_server_update(
            args.server_opt, server_lr=sched, tau=args.server_tau)
    opt_state = opt.init(params)
    start_round = 0
    drift_state = (drift_lib.scaffold_init(params, args.clients_per_round)
                   if args.scaffold else None)
    if args.resume:
        tmpl = {"params": params, "opt": opt_state}
        if args.scaffold:
            tmpl["drift"] = drift_state
        blob, start_round = restore_checkpoint(args.resume, tmpl, device)
        params, opt_state = blob["params"], blob["opt"]
        if args.scaffold:
            drift_state = blob["drift"]
        print(f"resumed from {args.resume} @ round {start_round}")

    ds, labels = build_dataset(cfg, args)
    leaf = input_leaf(cfg)
    data = torch.as_tensor(ds.data[leaf], device=device)
    labels_t = torch.as_tensor(labels, device=device)
    cut = int(len(labels) * 0.7)

    def evaluate(p):
        if not is_resnet(cfg):
            return float("nan")
        with torch.no_grad():
            z = resnet_mod.resnet_forward(cfg, p["tower"], data)
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
    if args.edges:
        # two-level topology: --channel becomes the client->edge hop
        channel = hierarchy.HierarchicalChannel(
            args.edges, client_channel=channel,
            edge_channel=comm.get_channel(args.edge_channel,
                                          dropout_p=args.dropout_p))
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "repro_ckpt")
    os.makedirs(ckpt_dir, exist_ok=True)
    log = _RunLog(device, evaluate)
    if args.mode == "engine":
        params, opt_state = _engine_rounds(
            args, algorithm, cfg, de_cfg, ds, data, labels_t, params, opt,
            opt_state, objective, channel, drift_state, start_round,
            ckpt_dir, log)
    else:
        params, opt_state = _loop_rounds(
            args, cfg, de_cfg, ds, params, opt, opt_state, objective,
            channel, drift_state, start_round, ckpt_dir, log)
    history, wire, edge_wire = log.history, log.wire, log.edge_wire
    probe = evaluate(params)
    if history:
        print(f"final loss {history[-1]:.4f}; first {history[0]:.4f}; "
              f"probe {probe:.3f}")
    else:
        print(f"no rounds to run (resumed at or past --rounds "
              f"{args.rounds}); probe {probe:.3f}")
    wire_bytes = float(sum(wire))
    if channel is not None:
        line = f"channel {channel!r}: uplink {wire_bytes / 1e6:.3f} MB total"
        acct = getattr(channel, "accountant", None)
        if acct is not None:
            line += (f"; DP epsilon={acct.epsilon():.2f} "
                     f"@ delta={acct.delta:g}")
        print(line)
    edge_bytes = float(sum(edge_wire))
    if args.edges:
        print(f"uplink per hop: client->edge "
              f"{(wire_bytes - edge_bytes) / 1e6:.3f} MB, edge->server "
              f"{edge_bytes / 1e6:.3f} MB")
    if history:
        with open(os.path.join(ckpt_dir, "history.json"), "w") as f:
            json.dump(history, f)
    return {"history": history, "round_ms": log.round_ms, "probe": probe,
            "probes": log.probes, "params": params, "opt_state": opt_state,
            "device": str(device),
            "wire_bytes": wire_bytes, "edge_bytes": edge_bytes,
            "updates": int(sum(log.applied)), "retrieval": log.retrieval,
            "loss_finite": bool(np.all(np.isfinite(history)))}


if __name__ == "__main__":
    main()
