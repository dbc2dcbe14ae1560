#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):
  1. build every CUDA kernel of the training path from ``src/repro_torch/csrc``
     (one nvcc per source, all started together) and print the build time;
  2. hold each kernel against its plain PyTorch version on the card, at the
     main path's shape and at a ragged, masked shape, and time the kernel,
     the plain version and a one-call PyTorch yardstick;
  3. the Appendix-A equivalence at full width: one DCCO round against one
     centralized step on the same 64-client cohort;
  4. the main path: ``repro_torch.launch.train --full`` for 5 rounds of
     64 clients x 2 samples on 2048 synthetic 32x32 images, with the kernel
     launch counts set to 0 just before and read just after.
Then one JSON line of kernel figures, and the device line last.
Needs a CUDA device and the repository's ``src/`` beside this file.
"""
import json
from pathlib import Path
import subprocess
import sys
import time

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import utils  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    get_config, get_dual_encoder_config)
from repro_torch.core import fed_sim, round_engine  # noqa: E402
from repro_torch.data import partition, pipeline, synthetic  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.cco_stats import cco_stats  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import dual_encoder  # noqa: E402
from repro_torch.optim import optimizers as opt_lib  # noqa: E402

ROUNDS = 5
K, N_PER_CLIENT, DATASET = 64, 2, 2048
MAIN_N, MAIN_D = K * N_PER_CLIENT, 1024   # phase-1 rows, projection width
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 non-tensor FLOP/s
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
# kernel vs plain: max |kernel - plain| <= TOL * (1 + max |plain|); both
# sum <= 128 f32 products of unit-normal data, in other orders
TOL = 1e-5


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def time_ms(fn, calls=50, replays=20):
    """Mean device time of one call of ``fn``: ``calls`` calls are captured
    in one CUDA graph, replayed ``replays`` times between CUDA events. The
    replay launches no Python, so this is the kernels' time and not the
    host's time to issue them (see ``eager_ms``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def eager_ms(fn, iters=200):
    """Mean time of one eager call, host issue included: CUDA events
    around ``iters`` back-to-back calls."""
    for _ in range(20):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cco_stats_bound_ms(n, d):
    """Least time on the card: each input read once and each output written
    once at the HBM rate, or the FLOPs at the f32 non-tensor peak."""
    bytes_moved = 4 * (2 * n * d + d * d + 4 * d + 1)
    flops = 2 * n * d * d + 6 * n * d
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, flops / PEAK_F32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_cco_stats(n, d, valid, seed):
    """Kernel vs plain version on pre-masked rows with ``num_valid``, as
    the engine calls it; returns (max_abs_err, ms, plain_ms, matmul_ms),
    times on the device."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    m = (torch.arange(n, device=dev) < valid).float()[:, None]
    zf = torch.randn(n, d, generator=gen, device=dev) * m
    zg = torch.randn(n, d, generator=gen, device=dev) * m
    nv = m.sum()
    out = cco_stats(zf, zg, nv)
    torch.cuda.synchronize()
    plain = ref.cco_stats_ref(zf, zg, nv)
    err, scale = 0.0, 0.0
    for k in plain:
        if out[k].shape != plain[k].shape or not out[k].is_cuda:
            fail(f"cco_stats {k}: shape {tuple(out[k].shape)} on "
                 f"{out[k].device}, expected {tuple(plain[k].shape)} on cuda")
        err = max(err, float((out[k] - plain[k]).abs().max()))
        scale = max(scale, float(plain[k].abs().max()))
    ok = err <= TOL * (1.0 + scale)
    ms = time_ms(lambda: cco_stats(zf, zg, nv))
    plain_ms = time_ms(lambda: ref.cco_stats_ref(zf, zg, nv))
    lib_ms = time_ms(lambda: torch.matmul(zf.T, zg))
    call_ms = eager_ms(lambda: cco_stats(zf, zg, nv))
    print(f"cco_stats N={n} d={d} num_valid={valid}: max_abs_err={err:.3e} "
          f"(tol {TOL:g} x (1 + {scale:.3g})) {'ok' if ok else 'MISMATCH'}; "
          f"device ms: kernel {ms:.5f} plain {plain_ms:.5f} matmul "
          f"{lib_ms:.5f}; eager call ms {call_ms:.5f}", flush=True)
    if not ok:
        fail(f"cco_stats disagrees with its plain version at N={n} d={d}")
    return err, ms, plain_ms, lib_ms


def appendix_a(device):
    """One DCCO round against one centralized step on the same cohort.

    The gate on parameters runs in f64: the reference's GroupNorm
    normalises each pixel over its group's channels only, and GN(32) on
    the 64-channel first stage makes groups of 2 channels, whose f32
    gradients are dominated by rounding (ROADMAP section 3); in f64 the
    identity holds to rounding. The f32 round, phase 1 through the kernel,
    is reported and gated on its loss, which equals the centralized loss
    by construction.
    """
    cfg = get_config("resnet14-cifar")
    de_cfg = get_dual_encoder_config("resnet14-cifar")
    imgs, labels = synthetic.synthetic_labeled_images(
        DATASET, 5, image_size=cfg.image_size, noise=0.5, seed=0)
    ds = pipeline.FederatedDataset.build(
        {"images": imgs}, labels, num_clients=DATASET // N_PER_CLIENT,
        samples_per_client=N_PER_CLIENT,
        partition=partition.PartitionSpec("dirichlet", alpha=0.0), seed=0)
    batch, sizes = ds.make_round_sampler(K, device)(
        torch.Generator(device=device).manual_seed(42))
    results = {}
    for dtype in ("float64", "float32"):
        c = cfg.replace(dtype=dtype)
        params = dual_encoder.init_dual_encoder(0, c, de_cfg, device)
        apply = train.make_apply(c, de_cfg)
        opt = opt_lib.sgd(0.05)
        agg = (round_engine.make_kernel_agg_stats() if dtype == "float32"
               else None)
        p_fed, _, m_fed = fed_sim.dcco_round(
            apply, params, opt.init(params), opt, batch, sizes, lam=5.0,
            agg_stats_fn=agg)
        p_cent, _, m_cent = fed_sim.centralized_step(
            apply, params, opt.init(params), opt,
            fed_sim._flatten_clients(batch), lam=5.0)
        torch.cuda.synchronize()
        rel = (utils.tree_max_abs_diff(p_fed, p_cent)
               / utils.tree_max_abs_diff(p_cent, params))
        lf, lc = float(m_fed.loss), float(m_cent.loss)
        results[dtype] = (rel, lf, lc)
        print(f"appendix-A {dtype} (full width, K={K} x {N_PER_CLIENT}): "
              f"|fed - centralized| / |update| = {rel:.3e}; loss "
              f"fed={lf:.6f} centralized={lc:.6f}", flush=True)
    rel64, lf64, lc64 = results["float64"]
    _, lf32, lc32 = results["float32"]
    if not (rel64 < 1e-4 and abs(lf64 - lc64) <= 1e-9 * abs(lc64)
            and abs(lf32 - lc32) <= 1e-4 * abs(lc32)):
        fail("one DCCO round does not equal one centralized step (gates: "
             "f64 parameters 1e-4 of the update, f64 loss 1e-9, f32 loss "
             "1e-4)")


def main_path():
    """``train --full`` through its entry point; returns the launch count."""
    cco_stats.launches = 0
    res = train.main(["--full", "--clients-per-round", str(K),
                      "--samples-per-client", str(N_PER_CLIENT),
                      "--dataset-size", str(DATASET), "--rounds", str(ROUNDS),
                      "--eval-every", "1", "--stats-kernel", "fused"])
    launches = cco_stats.launches
    leaves = utils.tree_leaves(res["params"])
    if len(res["history"]) != ROUNDS or not res["loss_finite"]:
        fail(f"training losses: {res['history']}")
    if not all(x.is_cuda and bool(torch.isfinite(x).all()) for x in leaves):
        fail("trained parameters are not finite tensors on cuda")
    d_out = res["params"]["proj"]["layers"][-1]["w"].shape[1]
    if d_out != MAIN_D:
        fail(f"projection width {d_out}, expected {MAIN_D}")
    if launches != ROUNDS:
        fail(f"cco_stats launched {launches} times in {ROUNDS} rounds")
    steady = sorted(res["round_ms"][1:])
    print(f"train --full: {ROUNDS} rounds, losses "
          f"{[round(x, 4) for x in res['history']]}; ms/round: first "
          f"{res['round_ms'][0]:.1f}, median of the rest "
          f"{steady[len(steady) // 2]:.1f}; probe acc {res['probe']:.3f} "
          f"(per round {res['probes']}); cco_stats launches {launches}",
          flush=True)
    return launches


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print("nvidia-smi name, power.limit:", flush=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    device = utils.resolve_device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    _build.build(["cco_stats"])
    print(f"build: {time.perf_counter() - t0:.2f} s wall "
          f"(nvcc seconds {_build.build_seconds})", flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    err, ms, plain_ms, lib_ms = check_cco_stats(MAIN_N, MAIN_D, MAIN_N, 0)
    check_cco_stats(37, 1000, 30, 1)
    appendix_a(device)
    launches = main_path()

    bound_ms, bound_by = cco_stats_bound_ms(MAIN_N, MAIN_D)
    print(json.dumps({"kernels": [{
        "name": "cco_stats", "route": "cuda",
        "source": "src/repro_torch/csrc/cco_stats.cu",
        "replaces": "src/repro/kernels/cco_stats.py:37",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": lib_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
