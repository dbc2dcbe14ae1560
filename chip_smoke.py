#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):
  1. build every CUDA kernel of the training paths from
     ``src/repro_torch/csrc`` (one nvcc per source, all started together)
     and print the build time and ptxas's register and spill lines;
  2. hold each kernel against its plain PyTorch version on the card, at the
     main paths' shapes and at a ragged shape, and time the kernel, the
     plain version and, where one exists, a one-call PyTorch yardstick:
     ``cco_stats`` in both moment sets (to 1e-5 x (1 + max|plain|)) and
     ``quant_dequant`` in both scale forms (bit for bit);
  3. the Appendix-A equivalence at full width, for DCCO and for D-VICReg:
     one round against one centralized step on the same 64-client cohort;
  4. three training paths through ``repro_torch.launch.train --full`` on
     64 clients x 2 samples of 2048 synthetic 32x32 images, each with every
     kernel launch count set to 0 just before and read just after:
     DCCO (5 rounds; the "cross" statistics kernel once a round), D-VICReg
     (3 rounds; the "full" statistics kernel once a round) and DCCO over an
     int8 uplink (3 rounds; the column-mapped quantize kernel twice a round,
     no statistics kernel).
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
from repro_torch.kernels.quantize import quant_dequant  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import dual_encoder  # noqa: E402
from repro_torch.objectives import get_objective  # noqa: E402
from repro_torch.optim import optimizers as opt_lib  # noqa: E402

ROUNDS = 5            # the DCCO path
PATH_ROUNDS = 3       # the D-VICReg and quantized-uplink paths
K, N_PER_CLIENT, DATASET = 64, 2, 2048
MAIN_N, MAIN_D = K * N_PER_CLIENT, 1024   # phase-1 rows, projection width
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 non-tensor FLOP/s
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
# kernel vs plain: max |kernel - plain| <= TOL * (1 + max |plain|); both
# sum <= 128 f32 products of unit-normal data, in other orders
TOL = 1e-5
QMAX = 127.0          # the int8 channel


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


def bound_ms(bytes_moved, ops):
    """Least time on the card: the bytes at the HBM rate or the operations
    at the f32 non-tensor peak, whichever is longer."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, ops / PEAK_F32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cco_stats_bound_ms(n, d, moments="cross"):
    """Each input read once and each output written once; FLOPs: 2Nd^2
    for cross, plus N d (d + 1) for the upper triangle (diagonal included)
    of each of the two symmetric within-view products in the full set, plus
    6Nd for the vector statistics."""
    mats, flops = 1, 2 * n * d * d + 6 * n * d
    if moments == "full":
        mats, flops = 3, flops + 2 * n * d * (d + 1)
    return bound_ms(4 * (2 * n * d + mats * d * d + 4 * d + 1), flops)


def check_cco_stats(n, d, valid, seed, moments="cross"):
    """Kernel vs plain version on pre-masked rows with ``num_valid``, as
    the engine calls it; returns (max_abs_err, ms, plain_ms, library_ms),
    times on the device. The yardstick is one cuBLAS product: zf^T zg for
    the cross set; for the full set z^T z with z = [zf, zg], which makes
    all three (d, d) blocks at once (and more: the lower blocks, no vector
    statistics, no masking)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    m = (torch.arange(n, device=dev) < valid).float()[:, None]
    zf = torch.randn(n, d, generator=gen, device=dev) * m
    zg = torch.randn(n, d, generator=gen, device=dev) * m
    nv = m.sum()
    out = cco_stats(zf, zg, nv, moments=moments)
    torch.cuda.synchronize()
    plain = ref.cco_stats_ref(zf, zg, nv, moments)
    err, scale = 0.0, 0.0
    if set(out) != set(plain):
        fail(f"cco_stats {moments}: keys {sorted(out)}, expected "
             f"{sorted(plain)}")
    for k in plain:
        if out[k].shape != plain[k].shape or not out[k].is_cuda:
            fail(f"cco_stats {k}: shape {tuple(out[k].shape)} on "
                 f"{out[k].device}, expected {tuple(plain[k].shape)} on cuda")
        err = max(err, float((out[k] - plain[k]).abs().max()))
        scale = max(scale, float(plain[k].abs().max()))
    ok = err <= TOL * (1.0 + scale)
    if moments == "full":
        for k in ("cov_f", "cov_g"):
            if not torch.equal(out[k], out[k].T):
                fail(f"cco_stats {k} is not exactly symmetric")
        z = torch.cat([zf, zg], 1)
        lib_ms = time_ms(lambda: torch.matmul(z.T, z))
        lib = "matmul([zf,zg]^T [zf,zg])"
    else:
        lib_ms = time_ms(lambda: torch.matmul(zf.T, zg))
        lib = "matmul(zf^T zg)"
    ms = time_ms(lambda: cco_stats(zf, zg, nv, moments=moments))
    plain_ms = time_ms(lambda: ref.cco_stats_ref(zf, zg, nv, moments))
    call_ms = eager_ms(lambda: cco_stats(zf, zg, nv, moments=moments))
    b_ms, b_by = cco_stats_bound_ms(n, d, moments)
    print(f"cco_stats moments={moments} N={n} d={d} num_valid={valid}: "
          f"max_abs_err={err:.3e} (tol {TOL:g} x (1 + {scale:.3g})) "
          f"{'ok' if ok else 'MISMATCH'}; device ms: kernel {ms:.5f} plain "
          f"{plain_ms:.5f} {lib} {lib_ms:.5f} bound {b_ms:.5f} ({b_by}); "
          f"eager call ms {call_ms:.5f}", flush=True)
    if not ok:
        fail(f"cco_stats {moments} disagrees with its plain version at "
             f"N={n} d={d}")
    return err, ms, plain_ms, lib_ms


def quant_bound_ms(k, n, two_d):
    """x and u read, out written (and the (K, n) scales read in the
    column-mapped form); 5 operations an element (divide, add, floor,
    clip, multiply)."""
    per_elem = 16 if two_d else 12
    return bound_ms(per_elem * k * n + (0 if two_d else 4 * k), 5 * k * n)


def check_quant(k, n, two_d, seed, calls=50, replays=20):
    """Kernel vs plain version, bit for bit; returns (max_abs_err, ms,
    plain_ms). The scales are per row, amax / qmax, or column-mapped: the
    row's scale times a factor in [0.5, 2) per element, as leaves of one
    payload have scales of their own. No single PyTorch call computes
    stochastic rounding, so there is no library yardstick."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(k, n, generator=gen, device=dev)
    x *= torch.logspace(-3, 1, k, device=dev)[:, None]
    u = torch.rand(k, n, generator=gen, device=dev)
    s = x.abs().amax(1) / QMAX
    if two_d:
        fac = torch.rand(k, n, generator=gen, device=dev) * 1.5 + 0.5
        s = (s[:, None] * fac).contiguous()
        del fac
    torch.cuda.reset_peak_memory_stats()
    out = quant_dequant(x, u, s, QMAX)
    torch.cuda.synchronize()
    plain = ref.quant_dequant_ref(x, u, s, QMAX)
    if out.shape != (k, n) or not out.is_cuda:
        fail(f"quant_dequant: shape {tuple(out.shape)} on {out.device}")
    err = float((out - plain).abs().max())
    equal = torch.equal(out, plain)
    del out, plain
    ms = time_ms(lambda: quant_dequant(x, u, s, QMAX), calls, replays)
    plain_ms = time_ms(lambda: ref.quant_dequant_ref(x, u, s, QMAX), calls,
                       replays)
    peak = torch.cuda.max_memory_allocated() / 2**30
    b_ms, b_by = quant_bound_ms(k, n, two_d)
    form = "column-mapped" if two_d else "per-row"
    print(f"quant_dequant {form} K={k} n={n}: max_abs_err={err:.3e} "
          f"bit-equal {equal}; device ms: kernel {ms:.5f} plain "
          f"{plain_ms:.5f} library none bound {b_ms:.5f} ({b_by}); peak "
          f"memory {peak:.2f} GiB", flush=True)
    if not equal:
        fail(f"quant_dequant {form} differs from its plain version at "
             f"K={k} n={n}")
    return err, ms, plain_ms


def appendix_a(device, objective="dcco"):
    """One round of ``objective`` against one centralized step on the same
    cohort.

    The gate on parameters runs in f64: the reference's GroupNorm
    normalises each pixel over its group's channels only, and GN(32) on
    the 64-channel first stage makes groups of 2 channels, whose f32
    gradients are dominated by rounding (ROADMAP section 3); in f64 the
    identity holds to rounding. The f32 round, phase 1 through the kernel
    in the objective's moment set, is reported and gated on its loss, which
    equals the centralized loss by construction.
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
    obj = get_objective(objective, **({"lam": 5.0} if objective == "dcco"
                                      else {}))
    results = {}
    for dtype in ("float64", "float32"):
        c = cfg.replace(dtype=dtype)
        params = dual_encoder.init_dual_encoder(0, c, de_cfg, device)
        apply = train.make_apply(c, de_cfg)
        opt = opt_lib.sgd(0.05)
        agg = (round_engine.make_kernel_agg_stats(obj.second_moments)
               if dtype == "float32" else None)
        p_fed, _, m_fed = fed_sim.stats_round(
            apply, params, opt.init(params), opt, batch, sizes,
            objective=obj, agg_stats_fn=agg)
        p_cent, _, m_cent = fed_sim.centralized_step(
            apply, params, opt.init(params), opt,
            fed_sim._flatten_clients(batch), objective=obj)
        torch.cuda.synchronize()
        rel = (utils.tree_max_abs_diff(p_fed, p_cent)
               / utils.tree_max_abs_diff(p_cent, params))
        lf, lc = float(m_fed.loss), float(m_cent.loss)
        results[dtype] = (rel, lf, lc)
        print(f"appendix-A {objective} {dtype} (full width, K={K} x "
              f"{N_PER_CLIENT}): |fed - centralized| / |update| = "
              f"{rel:.3e}; loss fed={lf:.6f} centralized={lc:.6f}",
              flush=True)
        del p_fed, p_cent, params
    rel64, lf64, lc64 = results["float64"]
    _, lf32, lc32 = results["float32"]
    if not (rel64 < 1e-4 and abs(lf64 - lc64) <= 1e-9 * abs(lc64)
            and abs(lf32 - lc32) <= 1e-4 * abs(lc32)):
        fail(f"one {objective} round does not equal one centralized step "
             f"(gates: f64 parameters 1e-4 of the update, f64 loss 1e-9, "
             f"f32 loss 1e-4)")


def _reset_counts():
    for counts in (cco_stats.launches, quant_dequant.launches):
        for key in counts:
            counts[key] = 0


def _read_counts():
    return {"cross": cco_stats.launches["cross"],
            "full": cco_stats.launches["full"],
            "per_row": quant_dequant.launches["per_row"],
            "column": quant_dequant.launches["column"]}


def train_path(name, flags, rounds, expected):
    """``train --full`` through its entry point, with every launch count
    set to 0 just before and read just after; fails unless the counts are
    ``expected`` (kernel -> launches, the others 0). Returns the counts."""
    _reset_counts()
    res = train.main(["--full", "--clients-per-round", str(K),
                      "--samples-per-client", str(N_PER_CLIENT),
                      "--dataset-size", str(DATASET), "--rounds", str(rounds),
                      "--eval-every", "1", *flags])
    counts = _read_counts()
    leaves = utils.tree_leaves(res["params"])
    if len(res["history"]) != rounds or not res["loss_finite"]:
        fail(f"{name}: training losses {res['history']}")
    if not all(x.is_cuda and bool(torch.isfinite(x).all()) for x in leaves):
        fail(f"{name}: trained parameters are not finite tensors on cuda")
    d_out = res["params"]["proj"]["layers"][-1]["w"].shape[1]
    if d_out != MAIN_D:
        fail(f"{name}: projection width {d_out}, expected {MAIN_D}")
    want = {k: expected.get(k, 0) for k in counts}
    if counts != want:
        fail(f"{name}: kernel launches {counts} in {rounds} rounds, "
             f"expected {want}")
    steady = sorted(res["round_ms"][1:])
    print(f"train --full {' '.join(flags)} ({name}): {rounds} rounds, losses "
          f"{[float(f'{x:.6g}') for x in res['history']]}; ms/round: first "
          f"{res['round_ms'][0]:.1f}, median of the rest "
          f"{steady[len(steady) // 2]:.1f}; probe acc {res['probe']:.3f} "
          f"(per round {res['probes']}); uplink bytes {res['wire_bytes']:.6g}"
          f"; kernel launches {counts}", flush=True)
    if "--channel" in flags and not res["wire_bytes"] > 0:
        fail(f"{name}: no uplink bytes counted")
    return counts


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
    _build.build(["cco_stats", "quantize"])
    print(f"build: {time.perf_counter() - t0:.2f} s wall "
          f"(nvcc seconds {_build.build_seconds})", flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    # kernel vs plain version at the main paths' shapes, then ragged ones
    n_params = sum(x.numel() for x in utils.tree_leaves(
        dual_encoder.init_dual_encoder(
            0, get_config("resnet14-cifar"),
            get_dual_encoder_config("resnet14-cifar"), device)))
    n_stats = MAIN_D * MAIN_D + 4 * MAIN_D      # the DCCO stats payload
    figures = {
        "cross": check_cco_stats(MAIN_N, MAIN_D, MAIN_N, 0) + (
            cco_stats_bound_ms(MAIN_N, MAIN_D),),
        "full": check_cco_stats(MAIN_N, MAIN_D, MAIN_N, 0, "full") + (
            cco_stats_bound_ms(MAIN_N, MAIN_D, "full"),),
    }
    check_cco_stats(37, 1000, 30, 1)
    check_cco_stats(37, 1000, 30, 1, "full")
    figures["per_row"] = check_quant(K, 1 << 20, False, 2) + (
        None, quant_bound_ms(K, 1 << 20, False))
    check_quant(K, n_stats, True, 3)
    figures["column"] = check_quant(K, n_params, True, 4, calls=5,
                                    replays=4) + (
        None, quant_bound_ms(K, n_params, True))
    for two_d in (False, True):
        check_quant(5, 4099, two_d, 5)
    torch.cuda.empty_cache()

    appendix_a(device, "dcco")
    appendix_a(device, "dvicreg")
    runs = [
        train_path("dcco", ["--stats-kernel", "fused"], ROUNDS,
                   {"cross": ROUNDS}),
        train_path("dvicreg",
                   ["--objective", "dvicreg", "--stats-kernel", "fused"],
                   PATH_ROUNDS, {"full": PATH_ROUNDS}),
        # no --stats-kernel: a lossy channel takes the per-client phase 1
        train_path("dcco over int8", ["--channel", "int8",
                                      "--quant-kernel", "fused"],
                   PATH_ROUNDS, {"column": 2 * PATH_ROUNDS})]
    # launches of each kernel on the main paths, read from their counts
    # (the per-row form runs on none of them, nor in the reference)
    launches = {name: sum(c[name] for c in runs) for name in figures}

    rows = []
    for name, source, replaces in (
            ("cross", "cco_stats.cu", "cco_stats.py:37"),
            ("full", "cco_stats.cu", "cco_stats.py:74"),
            ("per_row", "quantize.cu", "quantize.py:29"),
            ("column", "quantize.cu", "quantize.py:36")):
        err, ms, plain_ms, lib_ms, (b_ms, b_by) = figures[name]
        kernel = ("cco_stats_" if source == "cco_stats.cu"
                  else "quant_dequant_") + name
        rows.append({
            "name": kernel, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
