#!/usr/bin/env python3
"""Time the statistics kernel (``cco_stats``, both moment sets) on one GPU.

  python3 tools/time_cco_stats.py [--src DIR] [--shapes 128x1024,8x1024]

For each shape N x d and moment set it prints the kernel's error against
its plain version, its device time (calls captured in a CUDA graph), the
time of one eager call (host issue included), the ``torch.matmul``
yardstick of ``chip_smoke.py`` and ptxas's register and spill lines, then
one JSON line of the figures. ``--src`` puts DIR first on ``sys.path``,
so the same script times another checkout's kernel: run it once with
``--src src`` and once with the ``src`` of a commit unpacked beside it,
in one call on one card, to compare the two. Needs a CUDA device.
``chip_smoke.py`` times its kernels with this file's ``time_ms`` and
``eager_ms``.
"""
import argparse
import json
from pathlib import Path
import sys

import torch

ROOT = Path(__file__).resolve().parents[1]


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


def eager_ms(fn, iters=200, warmup=20):
    """Mean time of one eager call, host issue included: CUDA events
    around ``iters`` back-to-back calls, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--shapes", default="128x1024,8x1024,37x1000,4096x1024")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.cco_stats import cco_stats
    if not torch.cuda.is_available():
        sys.exit("time_cco_stats: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"{torch.cuda.get_device_name(0)}; kernel from {args.src}",
          flush=True)
    _build.build(["cco_stats"])
    for line in _build.build_logs.get("cco_stats", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)
    rows = []
    for shape in args.shapes.split(","):
        n, d = (int(x) for x in shape.split("x"))
        valid = n if n % 8 == 0 else n - 7      # ragged: pre-masked rows
        gen = torch.Generator(device=dev).manual_seed(n * d)
        m = (torch.arange(n, device=dev) < valid).float()[:, None]
        zf = torch.randn(n, d, generator=gen, device=dev) * m
        zg = torch.randn(n, d, generator=gen, device=dev) * m
        nv = m.sum()
        for moments in ("cross", "full"):
            out = cco_stats(zf, zg, nv, moments=moments)
            plain = ref.cco_stats_ref(zf, zg, nv, moments)
            err = max(float((out[k] - plain[k]).abs().max())
                      if bool(torch.isfinite(out[k]).all()) else float("inf")
                      for k in plain)
            if moments == "full":
                z = torch.cat([zf, zg], 1)
                lib = time_ms(lambda: torch.matmul(z.T, z))
            else:
                lib = time_ms(lambda: torch.matmul(zf.T, zg))
            ms = time_ms(lambda: cco_stats(zf, zg, nv, moments=moments))
            call = eager_ms(lambda: cco_stats(zf, zg, nv, moments=moments))
            row = {"moments": moments, "n": n, "d": d, "max_abs_err": err,
                   "ms": ms, "matmul_ms": lib, "eager_call_ms": call}
            rows.append(row)
            print(f"cco_stats {moments} N={n} d={d}: max_abs_err {err:.3e} "
                  f"kernel {ms:.5f} ms, matmul {lib:.5f} ms, eager call "
                  f"{call:.5f} ms", flush=True)
    print(json.dumps({"cco_stats": rows}), flush=True)


if __name__ == "__main__":
    main()
