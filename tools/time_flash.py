#!/usr/bin/env python3
"""Time the flash-attention kernel (``flash_attention``) on one GPU.

  python3 tools/time_flash.py [--src DIR] [--only LABEL,...] [--host]
                              [--backward] [--trace]

For each shape (every flash shape ``PERF.md`` tracks, in bf16 and in
f32, then TinyLlama's heads at B = 1 over 4096 and 32768 positions) it
prints the kernel's error
against its plain version, its device time (calls captured in a CUDA
graph), the time of one eager call (host issue included), the same with
the operands as the model hands them ((B, S, H, Dh) tensors seen as (B, H,
S, Dh)), one ``scaled_dot_product_attention`` call, the plain version's
time where its (B, H, Sq, Skv) scores fit in memory, and the bound (the
larger of the bytes at the HBM rate and the unmasked scores' operations at
the tensor-core peak of the type: bf16, or TF32 for f32), then one JSON
line of the figures. ``--src`` puts DIR first on ``sys.path``, so the same
script times another checkout's kernel: run it with ``--src src`` and with
the ``src`` of a parent commit unpacked beside it, in one call on one card,
to compare the two. ``--host`` times instead the host's cost of one call
at the TinyLlama path's shape: microseconds a call of the wrapper's
forward (on contiguous operands and on (B, S, H, Dh) views) and of the
differentiable call, on the host clock over back-to-back calls that the
card finishes faster than the host issues them. ``--backward`` times
instead, at each shape, the backward of ``flash_attention`` (whatever
the checkout's autograd Function runs: the backward kernel, or a parent's
plain-torch recompute) beside the backward of one SDPA call, each with
its forward outside the timed region (``backward_ms``), and the
backward's bound; and a digest of one call's dq, dk and dv bytes, which
two checkouts share where their kernels give the same bits. Needs a CUDA
device, but for ``--trace``: the peak
bytes of ``launch/dryrun.Trace`` over one forward and
``torch.autograd.grad`` through ``flash_attention`` on fake tensors
(TRACE_SHAPES; counted from shapes on the CPU, no device time), the
memory shape of the checkout's gradient.
"""
import argparse
import hashlib
import json
from pathlib import Path
import statistics
import subprocess
import sys
import time

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from tools.time_cco_stats import eager_ms, time_ms  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
# (label, B, H, KVH, Sq, Skv, Dqk, Dv, type), causal, no window
SHAPES = [
    ("tinyllama path", 8, 32, 4, 128, 128, 64, 64, BF16),
    ("internvl2-2b prefill", 4, 16, 8, 384, 384, 128, 128, BF16),
    ("fig1c view 2", 8, 16, 8, 257, 257, 128, 128, BF16),
    ("mla prefill", 4, 16, 16, 128, 128, 192, 128, BF16),
    ("zamba2 prefill", 4, 32, 32, 128, 128, 80, 80, BF16),
    ("musicgen prefill", 4, 32, 32, 128, 128, 64, 64, BF16),
    ("mla f32", 2, 8, 8, 100, 100, 192, 128, F32),
    ("zamba2 f32", 2, 8, 4, 100, 150, 80, 80, F32),
    # f32: the token path's shape, the smoke TinyLlama of
    # examples/dual_encoder_text.py (a microbatch of 8 sequences of 32),
    # TinyLlama's heads over 4096 positions
    ("tinyllama path f32", 8, 32, 4, 128, 128, 64, 64, F32),
    ("text example f32", 8, 8, 2, 32, 32, 32, 32, F32),
    ("tinyllama 4k f32", 1, 32, 4, 4096, 4096, 64, 64, F32),
    ("tinyllama 4k", 1, 32, 4, 4096, 4096, 64, 64, BF16),
    ("tinyllama 32k", 1, 32, 4, 32768, 32768, 64, 64, BF16),
]
PLAIN_BYTES = 8 << 30      # the plain version's scores above this: not run
# (B, H, KVH, S, Dh, type) of --trace: a (B, H, S, S) f32 block is 128 MiB
# at the first, TinyLlama's heads over 4096 positions after it
TRACE_SHAPES = [(1, 8, 2, 2048, 64, F32), (1, 32, 4, 4096, 64, F32),
                (1, 32, 4, 4096, 64, BF16)]


def flash_bound_ms(q, k, v, valid, peak=None):
    """(ms, "bytes" or "operations"): q, k, v read once, the output (B, H,
    Sq, Dv) and the f32 row log-sum-exp written once, against 2 (Dqk + Dv)
    operations for each score ``valid`` keeps, for each (batch, head), at
    ``peak`` (by default the tensor-core peak of the inputs' type: bf16,
    or TF32 for f32, on which the kernel's f32 route runs)."""
    from repro_torch.launch.mesh import HardwareSpec as hw
    if peak is None:
        peak = hw.PEAK_BF16 if q.dtype == BF16 else hw.PEAK_TF32
    b, h, sq, dh = q.shape
    dv = v.shape[3]
    moved = ((q.numel() + k.numel() + v.numel() + b * h * sq * dv)
             * q.element_size() + 4 * b * h * sq)
    ops = 2 * b * h * (dh + dv) * int(valid.sum())
    t_bytes, t_ops = moved / hw.PEAK_BYTES, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_bwd_bound_ms(q, k, v, causal=True, window=0, peak=None):
    """(ms, "bytes" or "operations") of the backward: q, k, v, the output,
    its gradient and the f32 row log-sum-exp read once, dq, dk and dv
    written once, against the five products of the gradient over the
    valid (64, 64) tile pairs (``flash_attention.backward_flops``), at
    ``peak`` (by default the tensor-core peak of the inputs' type: bf16,
    or TF32 for f32)."""
    from repro_torch.kernels.flash_attention import backward_flops
    from repro_torch.launch.mesh import HardwareSpec as hw
    if peak is None:
        peak = hw.PEAK_BF16 if q.dtype == BF16 else hw.PEAK_TF32
    b, h, sq, dh = q.shape
    skv, dv = k.shape[2], v.shape[3]
    moved = (2 * (q.numel() + k.numel() + v.numel() + b * h * sq * dv)
             * q.element_size() + 4 * b * h * sq)
    ops = backward_flops(b, h, sq, skv, dh, dv, causal, window)
    t_bytes, t_ops = moved / hw.PEAK_BYTES, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sdpa_backward_ms(q, k, v, mask, calls, replays):
    """Device ms of the backward of one ``scaled_dot_product_attention(q,
    k, v, enable_gqa=True, **mask)`` (``backward_ms``); None where no SDPA
    backend takes the shapes or its backward cannot be captured."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return backward_ms(lambda *x: sdpa(*x, enable_gqa=True, **mask), q, k, v,
                       calls, replays, "sdpa backward")


def backward_ms(fn, q, k, v, calls, replays, label="backward"):
    """Device ms of the backward of ``fn(q, k, v)``, its forward outside
    the timed region: the forward runs once on a side stream, then
    ``calls`` calls of ``torch.autograd.grad`` through it are captured in
    a CUDA graph on that stream (the backward's ops run on their
    forward's stream) and replayed ``replays`` times between CUDA events.
    None (printed) where the call or its capture raises."""
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    try:
        with torch.cuda.stream(side):
            out = fn(*leaves)
            grad = torch.randn_like(out)
            for _ in range(3):
                torch.autograd.grad(out, leaves, grad, retain_graph=True)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(calls):
                torch.autograd.grad(out, leaves, grad, retain_graph=True)
    except RuntimeError as e:
        print(f"{label}: {str(e).splitlines()[0][:160]}", flush=True)
        torch.cuda.current_stream().wait_stream(side)
        return None
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def nvidia_smi():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def time_shape(label, b, h, kvh, sq, skv, dqk, dv, dtype):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(sq * 7 + dqk)
    # the model's layout: (B, S, H, Dh), seen as (B, H, S, Dh)
    qv = torch.randn(b, sq, h, dqk, generator=gen, device=dev).to(
        dtype).transpose(1, 2)
    kv = torch.randn(b, skv, kvh, dqk, generator=gen, device=dev).to(
        dtype).transpose(1, 2)
    vv = torch.randn(b, skv, kvh, dv, generator=gen, device=dev).to(
        dtype).transpose(1, 2)
    q, k, v = qv.contiguous(), kv.contiguous(), vv.contiguous()
    big = sq >= 4096
    calls, replays = (4, 3) if big else (50, 20)
    iters = 12 if big else 200
    out = flash_attention(q, k, v)
    same_view = bool(torch.equal(flash_attention(qv, kv, vv), out))
    valid = ref.flash_attention_mask(sq, skv, True, 0, dev)
    plain_ms = err = None
    if b * h * sq * skv * 4 <= PLAIN_BYTES:
        plain = ref.flash_attention_ref(q, k, v)
        err = float((out.float() - plain.float()).abs().max())
        del plain
        plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v),
                           2 if big else 5, 3 if big else 4)
    del out
    ms = time_ms(lambda: flash_attention(q, k, v), calls, replays)
    call_ms = eager_ms(lambda: flash_attention(q, k, v), iters, 3)
    view_ms = eager_ms(lambda: flash_attention(qv, kv, vv), iters, 3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = ({"is_causal": True} if sq == skv else {"attn_mask": valid})
    try:
        lib_ms = time_ms(lambda: sdpa(q, k, v, enable_gqa=True, **mask),
                         calls, replays)
    except RuntimeError as e:          # no backend takes these shapes
        print(f"sdpa at {label}: {str(e).splitlines()[0][:160]}",
              flush=True)
        lib_ms = None
    bound, by = flash_bound_ms(q, k, v, valid)
    row = {"label": label, "b": b, "h": h, "kvh": kvh, "sq": sq, "skv": skv,
           "dqk": dqk, "dv": dv, "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": err, "ms": ms, "eager_call_ms": call_ms,
           "view_call_ms": view_ms, "view_equal": same_view,
           "sdpa_ms": lib_ms, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": by}
    fmt = (lambda x: "none" if x is None else f"{x:.5f}")
    print(f"flash {label} B={b} H={h} KVH={kvh} Sq={sq} Skv={skv} "
          f"D=({dqk}, {dv}) {row['dtype']}: max_abs_err "
          f"{'none' if err is None else f'{err:.3e}'}; kernel {ms:.5f} ms, "
          f"eager call {call_ms:.5f}, from (B, S, H, Dh) views {view_ms:.5f} "
          f"(equal {same_view}), sdpa {fmt(lib_ms)}, plain {fmt(plain_ms)}, "
          f"bound {bound:.5f} ({by}); kernel / sdpa "
          f"{fmt(None if lib_ms is None else ms / lib_ms)}, bound / kernel "
          f"{bound / ms:.3f}", flush=True)
    del q, k, v, qv, kv, vv, valid
    torch.cuda.empty_cache()
    return row


def time_backward(label, b, h, kvh, sq, skv, dqk, dv, dtype):
    """The backward at one shape: the checkout's flash backward and SDPA's,
    causal, no window; the bound where the checkout counts the backward's
    FLOPs. The parent's dense recompute is not run where its (B, H, Sq,
    Skv) f32 scores pass PLAIN_BYTES."""
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(sq * 7 + dqk)
    q, k, v = (torch.randn(b, n, s, d, generator=gen, device=dev).to(dtype)
               for n, s, d in ((h, sq, dqk), (kvh, skv, dqk), (kvh, skv, dv)))
    big = sq >= 4096
    calls, replays = (1, 2) if sq >= 32768 else (2, 3) if big else (20, 10)
    dense = not hasattr(fa, "backward_flops")
    ms = None
    if not dense or b * h * sq * skv * 4 <= PLAIN_BYTES:
        ms = backward_ms(lambda *x: fa.flash_attention(*x), q, k, v, calls,
                         replays, f"flash backward at {label}")
    mask = ({"is_causal": True} if sq == skv else {"attn_mask":
            torch.ones(sq, skv, dtype=torch.bool, device=dev).tril(
                skv - sq)})
    lib_ms = sdpa_backward_ms(q, k, v, mask, calls, replays)
    bound = by = None
    if not dense:
        bound, by = flash_bwd_bound_ms(q, k, v)
    digest = None
    if ms is not None:
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = fa.flash_attention(*leaves)
        do = torch.randn(out.shape, generator=gen, device=dev).to(dtype)
        grads = torch.autograd.grad(out, leaves, do)
        digest = hashlib.sha256(b"".join(
            g.contiguous().view(torch.uint8).cpu().numpy().tobytes()
            for g in grads)).hexdigest()[:16]
        del leaves, out, do, grads
    row = {"label": label, "b": b, "h": h, "kvh": kvh, "sq": sq, "skv": skv,
           "dqk": dqk, "dv": dv, "dtype": str(dtype).replace("torch.", ""),
           "route": "plain-torch recompute" if dense else "backward kernel",
           "backward_ms": ms, "sdpa_backward_ms": lib_ms, "bound_ms": bound,
           "bound_by": by, "grad_sha256": digest}
    fmt = (lambda x: "none" if x is None else f"{x:.5f}")
    print(f"flash backward {label} B={b} H={h} KVH={kvh} Sq={sq} Skv={skv} "
          f"D=({dqk}, {dv}) {row['dtype']} ({row['route']}): {fmt(ms)} ms, "
          f"sdpa backward {fmt(lib_ms)}, bound {fmt(bound)} ({by}), "
          f"grads {digest}; "
          f"backward / sdpa "
          f"{fmt(None if ms is None or lib_ms is None else ms / lib_ms)}",
          flush=True)
    del q, k, v
    torch.cuda.empty_cache()
    return row


def trace_peak(b, h, kvh, s, dh, dtype):
    """Peak bytes that ``dryrun.Trace`` counts above the operands and the
    output's weights over ``flash_attention(q, k, v)`` and
    ``torch.autograd.grad`` of its weighted sum, on fake CPU tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.dryrun import Trace
    with FakeTensorMode():
        q, k, v = (torch.empty(b, n, s, dh, dtype=dtype, requires_grad=True)
                   for n in (h, kvh, kvh))
        w = torch.empty(b, h, s, dh, dtype=dtype)
        with Trace(existing=[q, k, v, w]) as tr:
            out = flash_attention(q, k, v)
            torch.autograd.grad((out * w).sum(), (q, k, v))
    return tr.peak


def host_us(fn, calls=2000, runs=5):
    """(median, min) over ``runs`` of the host's microseconds a call of
    ``fn``, ``calls`` calls back to back, the card synchronised between
    runs only."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per_call), min(per_call)


def time_host(rounds=3):
    """The host's cost of one call at the TinyLlama path's shape (8, 32,
    4, 128, 128, 64) bf16: the wrapper's forward on contiguous operands,
    on (B, S, H, Dh) views, and the differentiable call on contiguous
    operands, each timed ``rounds`` times in turn."""
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, kvh, s, d = 8, 32, 4, 128, 64
    views = [torch.randn(b, s, n, d, generator=gen, device=dev).to(
        BF16).transpose(1, 2) for n in (h, kvh, kvh)]
    flat = [x.contiguous() for x in views]
    cases = {"forward contiguous": lambda: fa._forward(*flat, True, 0, 0.125),
             "forward views": lambda: fa._forward(*views, True, 0, 0.125),
             "flash_attention contiguous": lambda: fa.flash_attention(*flat)}
    rows = {name: [] for name in cases}
    for _ in range(rounds):
        for name, fn in cases.items():
            rows[name].append(host_us(fn))
    for name, runs in rows.items():
        print(f"host {name}: " + ", ".join(
            f"median {m:.1f} us (min {lo:.1f})" for m, lo in runs),
            flush=True)
    return {name: [m for m, _ in runs] for name, runs in rows.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--only", default="",
                    help="comma-separated labels; default: every shape")
    ap.add_argument("--host", action="store_true",
                    help="time the host's cost of a call, not the shapes")
    ap.add_argument("--backward", action="store_true",
                    help="time the backward at each shape beside SDPA's")
    ap.add_argument("--trace", action="store_true",
                    help="the traced gradient's peak bytes (no device)")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    if args.trace:
        rows = []
        for shape in TRACE_SHAPES:
            peak = trace_peak(*shape)
            rows.append({"shape": list(shape[:5]), "dtype": str(
                shape[5]).replace("torch.", ""), "peak_bytes": peak})
            print(f"traced forward + backward {shape[:5]} "
                  f"{rows[-1]['dtype']}: peak {peak} bytes "
                  f"({peak / 2 ** 20:.2f} MiB)", flush=True)
        print(json.dumps({"trace": rows, "src": args.src}), flush=True)
        return
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        sys.exit("time_flash: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"{nvidia_smi()}; kernel from {args.src}", flush=True)
    names = [n for n in ("flash_attention", "flash_attention_bwd")
             if n in _build.KERNELS]
    _build.build(names)
    print(f"nvcc {_build.build_seconds} s (none if built before)",
          flush=True)
    for name in names:
        for line in _build.build_logs.get(name, "").splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill")):
                print(f"ptxas {name}: {line.strip()}", flush=True)
    if args.host:
        print(json.dumps({"host_us": time_host(), "src": args.src,
                          "device": torch.cuda.get_device_name(0)}),
              flush=True)
        return
    only = {x.strip() for x in args.only.split(",") if x.strip()}
    rows = [(time_backward if args.backward else time_shape)(*shape)
            for shape in SHAPES if not only or shape[0] in only]
    print(json.dumps({"flash": rows, "src": args.src,
                      "device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
