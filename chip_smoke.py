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
     ``cco_stats`` in both moment sets (to 1e-5 x (1 + max|plain|), a
     second run bit-equal, cov_f and cov_g exactly symmetric, the full
     set's cross statistics bit-equal to the cross set's) at (N, d) =
     (128, 1024), the token path's (8, 1024), (37, 1000) and (4096, 1024),
     ``quant_dequant`` in both scale forms (bit for bit)
     and ``segment_sum`` (bit for bit, and the same on a second run) at
     every (K, D, E) its paths give it, a ragged shape with padding ids
     and empty segments, and one segment per client; then
     ``hierarchy.fold_to_edges`` end to end at the deltas shape beside the
     kernel alone;
  3. the Appendix-A equivalence at full width, for DCCO and for D-VICReg:
     one round against one centralized step on the same 64-client cohort;
  4. six training paths through ``repro_torch.launch.train --full`` on
     64 clients x 2 samples of 2048 synthetic 32x32 images, each with every
     kernel launch count set to 0 just before and read just after, and held
     to the launches its code makes:
     DCCO (5 rounds; the "cross" statistics kernel once a round), D-VICReg
     (3 rounds; the "full" statistics kernel once a round), DCCO over an
     int8 uplink (3 rounds; the column-mapped quantize kernel twice a round,
     no statistics kernel), and, 3 rounds each, the two-level tree over 8
     edges with an int8 client hop (segment_sum 3 a round, quantize 2),
     clustered aggregation over 4 clusters (segment_sum 8 a round) and the
     buffered engine (segment_sum 2 a tick);
  5. ``mips_topk`` in both forms against its plain version (scores to
     1e-5, indices equal but for near ties, a second run bit-equal) at the
     training eval's shape (512, 1536), the serving shape (64, 16384) in
     f32 and bf16, a deployed index of 2^20 rows (Q = 16 and 64), a large
     batch (1024, 65536, k = 32) and a ragged 1,000,003-row corpus, whose
     4 zero-padded shards through the offset form merge to the unsharded
     result bit for bit; duplicated rows must tie to the lowest index;
  6. a seventh training path, DCCO with the retrieval eval after every
     round (3 rounds; cco_stats and one mips_topk search a round, recall
     and MRR in [0, 1]), and the serving surface on the encoder it
     trained: CorpusIndex over 16,384 images in f32 and bf16, QueryServer
     (batch 64, k 10) over 32 batches equal to index.search,
     ShardedCorpusIndex x 4 equal bit for bit, and IVFIndex over 128 lists
     (k-means on segment_sum; every list probed equals the exact tier);
     then the serving rate: QueryServer over a deployed index of 2^20
     random unit rows (f32 and bf16), 512 batches back to back, p50, p99
     and qps. Each surface's launches are read in a window of its own,
     with the comparisons outside it, and held exact;
  7. ``flash_attention`` against its plain version (f32 to 2e-5, bf16 to
     3e-2, the row log-sum-exp to 2e-5 (1 + |lse|)) at the TinyLlama
     path's shape (phase 1 and phase 2 both give B = K * n), Dh 128 in
     groups of 2, the smoke configs' Dh 32 in f32, windows 32 and 96,
     non-causal, Sq 64 of Skv 128 and a ragged S of 100, each timed beside
     its plain version and ``scaled_dot_product_attention`` (a yardstick
     the port never calls); the gradient of its autograd Function against
     autograd of the plain version at the path's shape in f32; then, after
     the serving phase's memory is released, D-CCO training of the
     full-width TinyLlama-1.1B token dual encoder (3 rounds, TOK_K clients
     x 2 sequences of 128 tokens, bf16 weights from seed 0): losses
     finite, peak device memory printed, launches exactly 88 flash
     attention forwards a round (2 views x 22 layers in the no-grad phase
     1, the same again in phase 2, where vmap folds the K clients into
     one launch; the backward recomputes in plain torch) and one "cross"
     statistics kernel.
Then one JSON line of kernel figures, and the device line last.
Needs a CUDA device and the repository's ``src/`` beside this file.
"""
import gc
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
from repro_torch.hierarchy import fold_to_edges  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.cco_stats import cco_stats  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttention, flash_attention)
from repro_torch.kernels.quantize import quant_dequant  # noqa: E402
from repro_torch.kernels.mips_topk import mips_topk  # noqa: E402
from repro_torch.kernels.segment_sum import segment_sum  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import dual_encoder  # noqa: E402
from repro_torch.objectives import get_objective  # noqa: E402
from repro_torch.optim import optimizers as opt_lib  # noqa: E402
from repro_torch import retrieval  # noqa: E402
from tools.time_cco_stats import eager_ms, time_ms  # noqa: E402

ROUNDS = 5            # the DCCO path
PATH_ROUNDS = 3       # every other path
K, N_PER_CLIENT, DATASET = 64, 2, 2048
MAIN_N, MAIN_D = K * N_PER_CLIENT, 1024   # phase-1 rows, projection width
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 non-tensor FLOP/s
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
# kernel vs plain: max |kernel - plain| <= TOL * (1 + max |plain|); both
# sum f32 products of unit-normal data in other orders, the kernel each
# product as a TF32 and two bf16 remainder products (~2^-20 of it) summed
# from zero every 32 rows (tests/test_torch_kernel_numerics.py)
TOL = 1e-5
QMAX = 127.0          # the int8 channel
# MIPS kernel vs plain version: |score - plain score| <= MIPS_TOL; both sum
# d = 1024 f32 products of unit vectors in other orders (a typical error is
# sqrt(d) 2^-24 = 2e-6). An index may differ only where the plain scores
# of the two picks lie within MIPS_TOL of each other (a near tie).
MIPS_TOL = 1e-5
MIPS_K = 10                       # the training eval's and the server's k
SERVE_N, SERVE_BATCH, SERVE_BATCHES = 16384, 64, 32
RATE_N, RATE_BATCHES = 1 << 20, 512   # the serving rate's deployed index
IVF_C, IVF_NPROBE = 128, 8
# the token path: TinyLlama-1.1B at full width (22 layers, H 32, KVH 4,
# Dh 64, bf16), TOK_K clients x TOK_N sequences of TOK_S tokens
TOK_ARCH, TOK_LAYERS, TOK_K, TOK_N, TOK_S = "tinyllama-1.1b", 22, 4, 2, 128
PEAK_BF16 = 989e12    # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_TF32 = 495e12    # H100 SXM dense TF32 tensor-core FLOP/s
# flash attention vs plain: both compute in f32 from the same inputs, in
# other orders; a bf16 output is rounded once on each side (1 bf16 ulp of
# an output below 4 is under 3e-2), as tests/test_kernels.py holds it
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def bound_ms(bytes_moved, ops, peak=PEAK_F32):
    """Least time on the card: the bytes at the HBM rate or the operations
    at ``peak`` (by default the f32 non-tensor peak), whichever is
    longer."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cco_stats_bound_ms(n, d, moments="cross", peak=PEAK_TF32):
    """Each input read once and each output written once; FLOPs: 2Nd^2
    for cross, plus N d (d + 1) for the upper triangle (diagonal included)
    of each of the two symmetric within-view products in the full set, plus
    6Nd for the vector statistics, at the TF32 tensor-core peak, the
    fastest rate at which any route multiplies f32 inputs (``peak=PEAK_F32``
    gives the CUDA-core figure used before the kernel ran on the tensor
    cores)."""
    mats, flops = 1, 2 * n * d * d + 6 * n * d
    if moments == "full":
        mats, flops = 3, flops + 2 * n * d * (d + 1)
    return bound_ms(4 * (2 * n * d + mats * d * d + 4 * d + 1), flops, peak)


def check_cco_stats(n, d, valid, seed, moments="cross"):
    """Kernel vs plain version on pre-masked rows with ``num_valid``, as
    the engine calls it, and a second run bit-equal to the first; in the
    full set cov_f and cov_g exactly symmetric and the five cross
    statistics bit-equal to the cross set's. Returns (max_abs_err, ms,
    plain_ms, library_ms), times on the device. The yardstick is one cuBLAS
    product: zf^T zg for the cross set; for the full set z^T z with z =
    [zf, zg], which makes all three (d, d) blocks at once (and more: the
    lower blocks, no vector statistics, no masking)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    m = (torch.arange(n, device=dev) < valid).float()[:, None]
    zf = torch.randn(n, d, generator=gen, device=dev) * m
    zg = torch.randn(n, d, generator=gen, device=dev) * m
    nv = m.sum()
    out = cco_stats(zf, zg, nv, moments=moments)
    again = cco_stats(zf, zg, nv, moments=moments)
    torch.cuda.synchronize()
    if not all(torch.equal(out[k], again[k]) for k in out):
        fail(f"cco_stats {moments}: a second run differs at N={n} d={d}")
    plain = ref.cco_stats_ref(zf, zg, nv, moments)
    err, scale = 0.0, 0.0
    if set(out) != set(plain):
        fail(f"cco_stats {moments}: keys {sorted(out)}, expected "
             f"{sorted(plain)}")
    for k in plain:
        if out[k].shape != plain[k].shape or not out[k].is_cuda:
            fail(f"cco_stats {k}: shape {tuple(out[k].shape)} on "
                 f"{out[k].device}, expected {tuple(plain[k].shape)} on cuda")
        if not bool(torch.isfinite(out[k]).all()):
            fail(f"cco_stats {moments}: {k} is not finite at N={n} d={d}")
        err = max(err, float((out[k] - plain[k]).abs().max()))
        scale = max(scale, float(plain[k].abs().max()))
    ok = err <= TOL * (1.0 + scale)
    if moments == "full":
        for k in ("cov_f", "cov_g"):
            if not torch.equal(out[k], out[k].T):
                fail(f"cco_stats {k} is not exactly symmetric")
        cross = cco_stats(zf, zg, nv)
        if not all(torch.equal(cross[k], out[k]) for k in cross):
            fail(f"cco_stats: the full set's cross statistics differ from "
                 f"the cross set's at N={n} d={d}")
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
    f32_ms, f32_by = cco_stats_bound_ms(n, d, moments, PEAK_F32)
    print(f"cco_stats moments={moments} N={n} d={d} num_valid={valid}: "
          f"max_abs_err={err:.3e} (tol {TOL:g} x (1 + {scale:.3g})) "
          f"{'ok' if ok else 'MISMATCH'}, second run bit-equal"
          f"{', symmetric, cross bit-equal' if moments == 'full' else ''}; "
          f"device ms: kernel {ms:.5f} plain {plain_ms:.5f} {lib} "
          f"{lib_ms:.5f} bound {b_ms:.5f} ({b_by}; {f32_ms:.5f}, {f32_by}, "
          f"at the f32 CUDA-core rate); eager call ms {call_ms:.5f}",
          flush=True)
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


def segment_sum_bound_ms(k_valid, d, e):
    """Rows with an id in range read once, the (E, D) output written once,
    ids and weights read once; one multiply and one add an element of
    every row read."""
    return bound_ms(4 * (k_valid * d + e * d) + 8 * k_valid,
                    2 * k_valid * d)


def check_segment_sum(k, d, e, ids, seed, label, time_it=True):
    """Kernel vs plain version on (k, d) unit-normal rows, ``ids`` and
    weights in [0, 1), bit for bit, and kernel vs kernel on a second run;
    returns (max_abs_err, ms, plain_ms, library_ms, bound). The plain
    version reads its ranks on the host, so it is timed eagerly (CUDA
    events around back-to-back calls), not in a graph. The yardstick is
    one cuBLAS product ``W @ rows`` with W (E, K) = w_k [id_k = e], built
    outside the timed call."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randn(k, d, generator=gen, device=dev)
    w = torch.rand(k, generator=gen, device=dev)
    ids = ids.to(device=dev, dtype=torch.int32)
    out = segment_sum(rows, ids, e, w)
    again = segment_sum(rows, ids, e, w)
    torch.cuda.synchronize()
    plain = ref.segment_sum_ref(rows, ids, e, w)
    if out.shape != (e, d) or not out.is_cuda:
        fail(f"segment_sum {label}: shape {tuple(out.shape)} on {out.device}")
    err = float((out - plain).abs().max())
    equal, same = torch.equal(out, plain), torch.equal(out, again)
    del out, again, plain
    valid = (ids >= 0) & (ids < e)
    b_ms, b_by = segment_sum_bound_ms(int(valid.sum()), d, e)
    ms = plain_ms = lib_ms = float("nan")
    if time_it:
        onehot = (ids.long()[None, :] == torch.arange(e, device=dev)[:, None])
        wmat = (onehot.to(torch.float32) * w[None, :]).contiguous()
        ms = time_ms(lambda: segment_sum(rows, ids, e, w), 10, 5)
        plain_ms = eager_ms(lambda: ref.segment_sum_ref(rows, ids, e, w), 10)
        lib_ms = time_ms(lambda: torch.matmul(wmat, rows), 10, 5)
        del wmat
    print(f"segment_sum {label} K={k} D={d} E={e}: max_abs_err={err:.3e} "
          f"bit-equal {equal}, run-to-run equal {same}; device ms: kernel "
          f"{ms:.5f} plain {plain_ms:.5f} matmul(W, rows) {lib_ms:.5f} "
          f"bound {b_ms:.5f} ({b_by})", flush=True)
    if not (equal and same):
        fail(f"segment_sum {label} differs from its plain version or from "
             f"itself at K={k} D={d} E={e}")
    del rows
    torch.cuda.empty_cache()
    return err, ms, plain_ms, lib_ms, (b_ms, b_by)


def unit_rows(n, d, gen, dtype=torch.float32):
    """(n, d) random unit rows on the card, drawn from ``gen``."""
    x = torch.randn(n, d, generator=gen, device="cuda")
    x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x if dtype == torch.float32 else x.to(dtype)


def mips_bound_ms(qn, n_valid, d, k, corpus_bytes):
    """The corpus rows read once, the queries read once, the (Q, k) scores
    and indices written once; 2 Q N d operations at the TF32 tensor-core
    peak, the fastest rate at which any route multiplies f32 inputs."""
    return bound_ms(n_valid * d * corpus_bytes + qn * d * 4 + 8 * qn * k,
                    2 * qn * n_valid * d, PEAK_TF32)


def mips_agree(q, corpus, out, plain, off=0):
    """(max |score - plain score|, index mismatches, all of them near
    ties): a mismatch is a near tie when the plain scores of the two picks
    (one sum over d each, the same order for both) lie within MIPS_TOL."""
    (v, i), (pv, pi) = out, plain
    err = float((v - pv).abs().max())
    bad = i != pi
    ties = True
    if bool(bad.any()):
        rows = bad.nonzero()[:, 0]
        c = corpus.float()

        def score(idx):
            return (q[rows].float() * c[idx[bad].long() - off]).sum(-1)
        ties = bool(((score(i) - score(pi)).abs() <= MIPS_TOL).all())
    return err, int(bad.sum()), ties


def check_mips(q, corpus, k, label, *, off=None, n_total=None, time_it=True,
               graph=(50, 20)):
    """Kernel vs plain version at one shape (scores to MIPS_TOL, indices
    equal but for near ties) and kernel vs kernel on a second run (bit for
    bit); returns (max_abs_err, ms, plain_ms, library_ms, bound) and the
    kernel's result. The kernel is timed in a CUDA graph, the plain
    version (thousands of small launches a call) with CUDA events around
    two eager calls after one, and the yardstick
    ``torch.topk(q @ c.T, k)`` (TF32 off; a bf16 corpus upcast in the call;
    for the offset form it gives local indices, one addition short of the
    kernel's) in a graph."""
    qn, d = q.shape
    n = corpus.shape[0]
    kw = {} if off is None else {"index_offset": off, "n_total": n_total}
    out = mips_topk(q, corpus, k, **kw)
    again = mips_topk(q, corpus, k, **kw)
    torch.cuda.synchronize()
    plain = ref.mips_topk_ref(q, corpus, k, **kw)
    if out[0].shape != (qn, k) or out[1].dtype != torch.int32 \
            or not out[0].is_cuda:
        fail(f"mips_topk {label}: {tuple(out[0].shape)} {out[1].dtype} on "
             f"{out[0].device}")
    err, mismatches, ties = mips_agree(q, corpus, out, plain, off or 0)
    same = torch.equal(out[0], again[0]) and torch.equal(out[1], again[1])
    del again, plain
    valid = n if off is None else max(0, min(n, n_total - off))
    b = mips_bound_ms(qn, valid, d, k, corpus.element_size())
    ms = plain_ms = lib_ms = float("nan")
    if time_it:
        ms = time_ms(lambda: mips_topk(q, corpus, k, **kw), *graph)
        plain_ms = eager_ms(lambda: ref.mips_topk_ref(q, corpus, k, **kw),
                            2, 1)
        lib_ms = time_ms(lambda: torch.topk(q @ corpus.float().T, k),
                         *graph)
    print(f"mips_topk {label} Q={qn} N={n} d={d} k={k} "
          f"{str(corpus.dtype).replace('torch.', '')}"
          f"{'' if off is None else f' offset={off} n_total={n_total}'}: "
          f"max_abs_err={err:.3e} (tol {MIPS_TOL:g}), index mismatches "
          f"{mismatches} (all near ties: {ties}), run-to-run equal {same}; "
          f"device ms: kernel {ms:.5f} plain {plain_ms:.5f} topk(q @ c.T) "
          f"{lib_ms:.5f} bound {b[0]:.5f} ({b[1]})", flush=True)
    if not (err <= MIPS_TOL and ties and same):
        fail(f"mips_topk {label} disagrees with its plain version or with "
             f"itself")
    return (err, ms, plain_ms, lib_ms, b), out


def check_mips_laws(device):
    """Kernel vs plain version at every listed shape, then the exact laws
    inside the port: the offset form on 4 shards of a ragged corpus
    merged equals the unsharded search bit for bit, and duplicated rows go
    to the lowest index. Returns the figures of the training eval's
    shape (the search form) and of one shard (the offset form)."""
    gen = torch.Generator(device=device).manual_seed(40)
    figures = {}
    for qn, n, k, dtype, label, graph in (
            (512, 1536, MIPS_K, torch.float32, "training eval", (50, 20)),
            (64, SERVE_N, MIPS_K, torch.float32, "serving", (50, 20)),
            (64, SERVE_N, MIPS_K, torch.bfloat16, "serving", (50, 20)),
            (16, 1 << 20, MIPS_K, torch.float32, "deployed index", (5, 4)),
            (64, 1 << 20, MIPS_K, torch.float32, "deployed index", (5, 4)),
            (64, 1 << 20, MIPS_K, torch.bfloat16, "deployed index", (5, 4)),
            (1024, 65536, 32, torch.float32, "large batch", (5, 4))):
        corpus = unit_rows(n, MAIN_D, gen, dtype)
        q = unit_rows(qn, MAIN_D, gen)
        fig, _ = check_mips(q, corpus, k, label, graph=graph)
        figures.setdefault(label, fig)
        del corpus, q
        torch.cuda.empty_cache()

    # a ragged corpus: the search form at k = 1, then 4 shards of it
    n = 1_000_003
    corpus = unit_rows(n, MAIN_D, gen)
    check_mips(unit_rows(7, MAIN_D, gen), corpus, 1, "ragged", graph=(5, 4))
    q = unit_rows(16, MAIN_D, gen)
    whole = mips_topk(q, corpus, MIPS_K)
    shards = retrieval.sharded.stack_shards(corpus, 4)
    size = shards.shape[1]
    parts = []
    for s in range(4):
        fig, out = check_mips(q, shards[s], MIPS_K, f"shard {s} of 4",
                              off=s * size, n_total=n, time_it=s == 0,
                              graph=(5, 4))
        if s == 0:
            figures["shard"] = fig
        parts.append(out)
    merged = retrieval.sharded.merge_topk(
        torch.stack([v for v, _ in parts]), torch.stack([i for _, i in parts]),
        MIPS_K)
    equal = torch.equal(merged[0], whole[0]) and torch.equal(merged[1],
                                                             whole[1])
    print(f"mips_topk 4 shards of N={n} (shard_size {size}, last zero-padded)"
          f" merged vs unsharded: bit-equal {equal}", flush=True)
    if not equal:
        fail("the sharded search differs from the unsharded one")
    del corpus, shards, parts
    torch.cuda.empty_cache()

    # duplicated rows: rows [8192, 8292) repeat rows [0, 100), and each
    # query is one of them, so its best two are a tie of equal bits
    corpus = unit_rows(SERVE_N, MAIN_D, gen)
    corpus[8192:8292] = corpus[:100]
    q = corpus[:100:7].clone()
    (_, _, _, _, _), (v, i) = check_mips(q, corpus, MIPS_K, "duplicated rows",
                                         time_it=False)
    rows = torch.arange(0, 100, 7, device=device, dtype=torch.int32)
    lowest = (torch.equal(i[:, 0], rows) and torch.equal(i[:, 1], rows + 8192)
              and torch.equal(v[:, 0], v[:, 1]))
    print(f"mips_topk duplicated rows: the tie goes to the lowest index "
          f"{lowest}", flush=True)
    if not lowest:
        fail("a tie between duplicated rows did not go to the lowest index")
    return figures


def check_fold_to_edges(device, k, e):
    """``fold_to_edges`` of a stacked (K, ...) deltas tree of the
    full-width model, end to end (the leaf concatenation, the kernel and
    the split), beside the kernel alone on the concatenated rows."""
    params = dual_encoder.init_dual_encoder(
        0, get_config("resnet14-cifar"),
        get_dual_encoder_config("resnet14-cifar"), device)
    gen = torch.Generator(device=device).manual_seed(7)
    tree = utils.tree_map(
        lambda p: torch.randn((k,) + tuple(p.shape), generator=gen,
                              device=device), params)
    del params
    w = torch.rand(k, generator=gen, device=device)
    ids = (torch.arange(k, device=device) // (k // e)).to(torch.int32)
    rows = torch.cat([x.reshape(k, -1) for x in utils.tree_leaves(tree)], 1)
    folded = fold_to_edges(tree, w, ids, e)
    flat = torch.cat([x.reshape(e, -1) for x in utils.tree_leaves(folded)],
                     1)
    if not torch.equal(flat, segment_sum(rows, ids, e, w)):
        fail("fold_to_edges differs from one kernel call on its rows")
    del folded, flat
    ms = eager_ms(lambda: fold_to_edges(tree, w, ids, e), 10)
    kernel = eager_ms(lambda: segment_sum(rows, ids, e, w), 10)
    print(f"fold_to_edges deltas K={k} D={rows.shape[1]} E={e}: end to end "
          f"{ms:.5f} ms, the kernel alone {kernel:.5f} ms (eager, CUDA "
          f"events); the concatenation moves {2 * rows.numel() * 4 / 1e9:.3f}"
          f" GB", flush=True)
    del tree, rows
    torch.cuda.empty_cache()


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


def flash_bound_ms(q, k, valid):
    """q, k, v read once, the output and the f32 row log-sum-exp written
    once; 4 Dh operations (two products) for each score the mask keeps,
    at the peak of the inputs' type (the bf16 tensor rate, or the f32
    non-tensor rate)."""
    b, h, sq, dh = q.shape
    moved = (2 * q.numel() + 2 * k.numel()) * q.element_size() + 4 * b * h * sq
    ops = 4 * b * h * dh * int(valid.sum())
    peak = PEAK_BF16 if q.dtype == torch.bfloat16 else PEAK_F32
    t_bytes, t_ops = moved / PEAK_BYTES, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_flash(b, h, kvh, sq, skv, dh, dtype, label, *, causal=True,
                window=0, seed=0):
    """Kernel vs plain version at one shape: the output to FLASH_TOL of its
    type and the row log-sum-exp to 2e-5 (1 + |lse|); returns (max_abs_err,
    ms, plain_ms, library_ms, bound). The kernel and the plain version are
    timed in CUDA graphs; the yardstick is one
    ``scaled_dot_product_attention(..., enable_gqa=True)``, causal where
    its top-left causal mask is the kernel's (Sq == Skv, no window), else
    with the kernel's mask passed in."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, h, sq, dh, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, kvh, skv, dh, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, kvh, skv, dh, generator=gen, device=dev).to(dtype)
    kw = {"causal": causal, "window": window, "scale": 1.0 / dh ** 0.5}
    out, lse = FlashAttention.apply(q, k, v, causal, window, kw["scale"])
    again = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    plain, plain_lse = ref.flash_attention_ref(q, k, v, return_lse=True,
                                               **kw)
    if out.shape != q.shape or out.dtype != dtype or not out.is_cuda:
        fail(f"flash_attention {label}: {tuple(out.shape)} {out.dtype} on "
             f"{out.device}")
    err = float((out.float() - plain.float()).abs().max())
    lse_err = float(((lse - plain_lse).abs() / (1 + plain_lse.abs())).max())
    same = torch.equal(out, again)
    del again, plain, plain_lse, lse
    valid = ref.flash_attention_mask(sq, skv, causal, window, dev)
    bnd = flash_bound_ms(q, k, valid)
    ms = time_ms(lambda: flash_attention(q, k, v, causal=causal,
                                         window=window), 20, 10)
    plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), 5, 4)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if causal and window == 0 and sq == skv:
        lib_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True,
                                      enable_gqa=True), 20, 10)
    else:
        lib_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=valid,
                                      enable_gqa=True), 20, 10)
    tol = FLASH_TOL[dtype]
    print(f"flash_attention {label} B={b} H={h} KVH={kvh} Sq={sq} Skv={skv} "
          f"Dh={dh} {str(dtype).replace('torch.', '')} causal={causal} "
          f"window={window}: max_abs_err={err:.3e} (tol {tol:g}), lse "
          f"rel err {lse_err:.3e} (tol 2e-5), run-to-run equal {same}; "
          f"device ms: kernel {ms:.5f} plain {plain_ms:.5f} sdpa "
          f"{lib_ms:.5f} bound {bnd[0]:.5f} ({bnd[1]})", flush=True)
    if not (err <= tol and lse_err <= 2e-5 and same):
        fail(f"flash_attention {label} disagrees with its plain version or "
             f"with itself")
    del q, k, v, out, valid
    torch.cuda.empty_cache()
    return err, ms, plain_ms, lib_ms, bnd


def check_flash_shapes():
    """Every shape of phase 7; returns the path shape's figures."""
    b = TOK_K * TOK_N
    figures = check_flash(b, 32, 4, TOK_S, TOK_S, 64, torch.bfloat16,
                          "TinyLlama path (phase 1 = phase 2 folded)")
    if b != 16:
        check_flash(16, 32, 4, TOK_S, TOK_S, 64, torch.bfloat16,
                    "TinyLlama, 8 clients x 2", seed=1)
    check_flash(b, 16, 8, TOK_S, TOK_S, 128, torch.bfloat16,
                "qwen3-1.7b heads (Dh 128, groups of 2)", seed=2)
    check_flash(b, 8, 2, TOK_S, TOK_S, 32, torch.float32,
                "smoke heads (Dh 32, f32)", seed=3)
    for i, window in enumerate((32, 96)):
        check_flash(b, 32, 4, 256, 256, 64, torch.bfloat16,
                    f"window {window}", window=window, seed=4 + i)
    check_flash(b, 32, 4, TOK_S, TOK_S, 64, torch.bfloat16, "non-causal",
                causal=False, seed=6)
    check_flash(b, 32, 4, 64, 128, 64, torch.bfloat16, "Sq 64 of Skv 128",
                seed=7)
    check_flash(b, 32, 4, 100, 100, 64, torch.bfloat16, "ragged S 100",
                seed=8)
    check_flash(3, 8, 2, 100, 300, 32, torch.float32,
                "ragged Sq 100 of Skv 300, window 70", window=70, seed=9)
    return figures


def check_flash_gradient():
    """The autograd Function's backward (plain torch from the kernel's row
    log-sum-exp) against autograd of the plain version, at the path's
    shape in f32, through a weighted sum of the output; held to 1e-4 of
    each gradient's largest magnitude (the two sum in other orders)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    b, h, kvh, s, dh = TOK_K * TOK_N, 32, 4, TOK_S, 64
    leaves = [torch.randn(shape, generator=gen, device=dev)
              for shape in ((b, h, s, dh), (b, kvh, s, dh), (b, kvh, s, dh))]
    w = torch.randn(b, h, s, dh, generator=gen, device=dev)
    grads = []
    for fn in (flash_attention, ref.flash_attention_ref):
        xs = [x.clone().requires_grad_() for x in leaves]
        (fn(*xs) * w).sum().backward()
        grads.append([x.grad for x in xs])
    errs = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(*grads)]
    print(f"flash_attention gradient B={b} H={h} KVH={kvh} S={s} Dh={dh} "
          f"f32: max |Function - autograd of plain| / max |grad| for q, k, "
          f"v: {', '.join(f'{e:.3e}' for e in errs)} (tol 1e-4)", flush=True)
    if not max(errs) <= 1e-4:
        fail("flash_attention's backward disagrees with autograd of its "
             "plain version")


def _reset_counts():
    for counts in (cco_stats.launches, quant_dequant.launches,
                   segment_sum.launches, mips_topk.launches,
                   flash_attention.launches):
        for key in counts:
            counts[key] = 0


def _read_counts():
    return {"cross": cco_stats.launches["cross"],
            "full": cco_stats.launches["full"],
            "per_row": quant_dequant.launches["per_row"],
            "column": quant_dequant.launches["column"],
            "fold": segment_sum.launches["fold"],
            "search": mips_topk.launches["search"],
            "offset": mips_topk.launches["offset"],
            "flash": flash_attention.launches["forward"]}


def train_path(name, flags, rounds, expected):
    """``train --full`` through its entry point, with every launch count
    set to 0 just before and read just after; fails unless the counts are
    ``expected`` (kernel -> launches, the others 0). Returns the counts
    and the summary ``train.main`` returns."""
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    res = train.main(["--full", "--clients-per-round", str(K),
                      "--samples-per-client", str(N_PER_CLIENT),
                      "--dataset-size", str(DATASET), "--rounds", str(rounds),
                      "--eval-every", "1", *flags])
    counts = _read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
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
          f"; kernel launches {counts}; peak device memory {peak_gib:.2f} GiB",
          flush=True)
    if "--channel" in flags and not res["wire_bytes"] > 0:
        fail(f"{name}: no uplink bytes counted")
    if "--edges" in flags:
        print(f"{name}: uplink per hop: client->edge "
              f"{res['wire_bytes'] - res['edge_bytes']:.6g} bytes, "
              f"edge->server {res['edge_bytes']:.6g} bytes", flush=True)
        if not res["edge_bytes"] > 0:
            fail(f"{name}: no edge->server bytes counted")
    if "--async-k" in flags:
        print(f"{name}: server updates applied {res['updates']} in "
              f"{rounds} ticks", flush=True)
    if "--retrieval-eval" in flags:
        got = res["retrieval"]
        print(f"{name}: per round recall@1 {got.get('recall_at_1')}, "
              f"recall@10 {got.get('recall_at_10')}, mrr {got.get('mrr')}",
              flush=True)
        for key in ("recall_at_1", "recall_at_5", "recall_at_10", "mrr"):
            vals = got.get(key, [])
            if len(vals) != rounds or not all(0.0 <= v <= 1.0 for v in vals):
                fail(f"{name}: {key} per round {vals}, expected {rounds} "
                     f"values in [0, 1]")
    return counts, res


def _window(label, fn, expected):
    """``fn()`` with every launch count set to 0 just before and read just
    after; fails unless the counts are ``expected`` (kernel -> launches,
    the others 0). Returns fn's result and the counts."""
    _reset_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = _read_counts()
    want = {k: expected.get(k, 0) for k in counts}
    if counts != want:
        fail(f"{label}: kernel launches {counts}, expected {want}")
    return out, counts


def serve(server, reqs):
    """One warm-up search, then each request through ``server``."""
    server.warmup()
    return [server.query(r) for r in reqs]


def serving_phase(device, params):
    """The library's serving surface on the encoder the retrieval path
    trained: ``CorpusIndex`` over SERVE_N synthetic 32x32 images (f32 and
    bf16 storage), ``QueryServer`` over SERVE_BATCHES batches of encoded
    query images (equal to ``index.search``), ``ShardedCorpusIndex`` x 4
    (equal bit for bit to the unsharded index), and ``IVFIndex`` with
    IVF_C lists (every list probed equals the exact tier but for near
    ties; recall@10 against the exact tier at IVF_NPROBE). Each surface's
    launch counts are read in a window of its own, with the comparisons
    outside it, and held exact. Returns the windows' counts."""
    cfg = get_config("resnet14-cifar")
    de_cfg = get_dual_encoder_config("resnet14-cifar")

    def embed(p, batch):
        z, _ = dual_encoder.encode(cfg, de_cfg, p, batch)
        return z

    imgs, _ = synthetic.synthetic_labeled_images(
        SERVE_N, 5, image_size=cfg.image_size, noise=0.5, seed=1)
    qimgs, _ = synthetic.synthetic_labeled_images(
        SERVE_BATCH * SERVE_BATCHES, 5, image_size=cfg.image_size,
        noise=0.5, seed=2)
    corpus = {"images": torch.as_tensor(imgs, device=device)}
    queries = retrieval.encode_corpus_chunked(
        embed, params, {"images": torch.as_tensor(qimgs, device=device)})
    del imgs, qimgs
    windows = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        t0 = time.perf_counter()
        index, counts = _window(
            f"CorpusIndex.build ({name})",
            lambda: retrieval.CorpusIndex.build(embed, params, corpus,
                                                chunk=256, dtype=dtype), {})
        build_s = time.perf_counter() - t0
        server = retrieval.QueryServer(index, k=MIPS_K, batch=SERVE_BATCH)
        # odd batches are ragged: the server pads them to its batch
        reqs = [queries[b * SERVE_BATCH:(b + 1) * SERVE_BATCH - 5 * (b % 2)]
                for b in range(SERVE_BATCHES)]
        got, counts = _window(
            f"QueryServer ({name})",
            lambda: serve(server, reqs),
            {"search": 1 + SERVE_BATCHES})
        windows.append(counts)
        want = index.search(queries, MIPS_K)
        same = all(torch.equal(v, want[0][b * SERVE_BATCH:][:v.shape[0]])
                   and torch.equal(i, want[1][b * SERVE_BATCH:][:i.shape[0]])
                   for b, (v, i) in enumerate(got))
        st = server.stats()
        print(f"serving {name} index N={index.num_items} d={index.dim}: "
              f"build {build_s:.3f} s; QueryServer(batch={SERVE_BATCH}, "
              f"k={MIPS_K}) {st['batches']} batches (odd ones ragged, "
              f"{SERVE_BATCH - 5} queries), smoke reading p50 "
              f"{st['p50_us']:.1f} us; launches {counts}; equal to "
              f"index.search {same}", flush=True)
        if not same:
            fail(f"QueryServer differs from index.search ({name})")
        sharded = retrieval.ShardedCorpusIndex.from_index(index, 4)
        a, counts = _window(f"ShardedCorpusIndex x 4 ({name})",
                            lambda: sharded.search(queries, MIPS_K),
                            {"offset": 4})
        windows.append(counts)
        equal = torch.equal(a[0], want[0]) and torch.equal(a[1], want[1])
        print(f"serving {name}: ShardedCorpusIndex x 4 (shard_size "
              f"{sharded.shard_size}) equals the unsharded index bit for bit "
              f"over {queries.shape[0]} queries: {equal}; launches {counts}",
              flush=True)
        if not equal:
            fail(f"ShardedCorpusIndex differs from CorpusIndex ({name})")
        if dtype == torch.float32:
            windows.append(check_ivf(index, queries))
        del index, sharded, server, want, a
    return windows


def serving_rate(device):
    """``QueryServer(batch=SERVE_BATCH, k=MIPS_K)`` over a deployed index
    of RATE_N random unit rows from the seed (f32 and bf16 storage):
    RATE_BATCHES full batches of random unit queries back to back, with
    nothing but the server inside the window, then the served results
    held to one ``index.search`` of every query. Prints p50, p99, qps and
    qps_serial; returns the windows' counts."""
    gen = torch.Generator(device=device).manual_seed(50)
    queries = unit_rows(SERVE_BATCH * RATE_BATCHES, MAIN_D, gen)
    reqs = queries.split(SERVE_BATCH)
    windows = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        index = retrieval.CorpusIndex(unit_rows(RATE_N, MAIN_D, gen, dtype))
        server = retrieval.QueryServer(index, k=MIPS_K, batch=SERVE_BATCH)
        got, counts = _window(
            f"QueryServer over {RATE_N} rows ({name})",
            lambda: serve(server, reqs),
            {"search": 1 + RATE_BATCHES})
        windows.append(counts)
        want = index.search(queries, MIPS_K)
        same = (torch.equal(torch.cat([v for v, _ in got]), want[0])
                and torch.equal(torch.cat([i for _, i in got]), want[1]))
        st = server.stats()
        print(f"serving rate {name} index N={index.num_items} "
              f"d={index.dim}: QueryServer(batch={SERVE_BATCH}, k={MIPS_K}) "
              f"{st['batches']} batches back to back: p50 "
              f"{st['p50_us']:.1f} us, p99 {st['p99_us']:.1f} us, qps "
              f"{st['qps']:.1f}, qps_serial {st['qps_serial']:.1f}; "
              f"launches {counts}; equal to index.search {same}", flush=True)
        if not same:
            fail(f"QueryServer over {RATE_N} rows differs from index.search "
                 f"({name})")
        del index, server, got, want
        torch.cuda.empty_cache()
    return windows


def check_ivf(index, queries):
    """``IVFIndex`` with IVF_C lists over ``index``: k-means through the
    segment-sum kernel (sums and counts in each of 8 iterations, read in
    a window around the build alone), every list probed against the exact
    tier, and recall@10 at IVF_NPROBE. Returns the build's counts."""
    t0 = time.perf_counter()
    ivf, counts = _window(
        "IVFIndex.from_index",
        lambda: retrieval.IVFIndex.from_index(index, num_centroids=IVF_C,
                                              nprobe=IVF_NPROBE),
        {"fold": 2 * 8})
    build_s = time.perf_counter() - t0
    mismatches, ties, hits = 0, True, 0
    batches = queries.split(SERVE_BATCH)
    for qb in batches[:4]:
        exact = ivf.search_exact(qb, MIPS_K)
        full = ivf.search(qb, MIPS_K, nprobe=IVF_C)
        _, bad, near = mips_agree(qb, index.embeddings, full, exact)
        mismatches, ties = mismatches + bad, ties and near
    for qb in batches[:8]:
        exact = ivf.search_exact(qb, MIPS_K)[1]
        approx = ivf.search(qb, MIPS_K)[1]
        hits += int((approx[:, :, None] == exact[:, None, :]).any(-1).sum())
    recall = hits / (8 * SERVE_BATCH * MIPS_K)
    print(f"IVF C={IVF_C} (list length {ivf.list_len}, fill {ivf.fill:.3f}) "
          f"built in {build_s:.3f} s with launches {counts}; "
          f"nprobe=C vs the exact tier on {4 * SERVE_BATCH} queries: index "
          f"mismatches {mismatches} (all near ties: {ties}); recall@10 "
          f"against the exact tier at nprobe={IVF_NPROBE}: {recall:.4f}",
          flush=True)
    if not ties:
        fail("IVF with every list probed differs from the exact tier")
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
    _build.build(list(_build.KERNELS))
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
    # the token path's N = 8, a ragged shape, a large N
    for n, d, valid in ((8, 1024, 8), (37, 1000, 30), (4096, 1024, 4096)):
        for moments in ("cross", "full"):
            check_cco_stats(n, d, valid, 1, moments)
    figures["per_row"] = check_quant(K, 1 << 20, False, 2) + (
        None, quant_bound_ms(K, 1 << 20, False))
    check_quant(K, n_stats, True, 3)
    figures["column"] = check_quant(K, n_params, True, 4, calls=5,
                                    replays=4) + (
        None, quant_bound_ms(K, n_params, True))
    for two_d in (False, True):
        check_quant(5, 4099, two_d, 5)
    torch.cuda.empty_cache()
    # segment_sum at every (K, D, E) of its paths: D = the stats payload,
    # the parameters, both plus three scalars (the buffered dispatch), or
    # one (a mass or count); E = 8 edges or ring slots, 4 clusters
    n_dispatch = n_stats + n_params + 3
    seg_figures = {}
    for i, (d, e, label) in enumerate((
            (n_params, 8, "hierarchy deltas"),
            (n_stats, 8, "hierarchy stats"),
            (n_params, 4, "cluster deltas"),
            (n_stats, 4, "cluster stats + k-means"),
            (n_dispatch, 8, "buffered dispatch"),
            (1, 8, "mass / count"))):
        ids = torch.randint(0, e, (K,), generator=torch.Generator(
            device=device).manual_seed(10 + i), device=device)
        seg_figures[label] = check_segment_sum(K, d, e, ids, 20 + i, label)
    ragged = torch.randint(0, 8, (37,), generator=torch.Generator(
        device=device).manual_seed(30), device=device)
    ragged = torch.where(ragged >= 7, 7, ragged)   # padding id E = 7
    ragged[ragged == 3] = 7                         # segment 3 empty
    check_segment_sum(37, 4099, 7, ragged, 31, "ragged, padding ids, "
                      "empty segments")
    check_segment_sum(K, n_stats, K, torch.arange(K), 32,
                      "one segment per client")
    check_fold_to_edges(device, K, 8)

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
                   PATH_ROUNDS, {"column": 2 * PATH_ROUNDS}),
        # begin_round's per-edge mass, the stats fold, the deltas fold;
        # the int8 client hop quantizes both payloads
        train_path("hierarchical", ["--edges", "8", "--channel", "int8",
                                    "--edge-channel", "dense"],
                   PATH_ROUNDS, {"fold": 3 * PATH_ROUNDS,
                                 "column": 2 * PATH_ROUNDS}),
        # k-means: sums and counts in each of 2 Lloyd iterations; the
        # stats and the deltas: a fold and a mass each
        train_path("clustered", ["--clusters", "4"], PATH_ROUNDS,
                   {"fold": 8 * PATH_ROUNDS}),
        # the dispatch fold and the count fold of each tick
        train_path("buffered", ["--async-k", "32", "--latency-tail", "1.0",
                                "--staleness", "poly"], PATH_ROUNDS,
                   {"fold": 2 * PATH_ROUNDS}),
        # the retrieval eval after every round: one search of 512 queries
        # over a 1536-item corpus
        train_path("retrieval", ["--retrieval-eval", "--retrieval-every",
                                 "1", "--retrieval-corpus", "1536",
                                 "--retrieval-queries", "512"], PATH_ROUNDS,
                   {"cross": PATH_ROUNDS, "search": PATH_ROUNDS})]
    mips_figures = check_mips_laws(device)
    served = serving_phase(device, runs[-1][1]["params"])
    served += serving_rate(device)
    runs = [counts for counts, _ in runs] + served
    # the token path, with the serving phase's corpora released
    gc.collect()
    torch.cuda.empty_cache()
    figures["flash"] = check_flash_shapes()
    check_flash_gradient()
    runs.append(train_path(
        "tinyllama dcco", ["--arch", TOK_ARCH, "--seq-len", str(TOK_S),
                           "--clients-per-round", str(TOK_K),
                           "--samples-per-client", str(TOK_N),
                           "--stats-kernel", "fused"], PATH_ROUNDS,
        {"flash": 2 * 2 * TOK_LAYERS * PATH_ROUNDS,
         "cross": PATH_ROUNDS})[0])
    # launches of each kernel on the main paths, read from their counts
    # (the per-row form runs on none of them, nor in the reference)
    figures["fold"] = seg_figures["hierarchy deltas"]
    figures["search"] = mips_figures["training eval"]
    figures["offset"] = mips_figures["shard"]
    launches = {name: sum(c[name] for c in runs) for name in figures}

    rows = []
    for name, source, replaces in (
            ("cross", "cco_stats.cu", "cco_stats.py:37"),
            ("full", "cco_stats.cu", "cco_stats.py:74"),
            ("per_row", "quantize.cu", "quantize.py:29"),
            ("column", "quantize.cu", "quantize.py:36"),
            ("fold", "segment_sum.cu", "segment_sum.py:35"),
            ("search", "mips_topk.cu", "mips_topk.py:66"),
            ("offset", "mips_topk.cu", "mips_topk.py:97"),
            ("flash", "flash_attention.cu", "flash_attention.py:29")):
        err, ms, plain_ms, lib_ms, (b_ms, b_by) = figures[name]
        kernel = {"cco_stats.cu": "cco_stats_" + name,
                  "quantize.cu": "quant_dequant_" + name,
                  "segment_sum.cu": "segment_sum",
                  "mips_topk.cu": {"search": "mips_topk",
                                   "offset": "mips_topk_offset"}.get(name),
                  "flash_attention.cu": "flash_attention"}[source]
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
