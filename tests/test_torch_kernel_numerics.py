"""The split-precision arithmetic of the tensor-core kernels, emulated on
the CPU, and the MIPS kernel's launch plan.

The MIPS kernel scores on the tensor cores. With h() TF32 rounding and b()
bf16 rounding, an f32 corpus takes h(q) . h(c) on TF32 MMAs plus
b(q - h(q)) . b(c) + b(q) . b(c - h(c)) on bf16 MMAs; a bf16 corpus takes
h(q) . c + b(q - h(q)) . c. An MMA rounds its sum toward zero, so each
32-column chunk is summed from zero and then added to the score in f32.
The flash kernel's P . V splits P into two bf16 terms against bf16 V.
The statistics kernel takes the MIPS split for zf^T zg, zf^T zf and
zg^T zg, with N as the reduction, in chunks of 32 rows of N.
These tests emulate that arithmetic (TF32 and bf16 rounding, MMA sums in
f64 rounded toward zero, 8 columns a step) on the unit rows (the
unit-normal rows, for the statistics) ``chip_smoke.py`` uses, and fix the
tolerances before the card runs them: MIPS scores within MIPS_TOL = 1e-5
of the f32 plain version, P . V within the f32 tolerance 2e-5 of an f32
P . V, the statistics within STATS_TOL x (1 + max|plain|). Each test also
shows the cheaper form the kernel does not take failing the same bound.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import _aligned
from repro_torch.kernels.mips_topk import (FULL_TILE_K, MAX_SPLITS,
                                           ROWS_PER_TILE, plan)

MIPS_TOL = 1e-5        # chip_smoke.py: |kernel score - plain score|
STATS_TOL = 1e-5       # chip_smoke.py TOL: statistics, x (1 + max|plain|)
STATS_CHUNK = 32       # rows of N the statistics kernel sums from zero
FLASH_F32_TOL = 2e-5   # chip_smoke.py: the flash kernel's f32 outputs
D = 1024               # the projection width of the retrieval paths


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` does."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def toward_zero_f32(x: torch.Tensor) -> torch.Tensor:
    """f64 ``x`` rounded to f32 toward zero, as an MMA's sum is."""
    r = x.to(torch.float32)
    over = r.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def mma_scores(terms, d, chunk):
    """(Q, N) scores from split terms [(q_part, c_part), ...]: each MMA
    adds 8 columns of one term to the running sum, rounding toward zero;
    with ``chunk``, the sum restarts from zero every ``chunk`` columns and
    is added to the score in f32 (round to nearest)."""
    qn, n = terms[0][0].shape[0], terms[0][1].shape[0]
    acc = torch.zeros(qn, n)
    part = torch.zeros(qn, n)
    for k0 in range(0, d, 8):
        for qa, cb in terms:
            prod = qa[:, k0:k0 + 8].double() @ cb[:, k0:k0 + 8].double().T
            part = toward_zero_f32(part.double() + prod)
        if chunk and (k0 + 8) % chunk == 0:
            acc, part = acc + part, torch.zeros_like(part)
    return acc + part


def _unit(rng, n, d=D):
    x = rng.randn(n, d)
    return torch.tensor(x / np.linalg.norm(x, axis=1, keepdims=True),
                        dtype=torch.float32)


@pytest.fixture(scope="module")
def unit_rows():
    """64 unit corpus rows and 16 unit queries, the first 8 of them corpus
    rows (a self-match: every product positive, the worst case for a
    drift that has one sign)."""
    rng = np.random.RandomState(0)
    c = _unit(rng, 64)
    q = torch.cat([c[:8], _unit(rng, 8)])
    return q, c


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -(1.0 + 3 * 2 ** -11), 3.1415927])
    r = tf32(x)
    assert r[:4].tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0]
    assert float(r[4]) == -(1.0 + 2 * 2 ** -10)          # ties away
    assert float((r[5] - x[5]).abs()) <= 2 ** -11 * 4
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def test_split_scores_on_an_f32_corpus_stay_well_inside_mips_tol(
        unit_rows):
    """h(q) h(c) + b(q - h(q)) b(c) + b(q) b(c - h(c)) with chunk-local
    sums is within MIPS_TOL / 10 of the exact score and of the plain
    version's f32 sum, as 3xTF32 is; h(q) h(c) alone is not within
    MIPS_TOL, and without chunk-local sums the toward-zero rounding drifts
    on self-matches to more than 10x the kernel's error."""
    q, c = unit_rows
    exact = q.double() @ c.double().T
    plain = (q[:, None, :] * c[None]).sum(-1)
    qh, ch = tf32(q), tf32(c)
    kernel_terms = [(qh, ch), (bf16(q - qh), bf16(c)), (bf16(q), bf16(c - ch))]
    kernel = mma_scores(kernel_terms, D, 32)
    assert float((kernel.double() - exact).abs().max()) <= MIPS_TOL / 10
    assert float((kernel - plain).abs().max()) <= MIPS_TOL / 10
    three = mma_scores([(tf32(q - qh), ch), (qh, tf32(c - ch)), (qh, ch)],
                       D, 32)
    assert float((three.double() - exact).abs().max()) <= MIPS_TOL / 10
    one = mma_scores([(qh, ch)], D, 32)
    assert float((one.double() - exact).abs().max()) > MIPS_TOL
    drift = mma_scores(kernel_terms, D, 0)
    self_err = (drift.double() - exact).diagonal()[:8].abs().max()
    assert float(self_err) > 10 * float((kernel.double() - exact).abs().max())


def test_split_scores_on_a_bf16_corpus(unit_rows):
    """A bf16 corpus is exact in TF32 and bf16, so h(q) c + b(q - h(q)) c
    is within MIPS_TOL / 10 of the exact score of the bf16 rows (which the
    plain version upcasts); h(q) c alone is not within MIPS_TOL."""
    q, c = unit_rows
    cb = bf16(c)
    assert torch.equal(tf32(cb), cb)
    exact = q.double() @ cb.double().T
    qh = tf32(q)
    kernel = mma_scores([(qh, cb), (bf16(q - qh), cb)], D, 32)
    assert float((kernel.double() - exact).abs().max()) <= MIPS_TOL / 10
    one = mma_scores([(qh, cb)], D, 32)
    assert float((one.double() - exact).abs().max()) > MIPS_TOL


def _split_terms(a, b):
    """The kernel's terms for a^T b, operands given as (d, N): h(a) h(b)
    on TF32, then b(a - h(a)) b(b) + b(a) b(b - h(b)) on bf16."""
    ah, bh = tf32(a), tf32(b)
    return [(ah, bh), (bf16(a - ah), bf16(b)), (bf16(a), bf16(b - bh))]


def _stats_errors(n, d, seed=0):
    """Max |emulated - plain| of cross = zf^T zg / N and cov_f = zf^T zf / N
    on (n, d) unit-normal rows, for the kernel's split with 32-row chunks,
    a single TF32 product with the same chunks, and the kernel's split
    summed without chunks; and the bound STATS_TOL (1 + max|plain|), the
    max over the statistics as ``chip_smoke.py`` takes it (sq_f included).
    """
    rng = np.random.RandomState(seed)
    zf = torch.tensor(rng.randn(n, d), dtype=torch.float32)
    zg = torch.tensor(rng.randn(n, d), dtype=torch.float32)
    plain = {"cross": (zf.T @ zg) / n, "cov_f": (zf.T @ zf) / n}
    sq_f = (zf * zf).sum(0) / n
    scale = max([float(sq_f.max())] + [float(p.abs().max())
                                       for p in plain.values()])
    errs = {}
    for key, (a, b) in (("cross", (zf, zg)), ("cov_f", (zf, zf))):
        at, bt = a.T.contiguous(), b.T.contiguous()
        forms = {"kernel": (_split_terms(at, bt), STATS_CHUNK),
                 "one_tf32": ([(tf32(at), tf32(bt))], STATS_CHUNK),
                 "unchunked": (_split_terms(at, bt), 0)}
        for form, (terms, chunk) in forms.items():
            got = mma_scores(terms, n, chunk) / n
            errs[key, form] = float((got - plain[key]).abs().max())
    return errs, STATS_TOL * (1 + scale)


def test_split_statistics_at_the_main_path_shape():
    """At (N, d) = (128, 1024): the kernel's split, summed from zero each
    32 rows, is within a tenth of the bound for cross and cov_f; a single
    TF32 product (~2^-11 a product: ~3 decimal digits) is not within the
    bound. The tolerance is the kernel-vs-plain one of ``chip_smoke.py``:
    both sum the same f32 products in other orders."""
    errs, bound = _stats_errors(128, 1024)
    for key in ("cross", "cov_f"):
        assert errs[key, "kernel"] <= bound / 10, (key, errs, bound)
        assert errs[key, "one_tf32"] > bound, (key, errs, bound)


def test_split_statistics_at_a_large_n():
    """At N = 4096 (the engine's N is K x n, uncapped), d = 64: the kernel's
    chunked sums stay within a tenth of the bound; summed in one running
    MMA accumulator, the toward-zero rounding of every MMA drifts past the
    bound on cov_f, whose diagonal sums only positive products; a single
    TF32 product misses it there too."""
    errs, bound = _stats_errors(4096, 64)
    for key in ("cross", "cov_f"):
        assert errs[key, "kernel"] <= bound / 10, (key, errs, bound)
    assert errs["cov_f", "unchunked"] > bound, (errs, bound)
    assert errs["cov_f", "one_tf32"] > bound, (errs, bound)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_term_bf16_p_keeps_pv_at_f32_accuracy(seed):
    """P = P_hi + P_lo (both bf16) against bf16 V: the normalised output is
    within the f32 tolerance of an f32 P . V; a single bf16 P is not."""
    rng = np.random.RandomState(seed)
    s = torch.tensor(rng.randn(64, 128) * 3, dtype=torch.float32)
    p = torch.exp(s - s.max(1, keepdim=True).values)
    v = torch.tensor(rng.randn(128, 64), dtype=torch.float32).to(
        torch.bfloat16).double()
    l = p.double().sum(1, keepdim=True)
    exact = (p.double() @ v) / l
    hi = p.to(torch.bfloat16)
    lo = (p - hi.float()).to(torch.bfloat16)
    two = (hi.double() @ v + lo.double() @ v) / l
    one = (hi.double() @ v) / l
    assert float((two - exact).abs().max()) <= FLASH_F32_TOL
    assert float((one - exact).abs().max()) > FLASH_F32_TOL


@pytest.mark.parametrize("qn,n,k", [
    (1, 1, 1), (16, 1 << 20, 10), (64, 1 << 20, 10), (65, 5000, 10),
    (512, 1536, 10), (1024, 65536, 32), (7, 1_000_003, 1), (64, 300, 64),
    (64, 300, 65), (40, 700, 40), (3, 257, 256), (2048, 16384, 10),
    (33, 250_001, 10)])
@pytest.mark.parametrize("sms", [132, 7, 1])
def test_mips_plan_covers_the_corpus_in_whole_tiles(qn, n, k, sms):
    """The splits cover [0, N) exactly in whole 256-row tiles, at most
    1024 of them; a batch of up to 64 queries is one query tile (for k up
    to FULL_TILE_K) on a corpus of at least one row tile an SM; pass 1 is
    one wave unless the query tiles alone outnumber the SMs."""
    bq, splits, rows = plan(qn, n, k, sms)
    assert bq in (16, 32, 64)
    assert rows >= ROWS_PER_TILE and rows % ROWS_PER_TILE == 0
    assert 1 <= splits <= MAX_SPLITS
    assert (splits - 1) * rows < n <= splits * rows
    q_tiles = -(-qn // bq)
    if qn <= 64 and k <= FULL_TILE_K and -(-n // ROWS_PER_TILE) >= sms:
        assert q_tiles == 1
    if k > FULL_TILE_K:
        assert bq <= 32
    assert splits * q_tiles <= max(sms, q_tiles)


def test_flash_wrapper_aligns_only_misaligned_inputs():
    x = torch.arange(64, dtype=torch.float32).to(torch.bfloat16)
    assert _aligned(x) is x
    y = x[1:]
    assert y.data_ptr() % 16 != 0
    z = _aligned(y)
    assert z.data_ptr() % 16 == 0 and torch.equal(z, y)
