"""The split-precision arithmetic of the tensor-core kernels, emulated on
the CPU, the MIPS kernel's launch plan and the flash wrapper's operands.

The MIPS kernel scores on the tensor cores. With h() TF32 rounding and b()
bf16 rounding, an f32 corpus takes h(q) . h(c) on TF32 MMAs plus
b(q - h(q)) . b(c) + b(q) . b(c - h(c)) on bf16 MMAs; a bf16 corpus takes
h(q) . c + b(q - h(q)) . c. An MMA rounds its sum toward zero, so each
32-column chunk is summed from zero and then added to the score in f32.
The flash kernel's P . V splits P into two bf16 terms against bf16 V;
its f32 route scores on b(q - h(q)) . b(k) + b(q) . b(k - h(k)) + h(q) .
h(k) and forms P . V from P's two bf16 terms and V's three, each chain
adding its smaller terms first (wgmma steps of k16 in bf16, k8 in TF32).
The statistics kernel takes the MIPS split for zf^T zg, zf^T zf and
zg^T zg, with N as the reduction, in chunks of 32 rows of N.
These tests emulate that arithmetic (TF32 and bf16 rounding, MMA sums in
f64 rounded toward zero, 8 columns a step) on the unit rows (the
unit-normal rows, for the statistics) ``chip_smoke.py`` uses, and fix the
tolerances before the card runs them: MIPS scores within MIPS_TOL = 1e-5
of the f32 plain version, P . V within the f32 tolerance 2e-5 of an f32
P . V, the statistics within STATS_TOL x (1 + max|plain|). Each test also
shows the cheaper form the kernel does not take failing the same bound.

The attention backward kernel decides which (query rows, kv rows) pairs
each of its two passes visits: a kv pass of 64-row kv tiles over stages
of ``bwd_stage_rows(Dqk, f32)`` query rows (bf16: 64, or 32 at Dqk 80 and
192; f32: 32, or 16 at Dqk 128 and 192), and a query pass of 64-row
query tiles over stages of kv rows (bf16: 64; f32: the kv pass's stage
rows). Its index arithmetic is mirrored here: each pass visits every
valid score once, and ``_tiles`` (which ``backward_flops`` counts) counts
the 64-row pairs. Both routes sum in f32 in the kernel's order (a kv
tile's pairs head by head, each split of a GQA group summed apart and
folded in split order; a query tile's kv stages ascending). The bf16
route takes P, P^T, dS and dS^T rounded to bf16 as MMA operands and is
held here to half of its card tolerance (2^-8 of the largest gradient)
against the f32 plain version on the same bf16 inputs. The f32 route
takes the forward's split for S and dP (b(q - h(q)) . b(k) + b(q) . b(k
- h(k)) + h(q) . h(k)) and two bf16 terms of each operand of dV, dK and
dQ (three chains), and is held to a tenth of its card tolerance (1e-4 of
the largest gradient) against the f64 gradient; one term fewer of the
shared operand, or S and dP without their TF32 term, misses that.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (
    HEAD_DIMS, _aligned, _in_place, _tiles, attention_backward, bwd_splits)
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


# ------------------------------------------------ the flash f32 route --

def _wgmma(terms, acc=None):
    """The sum of A B over ``terms`` [(A (..., M, K), B (..., K, N), k),
    ...], one term after the other, k columns of K a step, each step added
    to the f32 accumulator rounding toward zero; from zero unless
    ``acc``."""
    for a, b, k in terms:
        if acc is None:
            acc = torch.zeros(*a.shape[:-1], b.shape[-1])
        for k0 in range(0, a.shape[-1], k):
            acc = toward_zero_f32(acc.double() + a[..., k0:k0 + k].double()
                                  @ b[..., k0:k0 + k, :].double())
    return acc


def _flash_f32(q, k, v, valid, scale, scores="kernel", values="kernel"):
    """(output, lse) of the f32 route emulated: the scores from the
    ``scores`` split, the softmax in f64 (the kernel's is f32 and online,
    its P terms taken against the running max), P . V from P's two bf16
    terms against the ``values`` split of V."""
    qh, kh = tf32(q), tf32(k)
    if scores == "kernel":
        s = _wgmma([(bf16(q - qh), bf16(k).T, 16),
                    (bf16(q), bf16(k - kh).T, 16), (qh, kh.T, 8)])
    else:                                       # "one_tf32"
        s = _wgmma([(qh, kh.T, 8)])
    s = torch.where(valid, s.double() * scale, torch.tensor(-1e30,
                                                            dtype=torch.float64))
    m = s.max(1, keepdim=True).values
    p = torch.exp(s - m).float()
    p1 = bf16(p)
    p2 = bf16(p - p1)
    v1 = bf16(v)
    v2 = bf16(v - v1)
    v3 = bf16(v - v1 - v2)
    terms = {"kernel": [(p2, v2), (p2, v1), (p1, v3), (p1, v2), (p1, v1)],
             "two_terms": [(p1, v1), (p1, v2), (p2, v1)],
             "bf16_v": [(p2, v1), (p1, v1)]}[values]
    pv = _wgmma([(a, b, 16) for a, b in terms])
    l = p.double().sum(1, keepdim=True)
    return pv.double() / l, (m + torch.log(l)).squeeze(1)


def _flash_f32_errors(dqk, dv, sq, skv, causal, window, seed, **forms):
    """Max |emulated - f64| of the output and max |dlse| / (1 + |lse|)
    against an f64 softmax . V, on unit-normal q, k, v (as the card's
    checks draw them)."""
    rng = np.random.RandomState(seed)
    q, k = (torch.tensor(rng.randn(n, dqk), dtype=torch.float32)
            for n in (sq, skv))
    v = torch.tensor(rng.randn(skv, dv), dtype=torch.float32)
    qpos = torch.arange(sq)[:, None] + skv - sq
    kpos = torch.arange(skv)[None]
    valid = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        valid &= kpos <= qpos
    if window:
        valid &= kpos > qpos - window
    scale = dqk ** -0.5
    s = torch.where(valid, (q.double() @ k.double().T) * scale,
                    torch.tensor(-1e30, dtype=torch.float64))
    exact_lse = torch.logsumexp(s, 1)
    exact = torch.softmax(s, 1) @ v.double()
    out, lse = _flash_f32(q, k, v, valid, scale, **forms)
    return (float((out - exact).abs().max()),
            float(((lse - exact_lse).abs() / (1 + exact_lse.abs())).max()))


FLASH_CASES = [(128, 128, True, 0), (37, 101, False, 20)]


@pytest.mark.parametrize("dqk,dv", HEAD_DIMS)
def test_flash_f32_split_within_a_third_of_its_tolerance(dqk, dv):
    """Every instance, a causal (128, 128) and a ragged windowed (37, 101)
    case, 3 seeds: the f32 route's output within FLASH_F32_TOL / 3 of an
    f64 softmax . V and its row log-sum-exp within 2e-5 (the card's gates
    are FLASH_F32_TOL and 2e-5 against the f32 plain version)."""
    for sq, skv, causal, window in FLASH_CASES:
        for seed in range(3):
            err, lse_err = _flash_f32_errors(dqk, dv, sq, skv, causal,
                                             window, seed)
            assert err <= FLASH_F32_TOL / 3, (sq, skv, seed, err)
            assert lse_err <= 2e-5, (sq, skv, seed, lse_err)


@pytest.mark.parametrize("dqk,dv", [(64, 64), (192, 128)])
def test_flash_f32_cheaper_splits_miss(dqk, dv):
    """What the route does not take: a single TF32 Q K^T misses the output
    tolerance (~2^-11 a product), bf16 V alone misses it by ~50x, and V in
    two bf16 terms (2^-18 |v| left in a row that attends to one key) misses
    the third of it that the kernel's three terms keep."""
    one = _flash_f32_errors(dqk, dv, 128, 128, True, 0, 0, scores="one_tf32")
    assert one[0] > FLASH_F32_TOL
    assert _flash_f32_errors(dqk, dv, 128, 128, True, 0, 0,
                             values="bf16_v")[0] > 10 * FLASH_F32_TOL
    assert max(_flash_f32_errors(dqk, dv, 128, 128, True, 0, seed,
                                 values="two_terms")[0]
               for seed in range(3)) > FLASH_F32_TOL / 3


@pytest.mark.parametrize("dh", [32, 64, 80, 128, 192])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_wrapper_reads_model_views_in_place(dh, dtype):
    """The model's (B, S, H, Dh) activations seen as (B, H, S, Dh) go to
    the kernel as they lie, with their strides; a row stride off 16 bytes,
    a stride of 0 or a head dim that is not unit-stride is copied to a
    contiguous tensor; a dim of length one takes 16 bytes' worth."""
    unit = 16 // torch.empty((), dtype=dtype).element_size()
    x = torch.zeros(2, 5, 4, dh, dtype=dtype).transpose(1, 2)
    y, st = _in_place(x)
    assert y is x and st == (5 * 4 * dh, dh, 4 * dh)
    odd = torch.zeros(2, 4, 5, dh + 1, dtype=dtype)[..., :dh]
    cols = torch.zeros(2, 4, dh, 5, dtype=dtype).transpose(2, 3)
    wide = torch.zeros(1, 4, 5, dh, dtype=dtype).expand(3, 4, 5, dh)
    for t in (odd, cols, wide):
        y, st = _in_place(t)
        assert y.is_contiguous() and torch.equal(y, t)
        assert st == y.stride()[:3]
    one = torch.zeros(1, 4, 7, dh, dtype=dtype)[:, :, 2:3]
    y, st = _in_place(one)
    assert y is one and st == (unit, 7 * dh, unit)
    off = torch.zeros(2 * 5 * 4 * dh + 1, dtype=dtype)[1:].view(
        2, 5, 4, dh).transpose(1, 2)
    y, st = _in_place(off)
    assert off.data_ptr() % 16 and y.data_ptr() % 16 == 0
    assert torch.equal(y, off) and st == y.stride()[:3] == off.stride()[:3]


# ------------------------------------------ the backward kernel's tiles --

BWD_TILE = 64             # csrc/flash_attention_bwd.cu: KR = 64
FLASH_BWD_F32_TOL = 1e-4  # chip_smoke.py: of the largest f32 gradient
FLASH_BWD_BF16_TOL = 2.0 ** -7   # chip_smoke.py: of the largest bf16 one
LOG2E = 1.4426950408889634


def bwd_stage_rows(dqk, f32=False):
    """Query rows a kv-pass stage of the backward kernel (``Wg::BQ``): in
    bf16 32 at Dqk 80 and 192, where 64 would pass the registers a thread
    has, else 64; in f32 16 at Dqk 128 and 192, where the fixed tiles' split
    terms leave room for no more, else 32. The f32 query pass streams kv
    stages of the same rows (``Wg::BK``); the bf16 one, 64."""
    if f32:
        return 16 if dqk >= 128 else 32
    return 32 if dqk in (80, 192) else 64


def _bwd_pairs(sq, skv, causal, window, bq=BWD_TILE, bk=BWD_TILE):
    """The (first query row, first kv row) of each pair of each pass of
    the backward kernel, by its index arithmetic, in the order a block
    visits them: the kv-tile pass (64 kv rows, stages of ``bq`` query
    rows) from the stage of the first causal row to the last row whose
    window reaches the kv tile; the query-tile pass (64 query rows, stages
    of ``bk`` kv rows) from the stage of the first row's window start to
    the last row's causal end."""
    t, q_offset = BWD_TILE, skv - sq
    kv_pass, q_pass = [], []
    for j0 in range(0, skv, t):
        nj = min(t, skv - j0)
        i_lo = (max(0, j0 - q_offset) if causal else 0) // bq * bq
        i_hi = (min(sq, j0 + nj - 1 + window - q_offset) if window > 0
                else sq)
        kv_pass += [(i0, j0) for i0 in range(i_lo, i_hi, bq)]
    for i0 in range(0, sq, t):
        ni = min(t, sq - i0)
        kv_lo = (max(0, q_offset + i0 - window + 1) if window > 0
                 else 0) // bk * bk
        kv_hi = q_offset + i0 + ni if causal else skv
        q_pass += [(i0, j0) for j0 in range(kv_lo, kv_hi, bk)]
    return kv_pass, q_pass


# (bq, bk) of the routes: bf16 (64, 64) and (32, 64); f32 (32, 32) and
# (16, 16)
@pytest.mark.parametrize("bq,bk", [
    pytest.param(BWD_TILE, BWD_TILE, id="64"),
    pytest.param(32, BWD_TILE, id="32"),
    pytest.param(32, 32, id="32-32"),
    pytest.param(16, 16, id="16-16")])
@pytest.mark.parametrize("sq,skv", [(1, 1), (64, 64), (65, 65), (100, 100),
                                    (128, 128), (15, 129), (37, 101),
                                    (65, 200), (200, 200), (100, 300),
                                    (257, 257)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 1),
                                           (True, 40), (True, 256),
                                           (False, 0), (False, 20)])
def test_backward_passes_visit_every_valid_tile_once(sq, skv, causal,
                                                    window, bq, bk):
    """Each pass visits no pair twice and covers every valid score; with
    64-row stages both passes visit the same pairs, which ``_tiles``
    counts; stages of fewer rows split each 64-row pair a pass needs into
    the stages that hold a valid score."""
    kv_pass, q_pass = _bwd_pairs(sq, skv, causal, window, bq, bk)
    assert len(set(kv_pass)) == len(kv_pass)
    assert len(set(q_pass)) == len(q_pass)
    valid = ref.flash_attention_mask(sq, skv, causal, window, "cpu")
    t = BWD_TILE
    for pairs, rows, cols in ((kv_pass, bq, t), (q_pass, t, bk)):
        needed = {(i // rows * rows, j // cols * cols)
                  for i, j in valid.nonzero().tolist()}
        assert needed <= set(pairs)
    if bq == bk == t:
        assert sorted(kv_pass) == sorted(q_pass)
        assert len(kv_pass) == _tiles(sq, skv, causal, window)
    else:
        halves = {(i0 // t * t, j0) for i0, j0 in kv_pass}
        assert halves == {(i0, j0 // t * t) for i0, j0 in q_pass}


def _split(x):
    """The f32 route's terms of an operand: h(x), b(x - h(x)), b(x) and
    b(x - b(x))."""
    h, hi = tf32(x), bf16(x)
    return h, bf16(x - h), hi, bf16(x - hi)


def _bwd_f32_emulated(q, k, v, o, lse, do, causal, window, scale, nsplit,
                      form="kernel", flush=True):
    """(dq, dk, dv) as the f32 route sums them: S = Q K^T and dP = dO V^T
    as b(a - h(a)) b(c) + b(a) b(c - h(c)) (k16 steps) + h(a) h(c) (k8),
    the residual of Q (dO) first, each step rounded toward zero, both
    passes alike; P = exp2(S scale log2 e - lse log2 e) and dS = P (dP -
    delta) scale in f32; then the kernel's tile plan: a kv tile's pairs
    head by head of each split and stage by stage, each split summed apart
    and the partials added in split order; a query tile's kv stages
    ascending; each accumulating product from two bf16 terms of each
    operand, x_lo y1 + x_hi y2 + x_hi y1, k16 steps rounded toward zero,
    each accumulator restarted from zero every 512 rows of its sum and
    added to the row's sum in f32. ``form`` "one_term" takes the shared
    operand of dV, dK and dQ as one term (x_lo y1 + x_hi y1), "no_tf32" S
    and dP without their TF32 term (b(a) b(c) in its place); without
    ``flush`` an accumulator takes its whole sum. One (batch) element in
    f32: q (H, Sq, Dqk), k (KVH, Skv, Dqk), v (KVH, Skv, Dv)."""
    h, sq, dqk = q.shape
    kvh, skv, _ = k.shape
    g, t = h // kvh, BWD_TILE
    bq = bk = bwd_stage_rows(dqk, f32=True)
    valid = ref.flash_attention_mask(sq, skv, causal, window, "cpu")
    delta = (do * o).sum(-1)
    lse2 = lse * torch.tensor(LOG2E, dtype=torch.float32)
    sl2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    kv_pass, q_pass = _bwd_pairs(sq, skv, causal, window, bq, bk)

    def kmajor(a, c):
        (ah, al, a1, _), (ch, cl, c1, _) = _split(a), _split(c)
        last = (a1, c1, 16) if form == "no_tf32" else (ah, ch, 8)
        return _wgmma([(x, y.transpose(-1, -2), n)
                       for x, y, n in ((al, c1, 16), (a1, cl, 16), last)])

    rep = torch.arange(h) // g
    s = kmajor(q, k[rep])
    p = torch.where(valid, torch.exp2(
        (s.double() * float(sl2) - lse2[..., None].double()).float()), 0.0)
    ds = p * (kmajor(do, v[rep]) - delta[..., None]) * scale

    def accumulate(acc, x, y):
        """acc += x y over x's columns, both as the kernel splits them."""
        pad = -x.shape[1] % 16              # rows past Sq or Skv: zeros
        x = torch.nn.functional.pad(x, (0, pad))
        y = torch.nn.functional.pad(y, (0, 0, 0, pad))
        xh = bf16(x)
        xl = bf16(x - xh)
        _, _, y1, y2 = _split(y)
        terms = ([(xl, y1), (xh, y1)] if form == "one_term"
                 else [(xl, y1), (xh, y2), (xh, y1)])
        return _wgmma([(a, b, 16) for a, b in terms], acc)

    def flushed(steps, like):
        """The sum of ``steps`` (functions acc -> acc) as the kernel takes
        it: accumulated from zero, added in f32 to the row's sum every
        512 // bq steps (the kernel's FLUSH) and at the end."""
        out, acc = None, torch.zeros_like(like)
        for n, step in enumerate(steps, 1):
            acc = step(acc)
            if flush and n % (512 // bq) == 0 or n == len(steps):
                out = acc if out is None else out + acc
                acc = torch.zeros_like(like)
        return acc if out is None else out

    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for j0 in range(0, skv, t):
        j = slice(j0, j0 + t)
        stages = [i0 for i0, jj in kv_pass if jj == j0]
        for kh in range(kvh):
            heads = range(kh * g, kh * g + g)
            for sp in range(nsplit):
                pairs = [(hh, slice(i0, i0 + bq)) for hh in
                         heads[sp * g // nsplit:(sp + 1) * g // nsplit]
                         for i0 in stages]
                dv[kh, j] += flushed([
                    lambda acc, hh=hh, i=i: accumulate(acc, p[hh, i, j].T,
                                                       do[hh, i])
                    for hh, i in pairs], dv[kh, j])
                dk[kh, j] += flushed([
                    lambda acc, hh=hh, i=i: accumulate(acc, ds[hh, i, j].T,
                                                       q[hh, i])
                    for hh, i in pairs], dk[kh, j])
    for hh in range(h):
        for i0 in range(0, sq, t):
            i = slice(i0, i0 + t)
            dq[hh, i] = flushed([
                lambda acc, jj=slice(j0, j0 + bk): accumulate(
                    acc, ds[hh, i, jj], k[hh // g, jj])
                for ii, j0 in q_pass if ii == i0], dq[hh, i])
    return dq, dk, dv


def _bwd_f32_error(dqk, dv, sq, skv, causal, window, form="kernel",
                   flush=True):
    """Max |emulated f32 route - f64 gradient| over dq, dk and dv, on
    unit-normal operands of 4 heads in groups of 2 (as the card's checks
    draw them), and the largest f64 gradient; the group split as the
    card's 132 SMs would take it for one batch element."""
    gen = torch.Generator().manual_seed(dqk + sq)
    h, kvh = 4, 2
    q = torch.randn(h, sq, dqk, generator=gen, dtype=torch.float64)
    k = torch.randn(kvh, skv, dqk, generator=gen, dtype=torch.float64)
    v = torch.randn(kvh, skv, dv, generator=gen, dtype=torch.float64)
    scale = dqk ** -0.5
    o, lse = ref.flash_attention_ref(q[None], k[None], v[None],
                                     causal=causal, window=window,
                                     scale=scale, return_lse=True)
    do = torch.randn(o.shape, generator=gen, dtype=torch.float64)
    want = attention_backward(q[None], k[None], v[None], o, lse, do, causal,
                              window, scale)
    got = _bwd_f32_emulated(*(x.float() for x in (q, k, v, o[0], lse[0],
                                                   do[0])),
                            causal, window, scale,
                            bwd_splits(1, kvh, skv, h // kvh, 132), form,
                            flush)
    top = max(float(w.abs().max()) for w in want)
    err = max(float((a.double() - w[0]).abs().max())
              for a, w in zip(got, want))
    return err, top


@pytest.mark.parametrize("dqk,dv", HEAD_DIMS)
@pytest.mark.parametrize("sq,skv,causal,window", [(100, 100, True, 0),
                                                  (65, 200, False, 0),
                                                  (129, 129, True, 40)])
def test_backward_f32_tiles_within_a_tenth_of_the_tolerance(
        dqk, dv, sq, skv, causal, window):
    """The f32 route's arithmetic, emulated, against the f64 gradient:
    within a tenth of FLASH_BWD_F32_TOL of the largest gradient, so the
    card's tolerance leaves room for the MMA's own summation."""
    err, top = _bwd_f32_error(dqk, dv, sq, skv, causal, window)
    assert err <= FLASH_BWD_F32_TOL / 10 * top, (err, top)


def test_backward_f32_flushed_sums_within_a_tenth_of_the_tolerance():
    """A causal (800, 800) at Dqk 32: the first kv tile's pairs and the
    last query tile's kv stages pass 512 rows, so both passes flush their
    accumulators into the rows' sums mid-way, and stay within a tenth of
    FLASH_BWD_F32_TOL; each accumulator taking its whole sum instead, its
    truncating MMA steps drift past it."""
    err, top = _bwd_f32_error(32, 32, 800, 800, True, 0)
    assert err <= FLASH_BWD_F32_TOL / 10 * top, (err, top)
    err, top = _bwd_f32_error(32, 32, 800, 800, True, 0, flush=False)
    assert err > FLASH_BWD_F32_TOL / 10 * top, (err, top)


@pytest.mark.parametrize("dqk,dv", [(64, 64), (192, 128)])
@pytest.mark.parametrize("form", ["one_term", "no_tf32"])
def test_backward_f32_cheaper_splits_miss(dqk, dv, form):
    """What the f32 route does not take: the shared operand of dV, dK and
    dQ as one bf16 term (~2^-9 of a product), or S and dP without their
    TF32 term, misses the tenth of FLASH_BWD_F32_TOL that the route
    keeps."""
    err, top = _bwd_f32_error(dqk, dv, 65, 200, False, 0, form)
    assert err > FLASH_BWD_F32_TOL / 10 * top, (err, top)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _bwd_bf16_emulated(q, k, v, o, lse, do, causal, window, scale, nsplit):
    """(dq, dk, dv) as the bf16 route (``flash_bwd_wg``) sums them, in f32
    before the outputs' own bf16 rounding: S and dP from the bf16 operands
    with f32 sums, P and dS in f32 (exp2 of the scores against lse times
    log2 e), rounded to bf16 as the A operands of dV += P^T dO, dK += dS^T
    Q and dQ += dS K. A kv tile's pairs run head by head and query stage
    by stage; with ``nsplit`` > 1 each split's heads are summed apart and
    the partials added in split order (``flash_bwd_fold``). One (batch)
    element of bf16 values held in f32: q (H, Sq, Dqk), k (KVH, Skv,
    Dqk)."""
    h, sq, dqk = q.shape
    kvh, skv, _ = k.shape
    g, t, bq = h // kvh, BWD_TILE, bwd_stage_rows(dqk)
    valid = ref.flash_attention_mask(sq, skv, causal, window, "cpu")
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    lse2, sl2 = lse * log2e, torch.tensor(scale, dtype=torch.float32) * log2e
    delta = (do * o).sum(-1)
    kv_pass, q_pass = _bwd_pairs(sq, skv, causal, window, bq)

    def probs(hh, i, j):
        kh = hh // g
        p = torch.where(valid[i, j], torch.exp2(
            q[hh, i] @ k[kh, j].T * sl2 - lse2[hh, i, None]), 0.0)
        ds = p * (do[hh, i] @ v[kh, j].T - delta[hh, i, None]) * scale
        return _bf16(p), _bf16(ds)

    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for j0 in range(0, skv, t):
        j = slice(j0, j0 + t)
        stages = [i0 for i0, jj in kv_pass if jj == j0]
        for kh in range(kvh):
            heads = range(kh * g, kh * g + g)
            for sp in range(nsplit):
                pk, pv = torch.zeros_like(dk[kh, j]), torch.zeros_like(dv[kh, j])
                for hh in heads[sp * g // nsplit:(sp + 1) * g // nsplit]:
                    for i0 in stages:
                        i = slice(i0, i0 + bq)
                        p, ds = probs(hh, i, j)
                        pv += p.T @ do[hh, i]
                        pk += ds.T @ q[hh, i]
                dk[kh, j] += pk
                dv[kh, j] += pv
    for hh in range(h):
        for i0, j0 in q_pass:
            i, j = slice(i0, i0 + t), slice(j0, j0 + t)
            dq[hh, i] += probs(hh, i, j)[1] @ k[hh // g, j]
    return dq, dk, dv


# (B, H, KVH, Sq, Skv, Dqk, Dv, causal, window) of chip_smoke.py's bf16
# backward checks, and the heads this test emulates of them (fewer batches
# or heads; the group split is the card's, from its B and 132 SMs)
BF16_BWD_CASES = {
    "path": ((8, 32, 4, 128, 128, 64, 64, True, 0), (32, 4)),
    "views, groups of 2": ((8, 16, 8, 257, 257, 128, 128, True, 0), (4, 2)),
    "window 32": ((8, 32, 4, 256, 256, 64, 64, True, 32), (8, 1)),
    "window 96": ((8, 32, 4, 256, 256, 64, 64, True, 96), (8, 1)),
    "MLA prefill": ((4, 16, 16, 128, 128, 192, 128, True, 0), (2, 2)),
    "zamba2 dims": ((2, 8, 2, 129, 129, 80, 80, True, 40), (4, 1)),
    "4096 positions": ((1, 32, 4, 4096, 4096, 64, 64, True, 0), (1, 1)),
}


@pytest.mark.parametrize("case", list(BF16_BWD_CASES))
def test_backward_bf16_route_within_half_its_tolerance(case):
    """The bf16 route's arithmetic against the f32 plain version
    (``attention_backward``) on the same bf16 q, k, v, output and
    gradient: within half of FLASH_BWD_BF16_TOL of the largest gradient,
    before the outputs' bf16 rounding that both card routes share (the
    card's tolerance holds one such rounding on each side)."""
    (b, h, kvh, sq, skv, dqk, dv, causal, window), (eh, ekvh) = \
        BF16_BWD_CASES[case]
    nsplit = bwd_splits(b, kvh, skv, h // kvh, 132)
    nsplit = min(nsplit, eh // ekvh)      # the emulated group's share
    gen = torch.Generator().manual_seed(sq + dqk + window)
    q = _bf16(torch.randn(eh, sq, dqk, generator=gen))
    k = _bf16(torch.randn(ekvh, skv, dqk, generator=gen))
    v = _bf16(torch.randn(ekvh, skv, dv, generator=gen))
    scale = dqk ** -0.5
    o, lse = ref.flash_attention_ref(q[None], k[None], v[None],
                                     causal=causal, window=window,
                                     scale=scale, return_lse=True)
    o, lse = _bf16(o[0]), lse[0]
    do = _bf16(torch.randn(o.shape, generator=gen))
    want = attention_backward(q[None], k[None], v[None], o[None], lse[None],
                              do[None], causal, window, scale)
    got = _bwd_bf16_emulated(q, k, v, o, lse, do, causal, window, scale,
                             nsplit)
    top = max(float(w.abs().max()) for w in want)
    errs = [float((a - w[0]).abs().max()) for a, w in zip(got, want)]
    assert max(errs) <= FLASH_BWD_BF16_TOL / 2 * top, (errs, top)
