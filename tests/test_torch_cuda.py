"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: skipped unless ``torch.cuda.is_available()``. This file
imports neither JAX nor the reference package, so it runs on a machine
that has only the port's requirements:
  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: the statistics kernel forms each product on the tensor cores
as a TF32 product plus two bf16 remainder products (~2^-20 of a product)
and sums chunks of 32 rows, and the plain version goes through cuBLAS in
f32 (TF32 off); on unit-normal rows the two differ by well under 1e-6
(tests/test_torch_kernel_numerics.py emulates the kernel's sums), so
rtol/atol 1e-5. The quantize kernel is one IEEE division, add, floor,
clip and multiply an element, like its plain version: bit equality. So is
the segment-sum kernel, which adds ``w_k * x`` over ascending k exactly
as its plain version does. The MIPS top-k kernel sums each score over d
with fused multiply-adds, its plain version in a reduction of its own
order: scores to 1e-5 on unit vectors, indices equal except at near ties
(plain scores of the two picks within 1e-5); inside the kernel, sharded
equals unsharded and one run equals the next, bit for bit. The flash
attention kernel computes in f32 from the same inputs as its plain
version, in other orders: f32 outputs to 2e-5, bf16 outputs (rounded once
on each side) to 3e-2, the row log-sum-exp to 2e-5 (1 + |lse|); its
gradient (plain torch from the kernel's log-sum-exp) to 1e-4 of each
gradient's magnitude against autograd of the plain version."""
import pytest
import torch

from repro_torch.core.round_engine import make_kernel_agg_stats
from repro_torch.kernels import ref
from repro_torch.kernels.cco_stats import cco_stats
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention)
from repro_torch.kernels.mips_topk import mips_topk
from repro_torch.kernels.quantize import quant_dequant
from repro_torch.kernels.segment_sum import segment_sum

KEYS = ("mean_f", "sq_f", "mean_g", "sq_g", "cross")
FULL_KEYS = KEYS + ("cov_f", "cov_g")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pair(dev, n, d, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(n, d, generator=gen, device=dev),
            torch.randn(n, d, generator=gen, device=dev))


# the main path, the token path (N = 8), a large N, a ragged shape with
# pre-masked rows, all rows masked, and the tile edges in N and d
SHAPES = [(128, 1024, None), (8, 1024, None), (4096, 256, None),
          (37, 1000, 30), (1, 65, None), (200, 64, 0), (33, 1, None),
          (1, 63, None), (33, 1023, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,valid", SHAPES)
def test_kernel_matches_plain_version(cuda_device, n, d, valid):
    zf, zg = _pair(cuda_device, n, d, n * d)
    nv = None
    if valid is not None:
        m = (torch.arange(n, device=cuda_device) < valid).float()[:, None]
        zf, zg = zf * m, zg * m
        nv = torch.tensor(float(valid), device=cuda_device)
    before = cco_stats.launches["cross"]
    out = cco_stats(zf, zg, nv)
    torch.cuda.synchronize()
    assert cco_stats.launches["cross"] == before + 1
    plain = ref.cco_stats_ref(zf, zg, nv)
    for k in KEYS:
        assert out[k].is_cuda and out[k].dtype == torch.float32
        torch.testing.assert_close(out[k], plain[k], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,valid", SHAPES)
def test_full_moment_kernel_matches_plain_version(cuda_device, n, d, valid):
    zf, zg = _pair(cuda_device, n, d, n + d)
    nv = None
    if valid is not None:
        m = (torch.arange(n, device=cuda_device) < valid).float()[:, None]
        zf, zg = zf * m, zg * m
        nv = torch.tensor(float(valid), device=cuda_device)
    before = dict(cco_stats.launches)
    out = cco_stats(zf, zg, nv, moments="full")
    torch.cuda.synchronize()
    assert cco_stats.launches == dict(before, full=before["full"] + 1)
    plain = ref.cco_stats_ref(zf, zg, nv, "full")
    assert set(out) == set(FULL_KEYS)
    for k in FULL_KEYS:
        assert out[k].is_cuda and out[k].dtype == torch.float32
        torch.testing.assert_close(out[k], plain[k], rtol=1e-5, atol=1e-5)
    for k in ("cov_f", "cov_g"):
        assert torch.equal(out[k], out[k].T)
    # the full set's cross statistics are the cross kernel's, bit for bit
    cross = cco_stats(zf, zg, nv)
    for k in KEYS:
        assert torch.equal(cross[k], out[k])


@pytest.mark.cuda
def test_within_view_diagonal_tiles_are_exactly_symmetric(cuda_device):
    """Every 64 x 64 diagonal tile of cov_f and cov_g at d = 1024 equals
    its transpose bit for bit, as does every off-diagonal pair of tiles."""
    zf, zg = _pair(cuda_device, 128, 1024, 3)
    out = cco_stats(zf, zg, moments="full")
    for k in ("cov_f", "cov_g"):
        for i in range(0, 1024, 64):
            tile = out[k][i:i + 64, i:i + 64]
            assert torch.equal(tile, tile.T), (k, i)
        assert torch.equal(out[k], out[k].T)


@pytest.mark.cuda
@pytest.mark.parametrize("moments", ["cross", "full"])
def test_kernel_is_deterministic(cuda_device, moments):
    zf, zg = _pair(cuda_device, 128, 1024, 1)
    a = cco_stats(zf, zg, moments=moments)
    b = cco_stats(zf, zg, moments=moments)
    for k in a:
        assert torch.equal(a[k], b[k])


@pytest.mark.cuda
@pytest.mark.parametrize("second_moments", [False, True])
def test_engine_aggregate_on_card(cuda_device, second_moments):
    zf, zg = _pair(cuda_device, 96, 256, 2)
    mask = (torch.arange(96, device=cuda_device) % 5 != 0).float()
    out = make_kernel_agg_stats(second_moments)(zf, zg, mask)
    m = mask[:, None]
    plain = ref.cco_stats_ref(zf * m, zg * m, mask.sum(),
                              "full" if second_moments else "cross")
    for k in plain:
        torch.testing.assert_close(out[k], plain[k], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(64, 1 << 16), (5, 4099), (3, 1), (7, 12)])
@pytest.mark.parametrize("two_d", [False, True])
def test_quant_kernel_bit_equal_to_plain_version(cuda_device, k, n, two_d):
    gen = torch.Generator(device=cuda_device).manual_seed(k * n)
    x = torch.randn(k, n, generator=gen, device=cuda_device) * 3
    x[0, :2] = 0.0
    u = torch.rand(k, n, generator=gen, device=cuda_device)
    s = x.abs().amax(1) / 7.0
    s = torch.where(s > 0, s, 1.0 / 7.0)
    if two_d:
        s = (s[:, None] * (torch.rand(k, n, generator=gen,
                                      device=cuda_device) + 0.5)).contiguous()
    form = "column" if two_d else "per_row"
    before = dict(quant_dequant.launches)
    out = quant_dequant(x, u, s, 7.0)
    torch.cuda.synchronize()
    assert quant_dequant.launches == dict(before, **{form: before[form] + 1})
    assert torch.equal(out, ref.quant_dequant_ref(x, u, s, 7.0))
    # inputs 4 bytes off a 16-byte boundary take the scalar path, exactly
    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=cuda_device)[1:]
        return buf.view(t.shape).copy_(t)

    xs, us = shifted(x), shifted(u)
    ss = shifted(s) if two_d else s
    assert xs.data_ptr() % 16 != 0
    assert torch.equal(quant_dequant(xs, us, ss, 7.0),
                       ref.quant_dequant_ref(xs, us, ss, 7.0))


@pytest.mark.cuda
@pytest.mark.parametrize("k,d,e", [
    (64, 4099, 8),        # odd D: the scalar path
    (600, 1024, 5),       # K past one 256-entry staging chunk
    (37, 4099, 7),        # ragged, with padding ids
    (5, 3, 70000),        # more segments than grid rows
    (64, 1, 8)])          # a mass or count
@pytest.mark.parametrize("weighted", [True, False])
def test_segment_sum_kernel_bit_equal_to_plain_version(cuda_device, k, d, e,
                                                       weighted):
    gen = torch.Generator(device=cuda_device).manual_seed(k + d + e)
    rows = torch.randn(k, d, generator=gen, device=cuda_device)
    ids = torch.randint(-1, e + 1, (k,), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    w = (torch.rand(k, generator=gen, device=cuda_device) if weighted
         else None)
    before = segment_sum.launches["fold"]
    out = segment_sum(rows, ids, e, w)
    torch.cuda.synchronize()
    assert segment_sum.launches["fold"] == before + 1
    assert torch.equal(out, ref.segment_sum_ref(rows, ids, e, w))
    # rows 4 bytes off a 16-byte boundary take the scalar path, exactly
    buf = torch.empty(rows.numel() + 1, device=cuda_device)[1:]
    shifted = buf.view(rows.shape).copy_(rows)
    assert torch.equal(segment_sum(shifted, ids, e, w), out)


@pytest.mark.cuda
def test_segment_sum_kernel_is_deterministic(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    rows = torch.randn(64, 1 << 20, generator=gen, device=cuda_device)
    ids = torch.randint(0, 8, (64,), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    w = torch.rand(64, generator=gen, device=cuda_device)
    first = segment_sum(rows, ids, 8, w)
    for _ in range(3):
        assert torch.equal(segment_sum(rows, ids, 8, w), first)


@pytest.mark.cuda
def test_fold_to_edges_is_one_kernel_launch_on_card(cuda_device):
    from repro_torch.hierarchy import fold_to_edges
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    tree = {"a": torch.randn(12, 3, 5, generator=gen, device=cuda_device),
            "b": torch.randn(12, 7, generator=gen, device=cuda_device)}
    w = torch.rand(12, generator=gen, device=cuda_device)
    ids = torch.arange(12, device=cuda_device) // 3
    before = segment_sum.launches["fold"]
    out = fold_to_edges(tree, w, ids, 4)
    assert segment_sum.launches["fold"] == before + 1
    for key, x in tree.items():
        plain = ref.segment_sum_ref(x.reshape(12, -1), ids, 4, w)
        assert torch.equal(out[key].reshape(4, -1), plain), key


def _unit_rows(dev, n, d, seed, dtype=torch.float32):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, d, generator=gen, device=dev)
    return (x / torch.linalg.vector_norm(x, dim=1, keepdim=True)).to(dtype)


def _assert_mips_close(q, corpus, out, plain, off=0):
    torch.testing.assert_close(out[0], plain[0], rtol=0, atol=1e-5)
    bad = out[1] != plain[1]
    if bool(bad.any()):
        rows = bad.nonzero()[:, 0]
        c = corpus.float()
        s1 = (q[rows] * c[out[1][bad].long() - off]).sum(-1)
        s2 = (q[rows] * c[plain[1][bad].long() - off]).sum(-1)
        assert bool(((s1 - s2).abs() <= 1e-5).all())


@pytest.mark.cuda
@pytest.mark.parametrize("qn,n,d,k,dtype", [
    (8, 256, 32, 5, torch.float32),
    (7, 1003, 36, 1, torch.float32),         # d % 32 != 0
    (5, 777, 33, 3, torch.bfloat16),         # odd d: scalar loads
    (64, 4096, 128, 10, torch.bfloat16),     # 16-byte bf16 loads
    (3, 5000, 64, 256, torch.float32),       # the largest k
    (33, 2000, 1024, 10, torch.float32)])    # two query tiles, ragged
def test_mips_kernel_matches_plain_version(cuda_device, qn, n, d, k, dtype):
    q = _unit_rows(cuda_device, qn, d, qn + n)
    corpus = _unit_rows(cuda_device, n, d, n + d, dtype)
    before = dict(mips_topk.launches)
    out = mips_topk(q, corpus, k)
    torch.cuda.synchronize()
    assert mips_topk.launches == dict(before, search=before["search"] + 1)
    assert out[0].is_cuda and out[1].dtype == torch.int32
    _assert_mips_close(q, corpus, out, ref.mips_topk_ref(q, corpus, k))
    again = mips_topk(q, corpus, k)
    assert torch.equal(out[0], again[0]) and torch.equal(out[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 3, 4])
def test_mips_offset_form_shards_equal_unsharded(cuda_device, shards):
    from repro_torch.retrieval.sharded import sharded_mips_topk, stack_shards
    n = 5003
    corpus = _unit_rows(cuda_device, n, 256, 1)
    corpus[4000:4050] = corpus[10:60]           # duplicates across shards
    q = torch.cat([corpus[10:13], _unit_rows(cuda_device, 6, 256, 2)])
    whole = mips_topk(q, corpus, 10)
    stacked = stack_shards(corpus, shards)
    size = stacked.shape[1]
    for s in range(shards):
        before = mips_topk.launches["offset"]
        out = mips_topk(q, stacked[s], 10, index_offset=s * size,
                        n_total=n)
        assert mips_topk.launches["offset"] == before + 1
        _assert_mips_close(q, stacked[s], out, ref.mips_topk_ref(
            q, stacked[s], 10, index_offset=s * size, n_total=n), s * size)
    got = sharded_mips_topk(q, stacked, 10, n_total=n)
    assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])
    assert whole[1][:3, :2].tolist() == [[10, 4000], [11, 4001], [12, 4002]]
    assert torch.equal(whole[0][:3, 0], whole[0][:3, 1])


@pytest.mark.cuda
def test_mips_kernel_pads_short_lists_with_sentinels(cuda_device):
    q = _unit_rows(cuda_device, 4, 64, 3)
    corpus = _unit_rows(cuda_device, 300, 64, 4)
    # only 3 rows of this shard lie below n_total
    v, i = mips_topk(q, corpus, 5, index_offset=1000, n_total=1003)
    assert (i[:, :3] >= 1000).all() and (i[:, :3] < 1003).all()
    assert (i[:, 3:] == ref.BIG_IDX).all() and (v[:, 3:] == ref.NEG_INF).all()
    pv, pi = ref.mips_topk_ref(q, corpus, 5, index_offset=1000, n_total=1003)
    assert torch.equal(i, pi)


def _qkv(dev, b, h, kvh, sq, skv, dh, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(b, h, sq, dh, generator=gen, device=dev).to(dtype),
            torch.randn(b, kvh, skv, dh, generator=gen, device=dev).to(dtype),
            torch.randn(b, kvh, skv, dh, generator=gen, device=dev).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kvh,sq,skv,dh,dtype,causal,window", [
    (8, 32, 4, 128, 128, 64, torch.bfloat16, True, 0),     # the token path
    (8, 32, 4, 128, 128, 64, torch.float32, True, 0),
    (4, 16, 8, 128, 128, 128, torch.bfloat16, True, 0),    # Dh 128, groups of 2
    (4, 8, 2, 128, 128, 32, torch.float32, True, 0),       # smoke heads
    (2, 8, 8, 256, 256, 64, torch.bfloat16, True, 32),     # windows
    (2, 8, 8, 256, 256, 64, torch.float32, True, 96),
    (2, 8, 2, 128, 128, 64, torch.float32, False, 0),      # non-causal
    (2, 8, 2, 64, 128, 64, torch.bfloat16, True, 0),       # q_offset 64
    (3, 8, 2, 100, 100, 64, torch.float32, True, 0),       # ragged S
    (1, 4, 1, 37, 101, 32, torch.float32, False, 20),      # ragged, window
])
def test_flash_kernel_matches_plain_version(cuda_device, b, h, kvh, sq, skv,
                                            dh, dtype, causal, window):
    q, k, v = _qkv(cuda_device, b, h, kvh, sq, skv, dh, dtype, b * sq + dh)
    before = flash_attention.launches["forward"]
    out, lse = FlashAttention.apply(q, k, v, causal, window, dh ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches["forward"] == before + 1
    assert out.shape == q.shape and out.dtype == dtype and out.is_cuda
    plain, plain_lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                               window=window,
                                               return_lse=True)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(out.float(), plain.float(), rtol=tol,
                               atol=tol)
    assert float(((lse - plain_lse).abs()
                  / (1 + plain_lse.abs())).max()) <= 2e-5
    assert torch.equal(flash_attention(q, k, v, causal=causal,
                                       window=window), out)


@pytest.mark.cuda
def test_flash_kernel_refuses_an_unbuilt_head_dim(cuda_device):
    q, k, v = _qkv(cuda_device, 1, 2, 1, 16, 16, 48, torch.float32, 0)
    with pytest.raises(ValueError, match="head dim 48"):
        flash_attention(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40),
                                           (False, 0)])
def test_flash_gradient_on_card(cuda_device, causal, window):
    """The Function's backward against autograd of the plain version, and
    under ``vmap(grad)`` one launch for all clients."""
    q, k, v = _qkv(cuda_device, 4, 8, 2, 96, 96, 64, torch.float32, 3)
    w = torch.randn(q.shape, device=cuda_device)
    grads = []
    for fn in (flash_attention, ref.flash_attention_ref):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        (fn(*xs, causal=causal, window=window) * w).sum().backward()
        grads.append([x.grad for x in xs])
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())

    def loss(qc, kc, vc):
        return (flash_attention(qc, kc, vc, causal=causal, window=window)
                ** 2).sum()

    before = flash_attention.launches["forward"]
    g = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(
        q.reshape(2, 2, 8, 96, 64), k.reshape(2, 2, 2, 96, 64),
        v.reshape(2, 2, 2, 96, 64))
    assert flash_attention.launches["forward"] == before + 1
    for i in range(2):
        gi = torch.func.grad(loss, argnums=(0, 1, 2))(
            q[2 * i:2 * i + 2], k[2 * i:2 * i + 2], v[2 * i:2 * i + 2])
        for a, b in zip(g, gi):
            assert float((a[i] - b).abs().max()) <= 1e-5 * float(
                b.abs().max())


# ------------------------------------------- tensor-core tile edges --------

@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,dh,h,kvh,causal,window", [
    (1, 1, 64, 8, 8, True, 0),          # S 1, groups of 1
    (15, 15, 32, 8, 4, True, 0),        # groups of 2
    (63, 63, 128, 16, 2, True, 0),      # groups of 8
    (65, 65, 64, 8, 1, True, 0),        # one row past a query tile
    (127, 127, 32, 4, 4, False, 0),     # non-causal
    (129, 129, 128, 8, 4, True, 1),     # window 1: the diagonal alone
    (200, 200, 64, 8, 2, True, 256),    # window >= S
    (15, 129, 64, 8, 2, True, 0),       # Sq < Skv
    (65, 200, 128, 4, 4, False, 0),     # Sq < Skv, non-causal
    (1, 200, 32, 8, 1, True, 0),        # one query over 200 kv rows
    (63, 127, 64, 8, 8, True, 1),       # window 1, Sq < Skv
    (129, 200, 32, 4, 2, False, 70),    # non-causal window, ragged tiles
])
def test_flash_bf16_tile_edges(cuda_device, sq, skv, dh, h, kvh, causal,
                               window):
    """The bf16 tensor-core route at ragged query and kv tiles, every head
    dim, GQA group and mask edge: held to the plain version (out 3e-2, lse
    2e-5 (1 + |lse|)) and bit-equal on a second run."""
    q, k, v = _qkv(cuda_device, 2, h, kvh, sq, skv, dh, torch.bfloat16,
                   sq * 7 + skv + dh)
    before = flash_attention.launches["forward"]
    out, lse = FlashAttention.apply(q, k, v, causal, window, dh ** -0.5)
    again, lse2 = FlashAttention.apply(q, k, v, causal, window, dh ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches["forward"] == before + 2
    plain, plain_lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                               window=window,
                                               return_lse=True)
    torch.testing.assert_close(out.float(), plain.float(), rtol=3e-2,
                               atol=3e-2)
    assert float(((lse - plain_lse).abs()
                  / (1 + plain_lse.abs())).max()) <= 2e-5
    assert torch.equal(out, again) and torch.equal(lse, lse2)


@pytest.mark.cuda
def test_flash_bf16_takes_misaligned_inputs(cuda_device):
    """bf16 inputs whose data start off a 16-byte boundary are copied to
    an aligned buffer by the wrapper (the kernel stages 16-byte copies)."""
    q, k, v = _qkv(cuda_device, 1, 4, 2, 40, 40, 64, torch.bfloat16, 9)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)
        return buf[1:].view(t.shape).copy_(t)

    qs, ks, vs = shifted(q), shifted(k), shifted(v)
    assert qs.data_ptr() % 16 != 0
    assert torch.equal(flash_attention(qs, ks, vs), flash_attention(q, k, v))


def _odd_base(t):
    """``t``'s values in a contiguous tensor whose data start one element
    past an allocation's start (off a 16-byte boundary)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


@pytest.mark.cuda
@pytest.mark.parametrize("qn,n,d,k,dtype,odd_base", [
    (1, 3000, 36, 10, torch.float32, False),      # d % 8 != 0
    (63, 1000, 100, 7, torch.float32, False),     # d % 32 != 0
    (64, 5000, 257, 10, torch.float32, False),    # odd d: plain staging
    (65, 4096, 64, 32, torch.bfloat16, False),    # two query tiles
    (1024, 3000, 128, 10, torch.float32, False),  # 16 query tiles
    (5, 300, 64, 256, torch.float32, False),      # the largest k
    (9, 200, 48, 5, torch.float32, False),        # N below one row tile
    (33, 2500, 64, 10, torch.bfloat16, True),     # bf16 at an odd base
    (40, 700, 72, 80, torch.float32, True),       # k > 64: 32-query tiles
])
def test_mips_tile_edges(cuda_device, qn, n, d, k, dtype, odd_base):
    q = _unit_rows(cuda_device, qn, d, qn + n + d)
    corpus = _unit_rows(cuda_device, n, d, n * d, dtype)
    if odd_base:
        corpus = _odd_base(corpus)
        assert corpus.data_ptr() % 16 != 0
    before = dict(mips_topk.launches)
    out = mips_topk(q, corpus, k)
    again = mips_topk(q, corpus, k)
    torch.cuda.synchronize()
    assert mips_topk.launches == dict(before, search=before["search"] + 2)
    _assert_mips_close(q, corpus, out, ref.mips_topk_ref(q, corpus, k))
    assert torch.equal(out[0], again[0]) and torch.equal(out[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mips_n_total_masks_rows_mid_tile(cuda_device, dtype):
    """The offset form with ``n_total`` ending inside a row tile: rows
    past it never enter, the rest match the plain version."""
    q = _unit_rows(cuda_device, 20, 128, 5)
    corpus = _unit_rows(cuda_device, 1000, 128, 6, dtype)
    corpus[900:] = corpus[:100]              # masked copies of real rows
    kw = {"index_offset": 3000, "n_total": 3000 + 777}
    v, i = mips_topk(q, corpus, 16, **kw)
    assert bool((i < 3777).all()) and bool((i >= 3000).all())
    _assert_mips_close(q, corpus, (v, i),
                       ref.mips_topk_ref(q, corpus, 16, **kw), 3000)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mips_score_is_position_independent(cuda_device, dtype):
    """One row copied to positions in other row tiles, splits and fragment
    slots (position mod 8, 32 and 256 all differ), searched by the same
    query placed in other slots of batches of other sizes (other query
    tiles): every copy scores the same bits, and the copies come out in
    ascending index order."""
    n, d = 70_000, 1024
    corpus = _unit_rows(cuda_device, n, d, 11, dtype)
    target = corpus[123].clone()
    places = [123, 300, 4096 + 13, 9_001, 33_333, 65_536 + 250, 69_999]
    for p in places:
        corpus[p] = target
    others = _unit_rows(cuda_device, 200, d, 12)
    seen = set()
    for qn, slot in ((1, 0), (17, 13), (64, 40), (65, 64), (200, 150)):
        q = others[:qn].clone()
        q[slot] = target.float()
        v, i = mips_topk(q, corpus, len(places) + 1)
        got_v, got_i = v[slot, :len(places)], i[slot, :len(places)]
        assert got_i.tolist() == places
        assert bool((got_v == got_v[0]).all())
        seen.add(float(got_v[0]))
    assert len(seen) == 1
