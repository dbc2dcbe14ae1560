"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: skipped unless ``torch.cuda.is_available()``. This file
imports neither JAX nor the reference package, so it runs on a machine
that has only the port's requirements:
  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: the statistics kernel sums f32 products with FFMA in its own
order and the plain version goes through cuBLAS in f32 (TF32 off); for
N <= 128 rows of unit-normal data the sums differ by a few f32 ulps, so
rtol/atol 1e-5. The quantize kernel is one IEEE division, add, floor,
clip and multiply an element, like its plain version: bit equality."""
import pytest
import torch

from repro_torch.core.round_engine import make_kernel_agg_stats
from repro_torch.kernels import ref
from repro_torch.kernels.cco_stats import cco_stats
from repro_torch.kernels.quantize import quant_dequant

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


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,valid", [(128, 1024, None), (37, 1000, 30),
                                       (1, 65, None), (200, 64, 0)])
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
@pytest.mark.parametrize("n,d,valid", [(128, 1024, None), (37, 1000, 30),
                                       (1, 65, None), (200, 64, 0)])
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
