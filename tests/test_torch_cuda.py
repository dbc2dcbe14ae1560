"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: skipped unless ``torch.cuda.is_available()``. This file
imports neither JAX nor the reference package, so it runs on a machine
that has only the port's requirements:
  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: the kernel sums f32 products with FFMA in its own order and the
plain version goes through cuBLAS in f32 (TF32 off); for N <= 128 rows of
unit-normal data the sums differ by a few f32 ulps, so rtol/atol 1e-5."""
import pytest
import torch

from repro_torch.core.round_engine import make_kernel_agg_stats
from repro_torch.kernels import ref
from repro_torch.kernels.cco_stats import cco_stats

KEYS = ("mean_f", "sq_f", "mean_g", "sq_g", "cross")


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
    before = cco_stats.launches
    out = cco_stats(zf, zg, nv)
    torch.cuda.synchronize()
    assert cco_stats.launches == before + 1
    plain = ref.cco_stats_ref(zf, zg, nv)
    for k in KEYS:
        assert out[k].is_cuda and out[k].dtype == torch.float32
        torch.testing.assert_close(out[k], plain[k], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_kernel_is_deterministic(cuda_device):
    zf, zg = _pair(cuda_device, 128, 1024, 1)
    a, b = cco_stats(zf, zg), cco_stats(zf, zg)
    for k in KEYS:
        assert torch.equal(a[k], b[k])


@pytest.mark.cuda
def test_engine_aggregate_on_card(cuda_device):
    zf, zg = _pair(cuda_device, 96, 256, 2)
    mask = (torch.arange(96, device=cuda_device) % 5 != 0).float()
    out = make_kernel_agg_stats()(zf, zg, mask)
    m = mask[:, None]
    plain = ref.cco_stats_ref(zf * m, zg * m, mask.sum())
    for k in KEYS:
        torch.testing.assert_close(out[k], plain[k], rtol=1e-5, atol=1e-5)
