"""The port's ``cco_stats`` against the reference's Pallas kernel (run in
interpret mode, as tests/test_kernels.py runs it) and its jnp oracle.

On the CPU the wrapper runs its plain version; the kernel itself is
compared with it on the card by tests/test_torch_cuda.py (marked ``cuda``)
and by chip_smoke.py.

Tolerance: both sides sum the same f32 products in other orders (blocked
over N and d in the Pallas kernel); for N <= 64 rows of unit-scale data
the sums differ by a few f32 ulps of their magnitude, so rtol 1e-5 /
atol 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.round_engine import make_kernel_agg_stats as j_agg_stats
from repro.kernels import ref as j_ref
from repro.kernels.cco_stats import cco_stats_pallas
from repro_torch.core.round_engine import make_kernel_agg_stats
from repro_torch.kernels import _build, cco_stats as cco_stats_mod, ref
from repro_torch.kernels.cco_stats import cco_stats

# tier-1 runs 6 pytest workers on the machine's cores: one torch thread
# per worker keeps them from contending with each other and with JAX
torch.set_num_threads(1)

KEYS = ("mean_f", "sq_f", "mean_g", "sq_g", "cross")
RTOL, ATOL = 1e-5, 1e-6


def _inputs(n, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d).astype(np.float32),
            (rng.randn(n, d) * 0.5 + 0.3).astype(np.float32))


def _close(port, expected):
    for k in KEYS:
        got = port[k]
        assert got.dtype == torch.float32, k
        np.testing.assert_allclose(got.numpy(), np.asarray(expected[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("n,d", [(16, 8), (37, 50), (64, 96), (5, 1)])
def test_matches_pallas_interpret_and_oracle(n, d):
    zf, zg = _inputs(n, d, n + d)
    port = cco_stats(torch.from_numpy(zf), torch.from_numpy(zg))
    _close(port, cco_stats_pallas(jnp.asarray(zf), jnp.asarray(zg),
                                  block_n=16, block_d=32, interpret=True))
    _close(port, j_ref.cco_stats_ref(jnp.asarray(zf), jnp.asarray(zg)))


@pytest.mark.parametrize("n,d,valid", [(37, 50, 30), (16, 24, 16),
                                       (12, 8, 0)])
def test_num_valid_on_premasked_rows(n, d, valid):
    zf, zg = _inputs(n, d, 7)
    m = (np.arange(n) < valid).astype(np.float32)[:, None]
    zf_m, zg_m = zf * m, zg * m
    nv = np.float32(valid)
    port = cco_stats(torch.from_numpy(zf_m), torch.from_numpy(zg_m),
                     torch.tensor(nv))
    _close(port, cco_stats_pallas(jnp.asarray(zf_m), jnp.asarray(zg_m),
                                  jnp.asarray(nv), block_n=16, block_d=32,
                                  interpret=True))
    if valid:
        # pre-masked statistics equal the statistics of the valid rows
        _close(port, j_ref.cco_stats_ref(jnp.asarray(zf[:valid]),
                                         jnp.asarray(zg[:valid])))


def test_engine_agg_stats_matches_reference():
    # the phase-1 aggregate as both engines build it: mask, pre-multiply,
    # normalise by the valid count
    zf, zg = _inputs(24, 40, 3)
    mask = (np.random.RandomState(3).rand(24) < 0.7).astype(np.float32)
    port = make_kernel_agg_stats()(torch.from_numpy(zf), torch.from_numpy(zg),
                                   torch.from_numpy(mask))
    _close(port, j_agg_stats(interpret=True)(
        jnp.asarray(zf), jnp.asarray(zg), jnp.asarray(mask)))


def test_casts_like_the_reference_and_rejects_bad_input():
    zf, zg = _inputs(8, 4, 1)
    half = cco_stats(torch.from_numpy(zf).half(), torch.from_numpy(zg).half())
    assert all(v.dtype == torch.float32 for v in half.values())
    with pytest.raises(ValueError):
        cco_stats(torch.zeros(4, 3), torch.zeros(4, 2))
    with pytest.raises(ValueError):
        cco_stats(torch.zeros(6, 4).T, torch.zeros(6, 4).T)
    with pytest.raises(TypeError):
        cco_stats(torch.zeros(4, 3, dtype=torch.int32),
                  torch.zeros(4, 3, dtype=torch.int32))
    with pytest.raises(ValueError):
        cco_stats(torch.zeros(4, 3, device="meta"),
                  torch.zeros(4, 3, device="meta"))


def test_cuda_tensor_never_reaches_the_plain_version(monkeypatch, tmp_path):
    """A tensor the wrapper sees as a CUDA tensor goes to the kernel; when
    the library cannot be built (no nvcc here) the wrapper raises, and
    neither falls back to the plain version nor counts a launch."""
    def no_plain(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(ref, "cco_stats_ref", no_plain)
    monkeypatch.setattr(cco_stats_mod, "_device_type", lambda t: "cuda")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build, "NVCC_FALLBACK", str(tmp_path / "nvcc"))
    before = cco_stats.launches
    zf, zg = _inputs(8, 4, 2)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cco_stats(torch.from_numpy(zf), torch.from_numpy(zg))
    assert cco_stats.launches == before


def test_cpu_path_counts_no_launch():
    before = cco_stats.launches
    zf, zg = _inputs(8, 4, 5)
    cco_stats(torch.from_numpy(zf), torch.from_numpy(zg))
    assert cco_stats.launches == before


def test_library_name_tracks_the_source():
    path = _build.library_path("cco_stats")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libcco_stats-") and path.suffix == ".so"
    assert (_build.CSRC / "cco_stats.cu").exists()
