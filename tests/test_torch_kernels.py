"""The port's ``cco_stats`` (both moment sets) and ``quant_dequant``
against the reference's Pallas kernels (run in interpret mode, as
tests/test_kernels.py runs them) and their jnp oracles.

On the CPU the wrapper runs its plain version; the kernel itself is
compared with it on the card by tests/test_torch_cuda.py (marked ``cuda``)
and by chip_smoke.py.

Tolerance: both sides sum the same f32 products in other orders (blocked
over N and d in the Pallas kernel); for N <= 64 rows of unit-scale data
the sums differ by a few f32 ulps of their magnitude, so rtol 1e-5 /
atol 1e-6. ``quant_dequant`` is one IEEE division, add, floor, clip and
multiply an element on both sides, so it is held to bit equality."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.round_engine import make_kernel_agg_stats as j_agg_stats
from repro.kernels import ref as j_ref
from repro.kernels.cco_stats import cco_stats_pallas
from repro.kernels.quantize import quant_dequant_pallas
from repro_torch.core.round_engine import make_kernel_agg_stats
from repro_torch.kernels import _build, cco_stats as cco_stats_mod, ref
from repro_torch.kernels import quantize as quantize_mod
from repro_torch.kernels.cco_stats import cco_stats
from repro_torch.kernels.quantize import quant_dequant

# tier-1 runs 6 pytest workers on the machine's cores: one torch thread
# per worker keeps them from contending with each other and with JAX
torch.set_num_threads(1)

KEYS = ("mean_f", "sq_f", "mean_g", "sq_g", "cross")
FULL_KEYS = KEYS + ("cov_f", "cov_g")
RTOL, ATOL = 1e-5, 1e-6


def _inputs(n, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d).astype(np.float32),
            (rng.randn(n, d) * 0.5 + 0.3).astype(np.float32))


def _close(port, expected, keys=KEYS):
    assert set(port) == set(keys)
    for k in keys:
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


@pytest.mark.parametrize("n,d,valid", [(16, 8, None), (37, 50, 30),
                                       (64, 96, None), (5, 1, None),
                                       (12, 70, 0)])
def test_full_moment_set_matches_pallas_interpret_and_oracle(n, d, valid):
    zf, zg = _inputs(n, d, n * d)
    nv = None
    if valid is not None:
        m = (np.arange(n) < valid).astype(np.float32)[:, None]
        zf, zg = zf * m, zg * m
        nv = np.float32(valid)
    port = cco_stats(torch.from_numpy(zf), torch.from_numpy(zg),
                     None if nv is None else torch.tensor(nv),
                     moments="full")
    _close(port, cco_stats_pallas(
        jnp.asarray(zf), jnp.asarray(zg),
        None if nv is None else jnp.asarray(nv), block_n=16, block_d=32,
        interpret=True, moments="full"), FULL_KEYS)
    if valid != 0:
        rows = n if valid is None else valid
        _close(port, j_ref.cco_stats_ref(jnp.asarray(zf[:rows]),
                                         jnp.asarray(zg[:rows]),
                                         second_moments=True), FULL_KEYS)
    # exactly symmetric within-view moments, and the cross set unchanged
    for k in ("cov_f", "cov_g"):
        assert torch.equal(port[k], port[k].T), k
    cross = cco_stats(torch.from_numpy(zf), torch.from_numpy(zg),
                      None if nv is None else torch.tensor(nv))
    for k in KEYS:
        assert torch.equal(cross[k], port[k]), k


@pytest.mark.parametrize("second_moments", [False, True])
def test_engine_agg_stats_matches_reference_in_both_moment_sets(
        second_moments):
    zf, zg = _inputs(24, 40, 3)
    mask = (np.random.RandomState(4).rand(24) < 0.6).astype(np.float32)
    port = make_kernel_agg_stats(second_moments)(
        torch.from_numpy(zf), torch.from_numpy(zg), torch.from_numpy(mask))
    _close(port, j_agg_stats(interpret=True, second_moments=second_moments)(
        jnp.asarray(zf), jnp.asarray(zg), jnp.asarray(mask)),
        FULL_KEYS if second_moments else KEYS)


def _qdq_inputs(k, n, seed, two_d):
    rng = np.random.RandomState(seed)
    x = (rng.randn(k, n) * rng.choice([1e-3, 1.0, 50.0], (k, 1))).astype(
        np.float32)
    x[0, : min(n, 3)] = 0.0
    u = rng.rand(k, n).astype(np.float32)
    amax = np.abs(x).max(1)
    s = (np.where(amax > 0, amax, 1.0) / 7.0).astype(np.float32)
    if two_d:
        s = (s[:, None] * rng.choice([0.5, 1.0, 2.0], (k, n))).astype(
            np.float32)
    return x, u, s


@pytest.mark.parametrize("two_d", [False, True])
@pytest.mark.parametrize("k,n,qmax", [(5, 4099, 7.0), (8, 256, 127.0),
                                      (3, 1, 1.0), (1, 130, 32767.0)])
def test_quant_dequant_bit_equal_to_pallas_interpret(k, n, qmax, two_d):
    x, u, s = _qdq_inputs(k, n, k + n, two_d)
    port = quant_dequant(torch.from_numpy(x), torch.from_numpy(u),
                         torch.from_numpy(s), qmax)
    pallas = np.asarray(quant_dequant_pallas(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(s), qmax,
        block_n=128, interpret=True))
    assert port.dtype == torch.float32 and port.shape == (k, n)
    np.testing.assert_array_equal(port.numpy(), pallas)
    np.testing.assert_array_equal(
        ref.quant_dequant_ref(torch.from_numpy(x), torch.from_numpy(u),
                              torch.from_numpy(s), qmax).numpy(), pallas)


def test_quant_dequant_rejects_bad_input():
    x, u, s = _qdq_inputs(4, 8, 0, False)
    x, u, s = torch.from_numpy(x), torch.from_numpy(u), torch.from_numpy(s)
    with pytest.raises(ValueError):
        quant_dequant(x, u[:, :4], s, 7.0)
    with pytest.raises(ValueError):
        quant_dequant(x, u, s[:3], 7.0)
    with pytest.raises(TypeError):
        quant_dequant(x.double(), u, s, 7.0)
    with pytest.raises(ValueError):
        quant_dequant(x.T.contiguous().T, u, s, 7.0)
    with pytest.raises(ValueError):
        quant_dequant(x.to("meta"), u.to("meta"), s.to("meta"), 7.0)
    with pytest.raises(ValueError):
        cco_stats(x, x, moments="diagonal")


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


def _no_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build, "NVCC_FALLBACK", str(tmp_path / "nvcc"))


def _no_plain(*a, **k):
    raise AssertionError("plain version called for a CUDA tensor")


@pytest.mark.parametrize("moments", ["cross", "full"])
def test_cuda_tensor_never_reaches_the_plain_version(monkeypatch, tmp_path,
                                                     moments):
    """A tensor the wrapper sees as a CUDA tensor goes to the kernel; when
    the library cannot be built (no nvcc here) the wrapper raises, and
    neither falls back to the plain version nor counts a launch."""
    monkeypatch.setattr(ref, "cco_stats_ref", _no_plain)
    monkeypatch.setattr(cco_stats_mod, "_device_type", lambda t: "cuda")
    _no_nvcc(monkeypatch, tmp_path)
    before = dict(cco_stats.launches)
    zf, zg = _inputs(8, 4, 2)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cco_stats(torch.from_numpy(zf), torch.from_numpy(zg), moments=moments)
    assert cco_stats.launches == before


@pytest.mark.parametrize("two_d", [False, True])
def test_quant_cuda_tensor_never_reaches_the_plain_version(monkeypatch,
                                                           tmp_path, two_d):
    monkeypatch.setattr(ref, "quant_dequant_ref", _no_plain)
    monkeypatch.setattr(quantize_mod, "_device_type", lambda t: "cuda")
    _no_nvcc(monkeypatch, tmp_path)
    before = dict(quant_dequant.launches)
    x, u, s = _qdq_inputs(3, 8, 1, two_d)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        quant_dequant(torch.from_numpy(x), torch.from_numpy(u),
                      torch.from_numpy(s), 7.0)
    assert quant_dequant.launches == before


def test_cpu_path_counts_no_launch():
    before = dict(cco_stats.launches)
    zf, zg = _inputs(8, 4, 5)
    cco_stats(torch.from_numpy(zf), torch.from_numpy(zg))
    cco_stats(torch.from_numpy(zf), torch.from_numpy(zg), moments="full")
    assert cco_stats.launches == before
    before = dict(quant_dequant.launches)
    x, u, s = _qdq_inputs(3, 8, 1, True)
    quant_dequant(torch.from_numpy(x), torch.from_numpy(u),
                  torch.from_numpy(s), 7.0)
    assert quant_dequant.launches == before


@pytest.mark.parametrize("name", ["cco_stats", "quantize"])
def test_library_name_tracks_the_source(name):
    path = _build.library_path(name)
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
    assert (_build.CSRC / f"{name}.cu").exists()
