"""Port vs reference: CCO statistics, loss and the gradient through the
stop-grad combine, with and without masks; Eq.-3 linearity and the
variance floor, inside the port.

Tolerances: statistics are f32 sums of < 64 unit-scale products, so they
agree to rtol 1e-5 / atol 1e-6. The loss divides by per-dimension std
and sums d^2 squared correlations, and its gradient goes back through
both, so they are held to rtol 1e-4 / atol 1e-5 (about 100 f32 ulps)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cco as j_cco
from repro_torch.core import cco

# tier-1 runs 6 pytest workers on the machine's cores: one torch thread
# per worker keeps them from contending with each other and with JAX
torch.set_num_threads(1)

KEYS = cco.STAT_KEYS


def _inputs(n, d, seed):
    rng = np.random.RandomState(seed)
    zf = rng.randn(n, d).astype(np.float32)
    zg = (0.6 * zf + 0.8 * rng.randn(n, d)).astype(np.float32)
    return zf, zg


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("masked", [False, True])
def test_stats_match_reference(masked):
    zf, zg = _inputs(20, 12, 0)
    mask = (np.arange(20) % 3 != 0).astype(np.float32) if masked else None
    ref = j_cco.moment_stats(jnp.asarray(zf), jnp.asarray(zg),
                             None if mask is None else jnp.asarray(mask))
    out = cco.moment_stats(_t(zf), _t(zg), None if mask is None else _t(mask))
    assert set(out) == set(KEYS)
    for k in KEYS:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("lam", [5.0, 20.0])
def test_combined_loss_and_grad_match_reference(masked, lam):
    """loss(combine(local(zf, zg), agg)) and its gradient w.r.t. the local
    encodings: the gradient flows through the local statistics only."""
    zf, zg = _inputs(8, 16, 1)
    af, ag = _inputs(40, 16, 2)                   # the "aggregate" cohort
    mask = np.array([1, 1, 1, 0, 1, 1, 0, 1], np.float32) if masked else None
    j_agg = j_cco.moment_stats(jnp.asarray(af), jnp.asarray(ag))
    t_agg = cco.moment_stats(_t(af), _t(ag))

    def j_loss(zf_, zg_):
        local = j_cco.moment_stats(zf_, zg_, None if mask is None
                                   else jnp.asarray(mask))
        return j_cco.cco_loss_from_stats(j_cco.dcco_combine(local, j_agg), lam)

    def t_loss(zf_, zg_):
        local = cco.moment_stats(zf_, zg_, None if mask is None else _t(mask))
        return cco.cco_loss_from_stats(cco.dcco_combine(local, t_agg), lam)

    j_val, (j_gf, j_gg) = jax.value_and_grad(j_loss, argnums=(0, 1))(
        jnp.asarray(zf), jnp.asarray(zg))
    tf, tg = _t(zf).requires_grad_(), _t(zg).requires_grad_()
    t_val = t_loss(tf, tg)
    t_val.backward()
    np.testing.assert_allclose(t_val.item(), float(j_val), rtol=1e-4)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(j_gf), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(j_gg), rtol=1e-4,
                               atol=1e-5)
    # the combine's value is the aggregate's
    combined = cco.dcco_combine(cco.moment_stats(tf, tg), t_agg)
    for k in KEYS:
        torch.testing.assert_close(combined[k].detach(), t_agg[k])


def test_correlation_and_loss_match_reference():
    zf, zg = _inputs(32, 10, 3)
    ref = j_cco.cco_loss(jnp.asarray(zf), jnp.asarray(zg), 20.0)
    out = cco.cco_loss(_t(zf), _t(zg), 20.0)
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-4)
    st = j_cco.moment_stats(jnp.asarray(zf), jnp.asarray(zg))
    np.testing.assert_allclose(
        cco.correlation_matrix(cco.moment_stats(_t(zf), _t(zg))).numpy(),
        np.asarray(j_cco.correlation_matrix(st)), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("sizes", [(4, 4, 4), (1, 6, 3)])
def test_eq3_weighted_average_equals_union_stats(sizes):
    """Statistics are linear in samples: the size-weighted average of the
    per-client statistics equals the statistics of the union."""
    zf, zg = _inputs(sum(sizes), 6, 4)
    tf, tg = _t(zf), _t(zg)
    n_max = max(sizes)
    per_client, off = [], 0
    for s in sizes:
        pf = torch.zeros(n_max, 6)
        pg = torch.zeros(n_max, 6)
        pf[:s], pg[:s] = tf[off:off + s], tg[off:off + s]
        m = (torch.arange(n_max) < s).float()
        per_client.append(cco.encoding_stats_masked(pf, pg, m))
        off += s
    stacked = {k: torch.stack([st[k] for st in per_client]) for k in KEYS}
    agg = cco.weighted_average_stats(stacked, torch.tensor(sizes))
    union = cco.encoding_stats(tf, tg)
    for k in KEYS:
        torch.testing.assert_close(agg[k], union[k], rtol=1e-5, atol=1e-6)
    # and it equals the reference's aggregation of the same stats
    j_agg = j_cco.weighted_average_stats(
        {k: jnp.asarray(v.numpy()) for k, v in stacked.items()},
        jnp.asarray(sizes))
    for k in KEYS:
        np.testing.assert_allclose(agg[k].numpy(), np.asarray(j_agg[k]),
                                   rtol=1e-6, atol=1e-7)


def test_variance_floor_invisible_for_healthy_variance():
    zf, zg = _inputs(32, 8, 5)
    st = cco.moment_stats(_t(zf), _t(zg))
    c = cco.correlation_matrix(st)
    var_f = st["sq_f"] - st["mean_f"] ** 2
    var_g = st["sq_g"] - st["mean_g"] ** 2
    unfloored = (st["cross"] - torch.outer(st["mean_f"], st["mean_g"])) / (
        torch.sqrt(var_f + 1e-8)[:, None] * torch.sqrt(var_g + 1e-8)[None, :])
    torch.testing.assert_close(c, unfloored, rtol=0, atol=0)


def test_variance_floor_bounds_degenerate_combine():
    # a cancelling combine: variance ~0 or negative, covariance not
    st = {"mean_f": torch.ones(4), "sq_f": torch.ones(4) - 1e-9,
          "mean_g": torch.zeros(4), "sq_g": torch.ones(4),
          "cross": torch.full((4, 4), 0.5)}
    c = cco.correlation_matrix(st)
    assert torch.isfinite(c).all()
    assert float(c.abs().max()) <= 1.0 / np.sqrt(2e-6) + 1.0
