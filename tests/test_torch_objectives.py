"""Port vs reference: the full moment set, the D-VICReg and D-WMSE losses
and their gradients, the objective registry and payload spec; Eq.-3
linearity and the Appendix-A gradient equivalence inside the port, for
every registered objective.

Tolerances: statistics are f32 sums of < 64 unit-scale products, so they
agree to rtol 1e-5 / atol 1e-6. The losses sum d^2 squared covariances
(and hinge terms) and their gradients go back through the statistics,
so they are held to rtol 1e-4 / atol 1e-5 (about 100 f32 ulps), as the
CCO loss is in tests/test_torch_cco.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import objectives as j_objectives
from repro.core import cco as j_cco
from repro.core import vicreg as j_vicreg
from repro.core import wmse as j_wmse
from repro_torch import objectives
from repro_torch.core import cco, vicreg, wmse

# the suite runs under several pytest workers: one torch thread per
# worker keeps them from contending with each other and with JAX
torch.set_num_threads(1)

FULL_KEYS = cco.STAT_KEYS + cco.SECOND_MOMENT_KEYS


def _inputs(n, d, seed):
    rng = np.random.RandomState(seed)
    zf = rng.randn(n, d).astype(np.float32)
    zg = (0.6 * zf + 0.8 * rng.randn(n, d)).astype(np.float32)
    return zf, zg


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("masked", [False, True])
def test_full_moment_stats_match_reference(masked):
    zf, zg = _inputs(21, 10, 0)
    mask = (np.arange(21) % 4 != 1).astype(np.float32) if masked else None
    ref = j_cco.moment_stats(jnp.asarray(zf), jnp.asarray(zg),
                             None if mask is None else jnp.asarray(mask),
                             second_moments=True)
    out = cco.moment_stats(_t(zf), _t(zg), None if mask is None else _t(mask),
                           second_moments=True)
    assert set(out) == set(FULL_KEYS)
    for k in FULL_KEYS:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # without the flag the set is the five CCO statistics
    assert set(cco.moment_stats(_t(zf), _t(zg))) == set(cco.STAT_KEYS)


LOSSES = {
    "vicreg": (vicreg.vicreg_loss_from_stats, j_vicreg.vicreg_loss_from_stats,
               {"inv_weight": 25.0, "var_weight": 25.0, "cov_weight": 1.0}),
    "vicreg_weighted": (vicreg.vicreg_loss_from_stats,
                        j_vicreg.vicreg_loss_from_stats,
                        {"inv_weight": 2.0, "var_weight": 5.0,
                         "cov_weight": 3.0, "gamma": 2.0}),
    "wmse": (wmse.wmse_loss_from_stats, j_wmse.wmse_loss_from_stats, {}),
    "wmse_weighted": (wmse.wmse_loss_from_stats, j_wmse.wmse_loss_from_stats,
                      {"inv_weight": 0.5, "whiten_weight": 2.0}),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
@pytest.mark.parametrize("masked", [False, True])
def test_combined_loss_and_grad_match_reference(name, masked):
    """loss(combine(local(zf, zg), agg)) and its gradient w.r.t. the local
    encodings, port autograd vs jax.grad."""
    t_fn, j_fn, kw = LOSSES[name]
    zf, zg = _inputs(8, 12, 1)
    zf = 0.3 * zf                       # std below gamma: the hinge is live
    af, ag = _inputs(40, 12, 2)
    mask = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32) if masked else None
    j_agg = j_cco.moment_stats(jnp.asarray(af), jnp.asarray(ag),
                               second_moments=True)
    t_agg = cco.moment_stats(_t(af), _t(ag), second_moments=True)

    def j_loss(zf_, zg_):
        local = j_cco.moment_stats(
            zf_, zg_, None if mask is None else jnp.asarray(mask),
            second_moments=True)
        return j_fn(j_cco.dcco_combine(local, j_agg), **kw)

    j_val, (j_gf, j_gg) = jax.value_and_grad(j_loss, argnums=(0, 1))(
        jnp.asarray(zf), jnp.asarray(zg))
    tf, tg = _t(zf).requires_grad_(), _t(zg).requires_grad_()
    local = cco.moment_stats(tf, tg, None if mask is None else _t(mask),
                             second_moments=True)
    t_val = t_fn(cco.dcco_combine(local, t_agg), **kw)
    t_val.backward()
    np.testing.assert_allclose(t_val.item(), float(j_val), rtol=1e-4)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(j_gf), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(j_gg), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["dcco", "dvicreg", "dwmse"])
def test_per_client_loss_and_grad_match_reference(name):
    zf, zg = _inputs(24, 8, 3)
    j_obj = j_objectives.get_objective(name)
    t_obj = objectives.get_objective(name)
    j_val, (j_gf, j_gg) = jax.value_and_grad(
        lambda a, b: j_objectives.per_client_loss(j_obj, a, b, 6),
        argnums=(0, 1))(jnp.asarray(zf), jnp.asarray(zg))
    tf, tg = _t(zf).requires_grad_(), _t(zg).requires_grad_()
    t_val = objectives.per_client_loss(t_obj, tf, tg, 6)
    t_val.backward()
    np.testing.assert_allclose(t_val.item(), float(j_val), rtol=1e-4)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(j_gf), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(j_gg), rtol=1e-4,
                               atol=1e-5)


def test_dvicreg_loss_per_client_matches_reference():
    zf, zg = _inputs(16, 6, 4)
    ref = j_vicreg.dvicreg_loss_per_client(jnp.asarray(zf), jnp.asarray(zg),
                                           4)
    out = vicreg.dvicreg_loss_per_client(_t(zf), _t(zg), 4)
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(
        vicreg.vicreg_loss(_t(zf), _t(zg)).item(),
        float(j_vicreg.vicreg_loss(jnp.asarray(zf), jnp.asarray(zg))),
        rtol=1e-5)
    np.testing.assert_allclose(
        wmse.wmse_loss(_t(zf), _t(zg)).item(),
        float(j_wmse.wmse_loss(jnp.asarray(zf), jnp.asarray(zg))),
        rtol=1e-5)


@pytest.mark.parametrize("name", ["dcco", "dvicreg", "dwmse"])
@pytest.mark.parametrize("sizes", [(4, 4, 4), (1, 6, 3)])
def test_eq3_linearity_of_every_objective(name, sizes):
    """The size-weighted average of masked per-client statistics equals
    the statistics of the union, for every statistic of the objective."""
    obj = objectives.get_objective(name)
    zf, zg = _inputs(sum(sizes), 6, 5)
    tf, tg = _t(zf), _t(zg)
    n_max = max(sizes)
    per_client, off = [], 0
    for s in sizes:
        pf, pg = torch.zeros(n_max, 6), torch.zeros(n_max, 6)
        pf[:s], pg[:s] = tf[off:off + s], tg[off:off + s]
        per_client.append(obj.stats_masked(pf, pg,
                                           (torch.arange(n_max) < s).float()))
        off += s
    stacked = {k: torch.stack([st[k] for st in per_client])
               for k in per_client[0]}
    agg = cco.weighted_average_stats(stacked, torch.tensor(sizes))
    union = obj.stats(tf, tg)
    assert set(agg) == set(obj.stat_keys)
    for k in union:
        torch.testing.assert_close(agg[k], union[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["dcco", "dvicreg", "dwmse"])
def test_appendix_a_per_client_gradient_equals_centralized(name):
    """The per-client stop-grad objective has the centralized loss's
    gradient (Appendix A), inside the port. In f64, except for the Eq.-3
    weights, which are f32 by the reference's contract (1/6 is inexact):
    measured 6.5e-6 relative for dcco, whose correlation divides by
    per-dimension std, so rtol 1e-4 / atol 1e-7."""
    obj = objectives.get_objective(name)
    zf, zg = _inputs(24, 8, 6)
    tf, tg = _t(zf).double().requires_grad_(), _t(zg).double()
    objectives.per_client_loss(obj, tf, tg, 6).backward()
    g_fed = tf.grad.clone()
    tf.grad = None
    obj.loss(tf, tg).backward()
    torch.testing.assert_close(g_fed, tf.grad, rtol=1e-4, atol=1e-7)


def test_registry_spec_and_template():
    assert objectives.OBJECTIVES == j_objectives.OBJECTIVES
    for name in objectives.OBJECTIVES:
        t_obj = objectives.get_objective(name)
        j_obj = j_objectives.get_objective(name)
        assert t_obj.second_moments == j_obj.second_moments
        assert t_obj.stat_keys == j_obj.stat_keys
        assert t_obj.stat_spec(7) == j_obj.stat_spec(7)
        tmpl = t_obj.stat_template(5)
        assert {k: tuple(v.shape) for k, v in tmpl.items()} == \
            t_obj.stat_spec(5)
        assert all(v.dtype == torch.float32 and not v.any()
                   for v in tmpl.values())
    obj = objectives.VicRegObjective()
    assert objectives.get_objective(obj) is obj
    with pytest.raises(ValueError):
        objectives.get_objective(obj, inv_weight=2.0)
    with pytest.raises(ValueError):
        objectives.get_objective("byol")
    assert objectives.get_objective("dcco", lam=3.0).lam == 3.0
