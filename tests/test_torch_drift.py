"""Client-drift correction (FedProx, SCAFFOLD and its variate uplink), port
vs reference, on the CPU: the drift helpers, the reference's own laws
restated on the port, one ``stats_round`` and one ``fedavg_round`` with
each correction on the toy encoder and the smoke ResNet, SCAFFOLD on the
smoke ResNet followed round by round until it diverges, the first client
lr at which two local steps stay finite at two widths, the same over an
int8 uplink and an 8-edge tree, three engine rounds, three buffered
ticks, and a FedProx round of the smoke tinyllama tower.

Both packages get the same numpy inputs; parameters cross by
``repro_torch.convert`` (the toy encoder of tests/_torch_toy.py needs
none), and so do the SCAFFOLD variates, slot by slot. The SCAFFOLD rounds
start from non-zero variates drawn with numpy, so that the corrections
act. The channels take the reference's own uniforms for all three phases
(the ``"variate"`` phase's from ``fold_in(key, 0x5CAF0)``), never a
reseed.

Tolerances:
- the helpers against ``repro.server.drift``: rtol 1e-6, atol 1e-7 (the
  same f32 formula);
- one round: the parameters, ``c`` and ``c_slots`` each within 1e-3 of
  their own update in the round (``max|port - ref| / max|ref - start|``),
  or within 4x the port's own f32 rounding where that is larger (the
  distance of its f32 round from the same round in f64), as
  tests/test_torch_fed_baselines.py holds its rounds; the loss to rtol
  1e-4;
- the int8 and tree rounds of the toy: 1e-4 of each update (the wire is
  bit-equal given the same inputs and uniforms, tests/test_torch_comm.py),
  the wire bytes exactly;
- three engine rounds and three buffered ticks: within 4x the port's own
  f32-vs-f64 distance plus 1e-6 of the update, and 1e-4 where the
  reference's ticks are held so (tests/test_torch_async.py).

Resuming from ``drift_state=`` in memory is tested here; the port's
versions of the reference's checkpoint-resume tests with drift
(tests/test_server_update.py, ``test_checkpoint_resume_with_drift_and_
lossy_channel`` and ``test_async_checkpoint_roundtrips_buffer_and_drift``)
resume from a file, in tests/test_torch_checkpoint.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lr_width as lrw
import _torch_toy as toy
from repro import hierarchy as j_hier
from repro.comm import channel as j_channel
from repro.configs.base import DualEncoderConfig as JDE
from repro.configs.base import get_config as j_get_config
from repro.core import buffer as j_buffer
from repro.core import fed_sim as j_fed_sim
from repro.core import round_engine as j_engine
from repro.data import partition as j_partition
from repro.data import pipeline as j_pipeline
from repro.data import synthetic as j_synthetic
from repro.models import dual_encoder as j_de
from repro.optim import optimizers as j_opt
from repro.server import drift as j_drift
from repro_torch import convert, server, utils
from repro_torch.comm import channel
from repro_torch.configs.base import DualEncoderConfig, get_config
from repro_torch.core import buffer, fed_sim, round_engine
from repro_torch.hierarchy import HierarchicalChannel
from repro_torch.launch.train import make_apply
from repro_torch.objectives import get_objective
from repro_torch.optim import optimizers as opt_lib
from repro_torch.server import drift

# tier-1 runs 6 pytest workers on the machine's cores: one torch thread
# per worker keeps them from contending with each other and with JAX
torch.set_num_threads(1)

LR = 0.005                       # server SGD learning rate (ResNet)
PROJ = (64, 64)
MU = 0.01                        # FedProx's coefficient on the chip paths


def _t(x):
    return torch.tensor(np.asarray(x))


def _bound(err_self):
    """1e-3 of the update, or 4x the port's own f32 rounding if larger."""
    return max(1e-3, 4 * err_self)


def _rel(port, ref, start):
    """max |port - ref| / max |ref - start| over port-layout trees."""
    return (utils.tree_max_abs_diff(port, ref)
            / utils.tree_max_abs_diff(ref, start))


# ------------------------------------------------------------ helpers --

def _variates_np(tree, k, seed, scale):
    """A non-zero ScaffoldState as numpy trees in ``tree``'s layout."""
    rng = np.random.RandomState(seed)
    c = jax.tree.map(lambda x: (rng.randn(*np.shape(x)) * scale)
                     .astype(np.float32), tree)
    c_slots = jax.tree.map(lambda x: (rng.randn(k, *np.shape(x)) * scale)
                           .astype(np.float32), tree)
    return c, c_slots


def _carry_slots(tree_k):
    """A K-stacked reference tree -> the port's layout, slot by slot."""
    tree_k = jax.tree.map(np.asarray, tree_k)
    k = jax.tree.leaves(tree_k)[0].shape[0]
    per = [convert.params_from_jax(jax.tree.map(lambda x: x[i], tree_k))
           for i in range(k)]
    return utils.tree_map(lambda *xs: torch.stack(xs), *per)


def _carry_state(state):
    """A reference ScaffoldState -> the port's."""
    return drift.ScaffoldState(
        convert.params_from_jax(jax.tree.map(np.asarray, state.c)),
        _carry_slots(state.c_slots))


def test_helpers_match_reference():
    p = toy.params_np()
    c, cs = _variates_np(p, 4, 0, 0.1)
    deltas = _variates_np(p, 4, 1, 0.01)[1]
    mask = np.array([1, 0, 1, 1], np.float32)
    js = j_drift.ScaffoldState(toy.to_jax(c), toy.to_jax(cs))
    ts = drift.ScaffoldState(toy.to_torch(c), toy.to_torch(cs))
    init = drift.scaffold_init(toy.to_torch(p), 4)
    assert all(x.dtype == torch.float32 and not x.any()
               for x in utils.tree_leaves(list(init)))
    assert init.c_slots["w1"].shape == (4, *p["w1"].shape)

    def close(port, ref):
        for key in ref:
            np.testing.assert_allclose(port[key].numpy(),
                                       np.asarray(ref[key]), rtol=1e-6,
                                       atol=1e-7)

    close(drift.scaffold_corrections(ts), j_drift.scaffold_corrections(js))
    new_t = drift.scaffold_new_slot_variates(ts, toy.to_torch(deltas), 0.05,
                                             2)
    new_j = j_drift.scaffold_new_slot_variates(js, toy.to_jax(deltas), 0.05,
                                               2)
    close(new_t, new_j)
    agg = {k: v[0] for k, v in deltas.items()}
    out_t = drift.scaffold_apply_round(ts, new_t, toy.to_torch(agg),
                                       torch.tensor(mask))
    out_j = j_drift.scaffold_apply_round(js, new_j, toy.to_jax(agg),
                                         jnp.asarray(mask))
    close(out_t.c, out_j.c)
    close(out_t.c_slots, out_j.c_slots)
    assert torch.equal(out_t.c_slots["w1"][1], ts.c_slots["w1"][1])
    assert server.ScaffoldState is drift.ScaffoldState


def test_variate_phase_salt_matches_reference():
    assert channel.PHASE_SALT == j_channel.PHASE_SALT
    assert channel.PHASE_SALT["variate"] == 0x5CAF0
    ch = channel.DPGaussianChannel(noise_phases=("stats", "update",
                                                 "variate"))
    assert ch.noise_phases[-1] == "variate"


# ---------------------------------------------- the reference's laws --

def _toy_round_data():
    pool = toy.pool_np()
    return ({v: torch.tensor(x[:8]) for v, x in pool.items()},
            torch.full((8,), toy.N_PER, dtype=torch.int32))


def test_fedprox_mu0_is_the_plain_step_bit_for_bit():
    params = toy.to_torch(toy.params_np())
    data, sizes = _toy_round_data()

    def loss_fn(p):
        zf, zg = toy.t_apply(p, {k: v[0] for k, v in data.items()})
        return (zf * zg).sum() * 1e-2

    d0, l0 = fed_sim.client_local_steps(loss_fn, params, 0.1, 3)
    d1, l1 = fed_sim.client_local_steps(loss_fn, params, 0.1, 3, prox_mu=0.0)
    assert utils.tree_max_abs_diff(d0, d1) == 0.0 and float(l0) == float(l1)
    opt = opt_lib.adam(1e-2)
    kw = dict(lam=toy.LAM, local_steps=2, client_lr=0.1)
    p0, _, _ = fed_sim.dcco_round(toy.t_apply, params, opt.init(params), opt,
                                  data, sizes, **kw)
    p1, _, _ = fed_sim.dcco_round(toy.t_apply, params, opt.init(params), opt,
                                  data, sizes, prox_mu=0.0, **kw)
    assert utils.tree_max_abs_diff(p0, p1) == 0.0


def test_fedprox_matches_the_analytic_proximal_gradient_and_reference():
    """f(w) = 0.5||w - t||^2 pulled toward w0 = 0:
    w <- w - lr * ((w - t) + mu * w)."""
    t = np.array([1.0, -2.0, 3.0], np.float32)
    lr, mu, steps = 0.1, 0.7, 4
    delta, _ = fed_sim.client_local_steps(
        lambda p: 0.5 * ((p["w"] - _t(t)) ** 2).sum(),
        {"w": torch.zeros(3)}, lr, steps, prox_mu=mu)
    w = np.zeros(3)
    for _ in range(steps):
        w = w - lr * ((w - t) + mu * w)
    np.testing.assert_allclose(delta["w"].numpy(), w, rtol=1e-6)
    ref, _ = j_fed_sim.client_local_steps(
        lambda p: 0.5 * jnp.sum((p["w"] - jnp.asarray(t)) ** 2),
        {"w": jnp.zeros(3)}, lr, steps, prox_mu=mu)
    np.testing.assert_allclose(delta["w"].numpy(), np.asarray(ref["w"]),
                               rtol=1e-6)


def test_prox_shrinks_client_drift():
    """On the reference's own toy of this law (its JAX-drawn parameters
    and client, carried across): five local steps at lr 0.1."""
    key = jax.random.PRNGKey(0)
    params = {"w1": _t(jax.random.normal(key, (10, 16)) * 0.3),
              "w2": _t(jax.random.normal(jax.random.PRNGKey(7), (16, 6))
                       * 0.3)}
    k1, k2 = jax.random.split(key)
    client = {"v1": _t(jax.random.normal(k1, (8, 3, 10))[0]),
              "v2": _t(jax.random.normal(k2, (8, 3, 10))[0])}
    objective = get_objective("dcco", lam=toy.LAM)

    def norm(mu):
        def loss_fn(p):
            zf, zg = toy.t_apply(p, client)
            return objective.loss_from_stats(objective.stats_masked(
                zf, zg, torch.ones(zf.shape[0])))
        d, _ = fed_sim.client_local_steps(loss_fn, params, 0.1, 5,
                                          prox_mu=mu)
        return float(torch.sqrt(sum((x ** 2).sum()
                                    for x in utils.tree_leaves(d))))

    assert norm(5.0) < norm(0.0)


def test_variates_sum_to_zero_after_four_rounds():
    """With constant round weights, sum_k w_k c_k == c: the aggregated
    corrections cancel."""
    params = toy.to_torch(toy.params_np())
    data, sizes = _toy_round_data()
    opt = opt_lib.adam(1e-2)
    p, st, d = params, opt.init(params), drift.scaffold_init(params, 8)
    for _ in range(4):
        p, st, d, _ = fed_sim.dcco_round(
            toy.t_apply, p, st, opt, data, sizes, lam=toy.LAM,
            client_lr=0.05, local_steps=2, scaffold_state=d)
    w = sizes.float() / sizes.float().sum()
    resid = [torch.tensordot(w, ck, dims=1) - c for ck, c in
             zip(utils.tree_leaves(d.c_slots), utils.tree_leaves(d.c))]
    norm = lambda xs: float(torch.sqrt(sum((x ** 2).sum()  # noqa: E731
                                           for x in xs)))
    assert norm(resid) < 1e-4 * max(1.0, norm(utils.tree_leaves(d.c)))


def test_scaffold_fixes_fedavgs_bias_on_heterogeneous_quadratics():
    """K clients minimizing 0.5||A_k w - b_k||^2 with many local steps:
    FedAvg's fixed point is biased, SCAFFOLD's is the optimum."""
    k, dim = 8, 6
    rng = np.random.RandomState(0)
    a = np.stack([np.diag(rng.uniform(0.2, 3.0, dim)) for _ in range(k)])
    b = np.stack([rng.randn(dim) for _ in range(k)])
    w_star = np.linalg.solve(sum(x.T @ x for x in a) / k,
                             sum(x.T @ y for x, y in zip(a, b)) / k)
    a_t, b_t = _t(a.astype(np.float32)), _t(b.astype(np.float32))
    params = {"w": torch.zeros(dim)}
    su = server.as_server_update(opt_lib.sgd(1.0))
    steps, clr = 10, 0.05
    w_agg = torch.full((k,), 1.0 / k)

    def run(scaffold):
        p, st = params, su.init(params)
        state = drift.scaffold_init(params, k) if scaffold else None
        for _ in range(150):
            def client_update(ak, bk, corr=None):
                def loss_fn(pp):
                    e = ak @ pp["w"] - bk
                    return 0.5 * (e * e).sum()
                return fed_sim.client_local_steps(loss_fn, p, clr, steps,
                                                  correction=corr)
            deltas, _ = fed_sim._vmap_clients(client_update, a_t, b_t,
                                              state)
            avg = utils.tree_map(lambda x: torch.tensordot(w_agg, x, dims=1),
                                 deltas)
            p, st = su.step(p, st, avg)
            if scaffold:
                state, _, _ = fed_sim._scaffold_round_tail(
                    state, deltas, clr, steps, w_agg, None, None)
        return p["w"].numpy()

    assert np.linalg.norm(run(False) - w_star) > 1e-2
    assert np.linalg.norm(run(True) - w_star) < 1e-5


def test_dense_channel_is_bit_identical_and_counts_the_variate_bytes():
    params = toy.to_torch(toy.params_np())
    data, sizes = _toy_round_data()
    opt = opt_lib.adam(1e-2)
    kw = dict(lam=toy.LAM, client_lr=0.05, local_steps=2)
    d0 = drift.scaffold_init(params, 8)
    p1, _, d1, m1 = fed_sim.dcco_round(toy.t_apply, params, opt.init(params),
                                       opt, data, sizes, scaffold_state=d0,
                                       **kw)
    p2, _, d2, m2 = fed_sim.dcco_round(
        toy.t_apply, params, opt.init(params), opt, data, sizes,
        scaffold_state=d0, channel=channel.DenseChannel(), channel_key=42,
        **kw)
    assert utils.tree_max_abs_diff(p1, p2) == 0.0
    assert utils.tree_max_abs_diff(d1.c, d2.c) == 0.0
    assert utils.tree_max_abs_diff(d1.c_slots, d2.c_slots) == 0.0
    _, _, m3 = fed_sim.dcco_round(toy.t_apply, params, opt.init(params), opt,
                                  data, sizes, channel=channel.DenseChannel(),
                                  channel_key=42, **kw)
    n = sum(x.numel() for x in utils.tree_leaves(params))
    assert m2.wire_bytes.item() == m3.wire_bytes.item() + 8 * 4 * n
    assert m1.wire_bytes.item() == 0.0


def test_dropped_slots_keep_their_variates():
    params = toy.to_torch(toy.params_np())
    data, sizes = _toy_round_data()
    opt = opt_lib.adam(1e-2)
    kw = dict(lam=toy.LAM, client_lr=0.05, local_steps=2)
    p, st, d1, _ = fed_sim.dcco_round(
        toy.t_apply, params, opt.init(params), opt, data, sizes,
        scaffold_state=drift.scaffold_init(params, 8), **kw)
    ch = channel.DropoutChannel(0.5)
    mask = ch.begin_round(123, sizes).mask.numpy()
    assert 0 < mask.sum() < 8, "pick a seed that drops some clients"
    _, _, d2, _ = fed_sim.dcco_round(toy.t_apply, p, st, opt, data, sizes,
                                     scaffold_state=d1, channel=ch,
                                     channel_key=123, **kw)
    for new, old in zip(utils.tree_leaves(d2.c_slots),
                        utils.tree_leaves(d1.c_slots)):
        moved = (new - old).abs().reshape(8, -1).amax(1).numpy()
        assert np.all(moved[mask == 0.0] == 0.0)
        assert np.all(moved[mask == 1.0] > 0.0)


def test_dp_channel_must_noise_variates():
    params = toy.to_torch(toy.params_np())
    data, sizes = _toy_round_data()
    opt = opt_lib.sgd(0.1)
    state = drift.scaffold_init(params, 8)
    for round_fn in (fed_sim.dcco_round, fed_sim.fedavg_round):
        with pytest.raises(ValueError, match="variate"):
            round_fn(toy.t_apply, params, opt.init(params), opt, data, sizes,
                     scaffold_state=state,
                     channel=channel.DPGaussianChannel(0.3, clip_norm=10.0),
                     channel_key=0)
    with pytest.raises(ValueError, match="variate"):
        round_engine.make_round_body(
            toy.t_apply, opt, round_engine.EngineConfig(
                scaffold=True, channel=channel.DPGaussianChannel(0.3)))
    out = fed_sim.dcco_round(
        toy.t_apply, params, opt.init(params), opt, data, sizes,
        lam=toy.LAM, scaffold_state=state,
        channel=channel.DPGaussianChannel(
            0.3, clip_norm=10.0, noise_phases=("stats", "update", "variate")),
        channel_key=0)
    assert len(out) == 4 and torch.isfinite(out[3].loss)


def test_centralized_and_clustered_bodies_refuse_drift():
    opt = opt_lib.sgd(0.1)
    for kw in ({"scaffold": True}, {"prox_mu": 0.1}):
        with pytest.raises(ValueError, match="drift correction"):
            round_engine.make_round_body(
                toy.t_apply, opt,
                round_engine.EngineConfig(algorithm="centralized", **kw))
    from repro_torch.cluster import make_cluster_round_body
    with pytest.raises(ValueError, match="SCAFFOLD"):
        make_cluster_round_body(toy.t_apply, opt, round_engine.EngineConfig(
            num_clusters=2, scaffold=True))
    make_cluster_round_body(toy.t_apply, opt, round_engine.EngineConfig(
        num_clusters=2, prox_mu=0.1))
    with pytest.raises(ValueError, match="drift="):
        round_engine.make_round_body(
            toy.t_apply, opt, round_engine.EngineConfig(scaffold=True))(
                toy.to_torch(toy.params_np()), None, *_toy_round_data())


def _replay_sampler(data, sizes):
    return lambda gen: (data, sizes)


def test_engine_with_scaffold_equals_the_round_loop_and_resumes():
    """The engine's drift carry: N rounds == N ``dcco_round`` calls, the
    3-tuple bodies stay 3-tuples, and ``run(drift_state=)`` continues the
    same trajectory."""
    params = toy.to_torch(toy.params_np())
    data, sizes = _toy_round_data()
    opt = opt_lib.sgd(0.1)
    cfg = round_engine.EngineConfig(lam=toy.LAM, chunk_rounds=2,
                                    client_lr=0.05, local_steps=2,
                                    scaffold=True, stats_kernel="off")
    eng = round_engine.RoundEngine(toy.t_apply, opt,
                                   _replay_sampler(data, sizes), cfg)
    seen = []
    pe, _, me = eng.run(params, opt.init(params), 3, 4,
                        on_segment=lambda r, c, m: seen.append(c.drift))
    assert isinstance(eng.drift_state, drift.ScaffoldState)
    assert seen[-1] is eng.drift_state
    p, st, d = params, opt.init(params), drift.scaffold_init(params, 8)
    for _ in range(4):
        p, st, d, m = fed_sim.dcco_round(toy.t_apply, p, st, opt, data, sizes,
                                         lam=toy.LAM, client_lr=0.05,
                                         local_steps=2, scaffold_state=d)
    assert utils.tree_max_abs_diff(pe, p) == 0.0
    assert utils.tree_max_abs_diff(eng.drift_state.c_slots, d.c_slots) == 0.0
    assert me.loss[-1].item() == m.loss.item()
    # resume: 2 + 2 rounds == 4 rounds
    p2, s2, _ = eng.run(params, opt.init(params), 3, 2)
    p2, _, _ = eng.run(p2, s2, 3, 2, start_round=2,
                       drift_state=eng.drift_state)
    assert utils.tree_max_abs_diff(p2, pe) == 0.0
    plain = round_engine.make_round_body(
        toy.t_apply, opt, round_engine.EngineConfig(lam=toy.LAM))
    assert len(plain(params, opt.init(params), data, sizes)) == 3


def test_fedavg_body_supports_scaffold():
    params = toy.to_torch(toy.params_np())
    data, sizes = _toy_round_data()
    su = server.get_server_update("fedadam", server_lr=0.05)
    cfg = round_engine.EngineConfig(algorithm="fedavg_cco", lam=toy.LAM,
                                    chunk_rounds=3, client_lr=0.05,
                                    local_steps=2, scaffold=True,
                                    server_update=su)
    eng = round_engine.RoundEngine(toy.t_apply, su,
                                   _replay_sampler(data, sizes), cfg)
    _, _, m = eng.run(params, su.init(params), 3, 3)
    assert torch.isfinite(m.loss).all()
    assert isinstance(eng.drift_state, drift.ScaffoldState)
    assert eng.drift_state.c["w1"].abs().max() > 0


# ------------------------------------------------ one round vs reference --

def _toy_cohort():
    pool = toy.pool_np()
    return ({v: x[:6] for v, x in pool.items()},
            np.array([3, 2, 3, 1, 3, 2], np.int32))


def _round_kw(kind, drift_kind, lr):
    kw = dict(client_lr=lr, local_steps=2, lam=toy.LAM)
    if kind == "fedavg":
        kw["loss_kind"] = "contrastive"
    if drift_kind == "fedprox":
        kw["prox_mu"] = MU
    return kw


def _port_round(apply, p0, batch, sizes, dtype, state, lr, **kw):
    """One port round from port-layout trees cast to ``dtype``; returns
    (params in f32, ScaffoldState or None, metrics)."""
    p0, batch = (utils.tree_map(lambda x: x.to(dtype), t) for t in (p0, batch))
    opt = opt_lib.sgd(lr)
    fn = fed_sim.fedavg_round if "loss_kind" in kw else fed_sim.dcco_round
    out = fn(apply, p0, opt.init(p0), opt, batch, sizes,
             scaffold_state=state, **kw)
    return (utils.tree_map(lambda x: x.float(), out[0]),
            out[2] if state is not None else None, out[-1])


def _ref_round(apply, p0, batch, sizes, state, lr, **kw):
    fn = j_fed_sim.fedavg_round if "loss_kind" in kw else j_fed_sim.dcco_round
    opt = j_opt.sgd(lr)
    return jax.jit(lambda p, o, b, s, d: fn(
        apply, p, o, opt, b, s, scaffold_state=d, **kw))(
            p0, opt.init(p0), batch, sizes, state)


def _check_round(out_t, out_64, out_j, start, carry):
    """Params, c and c_slots each against the reference, relative to
    their own update; returns the worst (error, bound) pairs."""
    pt, st, mt = out_t
    p64, s64, _ = out_64
    pj, sj, mj = out_j[0], (out_j[2] if len(out_j) == 4 else None), out_j[-1]
    p_start, s_start = start
    trees = [(pt, p64, carry["params"](pj), p_start)]
    if st is not None:
        sj = _carry_state(sj)
        trees += [(st.c, s64.c, sj.c, s_start.c),
                  (st.c_slots, s64.c_slots, sj.c_slots, s_start.c_slots)]
    for port, port64, ref, init in trees:
        err, err_self = _rel(port, ref, init), _rel(port, port64, init)
        assert err < _bound(err_self), (err, err_self)
    np.testing.assert_allclose(mt.loss.item(), float(mj.loss), rtol=1e-4)
    assert mt.wire_bytes.item() == float(mj.wire_bytes) == 0.0


@pytest.mark.parametrize("kind", ["stats", "fedavg"])
@pytest.mark.parametrize("drift_kind", ["fedprox", "scaffold"])
def test_one_toy_round_with_drift_matches_reference(kind, drift_kind):
    batch, sizes = _toy_cohort()
    p0 = toy.params_np()
    kw = _round_kw(kind, drift_kind, 0.05)
    state_j = state_t = None
    if drift_kind == "scaffold":
        c, cs = _variates_np(p0, 6, 5, 0.05)
        state_j = j_drift.ScaffoldState(toy.to_jax(c), toy.to_jax(cs))
        state_t = drift.ScaffoldState(toy.to_torch(c), toy.to_torch(cs))
    out_j = _ref_round(toy.j_apply, toy.to_jax(p0), toy.to_jax(batch),
                       jnp.asarray(sizes), state_j, 0.05, **kw)
    args = (toy.t_apply, toy.to_torch(p0), toy.to_torch(batch),
            torch.tensor(sizes))
    out_t = _port_round(*args, torch.float32, state_t, 0.05, **kw)
    out_64 = _port_round(*args, torch.float64, state_t, 0.05, **kw)
    _check_round(out_t, out_64, out_j, (toy.to_torch(p0), state_t),
                 {"params": toy.to_torch})


def _j_apply(cfg, de, leaf="images"):
    def apply(p, batch):
        zf, _ = j_de.encode(cfg, de, p, {leaf: batch["v1"]})
        zg, _ = j_de.encode(cfg, de, p, {leaf: batch["v2"]})
        return zf, zg
    return apply


def _from_ref(p):
    return convert.params_from_jax(jax.tree.map(np.asarray, p))


@pytest.fixture(scope="module")
def resnet():
    """The smoke ResNet with ``resnet_groups=2`` (tests/test_torch_round.py
    says why) and a reference-drawn cohort of variable-size clients."""
    jcfg = j_get_config("resnet14-cifar", smoke=True).replace(
        resnet_groups=2)
    tcfg = get_config("resnet14-cifar", smoke=True).replace(resnet_groups=2)
    jp = jax.jit(j_de.init_dual_encoder, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jcfg, JDE(proj_dims=PROJ))
    imgs, labels = j_synthetic.synthetic_labeled_images(
        96, 4, image_size=16, noise=0.5, seed=1)
    ds = j_pipeline.FederatedDataset.build(
        {"images": imgs}, labels, num_clients=32, samples_per_client=3,
        partition=j_partition.PartitionSpec("dirichlet_quantity",
                                            severity=0.7), seed=0)
    return {"jp": jp, "cohort": ds.round_batch(jax.random.PRNGKey(42), 6),
            "j_apply": _j_apply(jcfg, JDE(proj_dims=PROJ)),
            "t_apply": make_apply(tcfg, DualEncoderConfig(proj_dims=PROJ)),
            "t_apply64": make_apply(tcfg.replace(dtype="float64"),
                                    DualEncoderConfig(proj_dims=PROJ))}


@pytest.mark.parametrize("kind", ["stats", "fedavg"])
def test_one_resnet_round_with_drift_matches_reference(resnet, kind):
    """FedProx and SCAFFOLD together in one round of each kind (the toy
    rounds above take them one at a time)."""
    s = resnet
    batch, sizes = s["cohort"]
    kw = _round_kw(kind, "fedprox", 1.0)
    c, cs = _variates_np(jax.tree.map(np.asarray, s["jp"]), 6, 5, 1e-3)
    state_j = j_drift.ScaffoldState(jax.tree.map(jnp.asarray, c),
                                    jax.tree.map(jnp.asarray, cs))
    state_t = _carry_state(state_j)
    out_j = _ref_round(s["j_apply"], s["jp"], batch, sizes, state_j, LR,
                       **kw)
    p0, tb = _from_ref(s["jp"]), utils.tree_map(_t, batch)
    out_t = _port_round(s["t_apply"], p0, tb, _t(sizes), torch.float32,
                        state_t, LR, **kw)
    out_64 = _port_round(s["t_apply64"], p0, tb, _t(sizes), torch.float64,
                         state_t, LR, **kw)
    _check_round(out_t, out_64, out_j, (p0, state_t), {"params": _from_ref})


@pytest.mark.parametrize("lr,rounds", [(2.0 ** -11, 3), (2.0 ** -14, 5)])
def test_resnet_scaffold_diverges_where_the_reference_does(resnet, lr,
                                                           rounds):
    """D-CCO SCAFFOLD with two local steps, the CLI's server Adam(2e-3)
    and lam 5, from zero variates on the same cohort each round: plain-GD
    local steps on phase-2 gradients this large leave the parameters or
    variates non-finite after a few rounds, the later the lower the client
    lr. From the same start the port's state stops being finite after the
    same round as the reference's, and the losses agree until then: the
    first round's to rtol 1e-4, the later ones to 1e-2 (each round
    amplifies the previous one's rounding; about 5e-4 after round 4)."""
    s = resnet
    batch, sizes = s["cohort"]
    k = sizes.shape[0]
    opt_j, opt_t = j_opt.adam(2e-3), opt_lib.adam(2e-3)
    kw = dict(lam=5.0, client_lr=lr, local_steps=2)
    fn_j = jax.jit(lambda p, o, b, z, d: j_fed_sim.dcco_round(
        s["j_apply"], p, o, opt_j, b, z, scaffold_state=d, **kw))
    pj, oj, dj = s["jp"], opt_j.init(s["jp"]), j_drift.scaffold_init(
        s["jp"], k)
    pt = _from_ref(s["jp"])
    ot, dt = opt_t.init(pt), drift.scaffold_init(pt, k)
    tb, ts = utils.tree_map(_t, batch), _t(sizes)
    ref, port = [], []
    for _ in range(rounds):
        pj, oj, dj, mj = fn_j(pj, oj, batch, sizes, dj)
        pt, ot, dt, mt = fed_sim.dcco_round(s["t_apply"], pt, ot, opt_t, tb,
                                            ts, scaffold_state=dt, **kw)
        ref.append((float(mj.loss), all(bool(jnp.isfinite(x).all())
                                        for x in jax.tree.leaves((pj, dj)))))
        port.append((mt.loss.item(), all(
            bool(torch.isfinite(x).all())
            for x in utils.tree_leaves((pt, dt.c, dt.c_slots)))))
    assert [f for _, f in port] == [f for _, f in ref]
    assert not ref[-1][1] and ref[-2][1]       # diverged in the last round
    np.testing.assert_allclose(port[0][0], ref[0][0], rtol=1e-4)
    np.testing.assert_allclose([x for x, _ in port], [x for x, _ in ref],
                               rtol=1e-2)


# (width, first finite rate's exponent): SCAFFOLD's first rates in
# tests/_torch_lr_width.py's sweep, the same in both packages (PERF.md)
SCAFFOLD_FIRST_FINITE = [("smoke", -12), ("x4", -13)]


@pytest.mark.parametrize("width,first", SCAFFOLD_FIRST_FINITE)
def test_first_finite_client_lr_matches_the_reference_across_width(
        width, first):
    """Two plain-GD local steps of D-CCO with SCAFFOLD, three rounds from
    one converted start on one reference-drawn cohort
    (tests/_torch_lr_width.py), at the smoke ResNet's width and at 4x it,
    where the first finite rate moves: halving from 2^(first + 1), both
    packages stay finite for the same number of rounds at each rate, and
    first stay finite at 2^first. (FedProx stays finite at the start,
    1.0, at both widths, in both packages.)"""
    s = lrw.setup(width)
    got = {name: lrw.first_finite(make(s, "scaffold"), 2.0 ** (first + 1))
           for name, make in (("reference", lrw.reference_runner),
                              ("port", lrw.port_runner))}
    assert got["port"] == got["reference"]
    assert got["port"][0] == 2.0 ** first


# ------------------------------------------------- over int8, the tree --

def _ref_uniforms(key, tree_k):
    """The reference quantized channel's uniforms for ``tree_k``, one
    (K, n_total) draw split back into the payload's leaves."""
    leaves, treedef = jax.tree.flatten(tree_k)
    k = leaves[0].shape[0]
    sizes = [int(np.prod(x.shape[1:])) for x in leaves]
    flat = np.asarray(jax.random.uniform(key, (k, sum(sizes))))
    parts = np.split(flat, np.cumsum(sizes)[:-1], axis=1)
    return jax.tree.unflatten(treedef, [
        torch.tensor(p.reshape(x.shape)) for p, x in zip(parts, leaves)])


@pytest.mark.parametrize("kind", ["stats", "fedavg"])
@pytest.mark.parametrize("tree", [False, True], ids=["int8", "tree"])
def test_scaffold_round_over_int8_matches_reference(kind, tree):
    """SCAFFOLD with FedProx on the toy over an int8 uplink, flat or as the
    client hop of an 8-edge tree with a dense edge hop, given the
    reference's uniforms for every phase: the variate deltas ride the
    quantized wire and, through the tree, the edge fold."""
    pool, k = toy.pool_np(), 8
    batch = {v: x[:k] for v, x in pool.items()}
    sizes = np.array([3, 2, 3, 1, 3, 2, 3, 3], np.int32)
    p0 = toy.params_np()
    key = jax.random.PRNGKey(17)
    kw = dict(_round_kw(kind, "fedprox", 0.05))
    c, cs = _variates_np(p0, k, 5, 0.05)
    j_ch, t_ch = j_channel.QuantizedChannel(8), channel.QuantizedChannel(8)
    k_wire = key
    if tree:
        j_ch = j_hier.HierarchicalChannel(8, client_channel=j_ch)
        t_ch = HierarchicalChannel(8, client_channel=t_ch)
        k_wire = jax.random.split(key)[0]
    out_j = _ref_round(toy.j_apply, toy.to_jax(p0), toy.to_jax(batch),
                       jnp.asarray(sizes),
                       j_drift.ScaffoldState(toy.to_jax(c), toy.to_jax(cs)),
                       0.05, channel=j_ch, channel_key=key, **kw)
    params_k = {n: np.zeros((k,) + v.shape, np.float32)
                for n, v in p0.items()}
    payloads = {"update": params_k, "variate": params_k}
    if kind == "stats":
        payloads["stats"] = {n: np.zeros((k,) + sh, np.float32) for n, sh in
                             get_objective("dcco").stat_spec(
                                 toy.DIM_OUT).items()}
    draws = {}
    for phase, payload in payloads.items():
        u = _ref_uniforms(
            jax.random.fold_in(k_wire, j_channel.PHASE_SALT[phase]), payload)
        draws[phase] = {"client": u} if tree else u
    state_t = drift.ScaffoldState(toy.to_torch(c), toy.to_torch(cs))
    opt = opt_lib.sgd(0.05)
    pt0 = toy.to_torch(p0)
    fn = fed_sim.fedavg_round if kind == "fedavg" else fed_sim.dcco_round
    pt, _, st, mt = fn(toy.t_apply, pt0, opt.init(pt0), opt,
                       toy.to_torch(batch), torch.tensor(sizes),
                       scaffold_state=state_t, channel=t_ch, channel_key=17,
                       channel_draws=draws, **kw)
    pj, _, sj, mj = out_j
    for port, ref, start in ((pt, toy.to_torch(pj), pt0),
                             (st.c, toy.to_torch(sj.c), state_t.c),
                             (st.c_slots, toy.to_torch(sj.c_slots),
                              state_t.c_slots)):
        assert _rel(port, ref, start) <= 1e-4
    np.testing.assert_allclose(mt.loss.item(), float(mj.loss), rtol=1e-5)
    assert mt.wire_bytes.item() == float(mj.wire_bytes) > 0
    n = sum(v.size for v in p0.values())
    # the variate phase ships one more parameter-sized payload a client
    # (and, through the tree, a dense one an edge)
    n_stats = sum(int(np.prod(v.shape[1:]))
                  for v in payloads.get("stats", {}).values())
    assert mt.edge_bytes.item() == (8 * 4 * (2 * n + n_stats) if tree
                                    else 0.0)


# ------------------------------------------------------------- engine --

def test_three_engine_scaffold_rounds_replay_reference_cohorts():
    pool = toy.pool_np()
    rounds, seed, k = 3, 11, 6

    def j_sampler(k_sel, k_aug):
        sel = jax.random.choice(k_sel, toy.N_CLIENTS, (k,), replace=False)
        return ({v: jnp.asarray(x)[sel] for v, x in pool.items()},
                jnp.full((k,), toy.N_PER, jnp.int32))

    cohorts = []
    for r in range(rounds):
        k_sel, k_aug = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(seed), r))
        cohorts.append(j_sampler(k_sel, k_aug))
    cfg_kw = dict(lam=toy.LAM, client_lr=0.05, local_steps=2, scaffold=True,
                  prox_mu=MU)
    opt_j = j_opt.sgd(0.05)
    eng_j = j_engine.RoundEngine(
        toy.j_apply, opt_j, j_sampler,
        j_engine.EngineConfig(chunk_rounds=rounds, **cfg_kw))
    p0 = toy.params_np()
    pj, _, mj = eng_j.run(toy.to_jax(p0), opt_j.init(toy.to_jax(p0)),
                          jax.random.PRNGKey(seed), rounds)

    def run_port(dtype):
        replay = iter([({v: _t(x).to(dtype) for v, x in b.items()}, _t(sz))
                       for b, sz in cohorts])
        pt0 = utils.tree_map(lambda x: x.to(dtype), toy.to_torch(p0))
        opt_t = opt_lib.sgd(0.05)
        eng = round_engine.RoundEngine(
            toy.t_apply, opt_t, lambda gen: next(replay),
            round_engine.EngineConfig(chunk_rounds=2, **cfg_kw))
        p, _, m = eng.run(pt0, opt_t.init(pt0), seed, rounds)
        return p, eng.drift_state, m

    pt, st, mt = run_port(torch.float32)
    p64, s64, _ = run_port(torch.float64)
    np.testing.assert_allclose(mt.loss[0].item(), float(mj.loss[0]),
                               rtol=1e-4)
    sj = eng_j.drift_state
    zero = drift.scaffold_init(toy.to_torch(p0), k)
    for port, port64, ref, start in (
            (pt, p64, toy.to_torch(pj), toy.to_torch(p0)),
            (st.c, s64.c, toy.to_torch(sj.c), zero.c),
            (st.c_slots, s64.c_slots, toy.to_torch(sj.c_slots),
             zero.c_slots)):
        err, err_self = _rel(port, ref, start), _rel(port, port64, start)
        assert err <= 4 * err_self + 1e-6, (err, err_self)


def test_three_buffered_scaffold_ticks_match_reference_given_its_delays():
    """The buffered body with SCAFFOLD and FedProx: the variate refresh
    runs each tick on that tick's deltas while the updates wait in the
    ring. The variates are the deltas over L x lr, so rounding grows tick
    by tick (3.9e-5 of the update in the params and 1.1e-4 in c_slots at
    tick 3): each tick is held to 4x the port's own f32-vs-f64 distance
    plus 1e-6, its first to 1e-4 as tests/test_torch_async.py holds it."""
    k, horizon = 6, 4
    batch, sizes = _toy_cohort()
    p0, lr = toy.params_np(), 0.05
    cfg_kw = dict(async_k=2, staleness_fn="poly", lam=toy.LAM, client_lr=0.05,
                  local_steps=2, scaffold=True, prox_mu=MU)
    spec = get_objective("dcco").stat_spec(toy.DIM_OUT)
    opt_j = j_opt.sgd(lr)
    j_round = jax.jit(j_engine.make_async_round_body(
        toy.j_apply, opt_j, j_engine.EngineConfig(**cfg_kw), k))
    pj, dj = toy.to_jax(p0), j_drift.scaffold_init(toy.to_jax(p0), k)
    oj, aj = opt_j.init(pj), j_buffer.init_state(spec, pj, horizon)
    opt_t = opt_lib.sgd(lr)
    t_round = round_engine.make_async_round_body(
        toy.t_apply, opt_t, round_engine.EngineConfig(**cfg_kw))
    runs = {}
    for dtype in (torch.float32, torch.float64):
        pt = utils.tree_map(lambda x: x.to(dtype), toy.to_torch(p0))
        runs[dtype] = [pt, opt_t.init(pt),
                       buffer.init_state(spec, pt, horizon),
                       drift.scaffold_init(pt, k)]
    zero = drift.scaffold_init(toy.to_torch(p0), k)
    for tick, delays in enumerate(([0, 2, 1, 0, 3, 0], [1, 0, 0, 3, 2, 1],
                                   [0, 0, 1, 2, 0, 0])):
        d = np.asarray(delays, np.int32)
        pj, oj, dj, aj, mj = j_round(pj, oj, dj, aj, toy.to_jax(batch),
                                     jnp.asarray(sizes), jnp.asarray(d),
                                     jax.random.PRNGKey(0))
        for dtype, (pt, ot, at, dt) in runs.items():
            tb = utils.tree_map(lambda x: x.to(dtype), toy.to_torch(batch))
            pt, ot, at, dt, mt = t_round(pt, ot, at, tb, torch.tensor(sizes),
                                         torch.tensor(d), drift=dt)
            runs[dtype] = [pt, ot, at, dt]
            if dtype == torch.float32:
                m32 = mt
        (pt, _, at, dt), (p64, _, _, d64) = runs.values()
        for port, port64, ref, start in (
                (pt, p64, toy.to_torch(pj), toy.to_torch(p0)),
                (dt.c, d64.c, toy.to_torch(dj.c), zero.c),
                (dt.c_slots, d64.c_slots, toy.to_torch(dj.c_slots),
                 zero.c_slots)):
            err, err_self = _rel(port, ref, start), _rel(port, port64, start)
            assert err <= (1e-4 if tick == 0 else 4 * err_self + 1e-6), (
                tick, err, err_self)
        assert int(at.applied_total) == int(aj.applied_total)
        for name in ("applied", "staleness"):
            np.testing.assert_allclose(getattr(m32, name).item(),
                                       float(getattr(mj, name)), rtol=1e-5,
                                       atol=1e-7, err_msg=name)
        np.testing.assert_allclose(m32.loss.item(), float(mj.loss),
                                   rtol=1e-5)


# ------------------------------------------------------ the token tower --

def test_one_tinyllama_drift_round_matches_reference():
    """D-CCO with FedProx, SCAFFOLD and two local steps on the tinyllama
    smoke tower (at full width SCAFFOLD's f32 variates do not fit beside
    the token round, ROADMAP §1, "Left out by design"): a reference-drawn
    cohort of 4 clients x 2 sequences, every attention forward of both
    steps on the flash kernel's plain version."""
    seq = 16
    jcfg = j_get_config("tinyllama-1.1b", smoke=True)
    tcfg = get_config("tinyllama-1.1b", smoke=True)
    jp = j_de.init_dual_encoder(jax.random.PRNGKey(0), jcfg,
                                JDE(proj_dims=PROJ))
    toks, labels = j_synthetic.synthetic_labeled_tokens(64, 4, seq, 512,
                                                        seed=1)
    ds = j_pipeline.FederatedDataset.build(
        {"tokens": toks}, labels, num_clients=32, samples_per_client=2,
        partition=j_partition.PartitionSpec("dirichlet", alpha=0.0),
        seed=0, vocab=512)
    batch, sizes = ds.round_batch(jax.random.PRNGKey(42), 4)
    # the smoke tower diverges at the CLI's client lr 1.0 with two steps
    # (parameters near 1e17 after the round, in both frameworks)
    kw = dict(lam=toy.LAM, local_steps=2, prox_mu=MU, client_lr=0.1)
    opt_j = j_opt.sgd(LR)
    pj, _, sj, mj = jax.jit(lambda p, o, b, sz, d: j_fed_sim.dcco_round(
        _j_apply(jcfg, JDE(proj_dims=PROJ), "tokens"), p, o, opt_j, b, sz,
        scaffold_state=d, **kw))(jp, opt_j.init(jp), batch, sizes,
                                 j_drift.scaffold_init(jp, 4))
    p0 = _from_ref(jp)
    opt_t = opt_lib.sgd(LR)
    round_fn = round_engine.make_round_body(
        make_apply(tcfg, DualEncoderConfig(proj_dims=PROJ)), opt_t,
        round_engine.EngineConfig(stats_kernel="off", scaffold=True, **kw))
    zero = drift.scaffold_init(p0, 4)
    pt, _, st, mt = round_fn(p0, opt_t.init(p0), utils.tree_map(_t, batch),
                             _t(sizes), drift=zero)
    sj = _carry_state(sj)
    assert _rel(pt, _from_ref(pj), p0) < 1e-3
    assert _rel(st.c, sj.c, zero.c) < 1e-3
    assert _rel(st.c_slots, sj.c_slots, zero.c_slots) < 1e-3
    np.testing.assert_allclose(mt.loss.item(), float(mj.loss), rtol=1e-4)
