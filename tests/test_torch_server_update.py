"""The server strategies (repro_torch.server: the FedAvg delegate, FedAvgM,
FedAdagrad, FedAdam, FedYogi), port vs reference, on the CPU: each
strategy's ``step`` over three rounds of the same pseudo-deltas, the laws
the reference's own tests state (the delegate is the hard-coded server
step bit for bit, FedAvgM is momentum SGD, the adaptive rules are Reddi et
al.'s), D-CCO with FedAdam through the engine on replayed reference
cohorts, and the CLI's ``--server-opt``/``--server-tau`` with the
reference's refusals of ignored flags.

Tolerances: a strategy's step is the same few f32 operations a leaf on
both sides, so parameters and state (m, v, the step counter) are held to
rtol 1e-6, atol 1e-7 after three rounds (measured: parameters bit-equal
for every strategy, with and without a cosine schedule). Three engine rounds of D-CCO with FedAdam are held as
tests/test_torch_round.py holds the SGD ones: within 4x the port's own
divergence when only the order of the phase-1 f32 sums changes
(statistics kernel "fused" vs "off"), losses to rtol 1e-4 (measured on
the toy encoder of tests/_torch_toy.py: 1.2e-5 of the update against a
self-divergence of 8.6e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_toy as toy
from repro.core import round_engine as j_engine
from repro.launch import train as j_train
from repro.optim import optimizers as j_opt
from repro.optim import schedules as j_schedules
from repro.server import get_server_update as j_get_server_update
from repro_torch import utils
from repro_torch.core import round_engine
from repro_torch.launch import train
from repro_torch.optim import optimizers as opt_lib
from repro_torch.optim import schedules
from repro_torch.server import (SERVER_UPDATES, as_server_update,
                                get_server_update, optimizers as srv_opt)

# tier-1 runs 6 pytest workers on the machine's cores: one torch thread
# per worker keeps them from contending with each other and with JAX
torch.set_num_threads(1)

STRATEGIES = ["fedavg_sgd", "fedavgm", "fedadagrad", "fedadam", "fedyogi"]


def _tree_np(seed):
    rng = np.random.RandomState(seed)
    return {"a": {"w": rng.randn(4, 3).astype(np.float32)},
            "b": [rng.randn(5).astype(np.float32),
                  rng.randn(2, 2).astype(np.float32)]}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return utils.tree_map(lambda x: torch.tensor(np.asarray(x)), tree)


def _close(port, ref, **tol):
    lp, lr = utils.tree_leaves(port), jax.tree.leaves(ref)
    assert len(lp) == len(lr)
    for p, r in zip(lp, lr):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), **tol)


def test_registry_matches_reference():
    from repro.server import update as j_update
    assert SERVER_UPDATES == j_update.SERVER_UPDATES == tuple(STRATEGIES)


@pytest.mark.parametrize("name", STRATEGIES)
@pytest.mark.parametrize("scheduled", [False, True], ids=["float", "cosine"])
def test_strategy_step_matches_reference_over_three_rounds(name, scheduled):
    """The same pseudo-deltas through each strategy three times; the base
    optimizer of the delegate is Adam, as the CLI's default."""
    lr_j = j_schedules.cosine_decay(0.05, 3) if scheduled else 0.05
    lr_t = schedules.cosine_decay(0.05, 3) if scheduled else 0.05
    kw = {"tau": 1e-2} if name in ("fedadagrad", "fedadam",
                                   "fedyogi") else {}
    if name == "fedavg_sgd":
        su_j = j_get_server_update(name, base_opt=j_opt.adam(lr_j))
        su_t = get_server_update(name, base_opt=opt_lib.adam(lr_t))
    else:
        su_j = j_get_server_update(name, server_lr=lr_j, **kw)
        su_t = get_server_update(name, server_lr=lr_t, **kw)
    assert su_t.name == su_j.name == name
    p0 = _tree_np(0)
    pj, sj = _j(p0), su_j.init(_j(p0))
    pt, st = _t(p0), su_t.init(_t(p0))
    for r in range(3):
        delta = _tree_np(10 + r)
        pj, sj = su_j.step(pj, sj, _j(delta))
        pt, st = su_t.step(pt, st, _t(delta))
    _close(pt, pj, rtol=1e-6, atol=1e-7)
    assert set(st) == set(sj)
    for key in st:
        _close(st[key], sj[key], rtol=1e-6, atol=1e-7)
    assert int(st["step"]) == int(sj["step"]) == 3


@pytest.mark.parametrize("name", ["fedadagrad", "fedadam", "fedyogi"])
def test_matches_hand_computed_reddi_update(name):
    lr, b1, b2, tau = 0.05, 0.9, 0.99, 1e-3
    params = {"w": torch.ones(4)}
    g = {"w": torch.tensor([0.2, -0.1, 0.05, 0.0])}
    if name == "fedadagrad":
        opt, b1_eff = srv_opt.fedadagrad(lr, tau=tau), 0.0
    else:
        opt = {"fedadam": srv_opt.fedadam,
               "fedyogi": srv_opt.fedyogi}[name](lr, b1=b1, b2=b2, tau=tau)
        b1_eff = b1
    state = opt.init(params)
    for _ in range(2):        # two steps, so the v-recursions differ
        updates, state = opt.update(g, state, params)
    gv = g["w"].numpy().astype(np.float64)
    m, v = np.zeros(4), np.zeros(4)
    for _ in range(2):
        m = b1_eff * m + (1 - b1_eff) * gv
        g2 = gv * gv
        if name == "fedadagrad":
            v = v + g2
        elif name == "fedadam":
            v = b2 * v + (1 - b2) * g2
        else:
            v = v - (1 - b2) * g2 * np.sign(v - g2)
        ref = -lr * m / (np.sqrt(v) + tau)
    np.testing.assert_allclose(updates["w"].numpy(), ref, rtol=1e-6)


def test_fedavgm_is_momentum_sgd_and_the_delegate_is_the_hardcoded_step():
    params = {"w": torch.ones(3)}
    g = {"w": torch.tensor([1.0, -2.0, 0.5])}
    a, b = srv_opt.fedavgm(0.1, momentum=0.9), opt_lib.sgd(0.1, momentum=0.9)
    ua, _ = a.update(g, a.init(params), params)
    ub, _ = b.update(g, b.init(params), params)
    assert utils.tree_max_abs_diff(ua, ub) == 0.0
    p0 = _t(_tree_np(1))
    delta = _t(_tree_np(2))
    for opt in (opt_lib.sgd(0.1, momentum=0.9), opt_lib.adam(1e-2),
                opt_lib.lars(0.1)):
        updates, s_ref = opt.update(utils.tree_scale(delta, -1.0),
                                    opt.init(p0), p0)
        p_ref = opt_lib.apply_updates(p0, updates)
        p_new, s_new = as_server_update(opt).step(p0, opt.init(p0), delta)
        assert utils.tree_max_abs_diff(p_ref, p_new) == 0.0
        assert utils.tree_max_abs_diff(s_ref, s_new) == 0.0


def test_get_server_update_refusals_match_reference():
    su = get_server_update("fedavg_sgd", server_lr=0.1)
    assert as_server_update(su) is su
    with pytest.raises(TypeError):
        as_server_update(object())
    for name, kw in (("fedprox", {"server_lr": 0.1}), ("fedadam", {}),
                     ("fedavg_sgd", {})):
        with pytest.raises(ValueError) as port:
            get_server_update(name, **kw)
        with pytest.raises(ValueError) as ref:
            j_get_server_update(name, **kw)
        assert str(port.value) == str(ref.value)


def _toy_replay(seed=3, rounds=3, k=6):
    pool = toy.pool_np()

    def j_sampler(k_sel, k_aug):
        sel = jax.random.choice(k_sel, toy.N_CLIENTS, (k,), replace=False)
        return ({v: jnp.asarray(x)[sel] for v, x in pool.items()},
                jnp.full((k,), toy.N_PER, jnp.int32))

    cohorts = []
    for r in range(rounds):
        k_sel, k_aug = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(seed), r))
        cohorts.append(j_sampler(k_sel, k_aug))
    return j_sampler, cohorts


def test_dcco_with_fedadam_through_the_engine_matches_reference():
    rounds, seed = 3, 3
    j_sampler, cohorts = _toy_replay(seed, rounds)
    p0 = toy.params_np()
    su_j = j_get_server_update("fedadam", server_lr=0.02)
    eng_j = j_engine.RoundEngine(
        toy.j_apply, su_j, j_sampler,
        j_engine.EngineConfig(algorithm="dcco", lam=toy.LAM,
                              chunk_rounds=rounds, server_update=su_j))
    pj, sj, mj = eng_j.run(toy.to_jax(p0), su_j.init(toy.to_jax(p0)),
                           jax.random.PRNGKey(seed), rounds)

    def run_port(kernel):
        replay = iter([(toy.to_torch(b), torch.tensor(np.asarray(sz)))
                       for b, sz in cohorts])
        su = get_server_update("fedadam", server_lr=0.02)
        pt0 = toy.to_torch(p0)
        eng = round_engine.RoundEngine(
            toy.t_apply, opt_lib.sgd(1.0), lambda gen: next(replay),
            round_engine.EngineConfig(lam=toy.LAM, chunk_rounds=2,
                                      stats_kernel=kernel, server_update=su))
        return eng.run(pt0, su.init(pt0), seed, rounds)

    pt, st, mt = run_port("fused")
    p_off = run_port("off")[0]
    np.testing.assert_allclose(mt.loss.numpy(), np.asarray(mj.loss),
                               rtol=1e-4)
    upd = toy.max_diff(pj, p0)
    err_self = toy.max_diff(pt, p_off) / upd
    err = toy.max_diff(pt, pj) / upd
    assert err <= 4 * err_self + 1e-6, (err, err_self)
    assert int(st["step"]) == int(sj["step"]) == rounds


@pytest.mark.parametrize("name", ["fedavgm", "fedadagrad", "fedadam",
                                  "fedyogi"])
def test_engine_trains_with_strategy(name):
    """Every strategy drives the engine (the reference's own test); the
    engine's ``server_opt`` argument is overridden by ``server_update``."""
    pool = toy.to_torch(toy.pool_np())
    su = get_server_update(name, server_lr=0.05)

    def sampler(gen):
        return ({v: x[:8] for v, x in pool.items()},
                torch.full((8,), toy.N_PER, dtype=torch.int32))

    p0 = toy.to_torch(toy.params_np())
    eng = round_engine.RoundEngine(
        toy.t_apply, opt_lib.sgd(0.0), sampler,
        round_engine.EngineConfig(lam=toy.LAM, chunk_rounds=3,
                                  server_update=su))
    p, s, m = eng.run(p0, su.init(p0), 3, 3)
    assert bool(torch.isfinite(m.loss).all())
    assert utils.tree_max_abs_diff(p, p0) > 0.0
    assert int(s["step"]) == 3


SMALL = ["--device", "cpu", "--rounds", "2", "--eval-every", "1",
         "--dataset-size", "60", "--clients-per-round", "4"]


@pytest.mark.parametrize("flags", [
    ["--server-opt", "fedadam", "--server-optimizer", "sgd"],
    ["--server-tau", "0.01"],
    ["--server-opt", "fedavgm", "--server-tau", "0.01"],
])
def test_cli_refuses_the_server_flags_the_reference_refuses(flags):
    j_ap = j_train.build_parser()
    with pytest.raises(SystemExit):
        j_train.validate_flags(j_ap, j_ap.parse_args(flags))
    with pytest.raises(SystemExit, match="silently ignored"):
        train.main([*SMALL, *flags])


@pytest.mark.parametrize("flags", [
    ["--server-opt", "fedadam"],
    ["--server-opt", "fedyogi", "--server-tau", "0.01"],
    ["--server-opt", "fedavgm"],
])
def test_cli_trains_with_a_server_strategy(flags):
    j_ap = j_train.build_parser()
    j_train.validate_flags(j_ap, j_ap.parse_args(flags))   # accepted there
    res = train.main([*SMALL, *flags])
    assert res["loss_finite"] and len(res["history"]) == 2
    leaves = utils.tree_leaves(res["params"])
    assert all(bool(torch.isfinite(x).all()) for x in leaves)

