"""The FedBuff-style buffered engine and its latency model, port vs
reference, on the CPU.

JAX's and torch's generators never agree, so the port's delays are not
the reference's: the latency model is held to its laws (delays in
[0, horizon), persistent per client, a zero-latency sampler keeps the sync
streams), and the tick comparison feeds both sides the same delays.

Tolerances: a dispatch fold sums <= 8 weighted rows in another order on
each side: rtol 1e-5, atol 1e-6. Two buffered ticks of the toy model
(tests/_torch_toy.py) are held to 1e-4 of their update (measured ~1e-7),
losses to rtol 1e-5. Inside the port, the provably-synchronous
configuration is the sync engine bit for bit, and the forced real buffer
equals the per-client sync path to f32 regrouping: 1e-5 of the update
over four rounds (measured 2.8e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_toy as toy
from repro.core import buffer as j_buffer
from repro.core import round_engine as j_engine
from repro.optim import optimizers as j_opt
from repro_torch import utils
from repro_torch.comm import channel
from repro_torch.core import buffer, round_engine
from repro_torch.data import latency, partition, pipeline, synthetic
from repro_torch.hierarchy import HierarchicalChannel
from repro_torch.objectives import get_objective
from repro_torch.optim import optimizers as opt_lib

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
K, H = 6, 4
HEAVY = latency.LatencyModel("heavytail", horizon=H, tail=1.0, seed=3)


def _spec():
    return get_objective("dcco").stat_spec(toy.DIM_OUT)


def _contribution(seed):
    rng = np.random.RandomState(seed)
    st = {k: rng.randn(K, *s).astype(np.float32) for k, s in _spec().items()}
    dl = {k: rng.randn(K, *v.shape).astype(np.float32)
          for k, v in toy.params_np().items()}
    return (st, dl, rng.rand(K).astype(np.float32),
            rng.rand(K).astype(np.float32),
            (rng.rand(K) < 0.8).astype(np.float32),
            rng.randint(0, H, K).astype(np.int32))


def _close_buf(port, ref):
    for field in buffer.StalenessBuffer._fields:
        a, b = getattr(port, field), getattr(ref, field)
        if isinstance(a, dict):
            for k in a:
                np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                           rtol=RTOL, atol=ATOL,
                                           err_msg=f"{field}.{k}")
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL, err_msg=field)


def test_buffer_folds_match_reference():
    p0 = toy.params_np()
    t = buffer.init_state(_spec(), toy.to_torch(p0), H)
    j = j_buffer.init_state(_spec(), toy.to_jax(p0), H)
    _close_buf(t.pending, j.pending)
    for seed in (0, 1):
        st, dl, loss, w, mask, delays = _contribution(seed)
        t_pend = buffer.dispatch_fold(
            t.pending, toy.to_torch(st), toy.to_torch(dl),
            torch.tensor(loss), torch.tensor(w), torch.tensor(mask),
            torch.tensor(delays))
        j_pend = j_buffer.dispatch_fold(
            j.pending, toy.to_jax(st), toy.to_jax(dl), jnp.asarray(loss),
            jnp.asarray(w), jnp.asarray(mask), jnp.asarray(delays))
        _close_buf(t_pend, j_pend)
        t_arr, t_pend = buffer.ring_pop(t_pend)
        j_arr, j_pend = j_buffer.ring_pop(j_pend)
        _close_buf(t_arr, j_arr)
        _close_buf(t_pend, j_pend)
        assert not t_pend.mass[-1] and not t_pend.delta["w1"][-1].any()
        t_buf = buffer.buffer_add(t.buffer, t_arr)
        j_buf = j_buffer.buffer_add(j.buffer, j_arr)
        for a, b in zip(buffer.buffer_aggregate(t_buf),
                        j_buffer.buffer_aggregate(j_buf)):
            a = a if isinstance(a, dict) else {"x": a}
            b = b if isinstance(b, dict) else {"x": b}
            for k in a:
                np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                           rtol=RTOL, atol=ATOL)
        t = buffer.AsyncState(t_buf, t_pend, t.applied_total)
        j = j_buffer.AsyncState(j_buf, j_pend, j.applied_total)
    reset = buffer.buffer_reset_where(t.buffer, torch.tensor(True))
    assert all(not x.any() for x in utils.tree_leaves(list(reset)))
    kept = buffer.buffer_reset_where(t.buffer, torch.tensor(False))
    assert torch.equal(kept.mass, t.buffer.mass)
    # an empty buffer aggregates to zeros, never NaN
    empty = buffer.init_state(_spec(), toy.to_torch(p0), H).buffer
    stats, delta, tau = buffer.buffer_aggregate(empty)
    assert float(tau) == 0.0 and not delta["w1"].any()


def test_staleness_registry():
    tau = torch.tensor([0.0, 1.0, 3.0])
    assert buffer.resolve_staleness(None)(tau).tolist() == [1.0, 1.0, 1.0]
    assert buffer.resolve_staleness("poly")(tau).tolist() == pytest.approx(
        [1.0, 2 ** -0.5, 0.5])
    assert buffer.resolve_staleness("inv")(tau).tolist() == pytest.approx(
        [1.0, 0.5, 0.25])
    assert buffer.resolve_staleness(lambda t: t * 2)(tau)[2] == 6.0
    with pytest.raises(ValueError, match="staleness"):
        buffer.resolve_staleness("exp")


def _cohort():
    pool = toy.pool_np()
    return ({v: x[:K] for v, x in pool.items()},
            np.array([3, 2, 3, 1, 3, 2], np.int32))


def test_two_buffered_ticks_match_reference_given_its_delays():
    """Tick 1 dispatches delays [0, 2, 1, 0, 3, 0]: three arrive at once,
    async_k = 2 fires and the rest wait in the ring; tick 2's cohort
    arrives on top of them."""
    batch, sizes = _cohort()
    p0, lr = toy.params_np(), 0.05
    cfg_kw = dict(async_k=2, staleness_fn="poly", lam=toy.LAM)
    opt_j = j_opt.sgd(lr)
    j_round = jax.jit(j_engine.make_async_round_body(
        toy.j_apply, opt_j, j_engine.EngineConfig(**cfg_kw), K))
    pj = toy.to_jax(p0)
    oj = opt_j.init(pj)
    aj = j_buffer.init_state(_spec(), pj, H)
    opt_t = opt_lib.sgd(lr)
    t_round = round_engine.make_async_round_body(
        toy.t_apply, opt_t, round_engine.EngineConfig(**cfg_kw))
    pt = toy.to_torch(p0)
    ot = opt_t.init(pt)
    at = buffer.init_state(_spec(), pt, H)
    applied = []
    for delays in ([0, 2, 1, 0, 3, 0], [1, 0, 0, 3, 2, 1]):
        d = np.asarray(delays, np.int32)
        pj, oj, _, aj, mj = j_round(pj, oj, (), aj, toy.to_jax(batch),
                                    jnp.asarray(sizes), jnp.asarray(d),
                                    jax.random.PRNGKey(0))
        pt, ot, at, mt = t_round(pt, ot, at, toy.to_torch(batch),
                                 torch.tensor(sizes), torch.tensor(d))
        upd = toy.max_diff(pj, p0)
        assert upd > 0
        assert toy.max_diff(pt, pj) <= 1e-4 * upd
        _close_buf(at.pending, aj.pending)
        _close_buf(at.buffer, aj.buffer)
        assert int(at.applied_total) == int(aj.applied_total)
        for name in ("loss", "encoding_std", "applied", "staleness"):
            np.testing.assert_allclose(getattr(mt, name).item(),
                                       float(getattr(mj, name)), rtol=1e-5,
                                       atol=1e-7, err_msg=name)
        applied.append(mt.applied.item())
    assert applied == [1.0, 1.0]
    assert mt.staleness.item() > 0           # tick 2 applies stale arrivals


def test_heavytail_delays_obey_the_models_laws():
    ids = torch.arange(200, dtype=torch.int32)
    d1 = latency.sample_delays(HEAVY, 1, ids)
    d2 = latency.sample_delays(HEAVY, 2, ids.flip(0)).flip(0)
    assert d1.dtype == torch.int32
    assert int(d1.min()) >= 0 and int(d1.max()) == H - 1
    assert torch.equal(d1, d2)                 # per client, every round
    assert 0.3 < float((d1 == 0).float().mean()) < 0.8   # tail 1: P(0)=1/2
    other = latency.sample_delays(HEAVY._replace(seed=4), 1, ids)
    assert not torch.equal(d1, other)
    u = latency.client_uniforms(3, ids)
    assert float(u.min()) >= 1e-6 and float(u.max()) < 1.0
    uni = latency.resolve_latency("uniform")
    du = latency.sample_delays(uni, 5, ids)
    assert int(du.min()) >= 0 and int(du.max()) < uni.horizon
    assert torch.equal(du, latency.sample_delays(uni, 5, ids))
    assert not latency.sample_delays(latency.LatencyModel(), 0, ids).any()


@pytest.mark.parametrize("spec", [
    "lognormal", latency.LatencyModel(horizon=0),
    latency.LatencyModel("heavytail", horizon=4, tail=0.0), 3])
def test_latency_refusals(spec):
    with pytest.raises(ValueError):
        latency.resolve_latency(spec)


def test_zero_latency_sampler_keeps_the_sync_streams():
    imgs, labels = synthetic.synthetic_labeled_images(48, 3, image_size=8,
                                                      noise=0.5, seed=2)
    ds = pipeline.FederatedDataset.build(
        {"images": imgs}, labels, num_clients=16, samples_per_client=3,
        partition=partition.PartitionSpec("dirichlet", alpha=0.0), seed=0)
    sync = ds.make_round_sampler(4, "cpu")
    for model in (None, HEAVY):
        asyn = ds.make_async_round_sampler(4, "cpu", model)
        assert asyn.latency == latency.resolve_latency(model)
        assert asyn.clients_per_round == 4
        b0, s0 = sync(utils.generator(9, "cpu"))
        b1, s1, d1 = asyn(utils.generator(9, "cpu"))
        assert torch.equal(b0["v1"], b1["v1"]) and torch.equal(s0, s1)
        assert d1.shape == (4,) and d1.dtype == torch.int32
    # heavy-tail delays follow the sampled client ids
    gen = utils.generator(9, "cpu")
    sel = ds._select(gen, 4)
    _, _, d = ds.make_async_round_sampler(4, "cpu", HEAVY)(
        utils.generator(9, "cpu"))
    assert torch.equal(d, latency.sample_delays(HEAVY, 0, sel))


def _toy_sampler(model=None, k=K):
    pool = toy.to_torch(toy.pool_np())

    def plain(gen):
        sel = torch.randperm(toy.N_CLIENTS, generator=gen)[:k]
        return ({v: x[sel] for v, x in pool.items()},
                torch.full((k,), toy.N_PER, dtype=torch.int32))

    return plain, latency.make_async_sampler(plain, model, k)


def _run(cfg, sampler, rounds=4):
    opt = opt_lib.sgd(0.05)
    eng = round_engine.RoundEngine(toy.t_apply, opt, sampler, cfg)
    p0 = toy.to_torch(toy.params_np())
    return eng.run(p0, opt.init(p0), 7, rounds), eng


def test_sync_configuration_collapses_bit_for_bit():
    plain, asyn = _toy_sampler()
    base = dict(lam=toy.LAM, chunk_rounds=2)
    (p0, _, m0), _ = _run(round_engine.EngineConfig(**base), plain)
    (p1, _, m1), e1 = _run(round_engine.EngineConfig(async_k=K, **base),
                           asyn)
    assert e1.buffer_state is None               # the sync body ran
    assert utils.tree_max_abs_diff(p0, p1) == 0.0
    assert torch.equal(m0.loss, m1.loss)
    # forced through the real buffer: the per-client sync path (phase 1
    # as the buffer takes it) to f32 regrouping
    (p3, _, m3), _ = _run(round_engine.EngineConfig(stats_kernel="off",
                                                    **base), plain)
    (p2, _, m2), e2 = _run(round_engine.EngineConfig(
        async_k=K, async_collapse=False, **base), asyn)
    upd = utils.tree_max_abs_diff(p3, toy.to_torch(toy.params_np()))
    assert utils.tree_max_abs_diff(p3, p2) <= 1e-5 * upd
    assert m2.applied.tolist() == [1.0] * 4 and int(
        e2.buffer_state.applied_total) == 4
    torch.testing.assert_close(m2.loss, m3.loss, rtol=1e-5, atol=1e-6)


def test_buffered_heavytail_run_trains_counts_staleness_and_resumes():
    _, asyn = _toy_sampler(HEAVY)
    cfg = round_engine.EngineConfig(lam=toy.LAM, async_k=3,
                                    staleness_fn="poly", latency=HEAVY,
                                    chunk_rounds=3)
    (p6, _, m), eng = _run(cfg, asyn, rounds=6)
    assert bool(torch.isfinite(m.loss).all())
    assert 0 < m.applied.sum().item() <= 6
    assert int(eng.buffer_state.applied_total) == int(m.applied.sum())
    assert float(m.staleness.max()) > 0
    assert not m.staleness[m.applied == 0].any()
    assert eng.buffer_state.pending.delta["w1"].shape == (H, toy.DIM_IN, 16)
    # three rounds, then three more from the carried buffer: the same run
    opt = opt_lib.sgd(0.05)
    eng = round_engine.RoundEngine(toy.t_apply, opt, asyn, cfg)
    p0 = toy.to_torch(toy.params_np())
    p3, o3, _ = eng.run(p0, opt.init(p0), 7, 3)
    p6b, _, _ = eng.run(p3, o3, 7, 3, start_round=3,
                        buffer_state=eng.buffer_state)
    assert utils.tree_max_abs_diff(p6, p6b) == 0.0


@pytest.mark.parametrize("cfg,plain,match", [
    (dict(async_k=3), True, "latency-aware"),
    (dict(async_k=3, latency="uniform"), False, "must agree"),
    (dict(async_k=K + 1), False, "must be in"),
    (dict(async_k=3, stats_kernel="fused"), False, "per-client"),
    (dict(async_k=3, algorithm="centralized"), False, "dcco"),
    (dict(async_k=3, channel=channel.DPGaussianChannel()), False, "DP"),
    (dict(async_k=3, channel=HierarchicalChannel(
        2, client_channel=channel.QuantizedChannel(8))), False, "lossy"),
    (dict(async_k=3, staleness_fn="exp"), False, "staleness"),
])
def test_buffered_refusals(cfg, plain, match):
    p, a = _toy_sampler()
    with pytest.raises(ValueError, match=match):
        round_engine.RoundEngine(toy.t_apply, opt_lib.sgd(0.1),
                                 p if plain else a,
                                 round_engine.EngineConfig(**cfg))


def test_collapsing_tree_composes_with_the_buffer():
    """An ideal-hop tree is accepted by the buffered engine and counts
    both hops' bytes."""
    _, asyn = _toy_sampler(HEAVY)
    (_, _, m), _ = _run(round_engine.EngineConfig(
        lam=toy.LAM, async_k=3, latency=HEAVY,
        channel=HierarchicalChannel(2)), asyn, rounds=2)
    assert bool((m.wire_bytes > 0).all()) and bool((m.edge_bytes > 0).all())
