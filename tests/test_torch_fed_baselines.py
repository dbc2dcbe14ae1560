"""The paper's FedAvg baselines (FedAvg+CCO, FedAvg+NT-Xent, FedAvg+BYOL),
port vs reference, on the CPU: the losses and their gradients, one
``fedavg_round`` per loss kind, the round over a quantized uplink and a
two-level tree, three engine rounds of each ``fedavg_*`` body, a round of
the smoke tinyllama tower, the reference's own laws restated on the port,
the guards, and the loose ends that ride along (the partition registry,
``label_dominance``, ``flat_round_batch``, ``per_client_stats``).

Both packages get the same numpy inputs; parameters cross by
``repro_torch.convert`` (the toy encoder of tests/_torch_toy.py needs
none). Everything is f32; TF32 plays no part on the CPU. The channels
take the reference's own uniforms, never a reseed.

Tolerances:
- the losses and their gradients against ``repro.core.losses`` and
  ``jax.grad``: rtol 1e-6, atol 1e-6 (the same f32 formula on both sides);
- one round: parameters within 1e-3 of the round's update, by
  ``max|p_port - p_ref| / max|p_ref - p_0|`` as tests/test_torch_round.py
  measures it, or within 4x the port's own f32 rounding where that is
  larger (the distance of the port's f32 round from the same round in
  f64); the loss to rtol 1e-4. The rounding can exceed 1e-3 of the update
  because some gradients cancel: BYOL's ``zt - cos(zo, zt) zo`` when two
  views encode alike (the smoke ResNet's 3-sample cohort: port vs
  reference 1.65e-3, the port's f32 vs f64 1.65e-3, the reference's f32 vs
  the port's f64 4.1e-4), within-client CCO on tiny clients (1.22e-3,
  1.27e-3). With two samples every within-client correlation is +-1, where
  the CCO gradient vanishes analytically and what is left is rounding in
  both frameworks (the toy's 1-3 sample cohort: port vs reference 0.24 of
  the update, the port's f32 vs f64 0.25), so FedAvg+CCO takes full
  3-sample clients (6e-5 and 2.5e-5 on the toy); the other kinds take
  ragged clients, padding included;
- the quantized and tree rounds of the toy model: 1e-4 of the update (the
  wire is bit-equal given the same inputs and uniforms,
  tests/test_torch_comm.py; the parameters see one f32 regrouping of
  each fold), the wire bytes exactly;
- three engine rounds replaying the reference's cohorts: the parameters
  after them within 4x the port's own rounding, the distance of its f32
  run from the same three rounds in f64 (plus 1e-6 of the update), as the
  DCCO replay test holds its rounds to 4x the port's own divergence; a
  protocol fault moves parameters by O(1) of the update. The first
  round's loss to rtol 1e-4; later losses follow the parameters: three
  rounds of FedAvg+CCO on 3-sample toy clients are rounding-dominated
  (parameters: port vs reference 0.13 of the update, the port's f32 vs
  f64 0.098; the third loss 26.62 vs the reference's 26.22 and the f64
  run's 26.68), the other bodies agree to ~1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_toy as toy
from repro import hierarchy as j_hier
from repro.comm import channel as j_channel
from repro.configs.base import DualEncoderConfig as JDE
from repro.configs.base import get_config as j_get_config
from repro.core import cco as j_cco
from repro.core import fed_sim as j_fed_sim
from repro.core import losses as j_losses
from repro.core import round_engine as j_engine
from repro.data import partition as j_partition
from repro.data import pipeline as j_pipeline
from repro.data import synthetic as j_synthetic
from repro.models import dual_encoder as j_de
from repro.optim import optimizers as j_opt
from repro_torch import convert, utils
from repro_torch.comm import channel
from repro_torch.configs.base import DualEncoderConfig, get_config
from repro_torch.core import cco, fed_sim, losses, round_engine
from repro_torch.data import partition, pipeline
from repro_torch.hierarchy import HierarchicalChannel
from repro_torch.launch import train
from repro_torch.launch.train import make_apply
from repro_torch.optim import optimizers as opt_lib

# tier-1 runs 6 pytest workers on the machine's cores: one torch thread
# per worker keeps them from contending with each other and with JAX
torch.set_num_threads(1)

LR = 0.005                       # server SGD learning rate
PROJ = (64, 64)
KINDS = [("cco", None), ("stats", "dvicreg"), ("contrastive", None),
         ("byol", None)]


def _t(x):
    return torch.tensor(np.asarray(x))


def _grads_close(port, ref):
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------- losses --

def _pair(seed, n=6, d=8, zero_row=False):
    rng = np.random.RandomState(seed)
    zf = rng.randn(n, d).astype(np.float32)
    zg = (zf + 0.5 * rng.randn(n, d)).astype(np.float32)
    if zero_row:
        zf[2] = 0.0
    return zf, zg


@pytest.mark.parametrize("temperature", [0.1, 0.5])
@pytest.mark.parametrize("seed", [0, 1])
def test_ntxent_and_its_gradient_match_reference(seed, temperature):
    zf, zg = _pair(seed)
    ref = j_losses.ntxent_loss(jnp.asarray(zf), jnp.asarray(zg), temperature)
    out = losses.ntxent_loss(_t(zf), _t(zg), temperature)
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6, atol=1e-6)
    jg = jax.grad(lambda a, b: j_losses.ntxent_loss(a, b, temperature),
                  argnums=(0, 1))(jnp.asarray(zf), jnp.asarray(zg))
    tg = torch.func.grad(lambda a, b: losses.ntxent_loss(a, b, temperature),
                         argnums=(0, 1))(_t(zf), _t(zg))
    _grads_close(tg, jg)


def test_ntxent_masks_the_diagonal_and_floors_the_norm_like_reference():
    """A zero row normalises to zero (the 1e-8 floor), a duplicated row
    would beat its positive but for the -1e9 diagonal; both values equal
    the reference's."""
    zf, zg = _pair(3, zero_row=True)
    zg[4] = zf[4]
    for a, b in ((zf, zg), (zf.astype(np.float64), zg)):
        ref = j_losses.ntxent_loss(jnp.asarray(a, jnp.float32),
                                   jnp.asarray(b))
        out = losses.ntxent_loss(_t(a), _t(b))
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6,
                                   atol=1e-6)


def test_cross_entropy_and_encoding_variance_match_reference():
    rng = np.random.RandomState(4)
    logits = rng.randn(3, 5, 7).astype(np.float32)
    labels = rng.randint(0, 7, (3, 5))
    ref = j_losses.softmax_cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(labels))
    out = losses.softmax_cross_entropy(_t(logits), _t(labels))
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6, atol=1e-6)
    jg = jax.grad(lambda x: j_losses.softmax_cross_entropy(
        x, jnp.asarray(labels)))(jnp.asarray(logits))
    tg = torch.func.grad(lambda x: losses.softmax_cross_entropy(
        x, _t(labels)))(_t(logits))
    _grads_close([tg], [jg])
    z = rng.randn(9, 4).astype(np.float32)
    np.testing.assert_allclose(
        losses.encoding_variance(_t(z)).item(),
        float(j_losses.encoding_variance(jnp.asarray(z))), rtol=1e-6,
        atol=1e-6)


def test_byol_stop_gradient_holds_under_grad_and_vmap():
    zo, zt = _pair(5)
    ref = j_losses.byol_predictive_loss(jnp.asarray(zo), jnp.asarray(zt))
    out = losses.byol_predictive_loss(_t(zo), _t(zt))
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6, atol=1e-6)
    jg = jax.grad(j_losses.byol_predictive_loss, argnums=(0, 1))(
        jnp.asarray(zo), jnp.asarray(zt))
    tg = torch.func.grad(losses.byol_predictive_loss, argnums=(0, 1))(
        _t(zo), _t(zt))
    _grads_close(tg, jg)
    assert not tg[1].any()                 # the target is detached
    # per client under vmap, as the FedAvg round takes it
    zo3, zt3 = (np.stack([x, x[::-1], 2 * x]) for x in (zo, zt))
    jv = jax.vmap(jax.grad(j_losses.byol_predictive_loss, argnums=(0, 1)))(
        jnp.asarray(zo3), jnp.asarray(zt3))
    tv = torch.vmap(torch.func.grad(losses.byol_predictive_loss,
                                    argnums=(0, 1)))(_t(zo3), _t(zt3))
    _grads_close(tv, jv)
    assert not tv[1].any()


# ------------------------------------------------------------ one round --

def _toy_cohort(full=False):
    pool = toy.pool_np()
    sizes = [3] * 6 if full else [3, 2, 3, 1, 3, 2]
    return {v: x[:6] for v, x in pool.items()}, np.array(sizes, np.int32)


def _port_round(apply, p0, batch, sizes, dtype, lr, **kw):
    """One port ``fedavg_round`` from torch trees ``p0`` and ``batch``
    cast to ``dtype``; returns (params in f32, metrics)."""
    p0, batch = (utils.tree_map(lambda x: x.to(dtype), t) for t in (p0, batch))
    opt = opt_lib.sgd(lr)
    p, _, m = fed_sim.fedavg_round(apply, p0, opt.init(p0), opt, batch,
                                   sizes, **kw)
    return utils.tree_map(lambda x: x.float(), p), m


def _bound(err_self):
    """1e-3 of the update, or 4x the port's own f32 rounding if larger."""
    return max(1e-3, 4 * err_self)


@pytest.mark.parametrize("kind,objective", KINDS)
def test_one_toy_fedavg_round_matches_reference(kind, objective):
    batch, sizes = _toy_cohort(full=kind == "cco")
    p0 = toy.params_np()
    lr = 0.05
    opt_j = j_opt.sgd(lr)
    pj, _, mj = jax.jit(lambda p, o, b, s: j_fed_sim.fedavg_round(
        toy.j_apply, p, o, opt_j, b, s, loss_kind=kind, lam=toy.LAM,
        objective=objective))(toy.to_jax(p0), opt_j.init(toy.to_jax(p0)),
                              toy.to_jax(batch), jnp.asarray(sizes))
    kw = dict(loss_kind=kind, lam=toy.LAM, objective=objective)
    pt, mt = _port_round(toy.t_apply, toy.to_torch(p0), toy.to_torch(batch),
                         torch.tensor(sizes), torch.float32, lr, **kw)
    p64, _ = _port_round(toy.t_apply, toy.to_torch(p0), toy.to_torch(batch),
                         torch.tensor(sizes), torch.float64, lr, **kw)
    upd = toy.max_diff(pj, p0)
    assert upd > 0
    assert toy.max_diff(pt, pj) <= _bound(toy.max_diff(pt, p64) / upd) * upd
    np.testing.assert_allclose(mt.loss.item(), float(mj.loss), rtol=1e-4)
    assert mt.encoding_std.item() == float(mj.encoding_std) == 0.0
    assert mt.wire_bytes.item() == float(mj.wire_bytes) == 0.0


def _j_apply(cfg, de, leaf="images"):
    def apply(p, batch):
        zf, _ = j_de.encode(cfg, de, p, {leaf: batch["v1"]})
        zg, _ = j_de.encode(cfg, de, p, {leaf: batch["v2"]})
        return zf, zg
    return apply


@pytest.fixture(scope="module")
def resnet():
    """The smoke ResNet with ``resnet_groups=2`` (tests/test_torch_round.py
    says why) and two reference-drawn cohorts: variable-size clients, so
    padding samples take part, and full 3-sample clients."""
    jcfg = j_get_config("resnet14-cifar", smoke=True).replace(
        resnet_groups=2)
    tcfg = get_config("resnet14-cifar", smoke=True).replace(resnet_groups=2)
    jp = jax.jit(j_de.init_dual_encoder, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jcfg, JDE(proj_dims=PROJ))
    imgs, labels = j_synthetic.synthetic_labeled_images(
        96, 4, image_size=16, noise=0.5, seed=1)
    cohorts = {}
    for full, spec in ((False, j_partition.PartitionSpec(
            "dirichlet_quantity", severity=0.7)),
            (True, j_partition.PartitionSpec("dirichlet", alpha=0.0))):
        ds = j_pipeline.FederatedDataset.build(
            {"images": imgs}, labels, num_clients=32, samples_per_client=3,
            partition=spec, seed=0)
        cohorts[full] = ds.round_batch(jax.random.PRNGKey(42), 6)
    return {"jp": jp, "cohorts": cohorts,
            "j_apply": _j_apply(jcfg, JDE(proj_dims=PROJ)),
            "t_apply": make_apply(tcfg, DualEncoderConfig(proj_dims=PROJ)),
            "t_apply64": make_apply(tcfg.replace(dtype="float64"),
                                    DualEncoderConfig(proj_dims=PROJ))}


def _from_ref(p):
    return convert.params_from_jax(jax.tree.map(np.asarray, p))


@pytest.mark.parametrize("kind,objective", KINDS)
def test_one_resnet_fedavg_round_matches_reference(resnet, kind, objective):
    s = resnet
    batch, sizes = s["cohorts"][kind == "cco"]
    assert (int(np.min(sizes)) == 3) == (kind == "cco")
    opt_j = j_opt.sgd(LR)
    pj, _, mj = jax.jit(lambda p, o, b, sz: j_fed_sim.fedavg_round(
        s["j_apply"], p, o, opt_j, b, sz, loss_kind=kind, lam=toy.LAM,
        objective=objective))(s["jp"], opt_j.init(s["jp"]), batch, sizes)
    p0 = _from_ref(s["jp"])
    kw = dict(loss_kind=kind, lam=toy.LAM, objective=objective)
    tb = utils.tree_map(_t, batch)
    pt, mt = _port_round(s["t_apply"], p0, tb, _t(sizes), torch.float32, LR,
                         **kw)
    p64, _ = _port_round(s["t_apply64"], p0, tb, _t(sizes), torch.float64,
                         LR, **kw)
    ref = _from_ref(pj)
    upd = utils.tree_max_abs_diff(ref, p0)
    err = utils.tree_max_abs_diff(pt, ref) / upd
    err_self = utils.tree_max_abs_diff(pt, p64) / upd
    assert err < _bound(err_self), (err, err_self)
    np.testing.assert_allclose(mt.loss.item(), float(mj.loss), rtol=1e-4)


# -------------------------------------------------------------- channels --

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


@pytest.mark.parametrize("tree", [False, True], ids=["flat", "tree"])
def test_quantized_fedavg_round_matches_reference(tree):
    """FedAvg+NT-Xent of the toy model over an int8 uplink, flat or as the
    client hop of a three-edge tree with a dense edge hop, given the
    reference's uniforms for the one uplink (the deltas)."""
    batch, sizes = _toy_cohort()
    p0 = toy.params_np()
    lr, key = 0.05, jax.random.PRNGKey(17)
    j_ch = j_channel.QuantizedChannel(8)
    t_ch = channel.QuantizedChannel(8)
    k_upd = key
    if tree:
        j_ch = j_hier.HierarchicalChannel(3, client_channel=j_ch)
        t_ch = HierarchicalChannel(3, client_channel=t_ch)
        k_upd = jax.random.split(key)[0]
    opt_j = j_opt.sgd(lr)
    pj, _, mj = jax.jit(lambda p, o, b, s, k: j_fed_sim.fedavg_round(
        toy.j_apply, p, o, opt_j, b, s, loss_kind="contrastive",
        channel=j_ch, channel_key=k))(
            toy.to_jax(p0), opt_j.init(toy.to_jax(p0)), toy.to_jax(batch),
            jnp.asarray(sizes), key)
    u_upd = _ref_uniforms(
        jax.random.fold_in(k_upd, j_channel.PHASE_SALT["update"]),
        {k: np.zeros((6,) + v.shape, np.float32) for k, v in p0.items()})
    opt_t = opt_lib.sgd(lr)
    pt0 = toy.to_torch(p0)
    pt, _, mt = fed_sim.fedavg_round(
        toy.t_apply, pt0, opt_t.init(pt0), opt_t, toy.to_torch(batch),
        torch.tensor(sizes), loss_kind="contrastive", channel=t_ch,
        channel_key=17,
        channel_draws={"update": {"client": u_upd} if tree else u_upd})
    upd = toy.max_diff(pj, p0)
    assert upd > 0
    assert toy.max_diff(pt, pj) <= 1e-4 * upd
    np.testing.assert_allclose(mt.loss.item(), float(mj.loss), rtol=1e-5)
    assert mt.wire_bytes.item() == float(mj.wire_bytes) > 0
    n = sum(v.size for v in p0.values())
    assert mt.edge_bytes.item() == (3 * 4 * n if tree else 0.0)


# ---------------------------------------------------------------- engine --

@pytest.mark.parametrize("algorithm", ["fedavg_cco", "fedavg_contrastive",
                                       "fedavg_byol"])
def test_three_engine_rounds_replay_reference_cohorts(algorithm):
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
    lr = 0.05
    opt_j = j_opt.sgd(lr)
    eng_j = j_engine.RoundEngine(
        toy.j_apply, opt_j, j_sampler,
        j_engine.EngineConfig(algorithm=algorithm, lam=toy.LAM,
                              chunk_rounds=rounds))
    p0 = toy.params_np()
    pj, _, mj = eng_j.run(toy.to_jax(p0), opt_j.init(toy.to_jax(p0)),
                          jax.random.PRNGKey(seed), rounds)

    def run_port(dtype):
        replay = iter([({v: _t(x).to(dtype) for v, x in b.items()}, _t(sz))
                       for b, sz in cohorts])
        pt0 = utils.tree_map(lambda x: x.to(dtype), toy.to_torch(p0))
        opt_t = opt_lib.sgd(lr)
        eng = round_engine.RoundEngine(
            toy.t_apply, opt_t, lambda gen: next(replay),
            round_engine.EngineConfig(algorithm=algorithm, lam=toy.LAM,
                                      chunk_rounds=2))
        return eng.run(pt0, opt_t.init(pt0), seed, rounds)

    pt, _, mt = run_port(torch.float32)
    p64, _, m64 = run_port(torch.float64)
    assert mt.loss.shape == (rounds,) and not mt.encoding_std.any()
    assert torch.isfinite(mt.loss).all() and torch.isfinite(m64.loss).all()
    np.testing.assert_allclose(mt.loss[0].item(), float(mj.loss[0]),
                               rtol=1e-4)
    upd = toy.max_diff(pj, p0)
    err_self = toy.max_diff(pt, p64) / upd
    err = toy.max_diff(pt, pj) / upd
    assert err <= 4 * err_self + 1e-6, (err, err_self)


def test_one_token_fedavg_contrastive_round_matches_reference():
    """FedAvg+NT-Xent on the tinyllama smoke tower: a reference-drawn
    cohort of 4 clients x 2 sequences, every attention forward on the
    flash kernel's plain version (its vmap rule folding the clients)."""
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
    opt_j = j_opt.sgd(LR)
    pj, _, mj = jax.jit(lambda p, o, b, sz: j_fed_sim.fedavg_round(
        _j_apply(jcfg, JDE(proj_dims=PROJ), "tokens"), p, o, opt_j, b, sz,
        loss_kind="contrastive"))(jp, opt_j.init(jp), batch, sizes)
    p0 = _from_ref(jp)
    opt_t = opt_lib.sgd(LR)
    round_fn = round_engine.make_round_body(
        make_apply(tcfg, DualEncoderConfig(proj_dims=PROJ)), opt_t,
        round_engine.EngineConfig(algorithm="fedavg_contrastive"))
    pt, _, mt = round_fn(p0, opt_t.init(p0), utils.tree_map(_t, batch),
                         _t(sizes))
    ref = _from_ref(pj)
    err = utils.tree_max_abs_diff(pt, ref) / utils.tree_max_abs_diff(ref, p0)
    assert err < 1e-3, err
    np.testing.assert_allclose(mt.loss.item(), float(mj.loss), rtol=1e-4)


# ------------------------------------------- the reference's own laws --

def _lin_enc(seed, d_in=8, d=4):
    params = {"w": torch.tensor(
        np.random.RandomState(seed).randn(d_in, d).astype(np.float32) * 0.5)}

    def apply(p, batch):
        return batch["v1"] @ p["w"], batch["v2"] @ p["w"]
    return params, apply


def _lin_data(seed, clients, n, d_in=8):
    rng = np.random.RandomState(seed)
    base = rng.randn(clients, n, d_in).astype(np.float32)
    return {"v1": torch.tensor(base),
            "v2": torch.tensor(base + 0.1 * rng.randn(clients, n, d_in)
                               .astype(np.float32))}


@pytest.mark.parametrize("kind", ["cco", "contrastive", "byol"])
def test_fedavg_round_runs_and_is_finite(kind):
    params, apply = _lin_enc(0)
    opt = opt_lib.adam(1e-2)
    p, _, m = fed_sim.fedavg_round(
        apply, params, opt.init(params), opt, _lin_data(1, 4, 4),
        torch.full((4,), 4, dtype=torch.int32), loss_kind=kind,
        client_lr=0.1)
    assert torch.isfinite(m.loss)
    assert utils.tree_max_abs_diff(p, params) > 0


def test_fedavg_cco_differs_from_dcco():
    """Without the statistics exchange the update is another one (Sec 3.3:
    naive FedAvg+CCO is NOT equivalent to centralized training)."""
    params, apply = _lin_enc(0)
    data, sizes = _lin_data(1, 4, 4), torch.full((4,), 4, dtype=torch.int32)
    opt = opt_lib.sgd(0.1)
    p_dcco, _, _ = fed_sim.dcco_round(apply, params, opt.init(params), opt,
                                      data, sizes, client_lr=1.0)
    p_fa, _, _ = fed_sim.fedavg_round(apply, params, opt.init(params), opt,
                                      data, sizes, loss_kind="cco",
                                      client_lr=1.0)
    assert utils.tree_max_abs_diff(p_dcco, p_fa) > 1e-6


def test_single_sample_clients_give_degenerate_correlations():
    """Paper Table 1, 1 sample a client: a client's own CCO statistics have
    zero variance (no learning signal), the aggregate's do not."""
    params, apply = _lin_enc(0)
    data = _lin_data(1, 16, 1)
    zf, zg = apply(params, {k: v.reshape(16, -1) for k, v in data.items()})
    c_one = cco.correlation_matrix(cco.encoding_stats(zf[:1], zg[:1]))
    c_agg = cco.correlation_matrix(cco.encoding_stats(zf, zg))
    assert float(c_one.abs().max()) < 0.1
    assert float(c_agg.abs().max()) > 0.5


def test_constant_encoder_is_byol_minimum_but_not_cco():
    """App. C: without batch statistics the predictive loss admits the
    collapsed constant encoder as its minimum; the CCO loss does not."""
    n, d = 64, 8
    rng = np.random.RandomState(0)
    z_const = torch.tensor(np.ones((n, d), np.float32) * 0.7
                           + 1e-4 * rng.randn(n, d).astype(np.float32))
    assert float(losses.byol_predictive_loss(z_const, z_const)) < 1e-6
    cco_at_collapse = float(cco.cco_loss(z_const, z_const, lam=5.0))
    assert cco_at_collapse > 1.0
    zf = torch.tensor(rng.randn(4096, d).astype(np.float32))
    u, _, _ = torch.linalg.svd(zf - zf.mean(0), full_matrices=False)
    zw = u * np.sqrt(4096)
    assert float(cco.cco_loss(zw, zw, lam=5.0)) < 0.1 * cco_at_collapse


def test_collapse_direction_is_descent_for_byol_not_cco():
    rng = np.random.RandomState(1)
    zf = torch.tensor(rng.randn(128, 6).astype(np.float32))
    zg = zf + 0.3 * torch.tensor(rng.randn(128, 6).astype(np.float32))
    const = torch.full((6,), 2.0)

    def shrink(z, t):
        return const[None] * t + z * (1 - t)

    ts = (0.0, 0.7, 0.99)
    byol = [float(losses.byol_predictive_loss(shrink(zf, t), shrink(zg, t)))
            for t in ts]
    cco_v = [float(cco.cco_loss(shrink(zf, t), shrink(zg, t), 5.0))
             for t in ts]
    assert byol[2] < byol[1] < byol[0], byol
    assert byol[2] < 1e-4
    assert cco_v[2] > 0.9 * cco_v[0], cco_v
    z_end = shrink(zf, 1.0) + 1e-5 * zf
    assert float(cco.cco_loss(z_end, z_end, 5.0)) > 10 * cco_v[0]


def test_sample_clients_without_replacement():
    sel = fed_sim.sample_clients(torch.Generator().manual_seed(0), 100, 32)
    assert len(np.unique(sel.numpy())) == 32
    assert int(sel.max()) < 100 and int(sel.min()) >= 0


# ---------------------------------------------------------------- guards --

def test_engine_guards_match_reference():
    opt = opt_lib.sgd(LR)
    stats_only = channel.DPGaussianChannel(noise_multiplier=1.0)
    for algorithm in ("fedavg_cco", "fedavg_contrastive", "fedavg_byol"):
        with pytest.raises(ValueError, match="ships client updates only"):
            round_engine.make_round_body(
                toy.t_apply, opt, round_engine.EngineConfig(
                    algorithm=algorithm, channel=stats_only))
        round_engine.make_round_body(
            toy.t_apply, opt, round_engine.EngineConfig(
                algorithm=algorithm, channel=channel.DPGaussianChannel(
                    noise_phases=("update",))))
    # the two-phase round has a stats uplink for the stats-only channel
    round_engine.make_round_body(
        toy.t_apply, opt, round_engine.EngineConfig(channel=stats_only))
    for algorithm in ("fedavg_contrastive", "fedavg_byol"):
        with pytest.raises(ValueError, match="silently ignored"):
            round_engine.make_round_body(
                toy.t_apply, opt, round_engine.EngineConfig(
                    algorithm=algorithm, objective="dvicreg"))
    round_engine.make_round_body(
        toy.t_apply, opt, round_engine.EngineConfig(
            algorithm="fedavg_cco", objective="dvicreg"))
    with pytest.raises(ValueError, match="unknown algorithm"):
        round_engine.make_round_body(
            toy.t_apply, opt, round_engine.EngineConfig(algorithm="fedsgd"))
    with pytest.raises(ValueError, match="loss_kind"):
        params, apply = _lin_enc(0)
        fed_sim.fedavg_round(apply, params, opt.init(params), opt,
                             _lin_data(1, 2, 2),
                             torch.full((2,), 2, dtype=torch.int32),
                             loss_kind="simclr")
    # the buffered and clustered bodies keep to the two-phase round
    with pytest.raises(ValueError, match="stats round only"):
        round_engine.make_async_round_body(
            toy.t_apply, opt, round_engine.EngineConfig(
                algorithm="fedavg_cco", async_k=2))
    from repro_torch.cluster import make_cluster_round_body
    with pytest.raises(ValueError, match="stats round only"):
        make_cluster_round_body(toy.t_apply, opt, round_engine.EngineConfig(
            algorithm="fedavg_contrastive", num_clusters=2))


SMALL = ["--device", "cpu", "--rounds", "2", "--eval-every", "1",
         "--dataset-size", "60", "--clients-per-round", "4"]


def test_train_run_drives_the_fedavg_bodies_and_refuses_an_objective():
    res = train.run(train.parse_args(SMALL), algorithm="fedavg_byol")
    assert res["loss_finite"] and len(res["history"]) == 2
    with pytest.raises(SystemExit, match="silently ignored"):
        train.run(train.parse_args([*SMALL, "--objective", "dvicreg"]),
                  algorithm="fedavg_contrastive")
    with pytest.raises(ValueError, match="unknown algorithm"):
        train.run(train.parse_args(SMALL), algorithm="fedsgd")


def test_profile_round_runs_a_fedavg_path_on_cpu():
    from repro_torch.launch import profile_round
    for path in ("fedavg_contrastive", "fedavg_cco"):
        assert profile_round._path_config(path, 0) == {"algorithm": path}
    res = profile_round.main(["--device", "cpu", "--clients-per-round", "2",
                              "--dataset-size", "32", "--warmup", "1",
                              "--rounds", "1", "--path", "fedavg_contrastive"])
    assert res["wall_ms"] > 0 and res["busy_ms"] is None


# ------------------------------------------------------------ loose ends --

def test_partition_registry_matches_reference():
    assert partition.PARTITIONS == j_partition.PARTITIONS
    for name in partition.PARTITIONS:
        assert callable(partition.get_partition(name))
    with pytest.raises(ValueError, match="unknown partition"):
        partition.get_partition("no_such_strategy")
    with pytest.raises(ValueError, match="unknown partition"):
        partition.build_partition(partition.PartitionSpec("no_such", 0.5),
                                  np.zeros(8, np.int64), num_clients=2,
                                  samples_per_client=2)

    def every_other(labels, num_clients, samples_per_client, severity,
                    seed=0):
        idx = np.arange(0, 2 * num_clients * samples_per_client, 2)
        return idx.reshape(num_clients, samples_per_client)

    labels = np.random.RandomState(0).randint(0, 4, 120)
    partition.register_partition("test_every_other", every_other)
    try:
        assert "test_every_other" in partition.PARTITIONS
        assert partition.get_partition("test_every_other") is every_other
        idx, sizes = partition.build_partition(
            partition.PartitionSpec("test_every_other", 0.5), labels,
            num_clients=10, samples_per_client=3)
        np.testing.assert_array_equal(idx, every_other(labels, 10, 3, 0.5))
        assert idx.dtype == np.int64 and (sizes == 3).all()
    finally:
        partition._REGISTRY.pop("test_every_other")
        partition.PARTITIONS = tuple(partition._REGISTRY)


@pytest.mark.parametrize("strategy,severity", [
    ("iid", 0.5), ("uniform", 0.0), ("label", 0.0), ("label", 0.5),
    ("label", 1.0), ("dirichlet", 0.0), ("dirichlet", 0.5),
    ("dirichlet_quantity", 0.8)])
def test_label_dominance_matches_reference(strategy, severity):
    labels = np.random.RandomState(3).randint(0, 6, 300)
    idx, sizes = partition.build_partition(
        partition.PartitionSpec(strategy, severity), labels,
        num_clients=30, samples_per_client=6, seed=2)
    got = partition.label_dominance(labels, idx, sizes)
    assert got == j_partition.label_dominance(labels, idx, sizes)
    assert 1.0 / 6 <= got <= 1.0
    if strategy == "label" and severity == 1.0:
        assert got == 1.0                  # single-class clients
    assert partition.label_dominance(labels, idx) == \
        j_partition.label_dominance(labels, idx)


def test_label_dominance_at_severity_one_raises_where_the_reference_raises():
    """The reference's own dominance test reaches severity 1.0 of the
    Dirichlet strategy, where alpha = 1e-3 can give NaN probabilities and
    the cut raises; the port raises the same error on the same seeds and
    scores the cuts that return the same."""
    labels = np.random.RandomState(5).randint(0, 6, 900)
    outcomes = []
    for seed in range(8):
        res = []
        for mod in (j_partition, partition):
            try:
                idx, sizes = mod.build_partition(
                    mod.PartitionSpec("dirichlet", 1.0), labels,
                    num_clients=150, samples_per_client=6, seed=seed)
                res.append(("ok", mod.label_dominance(labels, idx, sizes)))
            except ValueError as e:
                res.append(("raise", str(e)))
        assert res[0] == res[1], seed
        outcomes.append(res[0][0])
    assert "raise" in outcomes


def test_flat_round_batch_and_per_client_stats():
    imgs, labels = j_synthetic.synthetic_labeled_images(40, 3, image_size=8,
                                                        noise=0.5, seed=0)
    spec = partition.PartitionSpec("dirichlet", alpha=0.0)
    ds = pipeline.FederatedDataset.build(
        {"images": imgs}, labels, num_clients=10, samples_per_client=3,
        partition=spec, seed=0)
    flat, sizes = ds.flat_round_batch(torch.Generator().manual_seed(4), 5)
    batch, sizes2 = ds.round_batch(torch.Generator().manual_seed(4), 5)
    for v in ("v1", "v2"):
        assert flat[v].shape == (15, 8, 8, 3)
        assert torch.equal(flat[v], batch[v].reshape(15, 8, 8, 3))
    assert torch.equal(sizes, sizes2)
    j_ds = j_pipeline.FederatedDataset.build(
        {"images": imgs}, labels, num_clients=10, samples_per_client=3,
        partition=j_partition.PartitionSpec("dirichlet", alpha=0.0), seed=0)
    j_flat, j_sizes = j_ds.flat_round_batch(jax.random.PRNGKey(4), 5)
    assert {k: v.shape for k, v in j_flat.items()} == \
        {k: tuple(v.shape) for k, v in flat.items()}
    assert j_sizes.shape == tuple(sizes.shape)

    rng = np.random.RandomState(6)
    zf, zg = (rng.randn(12, 5).astype(np.float32) for _ in range(2))
    ref = j_cco.per_client_stats(jnp.asarray(zf), jnp.asarray(zg), 4)
    out = cco.per_client_stats(_t(zf), _t(zg), 4)
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="equal clients"):
        cco.per_client_stats(_t(zf), _t(zg), 5)
