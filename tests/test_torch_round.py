"""The DCCO round and the engine, port vs reference, on the CPU, with
JAX's parameters carried over and JAX-drawn cohorts fed in.

Configuration: the smoke ResNet with ``resnet_groups=2`` (8 and 16
channels per group). The reference's GroupNorm normalises each pixel
over its group's channels only, and at the smoke config's 8 groups of 2
channels the f32 gradient is ill-conditioned in BOTH frameworks: against
an f64 evaluation the stem-weight gradient is off by 25% in the port and
by 170% in the reference, so no comparison of the two could hold there.
With 8+ channels per group both sit within 6e-5 of f64 and of each other.

Metric: parameters are compared by ``max|p_port - p_ref| / max|p_ref -
p_0|``, the error relative to the update, as examples/quickstart.py does.
One round is held to 1e-3 of its update (measured: 3e-5 to 1e-4), losses
to rtol 1e-4. Beyond one round the DCCO gradient at random init on
12-sample cohorts is sensitive to the aggregate statistics themselves:
reordering the phase-1 f32 sums inside the port (stats_kernel "off" vs
"fused") moves one round's parameters by up to 7e-4 of the update and
three rounds' by ~2e-2. So the fused-vs-off round is held to 2e-3, and
the three replayed rounds are held to 4x the port's own fused-vs-off
divergence on the same cohorts (measured ratio 1.0-1.5 at this learning
rate; a protocol fault moves parameters by O(1) of the update).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import DualEncoderConfig as JDE
from repro.configs.base import get_config as j_get_config
from repro.core import eval as j_eval
from repro.core import fed_sim as j_fed_sim
from repro.core import round_engine as j_engine
from repro.data import partition as j_partition
from repro.data import pipeline as j_pipeline
from repro.data import synthetic as j_synthetic
from repro.models import dual_encoder as j_de
from repro.optim import optimizers as j_opt
from repro_torch import convert, utils
from repro_torch.configs.base import DualEncoderConfig, get_config
from repro_torch.core import eval as eval_lib, fed_sim, round_engine
from repro_torch.launch.train import make_apply
from repro_torch.optim import optimizers as opt_lib

# tier-1 runs 6 pytest workers on the machine's cores: one torch thread
# per worker keeps them from contending with each other and with JAX
torch.set_num_threads(1)

LAM = 5.0
LR = 0.005                       # server SGD learning rate
PROJ = (64, 64)


def _j_apply(cfg, de):
    def apply(p, batch):
        zf, _ = j_de.encode(cfg, de, p, {"images": batch["v1"]})
        zg, _ = j_de.encode(cfg, de, p, {"images": batch["v2"]})
        return zf, zg
    return apply


@pytest.fixture(scope="module")
def setup():
    jcfg = j_get_config("resnet14-cifar", smoke=True).replace(
        resnet_groups=2)
    tcfg = get_config("resnet14-cifar", smoke=True).replace(resnet_groups=2)
    jp = jax.jit(j_de.init_dual_encoder, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jcfg, JDE(proj_dims=PROJ))
    imgs, labels = j_synthetic.synthetic_labeled_images(
        96, 4, image_size=16, noise=0.5, seed=1)
    return {"jcfg": jcfg, "tcfg": tcfg, "jp": jp, "imgs": imgs,
            "labels": labels,
            "j_apply": _j_apply(jcfg, JDE(proj_dims=PROJ)),
            "t_apply": make_apply(tcfg, DualEncoderConfig(proj_dims=PROJ))}


def _dataset(s, strategy):
    spec = (j_partition.PartitionSpec("dirichlet", alpha=0.0)
            if strategy == "dirichlet" else
            j_partition.PartitionSpec("dirichlet_quantity", severity=0.9))
    return j_pipeline.FederatedDataset.build(
        {"images": s["imgs"]}, s["labels"], num_clients=32,
        samples_per_client=3, partition=spec, seed=0)


def _to_torch(tree):
    return utils.tree_map(lambda x: torch.tensor(np.asarray(x)), tree)


def _port_params(s):
    return convert.params_from_jax(jax.tree.map(np.asarray, s["jp"]))


def _rel_err(p_port, p_ref, p0):
    """max|port - ref| / max|ref - p0|, with reference parameter trees."""
    ref = convert.params_from_jax(jax.tree.map(np.asarray, p_ref))
    return (utils.tree_max_abs_diff(p_port, ref) / utils.tree_max_abs_diff(
        ref, convert.params_from_jax(jax.tree.map(np.asarray, p0))))


@pytest.mark.parametrize("strategy", ["dirichlet", "dirichlet_quantity"])
def test_one_dcco_round_matches_reference(setup, strategy):
    s = setup
    ds = _dataset(s, strategy)
    batch, sizes = ds.round_batch(jax.random.PRNGKey(42), 6)
    opt_j = j_opt.sgd(LR)
    agg_j = j_engine.make_kernel_agg_stats(interpret=True)

    @jax.jit
    def j_round(p, o, b, sz):
        return j_fed_sim.dcco_round(s["j_apply"], p, o, opt_j, b, sz,
                                    lam=LAM, agg_stats_fn=agg_j)

    pj, _, mj = j_round(s["jp"], opt_j.init(s["jp"]), batch, sizes)

    p0 = _port_params(s)
    opt_t = opt_lib.sgd(LR)
    round_fn = round_engine.make_round_body(
        s["t_apply"], opt_t,
        round_engine.EngineConfig(lam=LAM, stats_kernel="fused"))
    pt, _, mt = round_fn(p0, opt_t.init(p0), _to_torch(batch),
                         torch.tensor(np.asarray(sizes)))
    err = _rel_err(pt, pj, s["jp"])
    assert err < 1e-3, err
    np.testing.assert_allclose(mt.loss.item(), float(mj.loss), rtol=1e-4)
    np.testing.assert_allclose(mt.encoding_std.item(),
                               float(mj.encoding_std), rtol=1e-4)


def test_stats_kernel_off_equals_fused(setup):
    """Eq. 3: the flattened-cohort aggregate (fused) equals the weighted
    average of per-client statistics (off)."""
    s = setup
    batch, sizes = _dataset(s, "dirichlet_quantity").round_batch(
        jax.random.PRNGKey(3), 6)
    batch, sizes = _to_torch(batch), torch.tensor(np.asarray(sizes))
    p0 = _port_params(s)
    opt = opt_lib.sgd(LR)
    outs = {}
    for kernel in ("off", "fused"):
        fn = round_engine.make_round_body(
            s["t_apply"], opt,
            round_engine.EngineConfig(lam=LAM, stats_kernel=kernel))
        outs[kernel] = fn(p0, opt.init(p0), batch, sizes)
    upd = utils.tree_max_abs_diff(outs["off"][0], p0)
    assert utils.tree_max_abs_diff(outs["off"][0], outs["fused"][0]) / upd \
        < 2e-3
    torch.testing.assert_close(outs["off"][2].loss, outs["fused"][2].loss,
                               rtol=1e-4, atol=0)


def test_appendix_a_round_equals_centralized_step(setup):
    """With one local step at client lr 1 and an SGD server, a DCCO round
    equals one centralized large-batch step on the union (Appendix A)."""
    s = setup
    batch, sizes = _dataset(s, "dirichlet").round_batch(
        jax.random.PRNGKey(42), 8)
    batch, sizes = _to_torch(batch), torch.tensor(np.asarray(sizes))
    p0 = _port_params(s)
    opt = opt_lib.sgd(LR)
    p_fed, _, _ = fed_sim.dcco_round(s["t_apply"], p0, opt.init(p0), opt,
                                     batch, sizes, lam=LAM, client_lr=1.0)
    union = fed_sim._flatten_clients(batch)
    p_cent, _, _ = fed_sim.centralized_step(s["t_apply"], p0, opt.init(p0),
                                            opt, union, lam=LAM)
    rel = (utils.tree_max_abs_diff(p_fed, p_cent)
           / utils.tree_max_abs_diff(p_fed, p0))
    assert rel < 1e-4, rel


def test_three_engine_rounds_replay_reference_cohorts(setup):
    s = setup
    ds = _dataset(s, "dirichlet")
    k, rounds, seed = 6, 3, 11
    sampler_j = ds.make_round_sampler(k)
    cohorts = []
    for r in range(rounds):
        k_sel, k_aug = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(seed), r))
        cohorts.append(sampler_j(k_sel, k_aug))
    opt_j = j_opt.sgd(LR)
    eng_j = j_engine.RoundEngine(
        s["j_apply"], opt_j, sampler_j,
        j_engine.EngineConfig(algorithm="dcco", lam=LAM, chunk_rounds=rounds,
                              stats_kernel="interpret"))
    pj, _, mj = eng_j.run(s["jp"], opt_j.init(s["jp"]),
                          jax.random.PRNGKey(seed), rounds)

    def run_port(kernel, on_segment=None):
        replay = iter([(_to_torch(b), torch.tensor(np.asarray(sz)))
                       for b, sz in cohorts])
        p0 = _port_params(s)
        opt_t = opt_lib.sgd(LR)
        eng = round_engine.RoundEngine(
            s["t_apply"], opt_t, lambda gen: next(replay),
            round_engine.EngineConfig(lam=LAM, chunk_rounds=2,
                                      stats_kernel=kernel))
        return eng.run(p0, opt_t.init(p0), seed, rounds,
                       on_segment=on_segment)

    segments = []
    pt, _, mt = run_port("fused", lambda r, c, m: segments.append(r))
    assert segments == [2, 3]
    assert mt.loss.shape == (rounds,)
    np.testing.assert_allclose(mt.loss.numpy(), np.asarray(mj.loss),
                               rtol=1e-3)
    # the port against itself, with only the order of the phase-1 f32 sums
    # changed: how far f32 rounding alone moves three rounds of this run
    p_off = run_port("off")[0]
    ref = convert.params_from_jax(jax.tree.map(np.asarray, pj))
    upd = utils.tree_max_abs_diff(ref, _port_params(s))
    err_self = utils.tree_max_abs_diff(p_off, pt) / upd
    err = utils.tree_max_abs_diff(pt, ref) / upd
    assert err <= 4 * err_self + 1e-4, (err, err_self)


def test_engine_round_stream_resumes_by_start_round(setup):
    s = setup
    imgs, labels = s["imgs"], s["labels"]
    from repro_torch.data import partition, pipeline
    ds = pipeline.FederatedDataset.build(
        {"images": imgs}, labels, num_clients=32, samples_per_client=3,
        partition=partition.PartitionSpec("dirichlet", alpha=0.0), seed=0)
    sampler = ds.make_round_sampler(4, "cpu")
    seen = []

    def recording(gen):
        out = sampler(gen)
        seen.append(out[0]["v1"])
        return out

    p0 = _port_params(s)
    opt = opt_lib.sgd(LR)
    cfg = round_engine.EngineConfig(lam=LAM, chunk_rounds=1)
    round_engine.RoundEngine(s["t_apply"], opt, recording, cfg).run(
        p0, opt.init(p0), 5, 2)
    round_engine.RoundEngine(s["t_apply"], opt, recording, cfg).run(
        p0, opt.init(p0), 5, 1, start_round=1)
    torch.testing.assert_close(seen[2], seen[1], rtol=0, atol=0)
    assert not torch.equal(seen[0], seen[1])


def test_centralized_body_and_unported_algorithms(setup):
    s = setup
    batch, sizes = _dataset(s, "dirichlet").round_batch(
        jax.random.PRNGKey(1), 4)
    batch, sizes = _to_torch(batch), torch.tensor(np.asarray(sizes))
    p0 = _port_params(s)
    opt = opt_lib.sgd(LR)
    fn = round_engine.make_round_body(
        s["t_apply"], opt, round_engine.EngineConfig(algorithm="centralized",
                                                     lam=LAM))
    p1, _, m = fn(p0, opt.init(p0), batch, sizes)
    assert torch.isfinite(m.loss)
    with pytest.raises(NotImplementedError):
        round_engine.make_round_body(
            s["t_apply"], opt,
            round_engine.EngineConfig(algorithm="fedavg_cco"))
    with pytest.raises(ValueError):
        round_engine.make_round_body(
            s["t_apply"], opt, round_engine.EngineConfig(stats_kernel="x"))


def test_ridge_linear_probe_matches_reference():
    rng = np.random.RandomState(0)
    protos = rng.randn(4, 16).astype(np.float32)
    ytr, yte = rng.randint(0, 4, 120), rng.randint(0, 4, 40)
    ztr = (protos[ytr] + 0.8 * rng.randn(120, 16)).astype(np.float32)
    zte = (protos[yte] + 0.8 * rng.randn(40, 16)).astype(np.float32)
    ref = float(j_eval.ridge_linear_probe(jnp.asarray(ztr), jnp.asarray(ytr),
                                          jnp.asarray(zte), jnp.asarray(yte),
                                          4))
    out = float(eval_lib.ridge_linear_probe(
        torch.from_numpy(ztr), torch.from_numpy(ytr), torch.from_numpy(zte),
        torch.from_numpy(yte), 4))
    assert out == ref
    assert 0.5 < out <= 1.0
