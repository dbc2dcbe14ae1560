"""Cluster-aware aggregation, port vs reference, on the CPU.

k-means runs on well-separated direction bundles, so that the cluster ids
are exact in both frameworks (a near-tie would let f32 rounding pick
either side); rounds run the toy dual encoder of tests/_torch_toy.py,
whose three client groups give k-means clear clusters.

Tolerances: centroids and per-cluster folds sum <= 12 unit-scale rows in
another order on each side: rtol 1e-5, atol 1e-6. Two clustered rounds
are held to 1e-4 of their update (the same phase-2 math on gathered
per-cluster slots; measured 2e-6 to 2e-5), losses to rtol 1e-5. Inside the port
one cluster is the global path bit for bit, and a run repeats bit for
bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_toy as toy
from repro import cluster as j_cluster
from repro import hierarchy as j_hier
from repro.comm import channel as j_channel
from repro.core import round_engine as j_engine
from repro.objectives import get_objective as j_get_objective
from repro.optim import optimizers as j_opt
from repro_torch import cluster, utils
from repro_torch.comm import channel
from repro_torch.core import round_engine
from repro_torch.hierarchy import HierarchicalChannel
from repro_torch.objectives import get_objective
from repro_torch.optim import optimizers as opt_lib

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
C = 3


def _bundles(seed=0, k=12, d=8):
    """Rows around C well-separated directions (cosine gap >> rounding)."""
    rng = np.random.RandomState(seed)
    dirs = np.eye(d, dtype=np.float32)[[0, 3, 6]] * 3.0
    rows = dirs[np.arange(k) % C] + 0.1 * rng.randn(k, d)
    return rows[rng.permutation(k)].astype(np.float32)


def test_kmeans_ids_and_centroids_match_reference():
    rows = _bundles()
    seeds = cluster.seed_centroids(torch.tensor(rows), C)
    np.testing.assert_allclose(
        seeds.numpy(), np.asarray(j_cluster.seed_centroids(jnp.asarray(rows),
                                                           C)),
        rtol=RTOL, atol=ATOL)
    for warm in (None, seeds.numpy()[::-1].copy()):
        ids, cents = cluster.cosine_kmeans(
            torch.tensor(rows), C, iters=3,
            centroids=None if warm is None else torch.tensor(warm))
        j_ids, j_cents = j_cluster.cosine_kmeans(
            jnp.asarray(rows), C, iters=3,
            centroids=None if warm is None else jnp.asarray(warm))
        assert ids.dtype == torch.int32
        np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
        np.testing.assert_allclose(cents.numpy(), np.asarray(j_cents),
                                   rtol=RTOL, atol=ATOL)
        assert sorted(set(ids.tolist())) == [0, 1, 2]


def test_kmeans_empty_cluster_keeps_centroid_and_ties_go_low():
    rows = torch.tensor(_bundles())
    far = torch.zeros((4, rows.shape[1]))
    far[:3] = cluster.seed_centroids(rows, C)
    far[3, 1] = 1.0                         # orthogonal to every row
    ids, cents = cluster.cosine_kmeans(rows, 4, iters=2, centroids=far)
    assert 3 not in ids.tolist()
    assert torch.equal(cents[3], far[3])
    # a row equally similar to two centroids joins the lower id
    tie = cluster.assign_clusters(torch.tensor([[1.0, 1.0]]),
                                  torch.tensor([[0.0, 1.0], [1.0, 0.0]]))
    assert tie.tolist() == [0]


def test_flatten_stats_layout_and_dim_match_reference():
    obj = get_objective("dvicreg")
    spec = obj.stat_spec(toy.DIM_OUT)
    assert cluster.stats_dim(spec) == j_cluster.stats_dim(
        j_get_objective("dvicreg").stat_spec(toy.DIM_OUT))
    rng = np.random.RandomState(0)
    st = {k: rng.randn(5, *s).astype(np.float32) for k, s in spec.items()}
    rows = cluster.flatten_stats(toy.to_torch(st))
    np.testing.assert_array_equal(
        rows.numpy(), np.asarray(j_cluster.flatten_stats(toy.to_jax(st))))
    assert rows.shape == (5, cluster.stats_dim(spec))


def test_fold_to_clusters_matches_reference_with_an_empty_cluster():
    rng = np.random.RandomState(1)
    tree = {"a": rng.randn(10, 3).astype(np.float32),
            "b": rng.randn(10, 2, 2).astype(np.float32)}
    w = rng.rand(10).astype(np.float32)
    ids = np.array([0, 2, 2, 0, 0, 2, 0, 2, 2, 0], np.int32)    # none: 1
    avg, mass = cluster.fold_to_clusters(toy.to_torch(tree), torch.tensor(w),
                                         torch.tensor(ids), C)
    j_avg, j_mass = j_cluster.fold_to_clusters(
        toy.to_jax(tree), jnp.asarray(w), jnp.asarray(ids), C)
    np.testing.assert_allclose(mass.numpy(), np.asarray(j_mass), rtol=RTOL)
    for k in tree:
        np.testing.assert_allclose(avg[k].numpy(), np.asarray(j_avg[k]),
                                   rtol=RTOL, atol=ATOL)
    assert float(mass[1]) == 0.0 and not avg["a"][1].any()


def _cohort(k=9):
    """Nine full clients. A cluster may hold a single client; were that
    client one sample, its statistics would have zero variance and its
    correlation would divide rounding noise in both frameworks, so every
    client keeps all its samples."""
    pool = toy.pool_np()
    sel = np.random.RandomState(2).permutation(toy.N_CLIENTS)[:k]
    return ({v: x[sel] for v, x in pool.items()},
            np.full((k,), toy.N_PER, np.int32))


def _two_rounds(t_channel=None, j_channel_=None, draws=None):
    """Two clustered rounds (the second warm-started) of the toy model on
    both sides: returns (port, reference) (params, state, metrics)."""
    batch, sizes = _cohort()
    p0, lr = toy.params_np(), 0.05
    dim = cluster.stats_dim(get_objective("dcco").stat_spec(toy.DIM_OUT))
    opt_j = j_opt.sgd(lr)
    j_cfg = j_engine.EngineConfig(num_clusters=C, lam=toy.LAM,
                                  channel=j_channel_)
    j_round = jax.jit(j_cluster.make_cluster_round_body(toy.j_apply, opt_j,
                                                        j_cfg))
    pj = toy.to_jax(p0)
    oj = opt_j.init(pj)
    sj = j_cluster.init_cluster_state(pj, oj, C, dim)
    opt_t = opt_lib.sgd(lr)
    t_round = cluster.make_cluster_round_body(
        toy.t_apply, opt_t,
        round_engine.EngineConfig(num_clusters=C, lam=toy.LAM,
                                  channel=t_channel))
    pt = toy.to_torch(p0)
    ot = opt_t.init(pt)
    st = cluster.init_cluster_state(pt, ot, C, dim)
    for r in range(2):
        pj, oj, sj, mj = j_round(pj, oj, sj, toy.to_jax(batch),
                                 jnp.asarray(sizes), jax.random.PRNGKey(r))
        pt, ot, st, mt = t_round(pt, ot, st, toy.to_torch(batch),
                                 torch.tensor(sizes), r, draws)
    return (pt, st, mt), (pj, sj, mj)


def _check(port, ref):
    (pt, st, mt), (pj, sj, mj) = port, ref
    p0 = toy.params_np()
    upd = toy.max_diff(pj, p0)
    assert upd > 0
    assert toy.max_diff(pt, pj) <= 1e-4 * upd
    for k in p0:
        assert float(np.abs(np.asarray(st.params_c[k])
                            - np.asarray(sj.params_c[k])).max()) <= 1e-4 * upd
    np.testing.assert_allclose(st.centroids.numpy(),
                               np.asarray(sj.centroids), rtol=RTOL,
                               atol=1e-5)
    assert bool(st.initialized) and bool(sj.initialized)
    np.testing.assert_allclose(mt.loss.item(), float(mj.loss), rtol=1e-5)
    np.testing.assert_allclose(mt.encoding_std.item(),
                               float(mj.encoding_std), rtol=1e-5)
    # the slots really differ: clusters trained apart
    assert float((st.params_c["w2"][0] - st.params_c["w2"][1]).abs().max()) > 0


def test_two_clustered_rounds_match_reference():
    port, ref = _two_rounds()
    _check(port, ref)
    assert port[2].wire_bytes.item() == 0.0


def test_clustered_rounds_through_a_semantic_tree_match_reference():
    """Clients route through their cluster's edge; the edge hop drops
    edges (the reference's mask, carried as uniforms), so survivors'
    clusters alone train."""
    j_ch = j_hier.HierarchicalChannel(
        C, edge_channel=j_channel.DropoutChannel(0.5))
    masks = []
    for r in range(2):
        ctx = j_ch.begin_round(jax.random.PRNGKey(r), jnp.ones((9,)))
        masks.append(np.asarray(ctx.edge_ctx.mask))
    assert any(0 < m.sum() < C for m in masks)
    # each round's edge mask: rounds use keys 0 and 1 in _two_rounds
    calls = iter(masks)

    class Carried(HierarchicalChannel):
        def begin_round(self, key, client_sizes, draws=None):
            self.u = torch.tensor(np.where(next(calls) > 0, 0.0, 0.9),
                                  dtype=torch.float32)
            return super().begin_round(key, client_sizes, {"edge": self.u})

        def with_edge_ids(self, ctx, edge_ids, draws=None):
            return super().with_edge_ids(ctx, edge_ids, self.u)

    t_ch = Carried(C, edge_channel=channel.DropoutChannel(0.5))
    port, ref = _two_rounds(t_ch, j_ch)
    _check(port, ref)
    assert port[2].wire_bytes.item() == float(ref[2].wire_bytes)
    assert port[2].edge_bytes.item() > 0


def _engine(cfg, sampler=None):
    pool = toy.to_torch(toy.pool_np())

    def plain(gen):
        sel = torch.randperm(toy.N_CLIENTS, generator=gen)[:6]
        return ({k: v[sel] for k, v in pool.items()},
                torch.full((6,), toy.N_PER, dtype=torch.int32))

    opt = opt_lib.sgd(0.05)
    return round_engine.RoundEngine(toy.t_apply, opt, sampler or plain,
                                    cfg), opt


def _run(cfg):
    eng, opt = _engine(cfg)
    p0 = toy.to_torch(toy.params_np())
    return eng.run(p0, opt.init(p0), 3, 3), eng


def test_single_cluster_is_the_global_path_bit_for_bit():
    (p0, _, m0), _ = _run(round_engine.EngineConfig(lam=toy.LAM,
                                                    stats_kernel="off"))
    (p1, _, m1), eng = _run(round_engine.EngineConfig(
        lam=toy.LAM, stats_kernel="off", num_clusters=1))
    assert eng.cluster_state is None
    assert utils.tree_max_abs_diff(p0, p1) == 0.0
    assert torch.equal(m0.loss, m1.loss)


def test_clustered_engine_is_deterministic_and_carries_its_state():
    cfg = round_engine.EngineConfig(lam=toy.LAM, num_clusters=C,
                                    chunk_rounds=2)
    (pa, _, ma), ea = _run(cfg)
    (pb, _, mb), eb = _run(cfg)
    assert utils.tree_max_abs_diff(pa, pb) == 0.0
    assert torch.equal(ma.loss, mb.loss)
    st = ea.cluster_state
    assert st.params_c["w1"].shape == (C, toy.DIM_IN, 16)
    assert st.centroids.shape == (C, cluster.stats_dim(
        get_objective("dcco").stat_spec(toy.DIM_OUT)))
    assert bool(st.initialized) and ma.applied.tolist() == [1.0] * 3
    assert torch.equal(st.centroids, eb.cluster_state.centroids)


@pytest.mark.parametrize("cfg,match", [
    (dict(num_clusters=-1), "num_clusters"),
    (dict(num_clusters=2, async_k=3), "not composed"),
    (dict(num_clusters=2, stats_kernel="fused"), "per-client"),
    (dict(num_clusters=2, algorithm="centralized"), "dcco"),
    (dict(num_clusters=2, channel=channel.DPGaussianChannel()), "DP"),
    (dict(num_clusters=2, channel=HierarchicalChannel(3)), "one edge per"),
])
def test_clustered_refusals(cfg, match):
    with pytest.raises(ValueError, match=match):
        _engine(round_engine.EngineConfig(**cfg))


def test_more_clusters_than_the_cohort_is_refused():
    eng, opt = _engine(round_engine.EngineConfig(num_clusters=7))
    p0 = toy.to_torch(toy.params_np())
    with pytest.raises(ValueError, match="exceeds the cohort"):
        eng.run(p0, opt.init(p0), 0, 1)


def test_one_clustered_resnet_round_matches_reference():
    """The smoke ResNet (8 and 16 channels per GroupNorm group, see
    tests/test_torch_round.py) through one clustered round: phase 2 runs
    ``vmap`` over per-client parameter slots, whose convolutions become
    per-client grouped convolutions. Held to 1e-3 of the update, as the
    port's other ResNet rounds are.

    A clustered round is, cluster by cluster, a global round of that
    cluster's clients, and a cluster of three 3-sample clients can be
    rounding-dominated in both frameworks: in the cohort drawn with key 42
    one such trio puts every pair of paths (port or reference, clustered
    or global) 6.7e-3 of the update apart. This cohort (key 7, 8 clients)
    splits 5 + 3, and a global round of either cluster's clients agrees
    across frameworks to 1.5e-5 and 5.7e-5 of its update."""
    from repro.configs.base import DualEncoderConfig as JDE
    from repro.configs.base import get_config as j_get_config
    from repro.data import partition as j_partition
    from repro.data import pipeline as j_pipeline
    from repro.data import synthetic as j_synthetic
    from repro.models import dual_encoder as j_de
    from repro_torch import convert
    from repro_torch.configs.base import DualEncoderConfig, get_config
    from repro_torch.launch.train import make_apply

    proj, lr, k = (64, 64), 0.005, 8
    jcfg = j_get_config("resnet14-cifar", smoke=True).replace(
        resnet_groups=2)
    tcfg = get_config("resnet14-cifar", smoke=True).replace(resnet_groups=2)
    jde = JDE(proj_dims=proj)
    jp = jax.jit(j_de.init_dual_encoder, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jcfg, jde)
    imgs, labels = j_synthetic.synthetic_labeled_images(
        96, 4, image_size=16, noise=0.5, seed=1)
    ds = j_pipeline.FederatedDataset.build(
        {"images": imgs}, labels, num_clients=32, samples_per_client=3,
        partition=j_partition.PartitionSpec("dirichlet", alpha=0.0), seed=0)
    batch, sizes = ds.round_batch(jax.random.PRNGKey(7), k)

    def j_apply(p, b):
        zf, _ = j_de.encode(jcfg, jde, p, {"images": b["v1"]})
        zg, _ = j_de.encode(jcfg, jde, p, {"images": b["v2"]})
        return zf, zg

    dim = cluster.stats_dim(get_objective("dcco").stat_spec(proj[-1]))
    opt_j, opt_t = j_opt.sgd(lr), opt_lib.sgd(lr)
    j_round = jax.jit(j_cluster.make_cluster_round_body(
        j_apply, opt_j, j_engine.EngineConfig(num_clusters=2, lam=toy.LAM)))
    pj, _, sj, mj = j_round(jp, opt_j.init(jp),
                            j_cluster.init_cluster_state(jp, opt_j.init(jp),
                                                         2, dim),
                            batch, sizes, jax.random.PRNGKey(0))
    p0 = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    t_round = cluster.make_cluster_round_body(
        make_apply(tcfg, DualEncoderConfig(proj_dims=proj)), opt_t,
        round_engine.EngineConfig(num_clusters=2, lam=toy.LAM))
    pt, _, st, mt = t_round(
        p0, opt_t.init(p0), cluster.init_cluster_state(p0, opt_t.init(p0), 2,
                                                       dim),
        utils.tree_map(lambda x: torch.tensor(np.asarray(x)), batch),
        torch.tensor(np.asarray(sizes)))
    np.testing.assert_allclose(st.centroids.numpy(), np.asarray(sj.centroids),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(mt.loss.item(), float(mj.loss), rtol=1e-4)
    ref = convert.params_from_jax(jax.tree.map(np.asarray, pj))
    assert utils.tree_max_abs_diff(pt, ref) < 1e-3 * utils.tree_max_abs_diff(
        ref, p0)
    for c in range(2):
        got = utils.tree_map(lambda x: x[c], st.params_c)
        ref_c = convert.params_from_jax(
            jax.tree.map(lambda x: np.asarray(x[c]), sj.params_c))
        upd = utils.tree_max_abs_diff(ref_c, p0)
        assert upd > 0 and utils.tree_max_abs_diff(got, ref_c) < 1e-3 * upd
