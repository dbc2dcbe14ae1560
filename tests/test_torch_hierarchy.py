"""The two-level client -> edge -> server tree, port vs reference, on the
CPU (where the segment-sum wrapper runs its plain version).

Inputs are numpy arrays handed to both sides; a toy dual encoder
(tests/_torch_toy.py) drives the rounds. Randomness never agrees between
JAX and torch, so the port is given the reference's draws: the client
hop's uniforms (split per leaf in ``jax.tree.flatten`` order, from the
reference's key ``fold_in(split(key)[0], PHASE_SALT[phase])``) and the
edge hop's dropout mask (as uniforms below or above ``1 - p``).

Tolerances: a fold of K <= 12 weighted rows sums in another order on each
side (the reference's scatter-add, the port's ascending k), a few f32 ulps
of unit-scale values: rtol 1e-5, atol 1e-6. Quantization of identical
inputs with identical uniforms is bit-equal on both sides
(tests/test_torch_comm.py), so the int8 tree is held to the same
tolerance. One int8 round of the toy model is held to 1e-4 of its update
(its parameters see one f32 regrouping of each fold; measured ~1e-6).
Inside the port, a dense-dense tree is the flat sum bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_toy as toy
from repro import hierarchy as j_hier
from repro.comm import channel as j_channel
from repro.core import fed_sim as j_fed_sim
from repro.optim import optimizers as j_opt
from repro_torch import utils
from repro_torch.comm import channel
from repro_torch.core import fed_sim, round_engine
from repro_torch.hierarchy import (HierarchicalChannel, contiguous_edge_ids,
                                   fold_to_edges)
from repro_torch.objectives import get_objective
from repro_torch.optim import optimizers as opt_lib

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
K, E, D = 12, 4, 5


def _payload(seed, k=K):
    rng = np.random.RandomState(seed)
    return {"mean_f": rng.randn(k, D), "sq_f": rng.rand(k, D),
            "mean_g": rng.randn(k, D), "sq_g": rng.rand(k, D),
            "cross": rng.randn(k, D, D)}


def _np32(tree):
    return {key: np.asarray(v, np.float32) for key, v in tree.items()}


def _sizes(seed, k=K):
    return np.random.RandomState(seed).randint(1, 5, k).astype(np.int32)


def _close(port, ref):
    for key in ref:
        np.testing.assert_allclose(np.asarray(port[key]), np.asarray(ref[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)


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


def test_contiguous_edge_ids_and_fold_match_reference():
    np.testing.assert_array_equal(
        contiguous_edge_ids(K, E).numpy(),
        np.asarray(j_hier.contiguous_edge_ids(K, E)))
    with pytest.raises(ValueError, match="equal edges"):
        contiguous_edge_ids(10, 4)
    tree = _np32(_payload(0))
    w = np.random.RandomState(1).rand(K).astype(np.float32)
    ids = np.random.RandomState(2).randint(0, E, K).astype(np.int32)
    port = fold_to_edges(toy.to_torch(tree), torch.tensor(w),
                         torch.tensor(ids), E)
    for impl in ("jnp", "interpret"):
        ref = j_hier.fold_to_edges(toy.to_jax(tree), jnp.asarray(w),
                                   jnp.asarray(ids), E, impl)
        _close(port, ref)
    assert port["cross"].shape == (E, D, D)


@pytest.mark.parametrize("collapse", [True, False])
def test_dense_tree_is_the_flat_sum(collapse):
    """Both hops dense: collapsed, the tree IS the flat sum (== 0.0);
    forced through the fold, it equals it to f32 regrouping."""
    tree = toy.to_torch(_np32(_payload(3)))
    sizes = torch.tensor(_sizes(4))
    flat_ch = channel.DenseChannel()
    flat = flat_ch.aggregate(flat_ch.begin_round(7, sizes), tree, "stats")
    tree_ch = HierarchicalChannel(E, collapse_ideal=collapse)
    assert tree_ch.collapses == collapse
    assert tree_ch.supports_flat_stats == collapse
    ctx = tree_ch.begin_round(7, sizes)
    out = tree_ch.aggregate(ctx, tree, "stats")
    for key in flat:
        if collapse:
            assert torch.equal(out[key], flat[key]), key
        else:
            torch.testing.assert_close(out[key], flat[key], rtol=RTOL,
                                       atol=ATOL)


def test_int8_client_hop_dense_edge_hop_matches_reference():
    tree = _np32(_payload(5))
    sizes = _sizes(6)
    key = jax.random.PRNGKey(11)
    j_ch = j_hier.HierarchicalChannel(
        E, client_channel=j_channel.QuantizedChannel(8))
    j_ctx = j_ch.begin_round(key, jnp.asarray(sizes))
    ref = j_ch.aggregate(j_ctx, toy.to_jax(tree), "stats")
    k_client = jax.random.split(key)[0]
    u = _ref_uniforms(
        jax.random.fold_in(k_client, j_channel.PHASE_SALT["stats"]),
        toy.to_jax(tree))

    t_ch = HierarchicalChannel(E, client_channel=channel.QuantizedChannel(8))
    assert not t_ch.collapses and not t_ch.supports_flat_stats
    ctx = t_ch.begin_round(11, torch.tensor(sizes))
    np.testing.assert_array_equal(ctx.edge_ids.numpy(),
                                  np.asarray(j_ctx.edge_ids))
    np.testing.assert_allclose(ctx.weights.numpy(), np.asarray(j_ctx.weights),
                               rtol=1e-6)
    port = t_ch.aggregate(ctx, toy.to_torch(tree), "stats",
                          draws={"client": u})
    _close(port, ref)
    # the wire is lossy: the result is not the flat dense sum
    flat = channel.DenseChannel().aggregate(
        channel.DenseChannel().begin_round(0, torch.tensor(sizes)),
        toy.to_torch(tree), "stats")
    assert max(float((port[k] - flat[k]).abs().max()) for k in flat) > 0
    # per-hop bytes: K int8 client payloads and E f32 edge payloads
    template = {k: v[0] for k, v in toy.to_torch(tree).items()}
    hops = t_ch.hop_bytes(ctx, template)
    j_hops = j_ch.hop_bytes(j_ctx, {k: v[0] for k, v in tree.items()})
    for name in ("client_edge", "edge_server"):
        assert float(hops[name]) == float(j_hops[name]), name
    n = sum(v.numel() for v in template.values())
    assert float(hops["edge_server"]) == E * 4 * n
    assert float(hops["client_edge"]) == K * (n + 4 * len(template))
    assert float(t_ch.round_bytes(ctx, template)) == float(
        hops["client_edge"] + hops["edge_server"])


def _outage(seed):
    """The reference's edge-outage round (p = 0.5), its mask carried to the
    port as uniforms on either side of 1 - p."""
    tree = _np32(_payload(seed))
    sizes = _sizes(seed + 1)
    key = jax.random.PRNGKey(seed)
    j_ch = j_hier.HierarchicalChannel(
        E, edge_channel=j_channel.DropoutChannel(0.5))
    j_ctx = j_ch.begin_round(key, jnp.asarray(sizes))
    emask = np.asarray(j_ctx.edge_ctx.mask)
    u_edge = torch.tensor(np.where(emask > 0, 0.0, 0.9), dtype=torch.float32)
    return tree, sizes, j_ch, j_ctx, emask, u_edge


def test_edge_outage_renormalises_over_survivors_like_reference():
    tree, sizes, j_ch, j_ctx, emask, u_edge = _outage(3)
    assert 0 < emask.sum() < E            # some edges down, some up
    t_ch = HierarchicalChannel(E, edge_channel=channel.DropoutChannel(0.5))
    assert not t_ch.full_participation and not t_ch.collapses
    ctx = t_ch.begin_round(3, torch.tensor(sizes), draws={"edge": u_edge})
    np.testing.assert_array_equal(ctx.edge_ctx.mask.numpy(), emask)
    np.testing.assert_array_equal(ctx.mask.numpy(), np.asarray(j_ctx.mask))
    np.testing.assert_allclose(ctx.weights.numpy(), np.asarray(j_ctx.weights),
                               rtol=1e-6, atol=1e-7)
    assert float(ctx.num_participants) == float(j_ctx.num_participants)
    # the dropped clients carry no weight; the survivors' weights sum to 1
    dropped = ctx.mask.numpy() == 0
    assert dropped.any() and not ctx.weights.numpy()[dropped].any()
    np.testing.assert_allclose(float(ctx.weights.sum()), 1.0, rtol=1e-6)
    port = t_ch.aggregate(ctx, toy.to_torch(tree), "update")
    _close(port, j_ch.aggregate(j_ctx, toy.to_jax(tree), "update"))


def test_semantic_edge_ids_recompose_like_reference():
    """with_edge_ids: a cluster assignment re-routes the tree; an edge may
    be empty."""
    tree, sizes, j_ch, j_ctx, emask, u_edge = _outage(3)
    ids = np.array([2, 0, 0, 2, 1, 2, 0, 0, 2, 1, 0, 2], np.int32)  # none: 3
    j_ctx2 = j_ch.with_edge_ids(j_ctx, jnp.asarray(ids))
    t_ch = HierarchicalChannel(E, edge_channel=channel.DropoutChannel(0.5))
    ctx = t_ch.begin_round(3, torch.tensor(sizes), draws={"edge": u_edge})
    ctx2 = t_ch.with_edge_ids(ctx, torch.tensor(ids), draws=u_edge)
    np.testing.assert_array_equal(ctx2.edge_ids.numpy(), ids)
    np.testing.assert_array_equal(ctx2.mask.numpy(), np.asarray(j_ctx2.mask))
    np.testing.assert_allclose(ctx2.weights.numpy(),
                               np.asarray(j_ctx2.weights), rtol=1e-6,
                               atol=1e-7)
    port = t_ch.aggregate(ctx2, toy.to_torch(tree), "stats")
    _close(port, j_ch.aggregate(j_ctx2, toy.to_jax(tree), "stats"))


@pytest.mark.parametrize("make", [
    lambda: HierarchicalChannel(0),
    lambda: HierarchicalChannel(2, client_channel=channel.DPGaussianChannel()),
    lambda: HierarchicalChannel(2, edge_channel=channel.DPGaussianChannel()),
    lambda: HierarchicalChannel(2, client_channel=HierarchicalChannel(2)),
    lambda: HierarchicalChannel(2, edge_channel=HierarchicalChannel(2)),
])
def test_tree_refusals(make):
    with pytest.raises(ValueError):
        make()


def _cohort(k=6):
    pool = toy.pool_np()
    return ({v: x[:k] for v, x in pool.items()},
            np.array([3, 2, 3, 1, 3, 2][:k], np.int32))


def test_one_int8_tree_round_matches_reference():
    """One DCCO round of the toy model through an int8 client hop and a
    dense edge hop, given the reference's uniforms for both uplinks."""
    batch, sizes = _cohort()
    p0 = toy.params_np()
    lr, key = 0.05, jax.random.PRNGKey(17)
    j_ch = j_hier.HierarchicalChannel(
        3, client_channel=j_channel.QuantizedChannel(8))
    opt_j = j_opt.sgd(lr)
    j_round = jax.jit(lambda p, o, b, s, k: j_fed_sim.dcco_round(
        toy.j_apply, p, o, opt_j, b, s, lam=toy.LAM, channel=j_ch,
        channel_key=k))
    pj, _, mj = j_round(toy.to_jax(p0), opt_j.init(toy.to_jax(p0)),
                        toy.to_jax(batch), jnp.asarray(sizes), key)
    k_client = jax.random.split(key)[0]
    spec = get_objective("dcco").stat_spec(toy.DIM_OUT)
    u_stats = _ref_uniforms(
        jax.random.fold_in(k_client, j_channel.PHASE_SALT["stats"]),
        {k: np.zeros((6,) + s, np.float32) for k, s in spec.items()})
    u_upd = _ref_uniforms(
        jax.random.fold_in(k_client, j_channel.PHASE_SALT["update"]),
        {k: np.zeros((6,) + v.shape, np.float32) for k, v in p0.items()})

    t_ch = HierarchicalChannel(3, client_channel=channel.QuantizedChannel(8))
    opt_t = opt_lib.sgd(lr)
    pt0 = toy.to_torch(p0)
    pt, _, mt = fed_sim.dcco_round(
        toy.t_apply, pt0, opt_t.init(pt0), opt_t, toy.to_torch(batch),
        torch.tensor(sizes), lam=toy.LAM, channel=t_ch, channel_key=17,
        channel_draws={"stats": {"client": u_stats},
                       "update": {"client": u_upd}})
    upd = toy.max_diff(pj, p0)
    assert upd > 0
    assert toy.max_diff(pt, pj) <= 1e-4 * upd
    np.testing.assert_allclose(mt.loss.item(), float(mj.loss), rtol=1e-5)
    assert mt.wire_bytes.item() == float(mj.wire_bytes)
    # the edge hop's share: 3 dense edge payloads of stats and of deltas
    n = sum(int(np.prod(s)) for s in spec.values()) + sum(
        v.size for v in p0.values())
    assert mt.edge_bytes.item() == 3 * 4 * n


def test_engine_dense_tree_is_bit_identical_to_flat_and_counts_both_hops():
    """Through the engine: a collapsing tree keeps the flat phase-1 kernel
    path and equals the channel-less run bit for bit; its wire counts K
    client and E edge payloads a phase."""
    pool = toy.to_torch(toy.pool_np())

    def sampler(gen):
        sel = torch.randperm(toy.N_CLIENTS, generator=gen)[:6]
        return ({k: v[sel] for k, v in pool.items()},
                torch.full((6,), toy.N_PER, dtype=torch.int32))

    p0 = toy.to_torch(toy.params_np())
    opt = opt_lib.adam(1e-2)
    runs = {}
    for name, ch in (("flat", None), ("tree", HierarchicalChannel(3))):
        eng = round_engine.RoundEngine(
            toy.t_apply, opt, sampler,
            round_engine.EngineConfig(lam=toy.LAM, chunk_rounds=2, channel=ch))
        runs[name] = eng.run(p0, opt.init(p0), 5, 3)
    assert utils.tree_max_abs_diff(runs["flat"][0], runs["tree"][0]) == 0.0
    assert torch.equal(runs["flat"][2].loss, runs["tree"][2].loss)
    m = runs["tree"][2]
    spec = get_objective("dcco").stat_spec(toy.DIM_OUT)
    n = sum(int(np.prod(s)) for s in spec.values()) + sum(
        x.numel() for x in utils.tree_leaves(p0))
    assert m.wire_bytes.tolist() == [(6 + 3) * 4 * n] * 3
    assert m.edge_bytes.tolist() == [3 * 4 * n] * 3
    assert not runs["flat"][2].edge_bytes.any()
