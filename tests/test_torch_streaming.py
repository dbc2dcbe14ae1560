"""Streaming cohorts (``EngineConfig.cohort_chunk``,
``hierarchy.streaming_stats_round``), port vs reference and port vs
itself, on the CPU.

The reference's round is fed the same cohort chunks as the port's (sliced
from one numpy cohort) and its draws are carried over: each chunk's
quantized uniforms come from the reference's key ``fold_in(fold_in(key,
c), PHASE_SALT[phase])`` (a tree's client hop from its client key), split
per leaf in ``jax.tree.flatten`` order; a dropout mask is carried as
uniforms below or above ``1 - p``.

Tolerances: one toy round is held to 1e-4 of its update, ``max|p_port -
p_ref| / max|p_ref - p_0|`` (each fold sums in another order on each side;
tests/test_torch_hierarchy.py), the loss to rtol 1e-5 and the uplink bytes
exactly; the smoke ResNet (``resnet_groups=2``, tests/test_torch_round.py
says why) to 1e-3 of its update and rtol 1e-4. Streamed against
materialized inside the port, lossless, the two differ only by the
grouping of the Eq.-3 sums: 1e-4 of the update on the toy, 2e-3 on the
ResNet (the fused-vs-off bound of tests/test_torch_round.py). The
sampler's chunks are the materialized cohort bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_toy as toy
from repro import hierarchy as j_hier
from repro import objectives as j_objectives
from repro.comm import channel as j_channel
from repro.configs.base import DualEncoderConfig as JDE
from repro.configs.base import get_config as j_get_config
from repro.data import partition as j_partition
from repro.data import pipeline as j_pipeline
from repro.data import synthetic as j_synthetic
from repro.models import dual_encoder as j_de
from repro.optim import optimizers as j_opt
from repro_torch import convert, utils
from repro_torch.comm import channel
from repro_torch.configs.base import DualEncoderConfig, get_config
from repro_torch.core import fed_sim, round_engine
from repro_torch.data import partition, pipeline, synthetic
from repro_torch.hierarchy import (HierarchicalChannel, StreamingSampler,
                                   streaming_stats_round)
from repro_torch.launch import train
from repro_torch.launch.train import make_apply
from repro_torch.objectives import get_objective
from repro_torch.optim import optimizers as opt_lib

# tier-1 runs 6 pytest workers on the machine's cores: one torch thread
# per worker keeps them from contending with each other and with JAX
torch.set_num_threads(1)

K, CHUNK, LR = 8, 4, 0.05
SIZES = np.array([3, 2, 3, 1, 3, 2, 3, 3], np.int32)
PROJ = (64, 64)


def _rel(port, ref, start):
    return (utils.tree_max_abs_diff(port, ref)
            / utils.tree_max_abs_diff(ref, start))


def _ref_uniforms(key, shapes):
    """The reference quantized channel's uniforms for a payload of leaf
    ``shapes`` (a dict), one (chunk, n_total) draw split per leaf in
    ``jax.tree.flatten`` order."""
    leaves, treedef = jax.tree.flatten(
        {n: jnp.zeros(s, jnp.float32) for n, s in shapes.items()})
    k = leaves[0].shape[0]
    sizes = [int(np.prod(x.shape[1:])) for x in leaves]
    flat = np.asarray(jax.random.uniform(key, (k, sum(sizes))))
    parts = np.split(flat, np.cumsum(sizes)[:-1], axis=1)
    return jax.tree.unflatten(treedef, [
        torch.tensor(p.reshape(x.shape)) for p, x in zip(parts, leaves)])


def _channels(case):
    """(reference channel, port channel) of a case, or (None, None)."""
    if case == "int8":
        return j_channel.QuantizedChannel(8), channel.QuantizedChannel(8)
    if case == "tree":          # 4 edges of 2 clients: 2 edges a chunk
        return (j_hier.HierarchicalChannel(
                    4, client_channel=j_channel.QuantizedChannel(8)),
                HierarchicalChannel(
                    4, client_channel=channel.QuantizedChannel(8)))
    if case == "tree_outage":   # 2 edges of 4 clients, one may fail
        return (j_hier.HierarchicalChannel(
                    2, client_channel=j_channel.QuantizedChannel(8),
                    edge_channel=j_channel.DropoutChannel(0.5)),
                HierarchicalChannel(
                    2, client_channel=channel.QuantizedChannel(8),
                    edge_channel=channel.DropoutChannel(0.5)))
    if case == "dropout":
        return j_channel.DropoutChannel(0.3), channel.DropoutChannel(0.3)
    return None, None


def _port_draws(case, j_ch, key, payloads):
    """The port's ``channel_draws`` carrying the reference's: begin-round
    masks and, per chunk and phase, the quantized uniforms."""
    j_ctx = j_ch.begin_round(key, jnp.asarray(SIZES))
    draws = {}
    if case == "dropout":
        draws["begin"] = torch.tensor(np.asarray(jax.random.uniform(
            jax.random.split(key)[0], (K,))))
    if case == "tree_outage":
        emask = np.asarray(j_ctx.edge_ctx.mask)
        draws["begin"] = {"edge": torch.tensor(
            np.where(emask > 0, 0.0, 0.9), dtype=torch.float32)}
    if case in ("int8", "tree", "tree_outage"):
        wire_key = j_ctx.key if case == "int8" else j_ctx.client_ctx.key
        for phase, shapes in payloads.items():
            per_chunk = []
            for c in range(K // CHUNK):
                u = _ref_uniforms(jax.random.fold_in(
                    jax.random.fold_in(wire_key, c),
                    j_channel.PHASE_SALT[phase]), shapes)
                per_chunk.append(u if case == "int8" else {"client": u})
            draws[phase] = per_chunk
    return draws, j_ctx


def _outage_key():
    """A channel key whose reference edge mask drops one of two edges."""
    for seed in range(64):
        key = jax.random.PRNGKey(seed)
        j_ch = _channels("tree_outage")[0]
        mask = np.asarray(j_ch.begin_round(key, jnp.asarray(SIZES))
                          .edge_ctx.mask)
        if mask.sum() == 1:
            return seed, key
    raise AssertionError("no key drops exactly one edge")


def _ref_round(apply, p0, cohort, objective, j_ch, key, **kw):
    """The reference's streamed round over the cohort's CHUNK-client
    slices."""
    opt = j_opt.sgd(LR)

    def sample_chunk(c):
        return (jax.tree.map(lambda x: jax.lax.dynamic_slice_in_dim(
                    x, c * CHUNK, CHUNK), cohort["batch"]),
                jax.lax.dynamic_slice_in_dim(cohort["sizes"], c * CHUNK,
                                             CHUNK))

    return jax.jit(lambda p, o: j_hier.streaming_stats_round(
        apply, p, o, opt, sample_chunk, K // CHUNK, cohort["sizes"],
        objective=objective, channel=j_ch,
        channel_key=None if j_ch is None else key, **kw))(p0, opt.init(p0))


def _port_round(apply, p0, batch, sizes, objective, t_ch=None, key=None,
                draws=None, **kw):
    opt = opt_lib.sgd(LR)

    def sample_chunk(c):
        return (utils.tree_map(lambda x: x[c * CHUNK:(c + 1) * CHUNK], batch),
                sizes[c * CHUNK:(c + 1) * CHUNK])

    return streaming_stats_round(
        apply, p0, opt.init(p0), opt, sample_chunk, K // CHUNK, sizes,
        objective=objective, channel=t_ch, channel_key=key,
        channel_draws=draws, **kw)


CASES = ["lossless", "int8", "tree", "tree_outage", "dropout", "dvicreg",
         "prox"]


@pytest.mark.parametrize("case", CASES)
def test_toy_streamed_round_matches_reference(case):
    pool = toy.pool_np()
    batch = {v: x[:K] for v, x in pool.items()}
    p0 = toy.params_np()
    obj = "dvicreg" if case == "dvicreg" else "dcco"
    hyper = {"lam": toy.LAM} if obj == "dcco" else {}
    kw = (dict(local_steps=2, prox_mu=0.01, client_lr=0.05)
          if case == "prox" else dict(client_lr=LR))
    j_ch, t_ch = _channels(case)
    seed = 17
    key = jax.random.PRNGKey(seed)
    if case == "tree_outage":
        seed, key = _outage_key()
    t_obj = get_objective(obj, **hyper)
    payloads = {
        "stats": {n: (CHUNK,) + s for n, s in
                  t_obj.stat_spec(toy.DIM_OUT).items()},
        "update": {n: (CHUNK,) + v.shape for n, v in p0.items()}}
    draws = None
    if j_ch is not None:
        draws, j_ctx = _port_draws(case, j_ch, key, payloads)
    cohort = {"batch": toy.to_jax(batch), "sizes": jnp.asarray(SIZES)}
    pj, _, mj = _ref_round(toy.j_apply, toy.to_jax(p0), cohort,
                           j_objectives.get_objective(obj, **hyper), j_ch,
                           key, **kw)
    pt0 = toy.to_torch(p0)
    pt, _, mt = _port_round(toy.t_apply, pt0, toy.to_torch(batch),
                            torch.tensor(SIZES), t_obj, t_ch,
                            None if t_ch is None else seed, draws, **kw)
    if case == "tree_outage":
        np.testing.assert_array_equal(
            t_ch.begin_round(seed, torch.tensor(SIZES),
                             draws["begin"]).mask.numpy(),
            np.asarray(j_ctx.mask))
    assert _rel(pt, toy.to_torch(pj), pt0) <= 1e-4
    np.testing.assert_allclose(mt.loss.item(), float(mj.loss), rtol=1e-5)
    np.testing.assert_allclose(mt.encoding_std.item(),
                               float(mj.encoding_std), rtol=1e-5)
    assert mt.wire_bytes.item() == float(mj.wire_bytes)
    assert (mt.wire_bytes.item() > 0) == (j_ch is not None)


@pytest.fixture(scope="module")
def resnet():
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
    batch, sizes = ds.round_batch(jax.random.PRNGKey(42), K)

    def j_apply(p, b):
        zf, _ = j_de.encode(jcfg, JDE(proj_dims=PROJ), p, {"images": b["v1"]})
        zg, _ = j_de.encode(jcfg, JDE(proj_dims=PROJ), p, {"images": b["v2"]})
        return zf, zg

    return {"jp": jp, "batch": batch, "sizes": sizes, "j_apply": j_apply,
            "t_apply": make_apply(tcfg, DualEncoderConfig(proj_dims=PROJ))}


def test_resnet_streamed_round_matches_reference_and_materialized(resnet):
    s = resnet
    p0 = convert.params_from_jax(jax.tree.map(np.asarray, s["jp"]))
    batch = utils.tree_map(lambda x: torch.tensor(np.asarray(x)), s["batch"])
    sizes = torch.tensor(np.asarray(s["sizes"]))
    pj, _, mj = _ref_round(
        s["j_apply"], s["jp"], {"batch": s["batch"], "sizes": s["sizes"]},
        j_objectives.get_objective("dcco", lam=toy.LAM), None, None,
        client_lr=1.0)
    obj = get_objective("dcco", lam=toy.LAM)
    pt, _, mt = _port_round(s["t_apply"], p0, batch, sizes, obj,
                            client_lr=1.0)
    ref = convert.params_from_jax(jax.tree.map(np.asarray, pj))
    assert _rel(pt, ref, p0) < 1e-3
    np.testing.assert_allclose(mt.loss.item(), float(mj.loss), rtol=1e-4)
    opt = opt_lib.sgd(LR)
    pm, _, mm = fed_sim.stats_round(s["t_apply"], p0, opt.init(p0), opt,
                                    batch, sizes, objective=obj)
    assert _rel(pt, pm, p0) < 2e-3
    np.testing.assert_allclose(mt.loss.item(), mm.loss.item(), rtol=1e-4)


@pytest.mark.parametrize("case", ["lossless", "dvicreg", "dwmse", "prox"])
def test_toy_streamed_equals_materialized_in_the_port(case):
    pool = toy.pool_np()
    batch, sizes = ({v: x[:K] for v, x in pool.items()},
                    torch.tensor(SIZES))
    obj = get_objective(case) if case in ("dvicreg", "dwmse") else \
        get_objective("dcco", lam=toy.LAM)
    kw = (dict(local_steps=2, prox_mu=0.01, client_lr=0.05)
          if case == "prox" else dict(client_lr=LR))
    p0 = toy.to_torch(toy.params_np())
    pt, _, mt = _port_round(toy.t_apply, p0, toy.to_torch(batch), sizes,
                            obj, **kw)
    opt = opt_lib.sgd(LR)
    pm, _, mm = fed_sim.stats_round(toy.t_apply, p0, opt.init(p0), opt,
                                    toy.to_torch(batch), sizes,
                                    objective=obj, **kw)
    assert _rel(pt, pm, p0) <= 1e-4
    np.testing.assert_allclose(mt.loss.item(), mm.loss.item(), rtol=1e-5)
    # a dense wire streams bit for bit like no wire at all
    pd, _, md = _port_round(toy.t_apply, p0, toy.to_torch(batch), sizes,
                            obj, channel.DenseChannel(), 3, **kw)
    assert utils.tree_max_abs_diff(pd, pt) == 0.0
    assert md.loss.item() == mt.loss.item() and md.wire_bytes.item() > 0


# ------------------------------------------------------------ sampler --

def _dataset(leaf):
    if leaf == "images":
        x, labels = synthetic.synthetic_labeled_images(96, 4, image_size=16,
                                                       noise=0.5, seed=1)
    else:
        x, labels = synthetic.synthetic_labeled_tokens(96, 4, 16, 512,
                                                       seed=1)
    return pipeline.FederatedDataset.build(
        {leaf: x}, labels, num_clients=32, samples_per_client=3,
        partition=partition.PartitionSpec("dirichlet_quantity",
                                          severity=0.7), seed=0)


@pytest.mark.parametrize("leaf", ["images", "tokens"])
def test_streaming_sampler_chunks_are_the_round_samplers_cohort(leaf):
    ds = _dataset(leaf)
    stream = ds.make_streaming_sampler(12, 4, "cpu")
    assert isinstance(stream, StreamingSampler) and stream.num_chunks == 3
    batch, sizes = ds.make_round_sampler(12, "cpu")(
        torch.Generator().manual_seed(5))
    state = stream.prepare(torch.Generator().manual_seed(5))
    chunks = [stream.sample_chunk(state, c) for c in range(3)]
    for view in ("v1", "v2"):
        assert torch.equal(torch.cat([b[view] for b, _ in chunks]),
                           batch[view])
    assert torch.equal(torch.cat([s for _, s in chunks]), sizes)
    assert torch.equal(stream.cohort_sizes(state), sizes)
    assert len(set(sizes.tolist())) > 1          # variable-size clients
    # phase 2 replays a chunk: the same bits again
    assert torch.equal(stream.sample_chunk(state, 1)[0]["v1"],
                       chunks[1][0]["v1"])
    with pytest.raises(ValueError, match="chunks of 5"):
        ds.make_streaming_sampler(12, 5, "cpu")


def test_engine_streams_the_materialized_engines_cohorts(resnet):
    """The streamed engine draws its cohorts from the round generator the
    materialized engine does: two rounds agree within the regrouping
    bound, and a retrieval-free run's metrics line up."""
    s = resnet
    ds = _dataset("images")
    p0 = convert.params_from_jax(jax.tree.map(np.asarray, s["jp"]))
    opt = opt_lib.sgd(LR)
    base = round_engine.EngineConfig(lam=toy.LAM, chunk_rounds=2,
                                     stats_kernel="off")
    pm, _, mm = round_engine.RoundEngine(
        s["t_apply"], opt, ds.make_round_sampler(8, "cpu"), base).run(
            p0, opt.init(p0), 3, 1)
    eng = round_engine.RoundEngine(
        s["t_apply"], opt, ds.make_streaming_sampler(8, 2, "cpu"),
        base._replace(cohort_chunk=2, stats_kernel=None))
    ps, _, ms = eng.run(p0, opt.init(p0), 3, 1)
    assert _rel(ps, pm, p0) < 2e-3
    np.testing.assert_allclose(ms.loss.numpy(), mm.loss.numpy(), rtol=1e-4)
    assert ms.applied.tolist() == [1.0]
    # start_round resumes the streamed run's round stream, bit for bit
    p2, o2, m2 = eng.run(p0, opt.init(p0), 3, 2)
    p_r, o_r, _ = eng.run(ps, opt.init(p0), 3, 1, start_round=1)
    assert utils.tree_max_abs_diff(p_r, p2) == 0.0
    assert m2.loss[0].item() == ms.loss[0].item()


# ----------------------------------------------------------- refusals --

def test_engine_refusals_match_reference():
    ds = _dataset("images")
    stream = ds.make_streaming_sampler(8, 2, "cpu")
    opt = opt_lib.sgd(LR)
    base = round_engine.EngineConfig(cohort_chunk=2)

    def build(cfg, sampler=stream):
        return round_engine.RoundEngine(toy.t_apply, opt, sampler, cfg)

    with pytest.raises(ValueError, match="chunkable sampler"):
        build(base, ds.make_round_sampler(8, "cpu"))
    with pytest.raises(ValueError, match="two-phase stats round only"):
        build(base._replace(algorithm="fedavg_cco"))
    with pytest.raises(ValueError, match="SCAFFOLD"):
        build(base._replace(scaffold=True))
    with pytest.raises(ValueError, match="never\\s+materializes"):
        build(base._replace(stats_kernel="fused"))
    with pytest.raises(ValueError, match="cohort_chunk=4"):
        build(base._replace(cohort_chunk=4))
    with pytest.raises(ValueError, match="cohort_chunk never"):
        build(base._replace(num_clusters=3))
    with pytest.raises(ValueError, match="two schedulers"):
        build(base._replace(async_k=4))
    with pytest.raises(ValueError, match=">= 0"):
        build(base._replace(cohort_chunk=-1))
    # a tree whose edges do not fit the chunk refuses the fold
    ch = HierarchicalChannel(2, client_channel=channel.QuantizedChannel(8))
    ctx = ch.begin_round(0, torch.tensor(SIZES))
    with pytest.raises(ValueError, match="whole edges"):
        ch.chunk_fold(ctx, {"x": torch.ones(2, 3)}, "stats", 0,
                      ctx.weights[:2])          # 2 < edge size 4


SMALL = ["--device", "cpu", "--rounds", "1", "--dataset-size", "48",
         "--clients-per-round", "8"]


@pytest.mark.parametrize("flags, match", [
    (["--cohort-chunk", "2", "--clusters", "2"], "drop one"),
    (["--cohort-chunk", "2", "--async-k", "4"], "two schedulers"),
    (["--cohort-chunk", "3"], "does not divide"),
    (["--cohort-chunk", "2", "--edges", "2"], "whole edges"),
    (["--cohort-chunk", "2", "--scaffold"], "--scaffold would be"),
    (["--cohort-chunk", "2", "--stats-kernel", "off"], "--stats-kernel"),
    (["--cohort-chunk", "2", "--mode", "protocol"], "--cohort-chunk"),
])
def test_cli_refusals_match_reference(flags, match):
    with pytest.raises(SystemExit, match=match):
        train.parse_args([*SMALL, *flags])


def test_cli_streams_over_the_int8_tree_on_cpu(capsys):
    res = train.main([*SMALL, "--rounds", "2", "--eval-every", "1",
                      "--cohort-chunk", "4", "--edges", "4", "--channel",
                      "int8", "--client-lr", "0.001"])
    assert res["loss_finite"] and len(res["history"]) == 2
    assert res["edge_bytes"] > 0 and res["wire_bytes"] > res["edge_bytes"]
    assert "uplink per hop" in capsys.readouterr().out
