"""The cohort sharded over devices, port vs reference and port vs itself,
on a gloo world of 2 CPU ranks (tests/_torch_dist.py).

``stats_round_sharded`` on the toy cohort of tests/_torch_sharded_ref.py
(16 clients of up to 3 samples): lossless D-CCO and D-VICReg against the
reference's unsharded ``fed_sim.stats_round`` on one device (its own
tests hold that equal to its sharded round), to 1e-4 of the update
(``max|p_port - p_ref| / max|p_ref - p_0|``; the Eq.-3 sums regroup on
both sides), the loss to rtol 1e-5; int8 and an int8 client hop into 8
edges against the reference's sharded round on 2 forced CPU devices, fed
its rank-folded uniforms, to 1e-3 of the update (a value at a rounding
boundary moves by a quantization step, 1/127 of its client's scale), the
uplink bytes exactly. Inside the port the lossless sharded round is the
unsharded one up to the same regrouping (1e-4 of the update), the ranks
agree bit for bit, DenseChannel equals no channel bit for bit, and a
world of one equals the unsharded round bit for bit. SCAFFOLD's params,
server variate and gathered slot variates are held to the unsharded
port's and the reference's at 1e-4 of their size. Three engine rounds
over ``cohort_axis`` against the unsharded engine: 1e-4 of the update.
The shard_map losses of D-CCO, D-VICReg and D-WMSE: the value to rtol
1e-5 and the gradient summed over ranks to 1e-4 of its largest entry
against the port's fused loss and the reference's ``jax.grad``; one
``make_dcco_train_step(mesh=)`` step of the smoke ResNet, at micro 1 and
2, to 1e-4 (micro 2: 1e-3) of the update against the port's fused step
and 1e-3 against the reference's.
The sharded corpus equals the port's unsharded search bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_dist as td
import _torch_sharded_ref as sref
from repro import objectives as j_objectives
from repro.comm import channel as j_channel
from repro.configs.base import DualEncoderConfig as JDE
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.base import get_config as j_get_config
from repro.core import dcco as j_dcco
from repro.core import fed_sim as j_fed_sim
from repro.hierarchy import HierarchicalChannel as JHier
from repro.kernels import mips_topk as j_mips
from repro.launch import steps as j_steps
from repro.models import dual_encoder as j_de
from repro.optim import optimizers as j_opt
from repro.server import drift as j_drift
from repro_torch import comm, convert, utils
from repro_torch.configs.base import (DualEncoderConfig, TrainConfig,
                                      get_config)
from repro_torch.core import dcco, fed_sim, round_engine
from repro_torch.hierarchy import HierarchicalChannel
from repro_torch.kernels.mips_topk import mips_topk
from repro_torch.launch import steps
from repro_torch.objectives import get_objective
from repro_torch.optim import optimizers as opt_lib
from repro_torch.server import drift
from repro_torch.sharding import maybe_initialize_distributed

torch.set_num_threads(1)

LAM, LR, WORLD = td.LAM, td.LR, 2
STEP_LR = 0.005


def _rel(port, ref, start):
    return (utils.tree_max_abs_diff(port, ref)
            / utils.tree_max_abs_diff(ref, start))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------ the inputs --

def _loss_inputs():
    rng = np.random.RandomState(5)
    x = rng.randn(12, 5).astype(np.float32)
    y = (0.6 * x + 0.8 * rng.randn(12, 5)).astype(np.float32)
    w = (rng.randn(5, 4) * 0.7).astype(np.float32)
    return x, y, w


def _resnet():
    jcfg = j_get_config("resnet14-cifar", smoke=True).replace(
        resnet_groups=2)
    jp = jax.jit(j_de.init_dual_encoder, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jcfg, JDE(proj_dims=(64, 64), lambda_cco=LAM))
    rng = np.random.RandomState(3)
    views = [rng.rand(8, 16, 16, 3).astype(np.float32) for _ in range(2)]
    return jcfg, jp, views


def _corpus():
    """101 unit rows of d 8 over 2 shards of 51; row 60 (shard 1)
    duplicates row 3 (shard 0), so the two tie on equal bits."""
    rng = np.random.RandomState(9)
    emb = rng.randn(101, 8).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb[60] = emb[3]
    q = emb[:6] + 0.01 * rng.randn(6, 8).astype(np.float32)
    return emb, q


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' outputs of one world of 2 running every task, with the
    inputs it was given."""
    params, batch, sizes = sref.cohort()
    pt = sref.to_torch(params)
    payloads = sref.payload_shapes(params)
    pool_p, pool_b, pool_s = sref.cohort(seed=1)
    x, y, w = _loss_inputs()
    _, jp, views = _resnet()
    emb, q = _corpus()
    inputs = {
        "rounds": {"axis": "data", "params": pt,
                   "batch": sref.to_torch(batch),
                   "sizes": torch.tensor(sizes), "edges": sref.EDGES,
                   "int8_draws": sref.shard_draws(WORLD, payloads, False),
                   "tree_draws": sref.shard_draws(WORLD, payloads, True)},
        "engine": {"axis": "data", "params": pt,
                   "pool": sref.to_torch(pool_b),
                   "pool_sizes": torch.tensor(pool_s), "k": 8},
        "losses": {"x": torch.tensor(x), "y": torch.tensor(y),
                   "w": torch.tensor(w)},
        "step": {"params": convert.params_from_jax(_np(jp)),
                 "views": [torch.tensor(v) for v in views],
                 "lr": STEP_LR},
        "corpus": {"emb": torch.tensor(emb), "q": torch.tensor(q), "k": 5},
    }
    outs = td.run_world(tmp_path_factory.mktemp("sharded"), WORLD,
                        list(inputs), inputs)
    return inputs, outs


@pytest.fixture(scope="module")
def ref_sharded(tmp_path_factory):
    return sref.run_reference_sharded(tmp_path_factory.mktemp("ref"), WORLD)


def _ranks_agree(outs, *path):
    """Every rank's tensors at ``path`` equal rank 0's bit for bit;
    returns rank 0's output there."""
    def at(o):
        for p in path:
            o = o[p]
        return o

    def tensors(d):
        return {k: v for k, v in d.items()
                if isinstance(v, (dict, torch.Tensor))}
    first = at(outs[0])
    for o in outs[1:]:
        assert utils.tree_max_abs_diff(tensors(at(o)), tensors(first)) == 0.0
    return first


def _unsharded(params, batch, sizes, **kw):
    opt = opt_lib.sgd(kw.pop("lr", LR))
    return fed_sim.dcco_round(td.t_apply, params, opt.init(params), opt,
                              batch, sizes, lam=LAM, client_lr=LR,
                              agg_stats_fn=None, **kw)


# ------------------------------------------------------------ the rounds --

@pytest.mark.parametrize("objective", ["dcco", "dvicreg"])
def test_sharded_round_matches_reference(world, objective):
    inputs, outs = world
    got = _ranks_agree(outs, "rounds", objective)
    params, batch, sizes = sref.cohort()
    hyper = {"lam": LAM} if objective == "dcco" else {}
    opt = j_opt.sgd(LR)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pj, _, mj = jax.jit(lambda p, o: j_fed_sim.stats_round(
        sref_apply, p, o, opt, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(sizes), client_lr=LR,
        objective=j_objectives.get_objective(objective, **hyper)))(
        jp, opt.init(jp))
    p0 = inputs["rounds"]["params"]
    assert _rel(got["params"], sref.to_torch(_np(pj)), p0) <= 1e-4
    np.testing.assert_allclose(got["loss"].item(), float(mj.loss), rtol=1e-5)
    np.testing.assert_allclose(got["encoding_std"].item(),
                               float(mj.encoding_std), rtol=1e-5)


def sref_apply(p, batch):
    def enc(x):
        return jnp.tanh(x @ p["w1"]) @ p["w2"]
    return enc(batch["v1"]), enc(batch["v2"])


def test_lossless_sharded_round_is_the_unsharded_round(world):
    inputs, outs = world
    got = _ranks_agree(outs, "rounds", "dcco")
    dense = _ranks_agree(outs, "rounds", "dense")
    assert utils.tree_max_abs_diff(dense["params"], got["params"]) == 0.0
    assert dense["loss"].item() == got["loss"].item()
    inp = inputs["rounds"]
    p, _, m = _unsharded(inp["params"], inp["batch"], inp["sizes"])
    assert _rel(got["params"], p, inp["params"]) <= 1e-4
    np.testing.assert_allclose(got["loss"].item(), m.loss.item(), rtol=1e-6)


@pytest.mark.parametrize("case", ["int8", "tree"])
def test_channel_rounds_match_the_references_sharded_draws(
        world, ref_sharded, case):
    inputs, outs = world
    want = ref_sharded[case]
    got = outs[0]["rounds"][case]
    for o in outs[1:]:
        # the ranks all-reduce the same partials: replicated results
        assert utils.tree_max_abs_diff(o["rounds"][case]["params"],
                                       got["params"]) == 0.0
    p0 = inputs["rounds"]["params"]
    ref_p = {k: torch.tensor(want[k]) for k in ("w1", "w2")}
    assert _rel(got["params"], ref_p, p0) <= 1e-3
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=1e-4)
    assert got["wire_bytes"].item() == float(want["wire_bytes"])
    if case == "tree":
        assert 0 < got["edge_bytes"].item() < got["wire_bytes"].item()


def test_scaffold_sharded_round_matches_unsharded_and_reference(world):
    inputs, outs = world
    got = _ranks_agree(outs, "rounds", "scaffold")
    inp = inputs["rounds"]
    p0, k = inp["params"], inp["sizes"].shape[0]
    p, _, state, m = _scaffold_unsharded(inp)
    assert _rel(got["params"], p, p0) <= 1e-4
    for name, want in (("c", state.c), ("c_slots", state.c_slots)):
        scale = max(float(x.abs().max()) for x in utils.tree_leaves(want))
        assert utils.tree_max_abs_diff(got[name], want) <= 1e-4 * scale
    np.testing.assert_allclose(got["loss"].item(), m.loss.item(), rtol=1e-5)
    # the reference's unsharded SCAFFOLD round
    params, batch, sizes = sref.cohort()
    opt = j_opt.sgd(LR)
    jp = {kk: jnp.asarray(v) for kk, v in params.items()}
    pj, _, sj, _ = jax.jit(lambda p_, o: j_fed_sim.stats_round(
        sref_apply, p_, o, opt,
        {kk: jnp.asarray(v) for kk, v in batch.items()}, jnp.asarray(sizes),
        client_lr=0.01, local_steps=2,
        objective=j_objectives.get_objective("dcco", lam=LAM),
        scaffold_state=j_drift.scaffold_init(p_, k)))(jp, opt.init(jp))
    assert _rel(got["params"], sref.to_torch(_np(pj)), p0) <= 1e-4
    c_ref = sref.to_torch(_np(sj.c))
    scale = max(float(x.abs().max()) for x in utils.tree_leaves(c_ref))
    assert utils.tree_max_abs_diff(got["c"], c_ref) <= 1e-4 * scale


def _scaffold_unsharded(inp):
    opt = opt_lib.sgd(LR)
    p0 = inp["params"]
    return fed_sim.dcco_round(
        td.t_apply, p0, opt.init(p0), opt, inp["batch"], inp["sizes"],
        lam=LAM, client_lr=0.01, local_steps=2,
        scaffold_state=drift.scaffold_init(p0, inp["sizes"].shape[0]))


def test_a_cohort_that_does_not_split_over_the_ranks_is_refused(world):
    _, outs = world
    for o in outs:
        assert "does not split into the 2 shards" in o["rounds"][
            "ragged_error"]


def test_sharded_round_collectives(world):
    """A lossless round all-reduces four buffers (the sample count, the
    statistics, the deltas, the loss) and gathers nothing; a channel's
    weights need no count; SCAFFOLD adds the variate deltas' all-reduce
    and the slots' all-gather. Bytes are this rank's buffers, from
    shapes."""
    _, outs = world
    rounds = outs[0]["rounds"]
    n_params = 10 * 16 + 16 * 6
    n_stats = 4 * 6 + 6 * 6
    calls = {name: {k: int(v[0]) for k, v in r["counts"].items()}
             for name, r in rounds.items() if name != "ragged_error"}
    assert calls["dcco"] == {"all_reduce": 4, "all_gather": 0}
    assert calls["dense"] == calls["int8"] == calls["tree"] == {
        "all_reduce": 3, "all_gather": 0}
    assert calls["scaffold"] == {"all_reduce": 5, "all_gather": 1}
    assert int(rounds["dcco"]["counts"]["all_reduce"][1]) == \
        4 * (1 + n_stats + n_params + 1)
    assert int(rounds["scaffold"]["counts"]["all_gather"][1]) == \
        4 * (16 // WORLD) * n_params


# ------------------------------------------------------------ the engine --

@pytest.mark.parametrize("case", ["lossless", "scaffold"])
def test_engine_cohort_axis_matches_the_unsharded_engine(world, case):
    inputs, outs = world
    got = _ranks_agree(outs, "engine", case)
    inp = inputs["engine"]
    extra = ({"scaffold": True, "local_steps": 2, "client_lr": 0.01}
             if case == "scaffold" else {})
    opt = opt_lib.sgd(LR)
    cfg = round_engine.EngineConfig(**{"lam": LAM, "client_lr": LR,
                                       "chunk_rounds": 2,
                                       "stats_kernel": "off", **extra})
    eng = round_engine.RoundEngine(
        td.t_apply, opt, td.toy_sampler(inp["pool"], inp["pool_sizes"],
                                        inp["k"]), cfg)
    p, _, m = eng.run(inp["params"], opt.init(inp["params"]), seed=3,
                      rounds=3)
    assert _rel(got["params"], p, inp["params"]) <= 1e-4
    np.testing.assert_allclose(got["loss"].numpy(), m.loss.numpy(),
                               rtol=1e-5)
    # only rank 0 writes the checkpoints (at rounds 2 and 3)
    assert f"{case}.msgpack" in outs[0]["engine"][case]["checkpoints"]
    assert outs[1]["engine"][case]["checkpoints"] == []
    if case == "scaffold":
        scale = max(float(x.abs().max())
                    for x in utils.tree_leaves(eng.drift_state.c_slots))
        assert utils.tree_max_abs_diff(
            got["c_slots"], eng.drift_state.c_slots) <= 1e-4 * scale


# ------------------------------------------------------- shard_map loss --

@pytest.mark.parametrize("objective", ["dcco", "dvicreg", "dwmse"])
def test_shard_map_loss_matches_fused_and_jax_grad(world, objective):
    inputs, outs = world
    got = _ranks_agree(outs, "losses", objective)
    x, y, w = (inputs["losses"][k] for k in ("x", "y", "w"))
    wt = w.clone().requires_grad_()
    zf, zg = torch.tanh(x @ wt), torch.tanh(y @ wt)
    if objective == "dcco":
        fused = dcco.dcco_loss(zf, zg, LAM, impl="fused")
        j_loss = lambda a, b: j_dcco.dcco_loss(a, b, LAM)  # noqa: E731
    else:
        fused = get_objective(objective).loss(zf, zg)
        j_loss = j_objectives.get_objective(objective).loss
    (g_fused,) = torch.autograd.grad(fused, wt)
    jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
    lj, gj = jax.value_and_grad(
        lambda ww: j_loss(jnp.tanh(jx @ ww), jnp.tanh(jy @ ww)))(
        jnp.asarray(w.numpy()))
    for want_l, want_g in ((fused.item(), g_fused),
                           (float(lj), torch.tensor(np.asarray(gj)))):
        np.testing.assert_allclose(got["loss"].item(), want_l, rtol=1e-5)
        scale = float(want_g.abs().max())
        assert float((got["grad"] - want_g).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("micro", [1, 2])
def test_sharded_train_step_matches_fused_and_reference(world, micro):
    inputs, outs = world
    got = _ranks_agree(outs, "step", f"micro{micro}")
    inp = inputs["step"]
    jcfg, jp, views = _resnet()
    tcfg = get_config("resnet14-cifar", smoke=True).replace(resnet_groups=2)
    de = DualEncoderConfig(proj_dims=(64, 64), lambda_cco=LAM)
    batch = {f"view{i + 1}": {"images": torch.tensor(v)}
             for i, v in enumerate(views)}
    opt = opt_lib.sgd(STEP_LR)
    p0 = inp["params"]
    pf, _, mf = steps.make_dcco_train_step(
        tcfg, de, TrainConfig(global_batch=8, samples_per_client=2),
        opt)(p0, opt.init(p0), batch)
    # micro 2 over 2 ranks regroups the statistics and the gradient's
    # batch sum into 4 pieces
    assert _rel(got["params"], pf, p0) <= (1e-4 if micro == 1 else 1e-3)
    np.testing.assert_allclose(got["loss"].item(), mf["loss"].item(),
                               rtol=1e-5)
    if micro == 1:
        # the whole batch's std; micro M averages its microbatches'
        np.testing.assert_allclose(got["encoding_std"].item(),
                                   mf["encoding_std"].item(), rtol=1e-4)
    opt_j = j_opt.sgd(STEP_LR)
    pj, _, mj = jax.jit(j_steps.make_dcco_train_step(
        jcfg, JDE(proj_dims=(64, 64), lambda_cco=LAM),
        JTrainConfig(global_batch=8, samples_per_client=2), opt_j))(
        jp, opt_j.init(jp), {f"view{i + 1}": {"images": jnp.asarray(v)}
                             for i, v in enumerate(views)})
    assert _rel(got["params"], convert.params_from_jax(_np(pj)), p0) < 1e-3
    np.testing.assert_allclose(got["loss"].item(), float(mj["loss"]),
                               rtol=1e-4)


# ---------------------------------------------------------- the corpus --

def test_sharded_corpus_equals_the_unsharded_search(world):
    inputs, outs = world
    got = _ranks_agree(outs, "corpus")
    inp = inputs["corpus"]
    assert [tuple(o["corpus"]["local_rows"].tolist()) for o in outs] == \
        [(1, 51)] * WORLD
    want = mips_topk(inp["q"], inp["emb"], inp["k"])
    assert torch.equal(got["values"], want[0])
    assert torch.equal(got["indices"], want[1])
    # the duplicated rows 3 (shard 0) and 60 (shard 1) tie on equal bits
    # and go to the lower index
    assert got["indices"][3, :2].tolist() == [3, 60]
    # a rank holds one shard of the two: a refresh needs them all
    assert "rebuild" in outs[0]["corpus"]["refresh_error"]
    assert got["values"][3, 0].item() == got["values"][3, 1].item()
    ref_v, ref_i = j_mips.mips_topk_chunked(
        jnp.asarray(inp["q"].numpy()), jnp.asarray(inp["emb"].numpy()),
        k=inp["k"], chunk=32)
    np.testing.assert_allclose(got["values"].numpy(), np.asarray(ref_v),
                               rtol=0, atol=1e-5)
    s = inp["q"].double() @ inp["emb"].double().T
    for r, c in np.argwhere(got["indices"].numpy() != np.asarray(ref_i)):
        assert abs(float(s[r, got["indices"][r, c]])
                   - float(s[r, int(ref_i[r, c])])) <= 1e-5


# ----------------------------------------------------------- refusals --

def _engine(cfg, sampler=None, mesh=None):
    return round_engine.RoundEngine(td.t_apply, opt_lib.sgd(LR),
                                    sampler or (lambda g: None), cfg,
                                    mesh=mesh)


@pytest.mark.parametrize("cfg,error,match", [
    (dict(algorithm="fedavg_cco"), NotImplementedError,
     "dcco body only"),
    (dict(), ValueError, "cohort_axis requires a mesh"),
    (dict(cohort_chunk=4), ValueError, "stream it or shard it"),
    (dict(num_clusters=3), ValueError,
     "num_clusters and cohort_axis are not composed"),
])
def test_sharded_engine_refusals(cfg, error, match):
    with pytest.raises(error, match=match):
        _engine(round_engine.EngineConfig(cohort_axis="data", **cfg))


def test_sharded_async_refusal():
    with pytest.raises(ValueError, match="async_k and cohort_axis"):
        round_engine.make_async_round_body(
            td.t_apply, opt_lib.sgd(LR), round_engine.EngineConfig(
                cohort_axis="data", async_k=2))


def test_misaligned_edges_and_fused_stats_are_refused():
    ch = HierarchicalChannel(3, client_channel=comm.QuantizedChannel(8))
    ctx = comm.ChannelContext(5, torch.ones(4), torch.full((4,), 0.25),
                              torch.tensor(4.0))
    with pytest.raises(ValueError, match="align"):
        ch.local_fold(ctx, {"a": torch.ones(4, 3)}, "stats", num_shards=2)
    with pytest.raises(ValueError, match="stats_kernel='fused'"):
        round_engine.make_round_body(
            td.t_apply, opt_lib.sgd(LR), round_engine.EngineConfig(
                cohort_axis="data", stats_kernel="fused"), mesh=object())


def test_tree_local_fold_matches_the_reference():
    """One rank's fold of 4 clients into its 2 of 4 edges over 2 shards,
    an int8 edge hop fed the reference's uniforms of that rank's edge
    seed, against the reference's ``local_fold``."""
    rng = np.random.RandomState(4)
    dec = {"a": rng.randn(4, 3).astype(np.float32),
           "b": rng.randn(4, 2, 2).astype(np.float32)}
    w = np.array([0.1, 0.2, 0.3, 0.15], np.float32)
    j_ch = JHier(4, client_channel=j_channel.QuantizedChannel(8),
                 edge_channel=j_channel.QuantizedChannel(8))
    key = jax.random.PRNGKey(21)
    j_ctx = j_channel.ChannelContext(key, jnp.ones(4), jnp.asarray(w),
                                     jnp.asarray(4.0))
    want = j_ch.local_fold(j_ctx, {k: jnp.asarray(v) for k, v in dec.items()},
                           "update", num_shards=2)
    from repro.hierarchy.aggregation import _EDGE_SALT
    u = sref.ref_uniforms(jax.random.fold_in(
        jax.random.fold_in(key, _EDGE_SALT), j_channel.PHASE_SALT["update"]),
        {"a": (2, 3), "b": (2, 2, 2)})
    t_ch = HierarchicalChannel(4, client_channel=comm.QuantizedChannel(8),
                               edge_channel=comm.QuantizedChannel(8))
    ctx = comm.ChannelContext(21, torch.ones(4), torch.tensor(w),
                              torch.tensor(4.0))
    got = t_ch.local_fold(ctx, sref.to_torch(dec), "update", num_shards=2,
                          draws=u)
    for k in dec:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6)
    # the base fold is aggregate's weighted sum
    base = comm.Channel().local_fold(ctx, sref.to_torch(dec), "stats")
    for k in dec:
        assert torch.equal(base[k], torch.tensordot(torch.tensor(w),
                                                    torch.tensor(dec[k]),
                                                    dims=1))


# --------------------------------------------------------- world of one --

@pytest.fixture
def world_of_one(tmp_path):
    """This process as a gloo world of one, through the REPRO_* env."""
    assert maybe_initialize_distributed(
        {"REPRO_COORDINATOR": f"file://{tmp_path}/store",
         "REPRO_NUM_PROCESSES": "1", "REPRO_PROCESS_ID": "0"},
        device="cpu", timeout_s=60.0)
    try:
        from repro_torch.launch.mesh import make_debug_mesh
        yield make_debug_mesh(1)
    finally:
        dist.destroy_process_group()


def test_world_of_one_is_the_unsharded_engine_bit_for_bit(world_of_one,
                                                           monkeypatch):
    """On one rank the sharded engine computes the unsharded round's
    arithmetic: equal bit for bit to the engine with stats_kernel='off'.
    It never calls the statistics kernel's wrapper, which the unsharded
    default (stats_kernel=None) calls once a round."""
    calls = []
    real = round_engine.cco_stats

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(round_engine, "cco_stats", spy)
    params, _, _ = sref.cohort()
    _, pool, pool_s = sref.cohort(seed=1)
    sampler = td.toy_sampler(sref.to_torch(pool), torch.tensor(pool_s), 8)
    p0 = sref.to_torch(params)
    out = {}
    for name, kw, mesh in (("sharded", {"cohort_axis": "data"},
                            world_of_one),
                           ("off", {"stats_kernel": "off"}, None),
                           ("default", {}, None)):
        calls.clear()
        opt = opt_lib.sgd(LR)
        eng = round_engine.RoundEngine(
            td.t_apply, opt, sampler,
            round_engine.EngineConfig(lam=LAM, client_lr=LR, **kw),
            mesh=mesh)
        out[name] = eng.run(p0, opt.init(p0), seed=3, rounds=2)
        out[name + "_calls"] = len(calls)
    assert out["sharded_calls"] == 0 and out["off_calls"] == 0
    assert out["default_calls"] == 2
    assert utils.tree_max_abs_diff(out["sharded"][0], out["off"][0]) == 0.0
    assert torch.equal(out["sharded"][2].loss, out["off"][2].loss)


def test_sharded_step_and_mesh_refusals(world_of_one):
    """With a mesh the step refuses the per-client loss and an MoE
    tower's aux losses; a tuple of axes out of the mesh's order is
    refused."""
    from repro_torch.sharding import collectives

    mesh = world_of_one
    de = DualEncoderConfig(proj_dims=(64, 64), lambda_cco=LAM)
    with pytest.raises(ValueError, match="per_client"):
        steps.make_dcco_train_step(
            get_config("tinyllama-1.1b", smoke=True), de,
            TrainConfig(dcco_impl="per_client"), opt_lib.sgd(LR), mesh=mesh)
    with pytest.raises(ValueError, match="MoE"):
        steps.make_dcco_train_step(
            get_config("deepseek-moe-16b", smoke=True), de, TrainConfig(),
            opt_lib.sgd(LR), mesh=mesh)
    with pytest.raises(ValueError, match="mesh's order"):
        collectives.axis_group(mesh, ("model", "data"))
    with pytest.raises(ValueError, match="no axis 'client'"):
        dcco.make_shard_map_dcco_loss(mesh, LAM, ("client",))
