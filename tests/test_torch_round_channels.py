"""One D-VICReg round and one DCCO round through a quantized uplink, port
vs reference, on the CPU; the engine's channel plumbing.

Configuration and metric as in tests/test_torch_round.py: the smoke
ResNet with ``resnet_groups=2``, JAX's parameters carried over, a cohort
drawn by the reference, and parameters compared by ``max|p_port -
p_ref| / max|p_ref - p_0|``.

The D-VICReg round is held to 1e-3 of its update, as the DCCO round is.

The quantized round takes the reference's uniforms for both uplinks
(split per leaf in ``jax.tree.flatten`` order and carried across client by
client). Its inputs differ from the reference's in the last f32 bits, so
an element near a rounding edge lands one quantization step away: each
parameter is held to ``lr * sum_k w_k step_k`` of its leaf (one step of
every client's payload, weighted as the aggregate weighs them) plus 1e-3
of the update (measured: the worst parameter at 0.62 of its bound, the
loss 3.2e8 on both sides to 1.5e-6). Where the inputs agree exactly the
wire is bit-equal (tests/test_torch_comm.py).
"""
import jax
import numpy as np
import pytest
import torch

from repro.comm import channel as j_channel
from repro.configs.base import DualEncoderConfig as JDE
from repro.configs.base import get_config as j_get_config
from repro.core import fed_sim as j_fed_sim
from repro.core import round_engine as j_engine
from repro.data import partition as j_partition
from repro.data import pipeline as j_pipeline
from repro.data import synthetic as j_synthetic
from repro.models import dual_encoder as j_de
from repro.objectives import get_objective as j_get_objective
from repro.optim import optimizers as j_opt
from repro_torch import convert, utils
from repro_torch.comm import channel
from repro_torch.configs.base import DualEncoderConfig, get_config
from repro_torch.core import fed_sim, round_engine
from repro_torch.launch.train import make_apply
from repro_torch.objectives import get_objective
from repro_torch.optim import optimizers as opt_lib

# the suite runs under several pytest workers: one torch thread per
# worker keeps them from contending with each other and with JAX
torch.set_num_threads(1)

LAM = 5.0
LR = 0.005                       # server SGD learning rate
PROJ = (64, 64)
K = 6


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
    ds = j_pipeline.FederatedDataset.build(
        {"images": imgs}, labels, num_clients=32, samples_per_client=3,
        partition=j_partition.PartitionSpec("dirichlet_quantity",
                                            severity=0.9), seed=0)
    batch, sizes = ds.round_batch(jax.random.PRNGKey(42), K)
    return {"jp": jp, "batch": batch, "sizes": sizes,
            "j_apply": _j_apply(jcfg, JDE(proj_dims=PROJ)),
            "t_apply": make_apply(tcfg, DualEncoderConfig(proj_dims=PROJ)),
            "t_batch": utils.tree_map(lambda x: torch.tensor(np.asarray(x)),
                                      batch),
            "t_sizes": torch.tensor(np.asarray(sizes))}


def _port_params(s):
    return convert.params_from_jax(jax.tree.map(np.asarray, s["jp"]))


def _from_ref(p):
    return convert.params_from_jax(jax.tree.map(np.asarray, p))


def test_one_dvicreg_round_matches_reference(setup):
    s = setup
    opt_j = j_opt.sgd(LR)
    agg_j = j_engine.make_kernel_agg_stats(interpret=True,
                                           second_moments=True)

    @jax.jit
    def j_round(p, o, b, sz):
        return j_fed_sim.stats_round(s["j_apply"], p, o, opt_j, b, sz,
                                     objective=j_get_objective("dvicreg"),
                                     agg_stats_fn=agg_j)

    pj, _, mj = j_round(s["jp"], opt_j.init(s["jp"]), s["batch"], s["sizes"])
    p0 = _port_params(s)
    opt_t = opt_lib.sgd(LR)
    round_fn = round_engine.make_round_body(
        s["t_apply"], opt_t,
        round_engine.EngineConfig(objective="dvicreg", stats_kernel="fused"))
    pt, _, mt = round_fn(p0, opt_t.init(p0), s["t_batch"], s["t_sizes"])
    ref = _from_ref(pj)
    err = (utils.tree_max_abs_diff(pt, ref)
           / utils.tree_max_abs_diff(ref, p0))
    assert err < 1e-3, err
    np.testing.assert_allclose(mt.loss.item(), float(mj.loss), rtol=1e-4)
    np.testing.assert_allclose(mt.encoding_std.item(),
                               float(mj.encoding_std), rtol=1e-4)
    assert mt.wire_bytes.item() == float(mj.wire_bytes) == 0.0


class _Recording(channel.QuantizedChannel):
    """The port's quantized channel, keeping each phase's raw payload."""

    def __init__(self, bits):
        super().__init__(bits)
        self.seen = {}

    def encode_decode(self, ctx, tree_k, phase, draws=None):
        self.seen[phase] = (tree_k, ctx.weights)
        return super().encode_decode(ctx, tree_k, phase, draws)


def _ref_draws(key, template_k):
    leaves, treedef = jax.tree.flatten(template_k)
    sizes = [int(np.prod(x.shape[1:])) for x in leaves]
    flat = np.asarray(jax.random.uniform(key, (K, sum(sizes))))
    parts = np.split(flat, np.cumsum(sizes)[:-1], axis=1)
    return jax.tree.unflatten(treedef, [p.reshape(x.shape)
                                        for p, x in zip(parts, leaves)])


def test_one_quantized_dcco_round_within_one_step(setup):
    s = setup
    bits, ch_key = 8, jax.random.PRNGKey(17)
    opt_j = j_opt.sgd(LR)
    j_ch = j_channel.QuantizedChannel(bits)

    @jax.jit
    def j_round(p, o, b, sz, key):
        return j_fed_sim.dcco_round(s["j_apply"], p, o, opt_j, b, sz,
                                    lam=LAM, channel=j_ch, channel_key=key)

    pj, _, mj = j_round(s["jp"], opt_j.init(s["jp"]), s["batch"], s["sizes"],
                        ch_key)

    # the reference's draws of both phases, carried into the port's layout
    spec = get_objective("dcco").stat_spec(PROJ[-1])
    u_stats = _ref_draws(
        jax.random.fold_in(ch_key, j_channel.PHASE_SALT["stats"]),
        {k: np.zeros((K,) + shp, np.float32) for k, shp in spec.items()})
    u_upd = _ref_draws(
        jax.random.fold_in(ch_key, j_channel.PHASE_SALT["update"]),
        jax.tree.map(lambda x: np.zeros((K,) + x.shape, np.float32),
                     s["jp"]))
    per_client = [convert.params_from_jax(
        jax.tree.map(lambda x: x[i], u_upd)) for i in range(K)]
    draws = {"stats": utils.tree_map(torch.tensor, u_stats),
             "update": utils.tree_map(lambda *xs: torch.stack(xs),
                                      *per_client)}

    p0 = _port_params(s)
    opt_t = opt_lib.sgd(LR)
    t_ch = _Recording(bits)
    pt, _, mt = fed_sim.dcco_round(
        s["t_apply"], p0, opt_t.init(p0), opt_t, s["t_batch"], s["t_sizes"],
        lam=LAM, channel=t_ch, channel_key=17, channel_draws=draws)

    qmax = channel.qmax_for_bits(bits)
    deltas, w = t_ch.seen["update"]
    ref = _from_ref(pj)
    upd = utils.tree_max_abs_diff(ref, p0)
    worst = []

    def check(pt_leaf, ref_leaf, delta_leaf):
        step = delta_leaf.reshape(K, -1).abs().amax(1) / qmax     # (K,)
        bound = LR * float((w * step).sum()) + 1e-3 * upd
        err = float((pt_leaf - ref_leaf).abs().max())
        worst.append(err / bound)
        assert err <= bound, (err, bound)

    utils.tree_map(check, pt, ref, deltas)
    assert max(worst) > 0                   # the rounds did differ somewhere
    np.testing.assert_allclose(mt.loss.item(), float(mj.loss), rtol=1e-4)
    np.testing.assert_allclose(mt.wire_bytes.item(), float(mj.wire_bytes),
                               rtol=1e-7)
    assert mt.wire_bytes.item() == K * (
        t_ch.payload_bytes(get_objective("dcco").stat_template(PROJ[-1]))
        + t_ch.payload_bytes(p0))


def _engine(s, opt, cfg, seen):
    from repro_torch.data import partition, pipeline
    from repro_torch.data import synthetic
    imgs, labels = synthetic.synthetic_labeled_images(48, 3, image_size=16,
                                                      noise=0.5, seed=2)
    ds = pipeline.FederatedDataset.build(
        {"images": imgs}, labels, num_clients=16, samples_per_client=3,
        partition=partition.PartitionSpec("dirichlet", alpha=0.0), seed=0)
    sampler = ds.make_round_sampler(3, "cpu")

    def recording(gen):
        out = sampler(gen)
        seen.append(out[0]["v1"])
        return out
    return round_engine.RoundEngine(s["t_apply"], opt, recording, cfg)


def test_engine_dense_channel_is_bit_identical_and_counts_wire(setup):
    s = setup
    p0 = _port_params(s)
    opt = opt_lib.sgd(LR)
    runs = {}
    for name in ("none", "dense"):
        seen = []
        cfg = round_engine.EngineConfig(
            lam=LAM, chunk_rounds=2, stats_kernel="off",
            channel=channel.get_channel(name))
        runs[name] = _engine(s, opt, cfg, seen).run(p0, opt.init(p0), 3, 2)
        runs[name + "_cohorts"] = seen
    # the sampler's stream does not depend on the channel
    for a, b in zip(runs["none_cohorts"], runs["dense_cohorts"]):
        assert torch.equal(a, b)
    assert utils.tree_max_abs_diff(runs["none"][0], runs["dense"][0]) == 0.0
    assert torch.equal(runs["none"][2].loss, runs["dense"][2].loss)
    assert not runs["none"][2].wire_bytes.any()
    per_round = 3 * 4 * (sum(x.numel() for x in utils.tree_leaves(
        get_objective("dcco").stat_template(PROJ[-1])))
        + sum(x.numel() for x in utils.tree_leaves(p0)))
    assert runs["dense"][2].wire_bytes.tolist() == [per_round] * 2


def test_engine_channel_guards_and_dp_accounting(setup):
    s = setup
    opt = opt_lib.sgd(LR)
    quant = channel.QuantizedChannel(8)
    with pytest.raises(ValueError, match="per-client payloads"):
        round_engine.make_round_body(
            s["t_apply"], opt,
            round_engine.EngineConfig(stats_kernel="fused", channel=quant))
    with pytest.raises(ValueError, match="centralized"):
        round_engine.make_round_body(
            s["t_apply"], opt,
            round_engine.EngineConfig(algorithm="centralized",
                                      channel=channel.DenseChannel()))
    p0 = _port_params(s)
    with pytest.raises(ValueError, match="per-client payloads"):
        fed_sim.dcco_round(
            s["t_apply"], p0, opt.init(p0), opt, s["t_batch"], s["t_sizes"],
            channel=quant, channel_key=1,
            agg_stats_fn=round_engine.make_kernel_agg_stats())
    with pytest.raises(ValueError, match="channel_key"):
        fed_sim.dcco_round(s["t_apply"], p0, opt.init(p0), opt, s["t_batch"],
                           s["t_sizes"], channel=quant)
    # a lossless channel may keep the flat kernel path
    round_engine.make_round_body(
        s["t_apply"], opt, round_engine.EngineConfig(
            stats_kernel="fused", channel=channel.DenseChannel()))
    # by default the phase-1 route follows the channel
    dcco = get_objective("dcco")
    for ch, flat in ((None, True), (channel.DenseChannel(), True),
                     (quant, False)):
        agg = round_engine._resolve_agg_stats_fn(
            round_engine.EngineConfig(channel=ch), dcco)
        assert (agg is not None) == flat, ch
    dp = channel.DPGaussianChannel(noise_multiplier=2.0, clip_norm=1.0)
    cfg = round_engine.EngineConfig(lam=LAM, chunk_rounds=1, channel=dp)
    _, _, m = _engine(s, opt, cfg, []).run(p0, opt.init(p0), 4, 2)
    assert dp.accountant.steps == 2
    assert bool(torch.isfinite(m.loss).all()) and bool(
        (m.wire_bytes > 0).all())
