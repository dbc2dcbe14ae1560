"""bf16 encoder compute (``EngineConfig.compute_dtype``), port vs reference,
on the CPU: the encoder may run in bf16 while every Eq.-3 statistic
accumulates in f32, and parameters, optimizer state, deltas and variates
stay f32.

Tolerances:
- statistics of bf16 encodings against those of the f32 encodings:
  0.02 (max |s32| + 1), as the reference's test holds them (an 8-bit
  mantissa rounds each input by ~2^-8 relative, and an f32 accumulator
  keeps that relative error whatever N);
- across frameworks: XLA:CPU's and PyTorch's CPU bf16 convolutions and
  products round and accumulate differently, so no f32 tolerance can hold
  them. One bf16 engine round of the smoke ResNet is held against the
  reference's bf16 round by the reference's own bf16 rounding: the
  distance of the port's parameters from the reference's is at most 2x
  the distance of the reference's bf16 round from its f32 round.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_toy as toy
from repro.configs.base import DualEncoderConfig as JDE
from repro.configs.base import get_config as j_get_config
from repro.core import round_engine as j_engine
from repro.data import partition as j_partition
from repro.data import pipeline as j_pipeline
from repro.data import synthetic as j_synthetic
from repro.models import dual_encoder as j_de
from repro.optim import optimizers as j_opt
from repro_torch import convert, utils
from repro_torch.configs.base import DualEncoderConfig, get_config
from repro_torch.core import cco, round_engine
from repro_torch.launch.train import make_apply
from repro_torch.optim import optimizers as opt_lib
from repro_torch.server import drift

torch.set_num_threads(1)

PROJ = (64, 64)


def _all_f32(tree):
    """Every float leaf f32 (an optimizer's step counter is an int)."""
    return all(x.dtype == torch.float32 for x in utils.tree_leaves(tree)
               if x.is_floating_point())


def _encodings(seed, n, d=8):
    rng = np.random.RandomState(seed)
    return (torch.tensor(rng.randn(n, d).astype(np.float32)),
            torch.tensor(rng.randn(n, d).astype(np.float32)))


@pytest.mark.parametrize("second", [False, True])
@pytest.mark.parametrize("seed,n", [(0, 2), (1, 17), (2, 64)])
def test_bf16_inputs_accumulate_f32_and_track_f32_stats(seed, n, second):
    zf, zg = _encodings(seed, n)
    st32 = cco.moment_stats(zf, zg, second_moments=second)
    st16 = cco.moment_stats(zf.bfloat16(), zg.bfloat16(),
                            second_moments=second)
    assert set(st16) == set(st32)
    for k, v in st16.items():
        assert v.dtype == torch.float32, (k, v.dtype)
        scale = float(st32[k].abs().max()) + 1.0
        assert float((v - st32[k]).abs().max()) < 0.02 * scale, k


def test_f32_inputs_untouched_and_the_kernel_path_upcasts():
    zf, zg = _encodings(0, 16)
    assert all(v.dtype == torch.float32
               for v in cco.moment_stats(zf, zg).values())
    mask = torch.ones(16)
    mask[-3:] = 0
    for second in (False, True):
        agg = round_engine.make_kernel_agg_stats(second)(
            zf.bfloat16(), zg.bfloat16(), mask)
        ref = cco.moment_stats(zf.bfloat16(), zg.bfloat16(), mask,
                               second_moments=second)
        for k, v in agg.items():
            assert v.dtype == torch.float32
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-5,
                                       atol=1e-6)


def test_cast_encoder_apply_is_the_identity_at_f32_and_refuses_float16():
    for name in ("float32", "f32", "fp32"):
        assert round_engine.cast_encoder_apply(toy.t_apply, name) \
            is toy.t_apply
    with pytest.raises(ValueError, match="compute_dtype"):
        round_engine.resolve_compute_dtype("float16")
    assert set(round_engine.COMPUTE_DTYPES) == set(j_engine.COMPUTE_DTYPES)
    for name, dtype in round_engine.COMPUTE_DTYPES.items():
        assert str(dtype).split(".")[-1] == jnp.dtype(
            j_engine.COMPUTE_DTYPES[name]).name


def test_bf16_outputs_leave_the_master_params_f32():
    params = toy.to_torch(toy.params_np())
    batch = {v: torch.tensor(x[0]) for v, x in toy.pool_np().items()}
    wrapped = round_engine.cast_encoder_apply(toy.t_apply, "bfloat16")
    zf, zg = wrapped(params, batch)
    assert zf.dtype == zg.dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for v in params.values())
    zf32, _ = toy.t_apply(params, batch)
    assert float((zf.float() - zf32).abs().max()) < 0.05
    # the cast is differentiable: a master parameter's gradient is f32
    g = torch.func.grad(lambda p: wrapped(p, batch)[0].float().sum())(params)
    assert all(v.dtype == torch.float32 for v in g.values())


def test_integer_leaves_pass_through():
    seen = {}

    def apply(p, batch):
        seen.update({k: v.dtype for k, v in batch.items()})
        return p["w"], p["w"]

    wrapped = round_engine.cast_encoder_apply(apply, "bf16")
    zf, _ = wrapped({"w": torch.ones(3)},
                    {"tokens": torch.arange(4), "x": torch.ones(2)})
    assert seen == {"tokens": torch.int64, "x": torch.bfloat16}
    assert zf.dtype == torch.bfloat16


def test_engine_bf16_rounds_train_finite_with_f32_state():
    """The engine at bf16 with SCAFFOLD and FedProx: finite losses, and
    params, optimizer state and variates stay f32; the parameters track
    the f32 run loosely."""
    pool = toy.pool_np()
    data = {v: torch.tensor(x[:8]) for v, x in pool.items()}
    sizes = torch.full((8,), toy.N_PER, dtype=torch.int32)
    params = toy.to_torch(toy.params_np())
    runs = {}
    for tag in ("float32", "bfloat16"):
        opt = opt_lib.adam(1e-2)
        eng = round_engine.RoundEngine(
            toy.t_apply, opt, lambda gen: (data, sizes),
            round_engine.EngineConfig(lam=toy.LAM, chunk_rounds=3,
                                      compute_dtype=tag, client_lr=0.05,
                                      local_steps=2, prox_mu=0.01,
                                      scaffold=True))
        p, s, m = eng.run(params, opt.init(params), 3, 3)
        assert torch.isfinite(m.loss).all(), tag
        assert _all_f32([p, s, list(eng.drift_state)]), tag
        assert isinstance(eng.drift_state, drift.ScaffoldState)
        runs[tag] = p
    diff = utils.tree_max_abs_diff(runs["float32"], runs["bfloat16"])
    assert 0.0 < diff < 0.1


def _j_apply(cfg, de):
    def apply(p, batch):
        zf, _ = j_de.encode(cfg, de, p, {"images": batch["v1"]})
        zg, _ = j_de.encode(cfg, de, p, {"images": batch["v2"]})
        return zf, zg
    return apply


def _from_ref(p):
    return convert.params_from_jax(jax.tree.map(np.asarray, p))


def test_one_bf16_resnet_round_is_as_close_to_the_reference_as_its_rounding():
    """One bf16 engine round of the smoke ResNet (``resnet_groups=2``, a
    reference-drawn cohort) in each package. The port's parameters lie
    within 2x the reference's own bf16-vs-f32 distance of the reference's
    bf16 round; every state leaf stays f32."""
    jcfg = j_get_config("resnet14-cifar", smoke=True).replace(
        resnet_groups=2)
    tcfg = get_config("resnet14-cifar", smoke=True).replace(resnet_groups=2)
    jp = jax.jit(j_de.init_dual_encoder, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jcfg, JDE(proj_dims=PROJ))
    imgs, labels = j_synthetic.synthetic_labeled_images(
        96, 4, image_size=16, noise=0.5, seed=1)
    ds = j_pipeline.FederatedDataset.build(
        {"images": imgs}, labels, num_clients=32, samples_per_client=3,
        partition=j_partition.PartitionSpec("dirichlet", alpha=0.0), seed=0)
    batch, sizes = ds.round_batch(jax.random.PRNGKey(42), 6)
    lr = 0.005
    opt_j = j_opt.sgd(lr)
    ref = {}
    for tag in ("float32", "bfloat16"):
        body = j_engine.make_round_body(
            _j_apply(jcfg, JDE(proj_dims=PROJ)), opt_j,
            j_engine.EngineConfig(lam=5.0, compute_dtype=tag))
        p, _, _, m = jax.jit(body)(jp, opt_j.init(jp), (), batch, sizes,
                                   jax.random.PRNGKey(0))
        ref[tag] = (_from_ref(p), float(m.loss))
    p0 = _from_ref(jp)
    opt_t = opt_lib.sgd(lr)
    body = round_engine.make_round_body(
        make_apply(tcfg, DualEncoderConfig(proj_dims=PROJ)), opt_t,
        round_engine.EngineConfig(lam=5.0, compute_dtype="bfloat16",
                                  stats_kernel="off"))
    pt, st, mt = body(p0, opt_t.init(p0),
                      utils.tree_map(lambda x: torch.tensor(np.asarray(x)),
                                     batch), torch.tensor(np.asarray(sizes)))
    assert _all_f32([pt, st])
    assert torch.isfinite(mt.loss)
    upd = utils.tree_max_abs_diff(ref["bfloat16"][0], p0)
    err = utils.tree_max_abs_diff(pt, ref["bfloat16"][0])
    bf16_rounding = utils.tree_max_abs_diff(ref["bfloat16"][0],
                                            ref["float32"][0])
    assert 0.0 < bf16_rounding < upd
    assert err <= 2 * bf16_rounding, (err, bf16_rounding, upd)
