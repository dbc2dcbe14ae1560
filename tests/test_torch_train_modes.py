"""The training modes: ``core/dcco.py``'s losses, ``launch/steps.py``'s
fused D-CCO step (single and exact microbatched) and LM step, and the
CLI's ``--mode fused|protocol``, port vs reference and port vs itself, on
the CPU.

Parity runs in f32 on the smoke configs (the ResNet with
``resnet_groups=2``, tests/test_torch_round.py says why; the tinyllama
tower) from the reference's parameters carried over by ``convert``, on
the same numpy batch, with a server SGD step. Tolerances: losses rtol
1e-5 (toy encodings) or 1e-4 (towers); parameters after one step within
1e-3 of the step's update, ``max|p_port - p_ref| / max|p_ref - p_0|``, as
one round is held in tests/test_torch_round.py. Inside the port the
fused and per-client losses agree to rtol 1e-5 in value and their
gradients to 1e-4 of the largest entry, and the microbatched step's
gradient equals the single step's to 1e-4 of its largest entry (one
regrouping of the Eq.-3 sums and of the gradient's batch sum).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import DualEncoderConfig as JDE
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.base import get_config as j_get_config
from repro.core import dcco as j_dcco
from repro.launch import steps as j_steps
from repro.models import dual_encoder as j_de
from repro.models import transformer as j_tf
from repro.optim import optimizers as j_opt
from repro_torch import convert, utils
from repro_torch.configs.base import (DualEncoderConfig, TrainConfig,
                                      get_config)
from repro_torch.core import dcco
from repro_torch.hierarchy import streaming_stats_round
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.launch import steps, train
from repro_torch.launch.train import make_apply
from repro_torch.models import dual_encoder
from repro_torch.objectives import get_objective
from repro_torch.optim import optimizers as opt_lib

# tier-1 runs 6 pytest workers on the machine's cores: one torch thread
# per worker keeps them from contending with each other and with JAX
torch.set_num_threads(1)

LAM, LR, PROJ = 5.0, 0.005, (64, 64)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(port, ref, start):
    return (utils.tree_max_abs_diff(port, ref)
            / utils.tree_max_abs_diff(ref, start))


def _max_abs(tree):
    return max(float(x.abs().max()) for x in utils.tree_leaves(tree))


# ------------------------------------------------------------- losses --

def _encodings(seed, n=12, d=6):
    rng = np.random.RandomState(seed)
    zf = rng.randn(n, d).astype(np.float32)
    zg = (0.6 * zf + 0.8 * rng.randn(n, d)).astype(np.float32)
    return zf, zg


@pytest.mark.parametrize("impl", ["fused", "per_client"])
def test_dcco_losses_match_reference(impl):
    zf, zg = _encodings(0)
    want = float(j_dcco.dcco_loss(jnp.asarray(zf), jnp.asarray(zg), LAM,
                                  impl=impl, clients=4))
    got = dcco.dcco_loss(torch.from_numpy(zf), torch.from_numpy(zg), LAM,
                         impl=impl, clients=4)
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


def test_fused_and_per_client_agree_in_value_and_gradient():
    zf, zg = (torch.from_numpy(x).requires_grad_() for x in _encodings(1))
    out = {}
    for impl in ("fused", "per_client"):
        loss = dcco.dcco_loss(zf, zg, LAM, impl=impl, clients=3)
        out[impl] = (loss.item(), torch.autograd.grad(loss, (zf, zg)))
    np.testing.assert_allclose(out["per_client"][0], out["fused"][0],
                               rtol=1e-5)
    scale = max(float(g.abs().max()) for g in out["fused"][1])
    for a, b in zip(out["fused"][1], out["per_client"][1]):
        assert float((a - b).abs().max()) <= 1e-4 * scale


def test_dcco_loss_refusals():
    z = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="needs the mesh"):
        dcco.dcco_loss(z, z, LAM, impl="shard_map")
    with pytest.raises(ValueError, match="DeviceMesh"):
        dcco.dcco_loss(z, z, LAM, impl="shard_map", mesh=object())
    with pytest.raises(ValueError, match="clients >= 1"):
        dcco.dcco_loss(z, z, LAM, impl="per_client")
    with pytest.raises(ValueError, match="unknown dcco impl"):
        dcco.dcco_loss(z, z, LAM, impl="nope")


# --------------------------------------------------------------- steps --

def _tower(arch):
    """(reference cfg, port cfg, reference params, batch leaf, numpy views
    of 8 samples) of a smoke tower."""
    jcfg = j_get_config(arch, smoke=True)
    tcfg = get_config(arch, smoke=True)
    if arch == "resnet14-cifar":
        jcfg, tcfg = (c.replace(resnet_groups=2) for c in (jcfg, tcfg))
    jp = jax.jit(j_de.init_dual_encoder, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jcfg, JDE(proj_dims=PROJ, lambda_cco=LAM))
    rng = np.random.RandomState(3)
    if arch == "resnet14-cifar":
        leaf = "images"
        views = [rng.rand(8, 16, 16, 3).astype(np.float32) for _ in range(2)]
    else:
        leaf = "tokens"
        views = [rng.randint(0, 512, (8, 16)).astype(np.int32)
                 for _ in range(2)]
    return jcfg, tcfg, jp, leaf, views


def _batch(leaf, views, to):
    return {"view1": {leaf: to(views[0])}, "view2": {leaf: to(views[1])}}


@pytest.fixture(scope="module", params=["resnet14-cifar", "tinyllama-1.1b"])
def tower(request):
    return _tower(request.param)


@pytest.mark.parametrize("micro", [1, 2])
def test_dcco_train_step_matches_reference(tower, micro):
    jcfg, tcfg, jp, leaf, views = tower
    de = JDE(proj_dims=PROJ, lambda_cco=LAM)
    jt = JTrainConfig(global_batch=8, samples_per_client=2)
    opt_j = j_opt.sgd(LR)
    step_j = jax.jit(j_steps.make_dcco_train_step(
        jcfg, de, jt, opt_j, num_microbatches=micro))
    pj, _, mj = step_j(jp, opt_j.init(jp), _batch(leaf, views, jnp.asarray))

    p0 = convert.params_from_jax(_np(jp))
    opt_t = opt_lib.sgd(LR)
    step_t = steps.make_dcco_train_step(
        tcfg, DualEncoderConfig(proj_dims=PROJ, lambda_cco=LAM),
        TrainConfig(global_batch=8, samples_per_client=2), opt_t,
        num_microbatches=micro)
    batch_t = _batch(leaf, views, lambda x: torch.from_numpy(x).long()
                     if x.dtype == np.int32 else torch.from_numpy(x))
    pt, _, mt = step_t(p0, opt_t.init(p0), batch_t)
    assert _rel(pt, convert.params_from_jax(_np(pj)), p0) < 1e-3
    np.testing.assert_allclose(mt["loss"].item(), float(mj["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(mt["encoding_std"].item(),
                               float(mj["encoding_std"]), rtol=1e-4)


def test_microbatched_gradient_equals_the_single_step(tower):
    _, tcfg, jp, leaf, views = tower
    p0 = convert.params_from_jax(_np(jp))
    batch = _batch(leaf, views, lambda x: torch.from_numpy(x).long()
                   if x.dtype == np.int32 else torch.from_numpy(x))
    grads = {}
    for micro in (1, 2, 4):
        step = steps.make_dcco_train_step(
            tcfg, DualEncoderConfig(proj_dims=PROJ, lambda_cco=LAM),
            TrainConfig(global_batch=8, samples_per_client=2),
            opt_lib.sgd(LR), num_microbatches=micro)
        grads[micro], _ = step.grads(p0, batch)
    assert all(x.dtype == torch.float32
               for x in utils.tree_leaves(grads[2]))
    scale = _max_abs(grads[1])
    for micro in (2, 4):
        assert utils.tree_max_abs_diff(grads[micro], grads[1]) \
            <= 1e-4 * scale, micro
    with pytest.raises(ValueError, match="microbatches"):
        steps.make_dcco_train_step(
            tcfg, DualEncoderConfig(proj_dims=PROJ), TrainConfig(),
            opt_lib.sgd(LR), num_microbatches=3).grads(p0, batch)


def test_per_client_step_equals_fused_step():
    """The per-client D-CCO loss gives the fused step's update (Appendix
    A), here on the toy-sized smoke ResNet batch of 4 clients of 2."""
    _, tcfg, jp, leaf, views = _tower("resnet14-cifar")
    p0 = convert.params_from_jax(_np(jp))
    batch = _batch(leaf, views, torch.from_numpy)
    out = {}
    for impl in ("fused", "per_client"):
        opt = opt_lib.sgd(LR)
        step = steps.make_dcco_train_step(
            tcfg, DualEncoderConfig(proj_dims=PROJ, lambda_cco=LAM),
            TrainConfig(global_batch=8, samples_per_client=2,
                        dcco_impl=impl), opt)
        out[impl] = step(p0, opt.init(p0), batch)
    assert _rel(out["per_client"][0], out["fused"][0], p0) < 1e-3
    np.testing.assert_allclose(out["per_client"][2]["loss"].item(),
                               out["fused"][2]["loss"].item(), rtol=1e-4)


def test_lm_train_step_matches_reference():
    jcfg = j_get_config("tinyllama-1.1b", smoke=True)
    tcfg = get_config("tinyllama-1.1b", smoke=True)
    jp = j_tf.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.RandomState(4).randint(0, 512, (3, 17)).astype(
        np.int32)
    opt_j = j_opt.sgd(0.1)
    pj, _, mj = jax.jit(j_steps.make_lm_train_step(jcfg, opt_j))(
        jp, opt_j.init(jp), {"tokens": jnp.asarray(tokens)})
    p0 = convert.params_from_jax(_np(jp))
    opt_t = opt_lib.sgd(0.1)
    pt, _, mt = steps.make_lm_train_step(tcfg, opt_t)(
        p0, opt_t.init(p0), {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(mt["loss"].item(), float(mj["loss"]),
                               rtol=1e-5)
    assert _rel(pt, convert.params_from_jax(_np(pj)), p0) < 1e-3


def test_flash_forwards_per_step_and_per_chunk(monkeypatch):
    """The flash Function's forward calls, which are the kernel's launches
    on the card (counted here through the plain version): 2 views x L
    layers for the single step; 6L a microbatch for the microbatched step
    (phase 1, phase 2's checkpointed forward and its recompute); 4L a
    chunk for a streamed round (phase 1, and phase 2 with the clients of
    the chunk folded into one call by the Function's vmap rule)."""
    calls = []
    real = flash_mod._forward
    monkeypatch.setattr(flash_mod, "_forward",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    cfg = get_config("tinyllama-1.1b", smoke=True)
    de = DualEncoderConfig(proj_dims=PROJ, lambda_cco=LAM)
    layers = cfg.num_layers
    p0 = dual_encoder.init_dual_encoder(0, cfg, de)
    toks = torch.randint(0, 512, (8, 16), generator=torch.Generator()
                         .manual_seed(0))
    batch = {"view1": {"tokens": toks}, "view2": {"tokens": toks.flip(0)}}
    for micro, want in ((1, 2 * layers), (2, 2 * 6 * layers)):
        calls.clear()
        step = steps.make_dcco_train_step(
            cfg, de, TrainConfig(global_batch=8, samples_per_client=2),
            opt_lib.sgd(LR), num_microbatches=micro)
        step(p0, opt_lib.sgd(LR).init(p0), batch)
        assert len(calls) == want, (micro, len(calls))
    calls.clear()
    opt = opt_lib.sgd(LR)
    cohort = {"v1": toks.reshape(4, 2, 16), "v2": toks.flip(0).reshape(
        4, 2, 16)}
    streaming_stats_round(
        make_apply(cfg, de), p0, opt.init(p0), opt,
        lambda c: ({k: v[2 * c:2 * c + 2] for k, v in cohort.items()},
                   torch.full((2,), 2)), 2, torch.full((4,), 2),
        objective=get_objective("dcco", lam=LAM))
    assert len(calls) == 2 * 4 * layers
    assert calls[2 * layers][0] == 2 * 2        # a chunk's 2 x 2 sequences


# ----------------------------------------------------------------- CLI --

SMALL = ["--device", "cpu", "--rounds", "2", "--eval-every", "1",
         "--dataset-size", "48", "--clients-per-round", "4"]


def test_modes_run_and_agree_with_the_engine(capsys, tmp_path):
    """Two rounds of each mode from one seed. Protocol trains on the
    engine's cohorts (the same round seeds) with the engine's per-client
    phase 1: the same bits. By Appendix A the fused step (one local step
    at client lr 1, equal-size clients) is the same round; at random init
    two D-CCO rounds amplify f32 regrouping (the engine's own fused-vs-off
    phase 1 moves them by ~1e-1 of the update here), so the fused modes
    are held to 4x that, and one round to 1e-3 of its update."""
    out = {}
    for mode, extra in (("engine", ["--stats-kernel", "off"]),
                        ("engine", ["--stats-kernel", "fused"]),
                        ("protocol", []), ("fused", []),
                        ("fused", ["--micro", "2"])):
        res = train.main([*SMALL, "--mode", mode, "--server-optimizer",
                          "sgd", "--ckpt-dir", str(tmp_path / mode),
                          "--ckpt-every", "2", *extra])
        assert res["loss_finite"] and len(res["history"]) == 2
        assert len(res["probes"]) == 2 and len(res["round_ms"]) == 2
        out[" ".join([mode, *extra])] = res
    assert (tmp_path / "fused" / "resnet14-cifar.msgpack").exists()
    p0 = dual_encoder.init_dual_encoder(
        0, get_config("resnet14-cifar", smoke=True),
        DualEncoderConfig(proj_dims=PROJ))
    ref = out["engine --stats-kernel off"]
    assert utils.tree_max_abs_diff(out["protocol"]["params"],
                                   ref["params"]) == 0.0
    assert out["protocol"]["history"] == ref["history"]
    err_self = _rel(out["engine --stats-kernel fused"]["params"],
                    ref["params"], p0)
    for name in ("fused", "fused --micro 2"):
        assert _rel(out[name]["params"], ref["params"], p0) \
            <= max(1e-3, 4 * err_self), name
        np.testing.assert_allclose(out[name]["history"][0],
                                   ref["history"][0], rtol=1e-5)
    one = train.main([*SMALL, "--rounds", "1", "--mode", "fused",
                      "--server-optimizer", "sgd", "--ckpt-every", "0"])
    ref1 = train.main([*SMALL, "--rounds", "1", "--stats-kernel", "off",
                       "--server-optimizer", "sgd", "--ckpt-every", "0"])
    assert _rel(one["params"], ref1["params"], p0) < 1e-3
    assert "round     2 loss=" in capsys.readouterr().out


def test_protocol_mode_over_a_channel_with_scaffold_and_resume(tmp_path):
    res = train.main([*SMALL, "--mode", "protocol", "--channel", "int8",
                      "--scaffold", "--ckpt-dir", str(tmp_path),
                      "--ckpt-every", "1"])
    assert res["loss_finite"] and res["wire_bytes"] > 0
    again = train.main([*SMALL, "--rounds", "3", "--mode", "protocol",
                        "--channel", "int8", "--scaffold", "--ckpt-dir",
                        str(tmp_path / "b"), "--resume",
                        str(tmp_path / "resnet14-cifar.msgpack")])
    assert len(again["history"]) == 1


def test_fused_mode_on_the_token_tower():
    res = train.main([*SMALL, "--arch", "tinyllama-1.1b", "--seq-len", "8",
                      "--mode", "fused", "--micro", "4"])
    assert res["loss_finite"] and np.isnan(res["probe"])


@pytest.mark.parametrize("flags, match", [
    (["--mode", "fused", "--partition", "dirichlet_quantity"],
     "dirichlet_quantity"),
    (["--mode", "fused", "--objective", "dvicreg"], "hardcodes the CCO"),
    (["--mode", "protocol", "--clusters", "2"], "--clusters runs"),
    (["--mode", "fused", "--async-k", "2"], "--async-k runs"),
    (["--mode", "protocol", "--retrieval-eval"], "--retrieval-eval runs"),
    (["--mode", "fused", "--stats-kernel", "off"], "--stats-kernel"),
    (["--mode", "protocol", "--chunk-rounds", "2"], "--chunk-rounds"),
    (["--mode", "protocol", "--compute-dtype", "bfloat16"],
     "--compute-dtype"),
    (["--mode", "fused", "--channel", "int8"], "no per-client wire"),
    (["--mode", "fused", "--edges", "2"], "no per-client wire"),
    (["--mode", "fused", "--server-opt", "fedadam"], "--server-opt"),
    (["--mode", "fused", "--fedprox-mu", "0.1"], "--fedprox-mu"),
    (["--mode", "fused", "--local-steps", "2"], "--local-steps"),
    (["--mode", "fused", "--micro", "3"], "divide the global batch"),
    (["--micro", "2"], "--micro would be"),
])
def test_mode_refusals(flags, match):
    with pytest.raises(SystemExit, match=match):
        train.parse_args([*SMALL, *flags])


def test_fused_and_protocol_modes_train_dcco_only():
    args = train.parse_args([*SMALL, "--mode", "fused"])
    with pytest.raises(SystemExit, match="round engine only"):
        train.run(args, algorithm="fedavg_cco")
    # encode_pair is encode of each view
    cfg = get_config("resnet14-cifar", smoke=True)
    de = DualEncoderConfig(proj_dims=PROJ)
    p = dual_encoder.init_dual_encoder(0, cfg, de)
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    zf, zg, aux = dual_encoder.encode_pair(cfg, de, p, {"images": x},
                                           {"images": x.flip(0)})
    assert torch.equal(zf, dual_encoder.encode(cfg, de, p,
                                               {"images": x})[0])
    assert zg.shape == zf.shape and aux == {}
