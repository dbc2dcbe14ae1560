"""The port's dense transformer tower and its token dual encoder against
the reference, on the CPU: the primitives, the tower's forward, the
token data path (synthetic tokens, augmentation given the reference's
draws, the federated pipeline), one D-CCO round, the training CLI and the
parameter conversion.

Parity runs on the smoke configs in f32 (TF32 plays no part on the CPU),
with the reference's parameters carried over by ``convert``. Tolerances:
the primitives 1e-6 (the same f32 formula on both sides); the tower and
the encoder 1e-4 of the output's magnitude (two layers of f32 matrix
products and softmaxes summed in other orders; measured 1e-6 to 1e-5).
One D-CCO round is held as tests/test_torch_round.py holds the ResNet's:
parameters within 1e-3 of the round's update, ``max|p_port - p_ref| /
max|p_ref - p_0|``, and the loss to rtol 1e-4 (measured: 1.4e-6 of the
update, the loss equal to f32 print precision).
"""
import os
from pathlib import Path
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import DualEncoderConfig as JDE
from repro.configs.base import get_config as j_get_config
from repro.core import fed_sim as j_fed_sim
from repro.core import round_engine as j_engine
from repro.data import augment as j_augment
from repro.data import partition as j_partition
from repro.data import pipeline as j_pipeline
from repro.data import synthetic as j_synthetic
from repro.models import common as j_common
from repro.models import dual_encoder as j_de
from repro.models import transformer as j_tf
from repro.optim import optimizers as j_opt
from repro_torch import convert, utils
from repro_torch.configs.base import DualEncoderConfig, get_config
from repro_torch.core import round_engine
from repro_torch.data import augment, partition, pipeline, synthetic
from repro_torch.launch.train import make_apply
from repro_torch.models import common, dual_encoder, transformer
from repro_torch.optim import optimizers as opt_lib

# tier-1 runs 6 pytest workers on the machine's cores: one torch thread
# per worker keeps them from contending with each other and with JAX
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PROJ = (64, 64)
SEQ = 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------ primitives --

def test_rmsnorm_rope_swiglu_match_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 12, 4, 32).astype(np.float32)
    scale = rng.rand(32).astype(np.float32) + 0.5
    want = j_common.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                            1e-5)
    got = common.rmsnorm({"scale": torch.from_numpy(scale)},
                         torch.from_numpy(x), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    pos = np.broadcast_to(np.arange(3, 15)[None], (2, 12)).copy()
    for theta in (10_000.0, 1_000_000.0):
        want = j_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                theta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    jp = j_common.swiglu_init(jax.random.PRNGKey(1), 32, 48, jnp.float32)
    h = rng.randn(5, 32).astype(np.float32)
    want = j_common.swiglu(jp, jnp.asarray(h))
    got = common.swiglu(convert.params_from_jax(_np(jp)), torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    table = rng.randn(50, 8).astype(np.float32)
    toks = rng.randint(0, 50, (3, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        common.embed({"table": torch.from_numpy(table)},
                     torch.from_numpy(toks)).numpy(),
        np.asarray(j_common.embed({"table": jnp.asarray(table)},
                                  jnp.asarray(toks))))


# ----------------------------------------------------------------- tower --

def _tokens(cfg, b, s, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-1.7b"])
def test_forward_and_token_encode_match_reference(arch):
    """The tower's hidden states and the dual encoder's token encoding
    (mean-pooled, with and without a mask); qwen3 covers qk_norm and a
    rope theta of 1e6."""
    jcfg, tcfg = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    jp = j_de.init_dual_encoder(jax.random.PRNGKey(2), jcfg,
                                JDE(proj_dims=PROJ))
    tp = convert.params_from_jax(_np(jp))
    toks = _tokens(jcfg, 3, 24, 3)
    want = np.asarray(j_tf.forward(jcfg, jp["tower"], jnp.asarray(toks)))
    got = transformer.forward(tcfg, tp["tower"], torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))
    mask = (np.arange(24)[None] < np.array([[24], [10], [1]])).astype(
        np.float32)
    for view_mask in (None, mask):
        jv = {"tokens": jnp.asarray(toks)}
        tv = {"tokens": torch.from_numpy(toks)}
        if view_mask is not None:
            jv["mask"], tv["mask"] = (jnp.asarray(view_mask),
                                      torch.from_numpy(view_mask))
        zj, _ = j_de.encode(jcfg, JDE(proj_dims=PROJ), jp, jv)
        zt, aux = dual_encoder.encode(tcfg, DualEncoderConfig(
            proj_dims=PROJ), tp, tv)
        assert zt.dtype == torch.float32 and aux == {}
        np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(zj).max()))


def test_init_has_reference_tree_and_round_trips():
    """The port's random init has the reference's tree, shapes and types
    (stacked ``layers``), and ``convert`` carries it both ways exactly,
    bf16 leaves included."""
    for arch, dtype in (("tinyllama-1.1b", None), ("qwen3-1.7b", "bfloat16")):
        jcfg = j_get_config(arch, smoke=True)
        tcfg = get_config(arch, smoke=True)
        if dtype:
            jcfg, tcfg = jcfg.replace(dtype=dtype), tcfg.replace(dtype=dtype)
        jp = jax.eval_shape(lambda k: j_de.init_dual_encoder(
            k, jcfg, JDE(proj_dims=PROJ)), jax.random.PRNGKey(0))
        tp = dual_encoder.init_dual_encoder(0, tcfg,
                                            DualEncoderConfig(proj_dims=PROJ))
        back = convert.params_to_jax(tp)
        assert jax.tree.structure(back) == jax.tree.structure(jp)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
            assert a.shape == b.shape and a.dtype == b.dtype
        assert tp["tower"]["layers"]["b0"]["attn"]["wq"]["w"].shape[0] == \
            tcfg.num_layers
        again = convert.params_from_jax(back)
        for a, b in zip(utils.tree_leaves(again), utils.tree_leaves(tp)):
            assert a.dtype == b.dtype and torch.equal(a, b)


# ------------------------------------------------------------------ data --

def test_synthetic_tokens_equal_reference():
    for args in ((50, 4, 16, 512, 0.25, 0), (33, 7, 9, 100, 0.1, 5)):
        tj, lj = j_synthetic.synthetic_labeled_tokens(*args)
        tt, lt = synthetic.synthetic_labeled_tokens(*args)
        np.testing.assert_array_equal(tt, tj)
        np.testing.assert_array_equal(lt, lj)
        assert tt.dtype == tj.dtype and lt.dtype == lj.dtype


def _reference_token_draws(key, s, mask_prob=0.15, crop_prob=0.5,
                           max_crop_frac=0.25):
    """The draws ``augment_tokens(key, ...)`` makes, from its keys."""
    km, kc, ks, _ = jax.random.split(key, 4)
    return (np.asarray(jax.random.bernoulli(km, mask_prob, (s,))),
            bool(jax.random.bernoulli(kc, crop_prob)),
            int(jax.random.randint(ks, (), 0, max(1, int(s * max_crop_frac)))))


def test_augment_tokens_given_reference_draws():
    toks = _tokens(get_config("tinyllama-1.1b", smoke=True), 12, 20, 4)
    keys = jax.random.split(jax.random.PRNGKey(5), 12)
    want = np.stack([np.asarray(j_augment.augment_tokens(kk, jnp.asarray(t),
                                                         512))
                     for kk, t in zip(keys, toks)])
    drawn = [_reference_token_draws(kk, 20) for kk in keys]
    draws = augment.TokenAugmentDraws(
        torch.from_numpy(np.stack([d[0] for d in drawn])),
        torch.tensor([d[1] for d in drawn]),
        torch.tensor([d[2] for d in drawn]))
    assert draws.do_crop.any() and not draws.do_crop.all()
    got = augment.augment_tokens(torch.from_numpy(toks), draws)
    np.testing.assert_array_equal(got.numpy(), want)
    # the port's own draws have the reference's ranges
    d = augment.draw_augment_tokens(torch.Generator().manual_seed(0), 64, 20)
    assert d.mask.shape == (64, 20) and d.shift.max() < 5
    gen = torch.Generator().manual_seed(0)
    v1, v2 = (augment.augment_tokens(
        torch.from_numpy(toks), augment.draw_augment_tokens(gen, *toks.shape))
        for _ in range(2))
    assert v1.shape == v2.shape == toks.shape and not torch.equal(v1, v2)


def test_pipeline_token_path():
    toks, labels = synthetic.synthetic_labeled_tokens(64, 4, SEQ, 512)
    ds = pipeline.FederatedDataset.build(
        {"tokens": toks}, labels, num_clients=16, samples_per_client=3,
        partition=partition.PartitionSpec("dirichlet", alpha=0.0))
    assert ds.leaf == "tokens"
    gen = torch.Generator().manual_seed(1)
    batch, sizes = ds.make_round_sampler(4, "cpu")(gen)
    assert batch["v1"].shape == (4, 3, SEQ) and sizes.shape == (4,)
    assert batch["v1"].dtype == torch.int32
    batch, _ = ds.round_batch(gen, 4)
    assert batch["v2"].shape == (4, 3, SEQ)
    with pytest.raises(NotImplementedError, match="one leaf"):
        pipeline.FederatedDataset({"tokens": toks, "images": toks}, labels,
                                  ds.client_index)



@pytest.mark.parametrize("arch", ["resnet14-cifar", "tinyllama-1.1b"])
def test_dataset_and_apply_read_the_towers_input_leaf(arch):
    """``dual_encoder.input_leaf`` is the one place that names the leaf a
    tower reads: the CLI's dataset is keyed by it and the engine's apply
    encodes from it."""
    from types import SimpleNamespace
    from repro_torch.launch import train
    cfg = get_config(arch, smoke=True)
    leaf = dual_encoder.input_leaf(cfg)
    assert leaf == ("images" if arch.startswith("resnet") else "tokens")
    args = SimpleNamespace(dataset_size=32, num_classes=4, seq_len=SEQ,
                           seed=0, samples_per_client=4, partition=None,
                           alpha=None, severity=None)
    ds, _ = train.build_dataset(cfg, args)
    assert ds.leaf == leaf and set(ds.data) == {leaf}
    de = DualEncoderConfig(proj_dims=PROJ)
    params = dual_encoder.init_dual_encoder(0, cfg, de)
    batch, _ = ds.round_batch(torch.Generator().manual_seed(0), 2)
    x = batch["v1"].reshape(-1, *batch["v1"].shape[2:])
    with torch.no_grad():
        zf, zg = make_apply(cfg, de)(params, {"v1": x, "v2": x})
        want, _ = dual_encoder.encode(cfg, de, params, {leaf: x})
    assert zf.shape == (x.shape[0], PROJ[-1])
    torch.testing.assert_close(zf, want, rtol=0, atol=0)
    torch.testing.assert_close(zg, want, rtol=0, atol=0)


# ----------------------------------------------------------------- round --

def _j_apply(cfg, de):
    def apply(p, batch):
        zf, _ = j_de.encode(cfg, de, p, {"tokens": batch["v1"]})
        zg, _ = j_de.encode(cfg, de, p, {"tokens": batch["v2"]})
        return zf, zg
    return apply


def test_one_dcco_round_matches_reference():
    """One D-CCO round of the tinyllama smoke tower on a reference-drawn
    cohort of 6 clients x 3 sequences, from the same parameters, with the
    fused statistics (the reference's Pallas kernel interpreted, the
    port's plain version) and server SGD."""
    jcfg = j_get_config("tinyllama-1.1b", smoke=True)
    tcfg = get_config("tinyllama-1.1b", smoke=True)
    jp = j_de.init_dual_encoder(jax.random.PRNGKey(0), jcfg,
                                JDE(proj_dims=PROJ))
    toks, labels = j_synthetic.synthetic_labeled_tokens(96, 4, SEQ, 512,
                                                        seed=1)
    ds = j_pipeline.FederatedDataset.build(
        {"tokens": toks}, labels, num_clients=32, samples_per_client=3,
        partition=j_partition.PartitionSpec("dirichlet", alpha=0.0),
        seed=0, vocab=512)
    batch, sizes = ds.round_batch(jax.random.PRNGKey(42), 6)
    lr, lam = 0.005, 5.0
    opt_j = j_opt.sgd(lr)
    pj, _, mj = jax.jit(lambda p, o, b, sz: j_fed_sim.dcco_round(
        _j_apply(jcfg, JDE(proj_dims=PROJ)), p, o, opt_j, b, sz, lam=lam,
        agg_stats_fn=j_engine.make_kernel_agg_stats(interpret=True)))(
            jp, opt_j.init(jp), batch, sizes)

    p0 = convert.params_from_jax(_np(jp))
    opt_t = opt_lib.sgd(lr)
    round_fn = round_engine.make_round_body(
        make_apply(tcfg, DualEncoderConfig(proj_dims=PROJ)), opt_t,
        round_engine.EngineConfig(lam=lam, stats_kernel="fused"))
    pt, _, mt = round_fn(p0, opt_t.init(p0),
                         utils.tree_map(lambda x: torch.tensor(np.asarray(x)),
                                        batch),
                         torch.tensor(np.asarray(sizes)))
    ref = convert.params_from_jax(_np(pj))
    err = (utils.tree_max_abs_diff(pt, ref)
           / utils.tree_max_abs_diff(ref, convert.params_from_jax(_np(jp))))
    assert err < 1e-3, err
    np.testing.assert_allclose(mt.loss.item(), float(mj.loss), rtol=1e-4)
    np.testing.assert_allclose(mt.encoding_std.item(),
                               float(mj.encoding_std), rtol=1e-4)


# ------------------------------------------------------------------- CLI --

def test_train_cli_runs_the_token_tower_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "tinyllama-1.1b", "--seq-len", str(SEQ), "--rounds", "2",
         "--eval-every", "1", "--dataset-size", "64",
         "--clients-per-round", "4", "--num-classes", "3"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("round")]
    assert len(lines) == 2 and all("probe_acc=nan" in ln for ln in lines)
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines]
    assert np.all(np.isfinite(losses))


@pytest.mark.parametrize("flags", [
    ["--retrieval-eval", "--retrieval-every", "1", "--retrieval-corpus",
     "20", "--retrieval-queries", "10"],
    ["--async-k", "2", "--latency-tail", "1.0", "--staleness", "poly"],
    ["--objective", "dvicreg", "--stats-kernel", "fused"],
])
def test_train_runs_other_engine_paths_on_the_token_tower(flags):
    """The engine's paths are encoder-agnostic: the retrieval eval indexes
    token sequences, the buffered engine sizes its state from a meta-device
    trace of the token tower, D-VICReg takes the full moment set."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import train
    before = dict(flash_attention.launches)
    res = train.main(["--device", "cpu", "--arch", "tinyllama-1.1b",
                      "--seq-len", "8", "--rounds", "2", "--eval-every", "1",
                      "--dataset-size", "48", "--clients-per-round", "4",
                      "--num-classes", "3", *flags])
    assert res["loss_finite"] and len(res["history"]) == 2
    assert np.isnan(res["probe"])
    assert flash_attention.launches == before     # the plain version on CPU
    if "--retrieval-eval" in flags:
        assert all(0.0 <= x <= 1.0 for x in res["retrieval"]["mrr"])


def test_profile_round_runs_the_token_tower_on_cpu():
    from repro_torch.launch import profile_round
    res = profile_round.main(["--device", "cpu", "--arch", "tinyllama-1.1b",
                              "--seq-len", "8", "--clients-per-round", "2",
                              "--dataset-size", "32", "--warmup", "1",
                              "--rounds", "1"])
    assert res["wall_ms"] > 0 and res["busy_ms"] is None
