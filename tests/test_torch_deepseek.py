"""The DeepSeek family in the port (deepseek-moe-16b: GQA + MoE FFN;
deepseek-v2-lite-16b: MLA + MoE FFN) against the reference, on the CPU:
the configs, both smoke towers' forward with their aux losses, prefill and
decode, the parameter tree and its conversion, checkpoints, the fused
D-CCO step's aux terms, and the training and serving CLIs.

Parity runs on the smoke configs (3 layers: one dense prologue layer, two
MoE layers of 4 experts, top 2) in f32, the reference's parameters carried
over by ``convert``. Tolerances: the tower 1e-4 of the hidden state's
largest magnitude and the aux sums rtol 1e-5 (f32 products of 256-wide
rows and the routers' softmaxes summed in other orders; the routing
itself agrees exactly); prefill and decode logits 1e-4 of their
magnitude against the reference's, and a decode step against the port's
own full forward to the reference's test bound, 2e-2 x max(1, max
|logits|) (tests/test_smoke_archs.py), at capacity factor 8 so that
neither grouping drops a token. The fused step: parameters within 1e-3
of the step's update and the loss to rtol 1e-4, as
tests/test_torch_train_modes.py holds the dense towers; its aux terms'
gradient, in f64, to 1e-6 of that gradient's magnitude (the same sums
taken in two passes). Files: byte for byte; conversions: bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as j_save
from repro.configs.base import DualEncoderConfig as JDE
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.base import get_config as j_get_config
from repro.launch import steps as j_steps
from repro.models import moe as j_moe
from repro.models import transformer as j_tf
from repro.optim import optimizers as j_opt
from repro_torch import convert, utils
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs.base import (DualEncoderConfig, TrainConfig,
                                      get_config)
from repro_torch.core import dcco
from repro_torch.launch import serve, steps, train
from repro_torch.models import dual_encoder, moe, transformer
from repro_torch.optim import optimizers as opt_lib

torch.set_num_threads(1)

ARCHS = ["deepseek-moe-16b", "deepseek-v2-lite-16b"]
PROJ = (64, 64)
LAM, LR = 5.0, 0.01


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, convert.params_to_jax(tree))


@functools.lru_cache(maxsize=None)
def _j_tower(arch, factor=None):
    """The reference's config and a smoke tower's parameters for it (the
    port's draw, carried over: the reference's jitted init would take
    longer than the tests that use it)."""
    cfg = j_get_config(arch, smoke=True)
    if factor is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=factor))
    return cfg, _to_jax(transformer.init_params(
        _t_cfg(arch), torch.Generator().manual_seed(0)))


def _t_cfg(arch, factor=None):
    cfg = get_config(arch, smoke=True)
    if factor is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=factor))
    return cfg


def _tokens(b, s, seed=1):
    return np.random.RandomState(seed).randint(0, 512, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_have_the_reference_values(arch, smoke):
    mine, ref = get_config(arch, smoke=smoke), j_get_config(arch, smoke=smoke)
    for f in dataclasses.fields(mine):
        if f.name == "moe":
            assert dataclasses.asdict(mine.moe) == dataclasses.asdict(ref.moe)
        else:
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    assert mine.num_prologue == ref.num_prologue == 1
    assert mine.num_superblocks == ref.num_superblocks


def test_full_config_decode_capacity_is_one():
    """Decode routes a step's B tokens as one group: at the full config
    and B = 4 that is one slot an expert, in both packages."""
    for arch in ARCHS:
        mc = get_config(arch).moe
        assert moe._capacity(4, mc) == j_moe._capacity(4, mc) == 1
        assert moe._capacity(512, mc) == j_moe._capacity(512, mc) == 60


@pytest.mark.parametrize("arch", ARCHS)
def test_tower_forward_and_aux_match_reference(arch):
    jcfg, jp = _j_tower(arch)
    tp = convert.params_from_jax(_np(jp))
    toks = _tokens(2, 16)
    h, aux = jax.jit(functools.partial(j_tf.forward, jcfg, return_aux=True))(
        jp, jnp.asarray(toks))
    th, taux = transformer.forward(_t_cfg(arch), tp,
                                   torch.from_numpy(toks).long(),
                                   return_aux=True)
    h = np.asarray(h)
    np.testing.assert_allclose(th.numpy(), h, rtol=0,
                               atol=1e-4 * float(np.abs(h).max()))
    assert set(taux) == {"balance", "router_z"}
    for k in taux:
        np.testing.assert_allclose(float(taux[k]), float(aux[k]), rtol=1e-5)
    # the dual encoder hands both views' sums up, as the reference's does
    de = DualEncoderConfig(proj_dims=PROJ)
    p = dual_encoder.init_dual_encoder(0, _t_cfg(arch), de)
    p["tower"] = tp
    view = {"tokens": torch.from_numpy(toks).long()}
    _, _, pair = dual_encoder.encode_pair(_t_cfg(arch), de, p, view, view)
    for k in pair:
        np.testing.assert_allclose(float(pair[k]), 2 * float(taux[k]),
                                   rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_and_forward(arch):
    """Prefill 15 tokens, decode the 16th, at capacity factor 8 (the
    reference's own consistency test), with the model-dtype and the
    int8 cache (which the MLA cache ignores)."""
    jcfg, jp = _j_tower(arch, 8.0)
    tcfg = _t_cfg(arch, 8.0)
    tp = convert.params_from_jax(_np(jp))
    toks = _tokens(2, 16, seed=2)
    jcache = j_tf.init_cache(jcfg, 2, 20)
    jl, jcache = jax.jit(j_tf.prefill, static_argnums=0)(
        jcfg, jp, jnp.asarray(toks[:, :15]), jcache)
    jd, _ = jax.jit(j_tf.decode_step, static_argnums=0)(
        jcfg, jp, jcache, jnp.asarray(toks[:, 15:16]))
    full = transformer.logits_from_hidden(
        tcfg, tp, transformer.forward(tcfg, tp, torch.from_numpy(toks))[:, -1])
    for kv in ("model", "int8"):
        c = tcfg.replace(kv_cache_dtype=kv)
        cache = transformer.init_cache(c, 2, 20)
        assert len(cache["prologue"]) == 1
        pl, cache = transformer.prefill(c, tp, torch.from_numpy(toks[:, :15]),
                                        cache)
        dl, cache = transformer.decode_step(c, tp, cache,
                                            torch.from_numpy(toks[:, 15:16]))
        assert int(cache["pos"]) == 16
        scale = max(1.0, float(full.abs().max()))
        assert float((dl - full).abs().max()) < 2e-2 * scale
        if kv == "model" or jcfg.use_mla:
            for got, want in ((pl, jl), (dl, jd)):
                want = np.asarray(want)
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=0,
                    atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference_and_converts_both_ways(arch):
    want = jax.eval_shape(lambda k: j_tf.init_params(
        j_get_config(arch, smoke=True), k), jax.random.PRNGKey(0))
    tp = transformer.init_params(_t_cfg(arch), torch.Generator().manual_seed(0))
    mine = jax.tree_util.tree_flatten_with_path(convert.params_to_jax(tp))[0]
    ref = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [(p, x.shape, x.dtype) for p, x in mine] == \
        [(p, x.shape, x.dtype) for p, x in ref]
    jp = convert.params_to_jax(tp)
    assert len(tp["prologue"]) == 1 and "ffn" in tp["prologue"][0]
    experts = tp["layers"]["b0"]["moe"]["experts"]
    assert experts["gate"].shape == (2, 4, 256, 128)
    assert experts["down"].shape == (2, 4, 128, 256)
    back = convert.params_to_jax(convert.params_from_jax(jp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # no expert leaf is transposed on the way in
    assert np.array_equal(
        convert.params_from_jax(jp)["layers"]["b0"]["moe"]["experts"]["up"]
        .numpy(), jp["layers"]["b0"]["moe"]["experts"]["up"])


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_is_the_references_byte_for_byte(tmp_path, arch):
    _, jp = _j_tower(arch)
    jp = jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)), jp)
    j_save(str(tmp_path / "ref.msgpack"), {"params": jp}, step=7)
    tp = convert.params_from_jax(jp)
    save_checkpoint(str(tmp_path / "port.msgpack"), {"params": tp}, step=7)
    assert (tmp_path / "port.msgpack").read_bytes() == \
        (tmp_path / "ref.msgpack").read_bytes()
    back, step = restore_checkpoint(str(tmp_path / "ref.msgpack"),
                                    {"params": tp}, device="cpu")
    assert step == 7 and isinstance(back["params"]["prologue"], list)
    for a, b in zip(utils.tree_leaves(back), utils.tree_leaves(tp)):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)


@pytest.mark.parametrize("micro", [1, 2])
def test_fused_step_adds_the_aux_terms_as_the_reference(micro):
    """The fused D-CCO step on the smoke MoE dual encoder against the
    reference's, whose loss adds balance_weight * balance + 1e-4 *
    router_z of both views (the tower cut to its prologue and one MoE
    layer, which keeps the reference's compile short)."""
    arch = "deepseek-moe-16b"
    jcfg = j_get_config(arch, smoke=True).replace(num_layers=2)
    jde = JDE(proj_dims=PROJ, lambda_cco=LAM)
    jp = _to_jax(dual_encoder.init_dual_encoder(
        0, get_config(arch, smoke=True).replace(num_layers=2),
        DualEncoderConfig(proj_dims=PROJ)))
    views = [_tokens(8, 16, seed=s) for s in (3, 4)]
    opt_j = j_opt.sgd(LR)
    step_j = jax.jit(j_steps.make_dcco_train_step(
        jcfg, jde, JTrainConfig(global_batch=8, samples_per_client=2),
        opt_j, num_microbatches=micro))
    pj, _, mj = step_j(jp, opt_j.init(jp), {
        "view1": {"tokens": jnp.asarray(views[0])},
        "view2": {"tokens": jnp.asarray(views[1])}})
    p0 = convert.params_from_jax(_np(jp))
    opt_t = opt_lib.sgd(LR)
    step_t = steps.make_dcco_train_step(
        get_config(arch, smoke=True).replace(num_layers=2),
        DualEncoderConfig(proj_dims=PROJ, lambda_cco=LAM),
        TrainConfig(global_batch=8, samples_per_client=2), opt_t,
        num_microbatches=micro)
    pt, _, mt = step_t(p0, opt_t.init(p0), {
        "view1": {"tokens": torch.from_numpy(views[0]).long()},
        "view2": {"tokens": torch.from_numpy(views[1]).long()}})
    ref = convert.params_from_jax(_np(pj))
    assert utils.tree_max_abs_diff(pt, ref) \
        / utils.tree_max_abs_diff(ref, p0) < 1e-3
    np.testing.assert_allclose(mt["loss"].item(), float(mj["loss"]),
                               rtol=1e-4)


def test_fused_step_gradient_is_dcco_plus_the_aux_terms():
    """In f64, the step's gradient less the D-CCO loss's alone is the
    gradient of 0.01 * balance + 1e-4 * router_z (the terms are ~1e-5 of
    the D-CCO gradient, too small to see in f32)."""
    arch = "deepseek-moe-16b"
    cfg = get_config(arch, smoke=True).replace(dtype="float64")
    de = DualEncoderConfig(proj_dims=PROJ, lambda_cco=LAM)
    p0 = utils.tree_map(lambda x: x.double(), dual_encoder.init_dual_encoder(
        0, get_config(arch, smoke=True), de))
    batch = {"view1": {"tokens": torch.from_numpy(_tokens(8, 16, 3)).long()},
             "view2": {"tokens": torch.from_numpy(_tokens(8, 16, 4)).long()}}
    step = steps.make_dcco_train_step(cfg, de, TrainConfig(), opt_lib.sgd(LR))
    g_step, _ = step.grads(p0, batch)

    def part(which):
        p = utils.tree_map(lambda x: x.detach().requires_grad_(), p0)
        zf, zg, aux = dual_encoder.encode_pair(cfg, de, p, batch["view1"],
                                               batch["view2"])
        loss = (dcco.dcco_loss(zf, zg, LAM) if which == "dcco" else
                0.01 * aux["balance"] + 1e-4 * aux["router_z"])
        return steps._grads(loss, p)

    g_dcco, g_aux = part("dcco"), part("aux")
    diff = utils.tree_map(lambda a, b: a - b, g_step, g_dcco)
    scale = max(float(x.abs().max()) for x in utils.tree_leaves(g_aux))
    assert scale > 0
    assert utils.tree_max_abs_diff(diff, g_aux) <= 1e-6 * scale


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("flags", [
    ["--cohort-chunk", "2", "--edges", "2", "--channel", "int8"],
    ["--mode", "fused", "--micro", "2"],
    ["--mode", "protocol", "--num-layers", "2"],
])
def test_train_cli_runs_the_deepseek_towers(arch, flags):
    res = train.main(["--device", "cpu", "--arch", arch, "--seq-len", "16",
                      "--rounds", "2", "--eval-every", "1",
                      "--dataset-size", "32", "--clients-per-round", "4",
                      "--num-classes", "3", *flags])
    assert res["loss_finite"] and len(res["history"]) == 2
    tower = res["params"]["tower"]
    layers = tower["layers"]["b0"]["ln1"]["scale"].shape[0]
    assert layers == (1 if "--num-layers" in flags else 2)
    assert len(tower["prologue"]) == 1


def test_num_layers_refusals():
    with pytest.raises(SystemExit, match="--num-layers 1 must exceed"):
        train.parse_args(["--arch", "deepseek-moe-16b", "--num-layers", "1"])
    with pytest.raises(SystemExit, match="--num-layers"):
        train.parse_args(["--num-layers", "2"])          # the ResNet


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_the_deepseek_towers(arch):
    out = serve.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                      "--prompt-len", "16", "--gen", "4"])
    assert out["tokens"].shape == (2, 4)
    assert all(bool(torch.isfinite(x).all()) for x in out["logits"])
    res = serve.main(["--device", "cpu", "--arch", arch, "--retrieval",
                      "--corpus-sizes", "64", "--serve-batches", "2"])
    assert res[0]["n"] == 64 and res[0]["batches"] == 2
    assert res[0]["query_embeddings"].shape[1] == 64    # the (64, 64) head
