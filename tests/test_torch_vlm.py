"""The vision-text tower in the port (internvl2-2b: InternLM2 backbone,
patch embeddings projected by ``vis_proj`` and prepended) against the
reference, on the CPU: the config, the tower's forward with and without
patches, prefill and decode with the reference's text-sized cache (which
the patches overflow) and with a cache sized for them, the parameter tree
and its conversion, the paper's cross-modal pair (Fig. 1c) through
``encode_pair`` and the fused D-CCO step, one D-CCO round on the text
views (``vis_proj`` gets no gradient), and the training and serving CLIs.

Parity runs on the smoke config (2 layers, d_model 256, 16 patches of 64)
in f32, the parameters carried over by ``convert``. Tolerances: hidden
states and logits to 1e-5 of their largest magnitude (two layers of f32
matrix products and softmaxes summed in other orders; measured ~1e-7);
a decode step over a cache that holds every position against the port's
own full forward to 1e-4 of max |logits|; the fused step's loss to rtol
1e-4 and its parameters to 1e-4 of the update, ``max|p_port - p_ref| /
max|p_ref - p_0|``, as tests/test_torch_transformer.py holds the token
encoder.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import DualEncoderConfig as JDE
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.base import get_config as j_get_config
from repro.configs.base import get_dual_encoder_config as j_get_de
from repro.core import fed_sim as j_fed_sim
from repro.core import round_engine as j_engine
from repro.data import partition as j_partition
from repro.data import pipeline as j_pipeline
from repro.data import synthetic as j_synthetic
from repro.launch import steps as j_steps
from repro.models import dual_encoder as j_de
from repro.models import transformer as j_tf
from repro.optim import optimizers as j_opt
from repro_torch import convert, utils
from repro_torch.configs.base import (DualEncoderConfig, TrainConfig,
                                      get_config, get_dual_encoder_config)
from repro_torch.core import round_engine
from repro_torch.launch import serve, steps, train
from repro_torch.launch.train import make_apply
from repro_torch.models import dual_encoder, transformer
from repro_torch.optim import optimizers as opt_lib

torch.set_num_threads(1)

ARCH = "internvl2-2b"
PROJ = (64, 64)
LAM, LR = 5.0, 0.01
B, S, GEN = 2, 16, 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@functools.lru_cache(maxsize=None)
def _j_tower():
    """The reference's smoke config and tower parameters (its own draw)."""
    jcfg = j_get_config(ARCH, smoke=True)
    return jcfg, j_tf.init_params(jcfg, jax.random.PRNGKey(3))


def _tokens(b, s, seed):
    return np.random.RandomState(seed).randint(
        0, get_config(ARCH, smoke=True).vocab_size, (b, s)).astype(np.int32)


def _patches(b, seed):
    cfg = get_config(ARCH, smoke=True)
    return np.random.RandomState(seed).randn(
        b, cfg.vis_patches, cfg.vis_dim).astype(np.float32)


@pytest.mark.parametrize("smoke", [False, True])
def test_config_has_the_reference_values(smoke):
    mine, want = get_config(ARCH, smoke=smoke), j_get_config(ARCH,
                                                             smoke=smoke)
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(want, f.name), f.name
    assert mine.modality == "vision_text" and want.tie_embeddings
    assert get_dual_encoder_config(ARCH) == DualEncoderConfig(
        proj_dims=j_get_de(ARCH).proj_dims,
        lambda_cco=j_get_de(ARCH).lambda_cco,
        shared_towers=j_get_de(ARCH).shared_towers)
    assert get_dual_encoder_config(ARCH).proj_dims == (2048, 2048, 2048)




def test_init_tree_matches_reference_and_converts_both_ways():
    """The dual encoder's tree (``tower/vis_proj`` an MLP (vis_dim, d, d)
    with bias), shapes and dtypes the reference's, in f32 and bf16;
    ``convert`` carries it both ways bit for bit."""
    for dtype in ("float32", "bfloat16"):
        jcfg = j_get_config(ARCH, smoke=True).replace(dtype=dtype)
        tcfg = get_config(ARCH, smoke=True).replace(dtype=dtype)
        want = jax.eval_shape(lambda k: j_de.init_dual_encoder(
            k, jcfg, JDE(proj_dims=PROJ)), jax.random.PRNGKey(0))
        tp = dual_encoder.init_dual_encoder(
            0, tcfg, DualEncoderConfig(proj_dims=PROJ))
        jp = convert.params_to_jax(tp)
        assert [(p, x.shape, x.dtype) for p, x in
                jax.tree_util.tree_flatten_with_path(jp)[0]] == \
            [(p, x.shape, x.dtype) for p, x in
             jax.tree_util.tree_flatten_with_path(want)[0]]
        vis = tp["tower"]["vis_proj"]["layers"]
        assert [tuple(lp["w"].shape) for lp in vis] == [(64, 256),
                                                        (256, 256)]
        assert all(bool((lp["b"] == 0).all()) for lp in vis)
        back = convert.params_to_jax(convert.params_from_jax(jp))
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
            assert a.dtype == b.dtype and np.array_equal(
                a.view(np.uint8), b.view(np.uint8))
    # a text tower has no projector
    assert "vis_proj" not in transformer.init_params(
        get_config("tinyllama-1.1b", smoke=True), torch.Generator())


def test_tower_forward_with_and_without_patches_matches_reference():
    jcfg, jp = _j_tower()
    tcfg = get_config(ARCH, smoke=True)
    tp = convert.params_from_jax(_np(jp))
    toks, pe = _tokens(B, S, 1), _patches(B, 2)
    fwd = jax.jit(functools.partial(j_tf.forward, jcfg))
    for patches in (None, pe):
        want = np.asarray(fwd(jp, jnp.asarray(toks), None if patches is None
                              else jnp.asarray(patches)))
        got = transformer.forward(
            tcfg, tp, torch.from_numpy(toks),
            None if patches is None else torch.from_numpy(patches))
        p = 0 if patches is None else tcfg.vis_patches
        assert tuple(got.shape) == (B, p + S, tcfg.d_model)
        _close(got, want, 1e-5)
    # a text or audio tower ignores patches, as the reference's does
    dense = get_config("musicgen-large", smoke=True)
    dp = transformer.init_params(dense, torch.Generator().manual_seed(0))
    t = torch.from_numpy(_tokens(B, S, 1) % dense.vocab_size)
    assert torch.equal(transformer.forward(dense, dp, t),
                       transformer.forward(dense, dp, t,
                                           torch.randn(B, 4, 8)))


def _j_decode(jcfg, jp, toks, pe, max_len):
    cache = j_tf.init_cache(jcfg, B, max_len)
    first, cache = jax.jit(j_tf.prefill, static_argnums=0)(
        jcfg, jp, jnp.asarray(toks[:, :S]), cache,
        patch_embeds=jnp.asarray(pe))
    out = [np.asarray(first)]
    for t in range(S, S + GEN):
        d, cache = jax.jit(j_tf.decode_step, static_argnums=0)(
            jcfg, jp, cache, jnp.asarray(toks[:, t:t + 1]))
        out.append(np.asarray(d))
    return out


def _decode(tcfg, tp, toks, pe, max_len):
    """Prefill S tokens after the patches, then GEN steps over ``toks``
    through the serving steps; the prefill's logits first."""
    first, cache = steps.make_prefill_step(tcfg, max_len)(
        tp, {"tokens": torch.from_numpy(toks[:, :S]),
             "patch_embeds": torch.from_numpy(pe)})
    step = steps.make_serve_step(tcfg)
    out = [first]
    for t in range(S, S + GEN):
        out.append(step(tp, cache, {"tokens": torch.from_numpy(
            toks[:, t:t + 1])})[0])
    assert int(cache["pos"]) == tcfg.vis_patches + S + GEN
    return out


def test_prefill_and_decode_match_reference_with_either_cache():
    """The reference's serving cache (``prompt + gen + 1`` positions: the
    P patches push the prefill into the attention ring, so decode attends
    to the last positions only) is reproduced step for step; a cache of
    P + prompt + gen + 1 positions meets the full forward with the
    patches, where the text-sized one departs from it."""
    jcfg, jp = _j_tower()
    tcfg = get_config(ARCH, smoke=True)
    tp = convert.params_from_jax(_np(jp))
    toks, pe = _tokens(B, S + GEN, 4), _patches(B, 5)
    p = tcfg.vis_patches
    full = [transformer.logits_from_hidden(tcfg, tp, transformer.forward(
        tcfg, tp, torch.from_numpy(toks[:, :S + j]),
        torch.from_numpy(pe))[:, -1]) for j in range(GEN + 1)]
    scale = max(float(x.abs().max()) for x in full)
    dist = {}
    for max_len in (S + GEN + 1, p + S + GEN + 1):
        got = _decode(tcfg, tp, toks, pe, max_len)
        for g, w in zip(got, _j_decode(jcfg, jp, toks, pe, max_len)):
            _close(g, w, 1e-5)
        dist[max_len] = max(float((g - f).abs().max())
                            for g, f in zip(got[1:], full[1:]))
        _close(got[0], full[0], 1e-4)      # the prefill sees every position
    assert dist[p + S + GEN + 1] < 1e-4 * scale
    assert dist[S + GEN + 1] > 100 * dist[p + S + GEN + 1]


def _fig1c_views(n):
    """The paper's cross-modal pair, laid out as
    ``launch.inputs.train_input_specs`` lays it out: view 1 text tokens
    (N, S), view 2 one BOS token and the patch embeddings (bf16)."""
    toks, bos, pe = _tokens(n, S, 6), _tokens(n, 1, 7), _patches(n, 8)
    jv = ({"tokens": jnp.asarray(toks)},
          {"tokens": jnp.asarray(bos),
           "patch_embeds": jnp.asarray(pe).astype(jnp.bfloat16)})
    tv = ({"tokens": torch.from_numpy(toks)},
          {"tokens": torch.from_numpy(bos),
           "patch_embeds": torch.from_numpy(pe).to(torch.bfloat16)})
    return jv, tv


def test_encode_pair_and_fused_step_on_the_cross_modal_pair():
    """Fig. 1c: ``encode_pair`` of text against patches, then one fused
    D-CCO step: the loss and the update, ``vis_proj`` included (its
    gradient comes from view 2), against the reference's."""
    jcfg, tcfg = j_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jde = JDE(proj_dims=PROJ, lambda_cco=LAM)
    tde = DualEncoderConfig(proj_dims=PROJ, lambda_cco=LAM)
    jp = j_de.init_dual_encoder(jax.random.PRNGKey(4), jcfg, jde)
    p0 = convert.params_from_jax(_np(jp))
    (jv1, jv2), (tv1, tv2) = _fig1c_views(8)
    zfj, zgj, _ = j_de.encode_pair(jcfg, jde, jp, jv1, jv2)
    zft, zgt, aux = dual_encoder.encode_pair(tcfg, tde, p0, tv1, tv2)
    assert aux == {} and tuple(zgt.shape) == (8, PROJ[-1])
    _close(zft, zfj, 1e-5)
    _close(zgt, zgj, 1e-5)
    opt_j = j_opt.sgd(LR)
    pj, _, mj = jax.jit(j_steps.make_dcco_train_step(
        jcfg, jde, JTrainConfig(global_batch=8, samples_per_client=2),
        opt_j))(jp, opt_j.init(jp), {"view1": jv1, "view2": jv2})
    opt_t = opt_lib.sgd(LR)
    pt, _, mt = steps.make_dcco_train_step(
        tcfg, tde, TrainConfig(global_batch=8, samples_per_client=2),
        opt_t)(p0, opt_t.init(p0), {"view1": tv1, "view2": tv2})
    want = convert.params_from_jax(_np(pj))
    assert utils.tree_max_abs_diff(pt, want) \
        / utils.tree_max_abs_diff(want, p0) < 1e-4
    vis = pt["tower"]["vis_proj"], want["tower"]["vis_proj"]
    moved = utils.tree_max_abs_diff(vis[1], p0["tower"]["vis_proj"])
    assert moved > 0
    assert utils.tree_max_abs_diff(*vis) < 1e-4 * moved
    np.testing.assert_allclose(mt["loss"].item(), float(mj["loss"]),
                               rtol=1e-4)


def _j_apply(cfg, de):
    def apply(p, batch):
        zf, _ = j_de.encode(cfg, de, p, {"tokens": batch["v1"]})
        zg, _ = j_de.encode(cfg, de, p, {"tokens": batch["v2"]})
        return zf, zg
    return apply


def test_one_dcco_round_on_text_views_leaves_vis_proj_as_the_reference():
    """One D-CCO round with server Adam on a reference-drawn cohort of
    text views (the reference's pipeline gives a VLM nothing else): the
    patch projector gets a zero gradient in phase 2 (``torch.func`` fills
    the unreached leaves with zeros, as ``jax.grad`` does), so its
    parameters and its Adam moments stay what the reference's are, bit
    for bit, while the rest of the tower moves."""
    jcfg, tcfg = j_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jp = j_de.init_dual_encoder(jax.random.PRNGKey(0), jcfg,
                                JDE(proj_dims=PROJ))
    toks, labels = j_synthetic.synthetic_labeled_tokens(48, 4, S, 512,
                                                        seed=1)
    ds = j_pipeline.FederatedDataset.build(
        {"tokens": toks}, labels, num_clients=16, samples_per_client=3,
        partition=j_partition.PartitionSpec("dirichlet", alpha=0.0),
        seed=0, vocab=512)
    batch, sizes = ds.round_batch(jax.random.PRNGKey(42), 4)
    opt_j = j_opt.adam(1e-3)
    pj, oj, mj = jax.jit(lambda p, o, b, sz: j_fed_sim.dcco_round(
        _j_apply(jcfg, JDE(proj_dims=PROJ)), p, o, opt_j, b, sz, lam=LAM,
        agg_stats_fn=j_engine.make_kernel_agg_stats(interpret=True)))(
            jp, opt_j.init(jp), batch, sizes)
    p0 = convert.params_from_jax(_np(jp))
    opt_t = opt_lib.adam(1e-3)
    round_fn = round_engine.make_round_body(
        make_apply(tcfg, DualEncoderConfig(proj_dims=PROJ)), opt_t,
        round_engine.EngineConfig(lam=LAM, stats_kernel="fused"))
    pt, ot, mt = round_fn(p0, opt_t.init(p0),
                          utils.tree_map(lambda x: torch.tensor(np.asarray(x)),
                                         batch),
                          torch.tensor(np.asarray(sizes)))
    want = convert.params_from_jax(_np(pj))
    for tree, ref in ((pt, want), (ot["m"], convert.params_from_jax(
            _np(oj["m"]))), (ot["v"], convert.params_from_jax(_np(oj["v"])))):
        for a, b in zip(utils.tree_leaves(tree["tower"]["vis_proj"]),
                        utils.tree_leaves(ref["tower"]["vis_proj"])):
            assert torch.equal(a, b)
    for a, b in zip(utils.tree_leaves(pt["tower"]["vis_proj"]),
                    utils.tree_leaves(p0["tower"]["vis_proj"])):
        assert torch.equal(a, b)
    assert utils.tree_max_abs_diff(pt["tower"]["layers"],
                                   p0["tower"]["layers"]) > 0
    np.testing.assert_allclose(mt.loss.item(), float(mj.loss), rtol=1e-4)


def test_train_cli_runs_two_rounds_on_text_views():
    """``train --arch internvl2-2b`` (smoke): finite losses, and the patch
    projector as initialised (no view carries patches)."""
    res = train.main(["--device", "cpu", "--arch", ARCH, "--seq-len", "16",
                      "--rounds", "2", "--eval-every", "1",
                      "--dataset-size", "32", "--clients-per-round", "4",
                      "--num-classes", "3"])
    assert res["loss_finite"] and len(res["history"]) == 2
    init = dual_encoder.init_dual_encoder(
        0, get_config(ARCH, smoke=True), DualEncoderConfig(proj_dims=PROJ))
    for a, b in zip(utils.tree_leaves(res["params"]["tower"]["vis_proj"]),
                    utils.tree_leaves(init["tower"]["vis_proj"])):
        assert torch.equal(a, b)
    assert utils.tree_max_abs_diff(res["params"]["tower"]["layers"],
                                   init["tower"]["layers"]) > 0


def test_serve_cli_prepends_random_patches():
    out = serve.main(["--device", "cpu", "--arch", ARCH, "--batch", "2",
                      "--prompt-len", "8", "--gen", "3"])
    cfg = get_config(ARCH, smoke=True)
    assert out["tokens"].shape == (2, 3)
    assert out["patch_embeds"].shape == (2, cfg.vis_patches, cfg.vis_dim)
    assert out["patch_embeds"].dtype == torch.bfloat16
    assert all(bool(torch.isfinite(x).all()) for x in out["logits"])
    # the reference's cache, prompt + gen + 1 positions, not the patches'
    assert out["cache"]["layers"]["b0"]["k"].shape[2] == 8 + 3 + 1
