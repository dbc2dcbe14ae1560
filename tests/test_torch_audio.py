"""The audio decoder in the port (musicgen-large: a dense decoder over
EnCodec token ids, 32 heads with 32 KV heads) against the reference, on
the CPU: the config, the tower's forward, prefill and decode with the
model-dtype cache and the int8 cache, the parameter tree and its
conversion, the fused D-CCO step, and the training and serving CLIs.

Parity runs on the smoke config (2 layers, d_model 256, 4 heads of 64,
vocab 256) in f32, the parameters carried over by ``convert``.
Tolerances: hidden states and logits to 1e-5 of their largest magnitude
(measured ~1e-7); the int8 cache's decode step within 5% of max |logits|
of a full forward, the reference's own bound
(tests/test_perf_features.py); the fused step's loss to rtol 1e-4 and its
parameters to 1e-4 of the update.
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
from repro.launch import steps as j_steps
from repro.models import dual_encoder as j_de
from repro.models import transformer as j_tf
from repro.optim import optimizers as j_opt
from repro_torch import convert, utils
from repro_torch.configs.base import (DualEncoderConfig, TrainConfig,
                                      get_config, get_dual_encoder_config)
from repro_torch.launch import serve, steps, train
from repro_torch.models import transformer
from repro_torch.optim import optimizers as opt_lib

torch.set_num_threads(1)

ARCH = "musicgen-large"
PROJ = (64, 64)
LAM, LR = 5.0, 0.01


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@functools.lru_cache(maxsize=None)
def _j_tower():
    jcfg = j_get_config(ARCH, smoke=True)
    return jcfg, j_tf.init_params(jcfg, jax.random.PRNGKey(5))


def _tokens(b, s, seed):
    return np.random.RandomState(seed).randint(
        0, get_config(ARCH, smoke=True).vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("smoke", [False, True])
def test_config_has_the_reference_values(smoke):
    mine, want = get_config(ARCH, smoke=smoke), j_get_config(ARCH,
                                                             smoke=smoke)
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(want, f.name), f.name
    assert mine.modality == "audio_tokens" and want.tie_embeddings
    assert mine.num_heads == mine.num_kv_heads        # a group of 1
    assert get_dual_encoder_config(ARCH) == DualEncoderConfig()


def test_init_tree_matches_reference_and_converts_both_ways():
    for dtype in ("float32", "bfloat16"):
        jcfg = j_get_config(ARCH, smoke=True).replace(dtype=dtype)
        tcfg = get_config(ARCH, smoke=True).replace(dtype=dtype)
        want = jax.eval_shape(lambda k: j_tf.init_params(jcfg, k),
                              jax.random.PRNGKey(0))
        tp = transformer.init_params(tcfg, torch.Generator().manual_seed(0))
        jp = convert.params_to_jax(tp)
        assert [(p, x.shape, x.dtype) for p, x in
                jax.tree_util.tree_flatten_with_path(jp)[0]] == \
            [(p, x.shape, x.dtype) for p, x in
             jax.tree_util.tree_flatten_with_path(want)[0]]
        back = convert.params_to_jax(convert.params_from_jax(jp))
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
            assert a.dtype == b.dtype and np.array_equal(
                a.view(np.uint8), b.view(np.uint8))
    assert "vis_proj" not in tp


def test_tower_forward_matches_reference():
    jcfg, jp = _j_tower()
    tcfg = get_config(ARCH, smoke=True)
    tp = convert.params_from_jax(_np(jp))
    toks = _tokens(2, 24, 1)
    want = np.asarray(jax.jit(functools.partial(j_tf.forward, jcfg))(
        jp, jnp.asarray(toks)))
    got, aux = transformer.forward(tcfg, tp, torch.from_numpy(toks),
                                   return_aux=True)
    _close(got, want, 1e-5)
    assert {k: float(v) for k, v in aux.items()} == {"balance": 0.0,
                                                     "router_z": 0.0}


def test_prefill_and_decode_match_reference_and_forward():
    """Prefill 16 tokens, decode 2: each step against the reference's
    (model-dtype cache) and against the port's full forward (both
    caches; the int8 one within the reference's 5% bound)."""
    jcfg, jp = _j_tower()
    tcfg = get_config(ARCH, smoke=True)
    tp = convert.params_from_jax(_np(jp))
    toks = _tokens(2, 18, 2)
    jcache = j_tf.init_cache(jcfg, 2, 20)
    jl, jcache = jax.jit(j_tf.prefill, static_argnums=0)(
        jcfg, jp, jnp.asarray(toks[:, :16]), jcache)
    want = [np.asarray(jl)]
    for t in (16, 17):
        d, jcache = jax.jit(j_tf.decode_step, static_argnums=0)(
            jcfg, jp, jcache, jnp.asarray(toks[:, t:t + 1]))
        want.append(np.asarray(d))
    full = transformer.logits_from_hidden(
        tcfg, tp, transformer.forward(tcfg, tp, torch.from_numpy(toks)))
    scale = max(1.0, float(full.abs().max()))
    for kv in ("model", "int8"):
        c = tcfg.replace(kv_cache_dtype=kv)
        cache = transformer.init_cache(c, 2, 20)
        got = [transformer.prefill(c, tp, torch.from_numpy(toks[:, :16]),
                                   cache)[0]]
        got += [transformer.decode_step(c, tp, cache, torch.from_numpy(
            toks[:, t:t + 1]))[0] for t in (16, 17)]
        if kv == "int8":
            assert cache["layers"]["b0"]["k"].dtype == torch.int8
        for i, t in enumerate((15, 16, 17)):
            err = float((got[i] - full[:, t]).abs().max())
            assert err < (1e-4 if kv == "model" else 0.05) * scale, (kv, t)
        if kv == "model":
            for g, w in zip(got, want):
                _close(g, w, 1e-5)


def test_fused_step_matches_reference():
    jcfg, tcfg = j_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jde = JDE(proj_dims=PROJ, lambda_cco=LAM)
    tde = DualEncoderConfig(proj_dims=PROJ, lambda_cco=LAM)
    jp = j_de.init_dual_encoder(jax.random.PRNGKey(6), jcfg, jde)
    p0 = convert.params_from_jax(_np(jp))
    views = [_tokens(8, 16, seed=s) for s in (3, 4)]
    opt_j = j_opt.sgd(LR)
    pj, _, mj = jax.jit(j_steps.make_dcco_train_step(
        jcfg, jde, JTrainConfig(global_batch=8, samples_per_client=2),
        opt_j))(jp, opt_j.init(jp), {"view1": {"tokens": jnp.asarray(
            views[0])}, "view2": {"tokens": jnp.asarray(views[1])}})
    opt_t = opt_lib.sgd(LR)
    pt, _, mt = steps.make_dcco_train_step(
        tcfg, tde, TrainConfig(global_batch=8, samples_per_client=2),
        opt_t)(p0, opt_t.init(p0), {
            "view1": {"tokens": torch.from_numpy(views[0])},
            "view2": {"tokens": torch.from_numpy(views[1])}})
    want = convert.params_from_jax(_np(pj))
    assert utils.tree_max_abs_diff(pt, want) \
        / utils.tree_max_abs_diff(want, p0) < 1e-4
    np.testing.assert_allclose(mt["loss"].item(), float(mj["loss"]),
                               rtol=1e-4)


def test_train_and_serve_clis_run_the_audio_tower():
    res = train.main(["--device", "cpu", "--arch", ARCH, "--seq-len", "16",
                      "--rounds", "2", "--eval-every", "1",
                      "--dataset-size", "32", "--clients-per-round", "4",
                      "--num-classes", "3", "--num-layers", "1"])
    assert res["loss_finite"] and len(res["history"]) == 2
    assert res["params"]["tower"]["layers"]["b0"]["ln1"]["scale"].shape[0] \
        == 1
    out = serve.main(["--device", "cpu", "--arch", ARCH, "--batch", "2",
                      "--prompt-len", "8", "--gen", "3"])
    assert out["tokens"].shape == (2, 3) and "patch_embeds" not in out
    assert int(out["tokens"].max()) < get_config(ARCH, smoke=True).vocab_size
    assert all(bool(torch.isfinite(x).all()) for x in out["logits"])
