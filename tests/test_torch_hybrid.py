"""The recurrent families in the port (zamba2-2.7b: 5 Mamba2 + 1
attention block a superblock; xlstm-350m: mLSTM + sLSTM) against the
reference, on the CPU: the configs, both smoke towers' forward, prefill
and decode, the parameter and cache trees and their conversion,
checkpoints, the fused D-CCO step, the training and serving CLIs, the
``--num-layers`` cut, and the flash kernel's plain version at zamba2's
head dim 80.

Parity runs on the smoke configs (zamba2: 2 superblocks of (mamba2,
mamba2, attn), d_model 256; xlstm: 1 superblock of (mlstm, slstm),
d_model 128) in f32, the parameters carried over by ``convert``.
Tolerances: the tower's hidden state and the prefill and decode logits
to 1e-4 of their largest magnitude against the reference's (f32 products
of 256-wide rows, the scans' einsums and exponentials in other orders;
measured ~2e-6); a decode step against the port's own full forward to
the reference's test bound, 2e-2 x max(1, max |logits|)
(tests/test_smoke_archs.py). The fused step: parameters within 1e-3 of
the step's update and the loss to rtol 1e-4, as
tests/test_torch_train_modes.py holds the dense towers. The flash plain
version at Dh 80 against the reference's ``blockwise_attention``: 2e-5
in f32, 3e-2 in bf16 (tests/test_kernels.py). Files: byte for byte;
conversions: bit for bit.
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
from repro.models import attention as j_attn
from repro.models import transformer as j_tf
from repro.optim import optimizers as j_opt
from repro_torch import convert, utils
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs.base import (ARCH_IDS, DualEncoderConfig,
                                      TrainConfig,
                                      get_config)
from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import serve, steps, train
from repro_torch.models import dual_encoder, transformer
from repro_torch.optim import optimizers as opt_lib

torch.set_num_threads(1)

ARCHS = ["zamba2-2.7b", "xlstm-350m"]
PROJ = (64, 64)
LAM, LR = 5.0, 0.01


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, convert.params_to_jax(tree))


@functools.lru_cache(maxsize=None)
def _j_tower(arch):
    """The reference's config and a smoke tower's parameters for it (the
    port's draw, carried over)."""
    return j_get_config(arch, smoke=True), _to_jax(transformer.init_params(
        get_config(arch, smoke=True), torch.Generator().manual_seed(0)))


def _tokens(arch, b, s, seed=1):
    vocab = get_config(arch, smoke=True).vocab_size
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_have_the_reference_values(arch, smoke):
    mine, ref_cfg = get_config(arch, smoke=smoke), j_get_config(arch,
                                                                smoke=smoke)
    for f in dataclasses.fields(mine):
        got, want = getattr(mine, f.name), getattr(ref_cfg, f.name)
        if f.name in ("ssm", "xlstm", "moe"):
            assert (got is None) == (want is None), f.name
            if got is not None:
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
        else:
            assert got == want, f.name
    assert mine.num_superblocks == ref_cfg.num_superblocks
    assert mine.resolved_head_dim == ref_cfg.resolved_head_dim


def test_the_vision_text_and_audio_archs_are_still_refused():
    """What the registry still refuses: an arch outside it (KeyError). The
    vision-text and audio archs, once refused here, now resolve with the
    rest of the reference's 11, with their modalities."""
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("internvl2-8b")
    assert len(ARCH_IDS) == 11
    for arch in ARCH_IDS:
        assert get_config(arch, smoke=True).num_layers >= 1
    assert get_config("internvl2-2b").modality == "vision_text"
    assert get_config("musicgen-large").modality == "audio_tokens"


@pytest.mark.parametrize("arch", ARCHS)
def test_tower_forward_matches_reference(arch):
    jcfg, jp = _j_tower(arch)
    tcfg = get_config(arch, smoke=True)
    tp = convert.params_from_jax(_np(jp))
    toks = _tokens(arch, 2, 32)
    h = np.asarray(jax.jit(functools.partial(j_tf.forward, jcfg))(
        jp, jnp.asarray(toks)))
    th, aux = transformer.forward(tcfg, tp, torch.from_numpy(toks).long(),
                                  return_aux=True)
    _close(th, h, 1e-4)
    assert {k: float(v) for k, v in aux.items()} == {"balance": 0.0,
                                                     "router_z": 0.0}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_and_forward(arch):
    """Prefill 32 tokens, decode 2 more, against the reference's and the
    port's own full forward over the 34 tokens (at a chunk that divides
    34), with the model-dtype and the int8 cache (which only the
    attention slots take)."""
    jcfg, jp = _j_tower(arch)
    tcfg = get_config(arch, smoke=True)
    tp = convert.params_from_jax(_np(jp))
    toks = _tokens(arch, 2, 34, seed=2)
    jcache = j_tf.init_cache(jcfg, 2, 40)
    jl, jcache = jax.jit(j_tf.prefill, static_argnums=0)(
        jcfg, jp, jnp.asarray(toks[:, :32]), jcache)
    jd = []
    for t in (32, 33):
        d, jcache = jax.jit(j_tf.decode_step, static_argnums=0)(
            jcfg, jp, jcache, jnp.asarray(toks[:, t:t + 1]))
        jd.append(np.asarray(d))
    whole = (tcfg.replace(ssm=dataclasses.replace(tcfg.ssm, chunk=17))
             if tcfg.ssm else
             tcfg.replace(xlstm=dataclasses.replace(tcfg.xlstm, chunk=17)))
    full = transformer.logits_from_hidden(
        tcfg, tp, transformer.forward(whole, tp, torch.from_numpy(toks)))
    for kv in ("model", "int8"):
        c = tcfg.replace(kv_cache_dtype=kv)
        cache = transformer.init_cache(c, 2, 40)
        pl, cache = transformer.prefill(c, tp, torch.from_numpy(toks[:, :32]),
                                        cache)
        dl = [transformer.decode_step(c, tp, cache, torch.from_numpy(
            toks[:, t:t + 1]))[0] for t in (32, 33)]
        assert int(cache["pos"]) == 34
        scale = max(1.0, float(full.abs().max()))
        for i, t in enumerate((32, 33)):
            assert float((dl[i] - full[:, t]).abs().max()) < 2e-2 * scale
        if kv == "model" or "attn" not in tcfg.block_pattern:
            for got, want in ((pl, jl), (dl[0], jd[0]), (dl[1], jd[1])):
                _close(got, want, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_tree_and_dtypes_match_reference(arch):
    """The bf16 tower's cache: every slot's leaves with the reference's
    shapes and dtypes (recurrent states f32, the conv ring bf16); the int8
    setting changes the attention slots only."""
    for kv in ("model", "int8"):
        jcfg = j_get_config(arch, smoke=True).replace(dtype="bfloat16",
                                                      kv_cache_dtype=kv)
        tcfg = get_config(arch, smoke=True).replace(dtype="bfloat16",
                                                    kv_cache_dtype=kv)
        want = jax.eval_shape(lambda: j_tf.init_cache(jcfg, 2, 24))
        mine = transformer.init_cache(tcfg, 2, 24)
        assert [(p, x.shape, x.dtype.name) for p, x in
                jax.tree_util.tree_flatten_with_path(want)[0]] == \
            [(p, tuple(x.shape), str(x.dtype).split(".")[-1]) for p, x in
             jax.tree_util.tree_flatten_with_path(mine)[0]]
        for slot, kind in enumerate(tcfg.block_pattern):
            leaves = mine["layers"][f"b{slot}"]
            if kind == "mamba2":
                assert leaves["conv"].dtype == torch.bfloat16
                assert leaves["ssm"].dtype == torch.float32
            elif kind != "attn":
                assert all(v.dtype == torch.float32 for v in leaves.values())
                assert bool((leaves["m"] == -1e30).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference_and_converts_both_ways(arch):
    for dtype in ("float32", "bfloat16"):
        jcfg = j_get_config(arch, smoke=True).replace(dtype=dtype)
        tcfg = get_config(arch, smoke=True).replace(dtype=dtype)
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
    slots = tp["layers"]
    assert sorted(slots) == [f"b{i}" for i in range(
        len(tcfg.block_pattern))]
    if arch == "xlstm-350m":
        # the sLSTM's stacked recurrent matrices are 4-D (L, h, dh, dh),
        # not named "w": they carry across untransposed
        r = jp["layers"]["b1"]["mixer"]["r_i"]
        assert r.ndim == 4 and r.shape == (1, 2, 64, 64)
        got = convert.params_from_jax(jp)["layers"]["b1"]["mixer"]["r_i"]
        assert np.array_equal(got.float().numpy(), r.astype(np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_is_the_references_byte_for_byte(tmp_path, arch):
    _, jp = _j_tower(arch)
    jp = jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)), jp)
    j_save(str(tmp_path / "ref.msgpack"), {"params": jp}, step=3)
    tp = convert.params_from_jax(jp)
    save_checkpoint(str(tmp_path / "port.msgpack"), {"params": tp}, step=3)
    assert (tmp_path / "port.msgpack").read_bytes() == \
        (tmp_path / "ref.msgpack").read_bytes()
    back, step = restore_checkpoint(str(tmp_path / "ref.msgpack"),
                                    {"params": tp}, device="cpu")
    assert step == 3
    for a, b in zip(utils.tree_leaves(back), utils.tree_leaves(tp)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_step_matches_reference(arch):
    """The fused D-CCO step on the smoke dual encoder (zamba2 cut to one
    superblock, which keeps the reference's compile short) against the
    reference's: no aux term is added (the towers have no MoE)."""
    layers = len(get_config(arch, smoke=True).block_pattern)
    jcfg = j_get_config(arch, smoke=True).replace(num_layers=layers)
    tcfg = get_config(arch, smoke=True).replace(num_layers=layers)
    jde = JDE(proj_dims=PROJ, lambda_cco=LAM)
    jp = _to_jax(dual_encoder.init_dual_encoder(
        0, tcfg, DualEncoderConfig(proj_dims=PROJ)))
    views = [_tokens(arch, 8, 16, seed=s) for s in (3, 4)]
    opt_j = j_opt.sgd(LR)
    step_j = jax.jit(j_steps.make_dcco_train_step(
        jcfg, jde, JTrainConfig(global_batch=8, samples_per_client=2),
        opt_j))
    pj, _, mj = step_j(jp, opt_j.init(jp), {
        "view1": {"tokens": jnp.asarray(views[0])},
        "view2": {"tokens": jnp.asarray(views[1])}})
    p0 = convert.params_from_jax(_np(jp))
    opt_t = opt_lib.sgd(LR)
    step_t = steps.make_dcco_train_step(
        tcfg, DualEncoderConfig(proj_dims=PROJ, lambda_cco=LAM),
        TrainConfig(global_batch=8, samples_per_client=2), opt_t)
    pt, _, mt = step_t(p0, opt_t.init(p0), {
        "view1": {"tokens": torch.from_numpy(views[0]).long()},
        "view2": {"tokens": torch.from_numpy(views[1]).long()}})
    want = convert.params_from_jax(_np(pj))
    assert utils.tree_max_abs_diff(pt, want) \
        / utils.tree_max_abs_diff(want, p0) < 1e-3
    np.testing.assert_allclose(mt["loss"].item(), float(mj["loss"]),
                               rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("flags", [
    ["--cohort-chunk", "2", "--edges", "2", "--channel", "int8"],
    ["--stats-kernel", "fused"],
    ["--mode", "fused", "--micro", "2"],
    ["--mode", "protocol"],
])
def test_train_cli_runs_the_recurrent_towers(arch, flags):
    cfg = get_config(arch, smoke=True)
    res = train.main(["--device", "cpu", "--arch", arch, "--seq-len", "16",
                      "--rounds", "2", "--eval-every", "1",
                      "--dataset-size", "16", "--clients-per-round", "4",
                      "--num-classes", "3", "--num-layers",
                      str(len(cfg.block_pattern)), *flags])
    assert res["loss_finite"] and len(res["history"]) == 2
    layers = res["params"]["tower"]["layers"]
    assert sorted(layers) == [f"b{i}" for i in range(
        len(cfg.block_pattern))]
    assert layers["b0"]["ln1"]["scale"].shape[0] == 1


def test_num_layers_must_fill_whole_superblocks():
    with pytest.raises(SystemExit, match="block pattern of length 3"):
        train.parse_args(["--arch", "zamba2-2.7b", "--num-layers", "4"])
    with pytest.raises(SystemExit, match="block pattern of length 6"):
        train.parse_args(["--arch", "zamba2-2.7b", "--full", "--num-layers",
                          "9"])
    with pytest.raises(SystemExit, match="block pattern of length 2"):
        train.parse_args(["--arch", "xlstm-350m", "--num-layers", "3"])
    assert train.parse_args(["--arch", "zamba2-2.7b", "--full",
                             "--num-layers", "6"]).num_layers == 6


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_the_recurrent_towers(arch):
    out = serve.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                      "--prompt-len", "16", "--gen", "4"])
    assert out["tokens"].shape == (2, 4)
    assert all(bool(torch.isfinite(x).all()) for x in out["logits"])
    res = serve.main(["--device", "cpu", "--arch", arch, "--retrieval",
                      "--corpus-sizes", "64", "--serve-batches", "2"])
    assert res[0]["n"] == 64 and res[0]["batches"] == 2
    assert res[0]["query_embeddings"].shape[1] == 64    # the (64, 64) head


# --------------------------------------------------- flash at head dim 80 --

_j_blockwise = jax.jit(j_attn.blockwise_attention,
                       static_argnames=("window", "kv_block", "scale"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kvh,sq,skv", [(2, 4, 4, 40, 40),
                                            (1, 4, 2, 24, 70)])
def test_plain_flash_at_head_dim_80_matches_reference_scan(b, h, kvh, sq,
                                                           skv, dtype):
    rng = np.random.RandomState(sq + skv)
    q, k, v = (rng.randn(b, n, s, 80).astype(np.float32)
               for n, s in ((h, sq), (kvh, skv), (kvh, skv)))
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    jq, jk, jv = (jnp.asarray(x.transpose(0, 2, 1, 3)).astype(jd)
                  for x in (q, k, v))
    q_pos = np.broadcast_to(np.arange(skv - sq, skv)[None], (b, sq))
    kv_pos = np.broadcast_to(np.arange(skv)[None], (b, skv))
    want = np.asarray(_j_blockwise(
        jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(kv_pos), window=0,
        kv_block=32, scale=float(1 / np.sqrt(80))).astype(jnp.float32)
    ).transpose(0, 2, 1, 3)
    tq, tk, tv = (torch.from_numpy(x).to(td) for x in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.shape == (b, h, sq, 80) and got.dtype == td
    tol = 2e-5 if dtype == "float32" else 3e-2
    for out in (got, ref.flash_attention_ref(tq, tk, tv, causal=True)):
        np.testing.assert_allclose(out.float().numpy(), want, rtol=tol,
                                   atol=tol)


def test_kernel_takes_head_dim_80(monkeypatch, tmp_path):
    """On a tensor the wrapper sees as CUDA: (80, 80) passes the shape
    checks and goes to the build (which raises here: no nvcc), where a
    pair the kernel has no instance of is refused by name."""
    assert (80, 80) in flash_mod.HEAD_DIMS
    monkeypatch.setattr(flash_mod, "_device_type", lambda t: "cuda")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build, "NVCC_FALLBACK", str(tmp_path / "nvcc"))
    before = dict(flash_attention.launches)
    q = torch.randn(1, 2, 8, 80)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="head dim 96"):
        flash_attention(*(torch.randn(1, 2, 8, 96),) * 3)
    assert flash_attention.launches == before
