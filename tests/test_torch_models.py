"""Port vs reference: ResNet/encoder forward, GroupNorm, MLP and the
parameter bridge, on the CPU in f32 with JAX's parameters carried over.

Tolerances: the two frameworks run the same f32 arithmetic in other
orders (XLA vs oneDNN convolutions). The reference's GroupNorm normalises
each pixel over the channels of its group only — 2 channels in the smoke
config (16 channels, 8 groups) — so it divides by the spread of two
values, which is ill-conditioned: on the smoke forward the reference's
own f32 output is 2e-4 from an f64 evaluation (values ~1), the port's
3e-5. Whole-encoder outputs are held to rtol 1e-3 / atol 1e-4 for that
reason; single layers (GroupNorm, MLP, one conv) to 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import DualEncoderConfig as JDE
from repro.configs.base import get_config as j_get_config
from repro.models import common as j_common
from repro.models import dual_encoder as j_de
from repro.models import resnet as j_resnet
from repro_torch import convert
from repro_torch.configs.base import (ARCH_IDS, DualEncoderConfig,
                                      get_config, get_dual_encoder_config)
from repro_torch.models import common, dual_encoder, resnet

# tier-1 runs 6 pytest workers on the machine's cores: one torch thread
# per worker keeps them from contending with each other and with JAX
torch.set_num_threads(1)

RTOL, ATOL = 1e-3, 1e-4


def _jax_params(cfg, proj=(64, 64), seed=0):
    return jax.jit(j_de.init_dual_encoder, static_argnums=(1, 2))(
        jax.random.PRNGKey(seed), cfg, JDE(proj_dims=proj))


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("stages,channels,groups,size", [
    ((1, 1), (16, 32), 8, 16),          # SMOKE_CONFIG: stride-2 on even 16
    ((1, 1, 1), (8, 16, 16), 4, 12),    # stride 2 twice: 12 -> 6 -> 3 (odd)
    ((2, 1), (8, 8), 32, 9),            # odd input, groups clipped to C
])
def test_resnet_forward_matches_reference(stages, channels, groups, size):
    jcfg = j_get_config("resnet14-cifar", smoke=True).replace(
        resnet_stages=stages, resnet_channels=channels, resnet_groups=groups,
        image_size=size)
    tcfg = get_config("resnet14-cifar", smoke=True).replace(
        resnet_stages=stages, resnet_channels=channels, resnet_groups=groups,
        image_size=size)
    jp = _jax_params(jcfg)
    imgs = np.random.RandomState(0).rand(5, size, size, 3).astype(np.float32)
    ref = np.asarray(jax.jit(j_resnet.resnet_forward, static_argnums=0)(
        jcfg, jp["tower"], jnp.asarray(imgs)))
    tp = convert.params_from_jax(_np_tree(jp))
    out = resnet.resnet_forward(tcfg, tp["tower"], torch.from_numpy(imgs))
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_same_padding_stride2_even_input_is_asymmetric():
    # the trap: XLA "SAME" for a 3x3 stride-2 conv on an even input pads
    # (0, 1); torch's padding=1 would pad (1, 1) and shift every output
    assert resnet._same_pads(16, 3, 2) == (0, 1)
    assert resnet._same_pads(15, 3, 2) == (1, 1)
    assert resnet._same_pads(16, 3, 1) == (1, 1)
    assert resnet._same_pads(16, 1, 2) == (0, 0)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 16, 16, 4).astype(np.float32)
    w = rng.randn(3, 3, 4, 6).astype(np.float32)
    ref = np.asarray(j_resnet._conv({"w": jnp.asarray(w)}, jnp.asarray(x), 2))
    tw = convert.params_from_jax({"w": w})
    out = resnet._conv(tw, torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=1e-5, atol=1e-5)


def test_encode_smoke_config_matches_reference():
    jcfg = j_get_config("resnet14-cifar", smoke=True)
    tcfg = get_config("resnet14-cifar", smoke=True)
    jp = _jax_params(jcfg, proj=(64, 48, 96))
    imgs = np.random.RandomState(2).rand(6, 16, 16, 3).astype(np.float32)
    ref, _ = jax.jit(j_de.encode, static_argnums=(0, 1))(
        jcfg, JDE(proj_dims=(64, 48, 96)), jp, {"images": jnp.asarray(imgs)})
    tp = convert.params_from_jax(_np_tree(jp))
    z, _ = dual_encoder.encode(tcfg, DualEncoderConfig(proj_dims=(64, 48, 96)),
                               tp, {"images": torch.from_numpy(imgs)})
    assert z.shape == (6, 96)
    np.testing.assert_allclose(z.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("shape,groups", [((3, 5, 5, 16), 8), ((4, 12), 3)])
def test_groupnorm_matches_reference(shape, groups):
    rng = np.random.RandomState(3)
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    scale = rng.rand(shape[-1]).astype(np.float32)
    bias = rng.randn(shape[-1]).astype(np.float32)
    ref = j_common.groupnorm(jnp.asarray(x), groups, jnp.asarray(scale),
                             jnp.asarray(bias))
    out = common.groupnorm(torch.from_numpy(x), groups,
                           torch.from_numpy(scale), torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_groupnorm_channel_axis_is_layout_only():
    # NCHW with axis=1 must equal NHWC with axis=-1 after the transpose
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 16, 3, 3)
                         .astype(np.float32))
    scale, bias = torch.rand(16), torch.randn(16)
    a = common.groupnorm(x, 4, scale, bias, axis=1)
    b = common.groupnorm(x.permute(0, 2, 3, 1), 4, scale, bias)
    torch.testing.assert_close(a, b.permute(0, 3, 1, 2), rtol=0, atol=0)


def test_mlp_matches_reference():
    jp = j_common.mlp_init(jax.random.PRNGKey(5), (12, 32, 8), jnp.float32)
    x = np.random.RandomState(5).randn(7, 12).astype(np.float32)
    ref = j_common.mlp(jp, jnp.asarray(x))
    tp = convert.params_from_jax(_np_tree(jp))
    out = common.mlp(tp, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_params_round_trip_is_exact():
    jp = _np_tree(_jax_params(j_get_config("resnet14-cifar", smoke=True)))
    back = convert.params_to_jax(convert.params_from_jax(jp))
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_port_init_has_reference_shapes():
    jcfg = j_get_config("resnet14-cifar", smoke=True)
    jp = _np_tree(_jax_params(jcfg))
    tp = dual_encoder.init_dual_encoder(
        0, get_config("resnet14-cifar", smoke=True),
        DualEncoderConfig(proj_dims=(64, 64)))
    back = convert.params_to_jax(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.shape == b.shape and a.dtype == b.dtype
    # truncated-normal init: within 2 std of 0 by construction
    w = tp["tower"]["stem"]["w"]
    assert float(w.abs().max()) <= 2.0 / np.sqrt(27) + 1e-6


def test_transformer_arch_raises_naming_roadmap():
    """Every arch of the reference's registry resolves, its smoke and full
    configs and its dual-encoder config; an arch outside the registry
    still raises KeyError."""
    assert len(ARCH_IDS) == 11
    for arch in ARCH_IDS:
        for smoke in (False, True):
            assert get_config(arch, smoke=smoke).name.startswith(
                arch.split("-")[0])
        assert get_dual_encoder_config(arch).proj_dims
    with pytest.raises(KeyError):
        get_config("not-an-arch")
    with pytest.raises(KeyError):
        get_dual_encoder_config("not-an-arch")


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-1.7b", "qwen3-8b",
                                  "granite-3-8b"])
def test_dense_archs_load_with_reference_values(arch, smoke):
    """The four dense configs are ported value for value: every field the
    port keeps equals the reference's."""
    ours, theirs = get_config(arch, smoke), j_get_config(arch, smoke)
    assert ours.family == "dense" and ours.name == theirs.name
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert ours.resolved_head_dim == theirs.resolved_head_dim
    assert ours.num_superblocks == theirs.num_superblocks
