"""``sharding/specs.py``, ``launch/mesh.make_production_mesh`` and the
shapes-only trees of ``launch/inputs.py`` in the port against the
reference, on the CPU.

The reference's layout rules run on ``jax.eval_shape`` trees and a
``FakeMesh`` stand-in (axis names and a device array's shape); the
port's run on its ``meta`` trees and a stand-in with ``mesh_dim_names``
and ``shape``. Every leaf's spec must be the reference's
``PartitionSpec``, entry for entry, on the production stand-ins (16, 16)
and (2, 16, 16), over the same set of leaf paths. On a gloo world of 4
CPU ranks (``tests/_torch_dist.py``) the DTensor placements that
``named`` gives must cut each leaf into the reference's
``NamedSharding`` shard shape and ``full_tensor()`` must give the leaf
back bit for bit.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

import _torch_dist as td
from repro.configs.base import get_config as j_get_config
from repro.configs.base import get_dual_encoder_config as j_de_config
from repro.launch import inputs as j_inputs
from repro.models import dual_encoder as j_de
from repro.models import transformer as j_transformer
from repro.optim import optimizers as j_opt
from repro.sharding import specs as j_specs
from repro_torch import utils
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.configs.base import get_dual_encoder_config
from repro_torch.launch import inputs
from repro_torch.models import transformer
from repro_torch.optim import optimizers as opt_lib
from repro_torch.sharding import specs
from repro_torch.sharding.specs import P

torch.set_num_threads(1)

TOKEN_ARCHS = tuple(a for a in ARCH_IDS if a != "resnet14-cifar")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SDS = jax.ShapeDtypeStruct((2,), jnp.uint32)


class JFake:
    """The reference's FakeMesh: axis names and a device array's shape."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


class TFake:
    """The port's stand-in: a DeviceMesh's names and shape."""

    def __init__(self, shape, names):
        self.mesh_dim_names = names
        self.shape = shape


def _meshes(key):
    shape, names = MESHES[key]
    return JFake(shape, names), TFake(shape, names)


def _j_flat(tree):
    """{path: leaf} of a reference tree (a PartitionSpec is a leaf)."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {j_specs._path_str(p): x for p, x in flat}


def _t_flat(tree):
    out = {}
    specs._map_with_path(lambda p, x: out.__setitem__(p, x), tree)
    return out


def _same_specs(j_tree, t_tree):
    """Both spec trees over one set of paths, each leaf's entries equal."""
    jf, tf = _j_flat(j_tree), _t_flat(t_tree)
    assert set(jf) == set(tf), set(jf) ^ set(tf)
    bad = {p: (jf[p], tf[p]) for p in jf if tuple(jf[p]) != tuple(tf[p])}
    assert not bad, list(bad.items())[:4]
    return len(jf)


def _same_layout(j_tree, t_tree):
    """Both trees over one set of paths with equal shapes and dtypes."""
    jf, tf = _j_flat(j_tree), _t_flat(t_tree)
    assert set(jf) == set(tf), set(jf) ^ set(tf)
    for p in jf:
        assert tuple(jf[p].shape) == tuple(tf[p].shape), p
        assert str(jf[p].dtype) == str(tf[p].dtype).replace("torch.", ""), p
        assert tf[p].device.type == "meta", p


def _j_params(arch):
    return jax.eval_shape(
        lambda k: j_transformer.init_params(j_get_config(arch), k), SDS)


# ------------------------------------------------------ shapes-only trees --

# PERF.md §4's full-config parameter counts (billions, 3 decimals)
PARAM_COUNTS = {"tinyllama-1.1b": 1.035, "deepseek-moe-16b": 16.166,
                "deepseek-v2-lite-16b": 15.497, "zamba2-2.7b": 2.821,
                "xlstm-350m": 0.392, "internvl2-2b": 1.706,
                "musicgen-large": 3.226}


def test_shapes_only_trees_of_all_token_archs_build_fast():
    t0 = time.perf_counter()
    counts = {}
    for arch in TOKEN_ARCHS:
        cfg = get_config(arch)
        tree = inputs.param_shapes(cfg)
        leaves = utils.tree_leaves(tree)
        assert all(x.device.type == "meta" for x in leaves), arch
        counts[arch] = sum(x.numel() for x in leaves)
        # the dual encoder and its Adam state, and every family's cache
        de = inputs.dual_encoder_shapes(cfg, get_dual_encoder_config(arch))
        opt = inputs.opt_state_shapes(opt_lib.adam(1e-3), de)
        assert all(x.device.type == "meta" for x in utils.tree_leaves(opt))
        cache = inputs.cache_shapes(cfg, 2, 64)
        assert all(x.device.type == "meta"
                   for x in utils.tree_leaves(cache)), arch
    assert time.perf_counter() - t0 < 10.0
    for arch, billions in PARAM_COUNTS.items():
        assert round(counts[arch] / 1e9, 3) == billions, (arch, counts[arch])


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_shapes_only_trees_are_the_references(arch):
    _same_layout(_j_params(arch), inputs.param_shapes(get_config(arch)))
    j_de_tree = jax.eval_shape(lambda k: j_de.init_dual_encoder(
        k, j_get_config(arch), j_de_config(arch)), SDS)
    de = inputs.dual_encoder_shapes(get_config(arch),
                                    get_dual_encoder_config(arch))
    _same_layout(j_de_tree, de)
    _same_layout(jax.eval_shape(j_opt.adam(1e-3).init, j_de_tree),
                 inputs.opt_state_shapes(opt_lib.adam(1e-3), de))


def test_meta_init_draws_nothing_and_real_init_is_unchanged():
    """On ``meta`` the init reads no generator (None is fine) and makes
    no ``.item()``; on the CPU one seed still gives the same draws."""
    cfg = get_config("deepseek-moe-16b", smoke=True)
    assert utils.tree_leaves(transformer.init_params(cfg, None, "meta"))
    a = transformer.init_params(cfg, torch.Generator().manual_seed(3))
    b = transformer.init_params(cfg, torch.Generator().manual_seed(3))
    assert utils.tree_max_abs_diff(a, b) == 0.0
    layout = [(p, tuple(x.shape), x.dtype)
              for p, x in _t_flat(a).items()]
    meta = [(p, tuple(x.shape), x.dtype) for p, x in
            _t_flat(transformer.init_params(cfg, None, "meta")).items()]
    assert layout == meta


# ------------------------------------------------------ the layout rules --

@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_param_pspecs_match_reference(arch, mesh):
    jm, tm = _meshes(mesh)
    jp, tp = _j_params(arch), inputs.param_shapes(get_config(arch))
    for mode in ("tp", "fsdp"):
        n = _same_specs(j_specs.param_pspecs(jp, jm, mode=mode),
                        specs.param_pspecs(tp, tm, mode=mode))
        assert n == len(jax.tree_util.tree_leaves(jp))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-moe-16b",
                                  "zamba2-2.7b", "internvl2-2b"])
def test_opt_state_pspecs_match_reference(arch):
    """ZeRO-1 on the dual encoder's Adam state, from the parameter
    rules run on the state itself, as the reference's dry run does."""
    j_tree = jax.eval_shape(lambda k: j_de.init_dual_encoder(
        k, j_get_config(arch), j_de_config(arch)), SDS)
    j_state = jax.eval_shape(j_opt.adam(5e-3).init, j_tree)
    t_state = inputs.opt_state_shapes(opt_lib.adam(5e-3), inputs.
                                      dual_encoder_shapes(
                                          get_config(arch),
                                          get_dual_encoder_config(arch)))
    for mesh in sorted(MESHES):
        jm, tm = _meshes(mesh)
        for mode in ("tp", "fsdp"):
            _same_specs(
                j_specs.opt_state_pspecs(
                    j_specs.param_pspecs(j_state, jm, mode=mode), j_state,
                    jm),
                specs.opt_state_pspecs(
                    specs.param_pspecs(t_state, tm, mode=mode), t_state,
                    tm))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_pspec_matches_reference(mesh):
    jm, tm = _meshes(mesh)
    for ndim in (1, 2, 3):
        for batch in (0, 1, 16, 32, 256):
            assert tuple(specs.batch_pspec(tm, ndim, batch)) == tuple(
                j_specs.batch_pspec(jm, ndim, batch)), (ndim, batch)
    assert specs.data_axes(tm) == j_specs.data_axes(jm)


@pytest.mark.parametrize("kv", ["model", "int8"])
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_cache_pspecs_match_reference(arch, shape, kv):
    js, ts = j_inputs.INPUT_SHAPES[shape], inputs.INPUT_SHAPES[shape]
    jcfg = j_inputs.arch_variant_for_shape(
        j_get_config(arch).replace(kv_cache_dtype=kv), js)
    tcfg = inputs.arch_variant_for_shape(
        get_config(arch).replace(kv_cache_dtype=kv), ts)
    j_cache = jax.eval_shape(lambda: j_transformer.init_cache(
        jcfg, js.global_batch, js.seq_len))
    t_cache = inputs.cache_shapes(tcfg, ts.global_batch, ts.seq_len)
    _same_layout(j_cache, t_cache)
    seq_shard = ts.global_batch == 1
    for mesh in sorted(MESHES):
        jm, tm = _meshes(mesh)
        _same_specs(j_specs.cache_pspecs(j_cache, jm, seq_shard=seq_shard),
                    specs.cache_pspecs(t_cache, tm, seq_shard=seq_shard))


# ------------------------------------- the reference's own four checks --

def _specs_by_path(arch, dtype=None):
    cfg = get_config(arch)
    if dtype:
        cfg = cfg.replace(dtype=dtype)
    return _t_flat(specs.param_pspecs(inputs.param_shapes(cfg),
                                      TFake((16, 16), ("data", "model"))))


def test_rules_on_abstract_16way():
    d = _specs_by_path("qwen3-8b", "bfloat16")
    assert d["embed/table"] == P("model", None)          # 151936 % 16 == 0
    assert d["layers/b0/attn/wq/w"] == P(None, None, "model")
    assert d["layers/b0/attn/wo/w"] == P(None, "model", None)
    assert d["layers/b0/ffn/gate/w"] == P(None, None, "model")
    assert d["layers/b0/ffn/down/w"] == P(None, "model", None)
    assert d["layers/b0/ln1/scale"] == P()


def test_moe_expert_sharding():
    d = _specs_by_path("deepseek-moe-16b", "bfloat16")
    assert d["layers/b0/moe/experts/gate"] == P(None, "model", None, None)
    assert d["layers/b0/moe/router/w"] == P()
    assert d["embed/table"] == P("model", None)          # 102400 % 16 == 0


def test_indivisible_dims_stay_replicated():
    assert _specs_by_path("granite-3-8b")["embed/table"] == P()  # 49155


def test_batch_pspec_divisibility():
    m = TFake((16, 16), ("data", "model"))
    assert specs.batch_pspec(m, 2, 256) == P("data", None)
    assert specs.batch_pspec(m, 2, 1) == P(None, None)


# ------------------------------------------------------- the placements --

def test_named_gives_dtensor_placements():
    from torch.distributed.tensor import Replicate, Shard

    m3 = TFake((2, 16, 16), ("pod", "data", "model"))
    assert specs.named(m3, P(("pod", "data"), None, "model")) == [
        Shard(0), Shard(0), Shard(2)]
    assert specs.named(m3, P()) == [Replicate()] * 3
    assert specs.named(m3, P(None, "data")) == [Replicate(), Shard(1),
                                                Replicate()]
    with pytest.raises(ValueError, match="out of the mesh's order"):
        specs.named(m3, P(("data", "pod")))
    with pytest.raises(ValueError, match="twice"):
        specs.named(m3, P("data", "data"))
    with pytest.raises(ValueError, match="not in the mesh"):
        specs.named(TFake((4,), ("data",)), P("model"))
    assert specs.local_shape((64, 64, 32), P(("pod", "data"), None, "model"),
                             m3) == (2, 64, 2)
    with pytest.raises(ValueError, match="'tp' or 'fsdp'"):
        specs.param_pspecs({}, m3, mode="zero")


# --------------------------------------------- the gloo world of 4 ranks --

WORLD = 4
LAYOUT_ARCHS = ("tinyllama-1.1b", "deepseek-moe-16b")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    params = {a: transformer.init_params(
        get_config(a, smoke=True), torch.Generator().manual_seed(1))
        for a in LAYOUT_ARCHS}
    adam = opt_lib.adam(1e-3).init(params["tinyllama-1.1b"])
    outs = td.run_world(tmp_path_factory.mktemp("specs"), WORLD,
                        ["layouts"], {"layouts": {"params": params,
                                                  "adam": adam}})
    return params, adam, [o["layouts"] for o in outs]


def _j_shard_shapes(tree, j_spec_tree):
    """Each leaf's shard shape under the reference's NamedSharding on an
    abstract (2, 2) mesh."""
    am = AbstractMesh((2, 2), ("data", "model"))
    return {p: NamedSharding(am, s).shard_shape(tuple(tree[p].shape))
            for p, s in _j_flat(j_spec_tree).items()}


def test_gloo_world_lays_out_the_references_shards(world):
    params, adam, outs = world
    jm = JFake((2, 2), ("data", "model"))
    for arch in LAYOUT_ARCHS:
        j_tree = jax.eval_shape(lambda k: j_transformer.init_params(
            j_get_config(arch, smoke=True), k), SDS)
        flat = _t_flat(params[arch])
        for mode in ("tp", "fsdp"):
            want = _j_shard_shapes(
                flat, j_specs.param_pspecs(j_tree, jm, mode=mode))
            for r, out in enumerate(outs):
                got = out[f"{arch}/{mode}"]
                assert set(got["local"]) == set(want)
                for p, shape in want.items():
                    assert tuple(got["local"][p].tolist()) == shape, \
                        (arch, mode, r, p)
                assert all(bool(v) for v in got["same"].values()), \
                    (arch, mode, r)
    # ZeRO-1 on the Adam state: data-axis sharding on top of the model's
    j_state = jax.eval_shape(
        j_opt.adam(1e-3).init,
        jax.eval_shape(lambda k: j_transformer.init_params(
            j_get_config("tinyllama-1.1b", smoke=True), k), SDS))
    want = _j_shard_shapes(_t_flat(adam), j_specs.opt_state_pspecs(
        j_specs.param_pspecs(j_state, jm), j_state, jm))
    assert any(s != tuple(_t_flat(adam)[p].shape) for p, s in want.items())
    for out in outs:
        got = out["adam/zero1"]
        assert {p: tuple(v.tolist()) for p, v in got["local"].items()} \
            == want
        assert all(bool(v) for v in got["same"].values())


def test_production_mesh_on_the_gloo_world(world):
    outs = world[2]
    for out in outs:
        m = out["mesh"]
        assert m["default"] == ([1, 4], ["data", "model"])
        assert m["2x2"] == ([2, 2], ["data", "model"])
        assert m["multi_pod"] == ([2, 1, 2], ["pod", "data", "model"])
        assert "split into 2 pods" in m["multi_pod_one_host"]
        assert "do not split into hosts of 3" in m["uneven"]
