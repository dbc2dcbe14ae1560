"""The dry run (``repro_torch.launch.dryrun``) and the layer knobs it
drives, on the CPU, on the smoke towers and small fake worlds.

* Per-device argument and output bytes equal the reference's
  ``memory_analysis()`` of the same case (its ``build_case`` compiled on 8
  XLA host devices in a subprocess, ``tests/_torch_dryrun_ref.py``; XLA
  adds 8 bytes a leaf for its output tuple), the train step under each
  of the reference's D-CCO losses (fused, shard_map, per_client).
* The tp- and fsdp-placed train steps with real values on a gloo world of
  4 (``tests/_torch_dist.py``), with the fused, the shard_map and the
  per-client loss, against the port's unsharded fused step:
  the loss to 1e-5 relative; the gradients to 1e-5 of the largest
  gradient (f32 sums regrouped across ranks; a leaf whose gradient is
  zero analytically, the last bias under the CCO loss's centring, holds
  rounding only); the updated parameters to 1e-5 of each leaf's largest
  wherever the gradient's sign is decided (|g| above 1e-3 of the largest
  gradient, 100x the gradients' tolerance): Adam's first step is sign(g)
  x lr, so elsewhere a sign flip of a rounding-level gradient moves an
  element by 2 lr.
* ``parallel_block`` forward, prefill and decode against the reference's
  (f32, the tolerances of ``tests/test_torch_serve.py``); ``remat="full"``
  bit for bit equal to ``"none"``; ``act_shard_axes`` and
  ``fsdp_model_size`` changing no value on the gloo world.
* A collective law counted by hand, the statistics' reductions of each
  D-CCO loss, the group of a tuple of data axes, the FLOPs a device, the
  flash formula, the 4-kv-head reshape and the CLI.

Every fake world is torn down by ``dryrun.fake_world``; the gloo world
and the reference run in subprocesses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.models import transformer as j_tf
from repro_torch import convert, utils
from repro_torch.configs.base import get_config, get_dual_encoder_config
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.launch import dryrun, inputs as inp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import common, dual_encoder, transformer
from repro_torch.sharding import specs

import _torch_dist as td
import _torch_dryrun_ref as dref

TOL = 1e-5
LOGIT_TOL = 1e-5
# key: (arch, shape name, seq_len, global batch, kind, microbatches[,
# dcco_impl, sharding])
REF_CASES = {
    "tinyllama train": ("tinyllama-1.1b", "train_4k", 16, 8, "train", 2),
    "tinyllama decode": ("tinyllama-1.1b", "decode_32k", 32, 8, "decode", 1),
    "deepseek-moe prefill": ("deepseek-moe-16b", "prefill_32k", 32, 8,
                             "prefill", 1),
    "tinyllama train shard_map": ("tinyllama-1.1b", "train_4k", 16, 8,
                                  "train", 1, "shard_map", "tp"),
    "tinyllama train per_client": ("tinyllama-1.1b", "train_4k", 16, 8,
                                   "train", 1, "per_client", "tp"),
    "tinyllama train fsdp shard_map": ("tinyllama-1.1b", "train_4k", 16, 8,
                                       "train", 1, "shard_map", "fsdp"),
}


def _smoke_case(arch, name, seq, batch, kind, micro, impl="fused",
                sharding="tp", dtype="bfloat16"):
    """The port's record of a case on the (2, 4) fake world."""
    return dryrun.run_case(
        arch, inp.InputShape(name, seq, batch, kind), False, device="cpu",
        world=8, ranks_per_host=4, num_microbatches=micro, dcco_impl=impl,
        sharding=sharding,
        cfg=get_config(arch, smoke=True).replace(dtype=dtype))


@pytest.fixture(scope="module")
def ref_memory():
    return dref.reference_memory(REF_CASES)


@pytest.mark.parametrize("case", list(REF_CASES))
def test_argument_and_output_bytes_equal_the_references(ref_memory, case):
    rec = _smoke_case(*REF_CASES[case])
    mem, want = rec["memory"], ref_memory[case]
    assert mem["argument_size_in_bytes"] == want["argument_size_in_bytes"]
    assert mem["output_size_in_bytes"] + 8 * mem["output_leaves"] == \
        want["output_size_in_bytes"]
    assert mem["temp_size_in_bytes"] > 0 and rec["flops_per_device"] > 0


def test_each_impl_reduces_the_statistics_as_its_loss_does():
    """The three D-CCO losses traced on the (2, 4) fake world at micro 1.
    The fused loss reduces each of the five statistics where it is made
    (five all-reduces over "data"); the shard_map loss packs the same
    bytes into one all-reduce of (4d + d^2) f32 values, counted once
    under "data" (its body sees plain tensors, so nothing settles twice);
    the per-client loss reduces the five weighted sums over the clients,
    which are sharded over "data", and then its scalar loss. Each data
    rank holds the d x d cross moments of its K/2 clients."""
    d = get_dual_encoder_config("tinyllama-1.1b").proj_dims[-1]
    recs = {impl: _smoke_case("tinyllama-1.1b", "train_4k", 16, 8, "train",
                              1, impl=impl)
            for impl in ("fused", "shard_map", "per_client")}
    data = {k: r["collectives"]["by_axis"]["data"] for k, r in recs.items()}
    assert data["shard_map"]["bytes"] == data["fused"]["bytes"]
    assert data["shard_map"]["calls"] == data["fused"]["calls"] - 4
    assert data["per_client"]["bytes"] == data["fused"]["bytes"] + 4
    assert data["per_client"]["calls"] == data["fused"]["calls"] + 1
    for impl, rec in recs.items():
        assert rec["dcco_impl"] == impl
        assert rec["flops_per_device"] > 0
    temp = {k: r["memory"]["temp_size_in_bytes"] for k, r in recs.items()}
    assert temp["per_client"] >= temp["fused"] + 4 * d * d * 4


def test_a_tuple_of_data_axes_reduces_over_one_group():
    """On a (2, 2, 2) world a mean over ("pod", "data") is one all-reduce
    over the 4 ranks that share this rank's "model" coordinate (a group
    made once, not a flattened mesh dimension), counted under
    "pod+data"; its wire is timed at NVLink's rate (the 4 ranks lie on
    one 8-card host)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import HardwareSpec
    from repro_torch.sharding import collectives

    with dryrun.fake_world(8):
        mesh = make_production_mesh(multi_pod=True, ranks_per_host=2,
                                    device_type="cpu")
        group = collectives.axis_group(mesh, ("pod", "data"))
        assert torch.distributed.get_process_group_ranks(group) == [0, 2,
                                                                    4, 6]
        assert collectives.axis_group(mesh, ("pod", "data")) is group
        with FakeTensorMode():
            tree = {"a": torch.ones(3), "b": torch.ones(2, 2)}
            with dryrun.Trace() as tr:
                collectives.pmean_tree(tree, mesh, ("pod", "data"))
        coll = dryrun.collective_stats(tr, mesh)
        roof = dryrun.roofline(0.0, 0.0, coll, mesh)
    assert coll["by_axis"] == {"pod+data": {"bytes": 28.0,
                                            "wire_bytes": 56.0, "calls": 1}}
    assert roof["collective_s"] == 56.0 / HardwareSpec.NVLINK_BW
    assert not collectives.group_axes


# --------------------------------------------------- values on gloo --

TRAIN_ARCHS = ("tinyllama-1.1b", "deepseek-moe-16b")
# key: (arch, batch, prompt length, sliding window); two decode steps
SERVE_CASES = {
    "tinyllama b1 window": ("tinyllama-1.1b", 1, 12, 8),
    "tinyllama b4": ("tinyllama-1.1b", 4, 12, 0),
    "mla b4": ("deepseek-v2-lite-16b", 4, 16, 0),
    "mla b1": ("deepseek-v2-lite-16b", 1, 16, 0),
    "zamba2 b4": ("zamba2-2.7b", 4, 16, 0),
    "xlstm b4": ("xlstm-350m", 4, 16, 0),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    train = {}
    for i, arch in enumerate(TRAIN_ARCHS):
        cfg = get_config(arch, smoke=True)
        de = get_dual_encoder_config(arch)
        gen = torch.Generator().manual_seed(1 + i)
        train[arch] = {
            "params": dual_encoder.init_dual_encoder(i, cfg, de, "cpu"),
            "batch": {v: {"tokens": torch.randint(
                0, cfg.vocab_size, (8, 16), generator=gen,
                dtype=torch.int32)} for v in ("view1", "view2")}}
    outs = td.run_world(tmp_path_factory.mktemp("dryrun"), 4, ["dryrun"],
                        {"dryrun": {"train": train}})
    return outs[0]["dryrun"], train


@pytest.fixture(scope="module")
def serve_world(tmp_path_factory):
    archs = sorted({a for a, *_ in SERVE_CASES.values()})
    towers = {a: transformer.init_params(
        get_config(a, smoke=True), torch.Generator().manual_seed(7), "cpu")
        for a in archs}
    vocab = min(get_config(a, smoke=True).vocab_size for a in archs)
    tokens = torch.as_tensor(_tokens((4, 18), vocab, seed=3))
    outs = td.run_world(tmp_path_factory.mktemp("serve"), 4,
                        ["dryrun_serve"], {"dryrun_serve": {
                            "towers": towers, "tokens": tokens,
                            "serve_cases": SERVE_CASES}})
    return outs[0]["dryrun_serve"]


@pytest.mark.parametrize("case", [
    "tinyllama-1.1b/tp", "tinyllama-1.1b/fsdp", "deepseek-moe-16b/tp",
    "tinyllama-1.1b/tp/shard_map", "tinyllama-1.1b/fsdp/shard_map",
    "tinyllama-1.1b/tp/per_client"])
def test_sharded_train_step_equals_the_unsharded_step(world, case):
    """The MoE tower's loss holds its balance and router-z terms and its
    gradients their backward (expert parallel, the routing of each
    rank's groups). The shard_map and per-client losses (each rank's
    rows of the encodings under ``local_map``; the per-client statistics
    sharded by client) give the unsharded fused step's loss, gradients
    and parameters."""
    out, train = world
    o = out["train"][case]
    p_init = train[case.split("/")[0]]["params"]
    torch.testing.assert_close(o["loss"], o["plain_loss"], rtol=TOL, atol=0)
    g_scale = max(g.abs().max().item()
                  for g in utils.tree_leaves(o["plain_grads"]))
    for g, g0 in zip(utils.tree_leaves(o["grads"]),
                     utils.tree_leaves(o["plain_grads"])):
        assert (g - g0).abs().max().item() <= TOL * g_scale
    for p, p0, g0, pi in zip(*(utils.tree_leaves(t) for t in (
            o["params"], o["plain_params"], o["plain_grads"], p_init))):
        decided = g0.abs() > 1e-3 * g_scale
        gap = ((p - p0).abs() * decided).max().item()
        assert gap <= TOL * p0.abs().max().item()
        assert not torch.equal(p0, pi)        # the step moved them
    if "aux" in o:
        assert set(o["aux"]) == set(o["plain_aux"]) == {"balance",
                                                        "router_z"}
        for k in o["aux"]:
            torch.testing.assert_close(o["aux"][k], o["plain_aux"][k],
                                       rtol=TOL, atol=0)


@pytest.mark.parametrize("case", ["tinyllama-1.1b/tp/shard_map",
                                  "tinyllama-1.1b/fsdp/shard_map",
                                  "tinyllama-1.1b/tp/per_client"])
def test_shard_map_step_reduces_the_statistics_once(world, case):
    """The shard_map step's gradient reduces the five statistics by one
    all-reduce of (4d + d^2) f32 values over the data axis (a rank's
    buffer, counted by ``sharding.collectives``); the per-client step
    reduces through DTensor alone."""
    d = get_dual_encoder_config("tinyllama-1.1b").proj_dims[-1]
    counts = world[0]["train"][case]["counts"]
    want = {"calls": 1, "bytes": (4 * d + d * d) * 4} \
        if case.endswith("shard_map") else {"calls": 0, "bytes": 0}
    assert counts["all_reduce"] == want
    assert counts["all_gather"] == {"calls": 0, "bytes": 0}


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_sharded_prefill_and_decode_equal_the_unsharded(serve_world, case):
    """Prefill and two decode steps on DTensors (the cache laid out by the
    dry run's rules: its slots split over ranks, each writing the slots
    of its block, a decode's blocks merged by their log-sum-exp; MLA's
    absorbed decode; the recurrent mixers on each rank's rows) against
    the unsharded port: each step's f32 logits to 1e-5 of their largest,
    the cache after the last step likewise (its positions exactly)."""
    rec = serve_world["serve"][case]
    assert len(rec["logits"]) == len(rec["plain"]) == 3
    for got, want in zip(rec["logits"], rec["plain"]):
        assert got.shape == want.shape
        gap = (got - want).abs().max().item()
        assert gap <= TOL * want.abs().max().item()
    flat = utils.tree_leaves(rec["cache"])
    flat0 = utils.tree_leaves(rec["plain_cache"])
    assert len(flat) == len(flat0)
    for c, c0 in zip(flat, flat0):
        assert c.shape == c0.shape and c.dtype == c0.dtype
        if not c0.is_floating_point():
            assert torch.equal(c, c0)
        else:
            gap = (c - c0).abs().max().item()
            assert gap <= TOL * max(c0.abs().max().item(), 1e-30)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-350m"])
def test_recurrent_towers_on_rows_equal_the_unsharded(serve_world, arch):
    """The Mamba2, mLSTM and sLSTM mixers under ``rows_map`` (each rank's
    rows, their weights gathered): the tower's output to 1e-5 of its
    largest."""
    rec = serve_world["forward"][arch]
    gap = (rec["h"] - rec["plain"]).abs().max().item()
    assert gap <= TOL * rec["plain"].abs().max().item()


def test_activation_and_fsdp_constraints_change_no_value(world):
    """The constraints move data, not values: the tower's output equals
    the unconstrained one's to 1e-5 of its largest (f32 sums regrouped
    where a product runs on other blocks)."""
    knobs = world[0]["knobs"]
    scale = knobs["plain"].abs().max().item()
    for name in ("act_shard_axes", "fsdp_model_size"):
        gap = (knobs[name] - knobs["plain"]).abs().max().item()
        assert gap <= TOL * scale, name


# ------------------------------------------------------------ knobs --

def _towers(arch, **kw):
    jc = j_get_config(arch, smoke=True).replace(**kw)
    tc = get_config(arch, smoke=True).replace(**kw)
    jp = j_tf.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, convert.params_from_jax(jax.tree.map(np.asarray, jp))


def _tokens(shape, vocab, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("arch", ["granite-3-8b", "tinyllama-1.1b"])
def test_parallel_block_matches_the_reference(arch):
    """Forward, prefill and two decode steps of the parallel block, held
    to the reference's (the sequential block differs, as the reference's
    own test checks)."""
    jc, tc, jp, tp = _towers(arch, parallel_block=True)
    toks = _tokens((2, 16), jc.vocab_size)
    h = transformer.forward(tc, tp, torch.as_tensor(toks))
    hj = np.asarray(j_tf.forward(jc, jp, jnp.asarray(toks)))
    np.testing.assert_allclose(h.numpy(), hj, rtol=1e-4,
                               atol=1e-4 * np.abs(hj).max())
    seq = transformer.forward(tc.replace(parallel_block=False), tp,
                              torch.as_tensor(toks))
    assert (seq - h).abs().max().item() > 1e-4
    jl, jcache = j_tf.prefill(jc, jp, jnp.asarray(toks[:, :12]),
                              j_tf.init_cache(jc, 2, 20))
    tl, tcache = transformer.prefill(tc, tp, torch.as_tensor(toks[:, :12]),
                                     transformer.init_cache(tc, 2, 20))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    for t in (12, 13):
        tok = toks[:, t:t + 1]
        jl, jcache = j_tf.decode_step(jc, jp, jcache, jnp.asarray(tok))
        tl, tcache = transformer.decode_step(tc, tp, tcache,
                                             torch.as_tensor(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0)


def test_remat_full_is_bit_equal_to_none():
    cfg = get_config("tinyllama-1.1b", smoke=True)
    de = get_dual_encoder_config("tinyllama-1.1b")
    params = dual_encoder.init_dual_encoder(0, cfg, de, "cpu")
    toks = torch.as_tensor(_tokens((2, 16), cfg.vocab_size))
    outs = {}
    for remat in ("none", "full"):
        p = utils.tree_map(lambda x: x.detach().requires_grad_(), params)
        z, _ = dual_encoder.encode(cfg.replace(remat=remat), de, p,
                                   {"tokens": toks})
        leaves = utils.tree_leaves(p)
        grads = torch.autograd.grad(z.square().sum(), leaves,
                                    allow_unused=True)
        outs[remat] = [z.detach()] + [g for g in grads if g is not None]
    assert len(outs["full"]) == len(outs["none"])
    for a, b in zip(outs["full"], outs["none"]):
        assert torch.equal(a, b)


# ------------------------------------------- collectives and FLOPs --

def _trace(world, per, fn):
    """``fn(mesh)`` -> (step, args) traced on a fake world of ``world``
    ranks, hosts of ``per``; the record."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with dryrun.fake_world(world):
        mesh = make_production_mesh(ranks_per_host=per, device_type="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            step, args = fn(mesh)
            return dryrun.trace_step(step, args, mesh)


def _block_case(cfg, b, s):
    def build(mesh):
        p = inp.param_shapes(cfg)["layers"]
        p = utils.tree_map(lambda x: x[0], p)["b0"]
        x = torch.empty((b, s, cfg.d_model), device="meta")
        placed = dryrun.place(
            {"p": p, "x": x},
            {"p": specs.param_pspecs({"attn": p["attn"], "ffn": p["ffn"],
                                      "ln1": p["ln1"], "ln2": p["ln2"]},
                                     mesh), "x": specs.P()}, mesh)

        def step(pp, xx):
            pos = torch.arange(s)[None].expand(b, s)
            from repro_torch.sharding import dtensor
            return transformer._block_forward(
                cfg, "attn", pp, xx, dtensor.replicated(pos, xx))[0]

        return step, (placed["p"], placed["x"])
    return build


@pytest.mark.parametrize("preferred", [None, torch.bfloat16])
def test_tp_layer_collectives_counted_by_hand(preferred):
    """One tp attention + FFN layer on (1, 4): the row-parallel output
    and down projections leave pending sums, each reduced by one
    all-reduce of the B S d activation (the wire 2x its bytes), in f32,
    or in bf16 after ``set_matmul_preferred(torch.bfloat16)``; the 2 kv
    heads, which do not split over 4 ranks, are gathered (k and v)."""
    cfg = get_config("tinyllama-1.1b", smoke=True)
    b, s = 2, 16
    common.set_matmul_preferred(preferred)
    try:
        rec = _trace(4, 4, _block_case(cfg, b, s))
    finally:
        common.set_matmul_preferred(None)
    coll = rec["collectives"]
    width = 2 if preferred is torch.bfloat16 else 4
    assert coll["count_by_op"]["all-reduce"] == 2
    assert coll["bytes_by_op"]["all-reduce"] == 2 * b * s * cfg.d_model * width
    assert coll["count_by_op"]["all-gather"] == 2
    kv = cfg.num_kv_heads * cfg.resolved_head_dim
    assert coll["bytes_by_op"]["all-gather"] == 2 * b * s * kv * 4
    ar = coll["bytes_by_op"]["all-reduce"]
    assert coll["wire_bytes"] == 2 * ar + coll["bytes_by_op"]["all-gather"]
    assert set(coll["by_axis"]) == {"model"}


def test_a_tree_of_shapes_costs_nothing():
    """A step that reads a ``meta`` tree of shapes (the prefill step's
    cache layout) allocates, moves and computes nothing for it."""
    cfg = get_config("musicgen-large", smoke=True)
    rec = _trace(1, 1, lambda mesh: (
        lambda: inp.cache_shapes(cfg, 8, 512), ()))
    assert rec["memory"]["temp_size_in_bytes"] == 0
    assert rec["bytes_per_device"] == rec["flops_per_device"] == 0


@pytest.mark.parametrize("world", [4, 8])
def test_tp_linear_flops_are_a_quarter_a_device(world):
    """A column-parallel linear on (1, 4) and (2, 4), its input
    replicated: each device computes its quarter of the output, whatever
    the data axis (DTensor's own shape propagation is not counted)."""
    b, s, d, f = 2, 8, 64, 256

    def build(mesh):
        assert tuple(mesh.shape) == (world // 4, 4)
        tree = {"ffn": {"up": {"w": torch.empty((d, f), device="meta")}},
                "x": torch.empty((b, s, d), device="meta")}
        spec = {"ffn": specs.param_pspecs({"ffn": tree["ffn"]}, mesh)["ffn"],
                "x": specs.P()}
        placed = dryrun.place(tree, spec, mesh)
        return (lambda w, x: common.linear(w, x)), (
            placed["ffn"]["up"], placed["x"])

    rec = _trace(world, 4, build)
    assert rec["flops_per_device"] == 2 * b * s * d * f / 4
    assert rec["collectives"]["count_by_op"] == {}


def test_flash_forward_flops_follow_the_stated_formula():
    # whole tiles, no mask: the dense products
    assert flash_mod.forward_flops(2, 3, 128, 128, 64, 64, False, 0) == \
        2 * 3 * 2 * 128 * 128 * (64 + 64)
    # causal over 4 x 4 tiles of 64: 1 + 2 + 3 + 4 of the 16 visited
    assert flash_mod.forward_flops(1, 1, 256, 256, 64, 64, True, 0) == \
        10 * 2 * 64 * 64 * 128
    # a window of 64 sees the diagonal tile and the one before it
    assert flash_mod.forward_flops(1, 1, 256, 256, 64, 64, True, 64) == \
        7 * 2 * 64 * 64 * 128
    # the trace adds the formula of each rank's own calls: 8 prompts of
    # 64 over 2 data ranks, 8 heads over 4 model ranks, 2 kv heads kept
    # whole, one kv head read a rank
    cfg = get_config("tinyllama-1.1b", smoke=True)
    rec = _smoke_case("tinyllama-1.1b", "prefill_32k", 64, 8, "prefill", 1,
                      dtype=cfg.dtype)
    assert rec["flash_calls"] == cfg.num_layers
    assert rec["flash_flops"] == cfg.num_layers * flash_mod.forward_flops(
        4, 2, 64, 64, 32, 32, True, 0)


def test_four_kv_heads_trace_on_eight_model_ranks():
    """TinyLlama-1.1B's 4 kv heads on a "model" axis of 8 (a narrow tower
    with its head counts): the kv projection is gathered before the head
    reshape, 2 all-gathers a layer on "model"."""
    cfg = get_config("tinyllama-1.1b").replace(
        num_layers=2, d_model=256, head_dim=16, d_ff=512, vocab_size=512,
        dtype="float32")
    assert (cfg.num_heads, cfg.num_kv_heads) == (32, 4)
    b, s = 4, 32
    rec = dryrun.run_case("tinyllama-1.1b", inp.InputShape(
        "p", s, b, "prefill"), False, device="cpu", world=16,
        ranks_per_host=8, cfg=cfg)
    assert rec["mesh"] == {"data": 2, "model": 8}
    model = rec["collectives"]["by_axis"]["model"]
    gathers = rec["collectives"]["count_by_op"]["all-gather"]
    assert gathers >= 2 * cfg.num_layers and model["calls"] >= gathers
    kv = (b // 2) * s * cfg.num_kv_heads * cfg.resolved_head_dim * 4
    assert rec["collectives"]["bytes_by_op"]["all-gather"] >= \
        2 * cfg.num_layers * kv


# --------------------------------------------------------------- CLI --

def test_cli_writes_records_and_refuses(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: get_config(arch, smoke=True))
    for name, (seq, b) in (("decode_32k", (32, 8)), ("train_4k", (16, 32))):
        kind = inp.INPUT_SHAPES[name].kind
        monkeypatch.setitem(inp.INPUT_SHAPES, name,
                            inp.InputShape(name, seq, b, kind))
    out = tmp_path / "r.json"
    dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k",
                 "--device", "cpu", "--out", str(out)])
    rec = dryrun.load_results(str(out))["baseline/tinyllama-1.1b/"
                                        "decode_32k/single"]
    assert {"memory", "flops_per_device", "bytes_per_device", "collectives",
            "roofline", "trace_s", "chips"} <= set(rec)
    assert rec["chips"] == 256 and rec["mesh"] == {"data": 16, "model": 16}
    assert {"argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes"} <= set(rec["memory"])
    assert {"bytes_by_op", "count_by_op", "wire_bytes", "total_bytes",
            "by_axis"} <= set(rec["collectives"])
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "resnet14-cifar", "--device", "cpu"])
    assert e.value.code == 2
    dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "train_4k",
                 "--dcco-impl", "shard_map", "--device", "cpu",
                 "--tag", "sm", "--out", str(out)])
    rec = dryrun.load_results(str(out))["sm/tinyllama-1.1b/train_4k/single"]
    assert rec["dcco_impl"] == "shard_map"
    d = get_dual_encoder_config("tinyllama-1.1b").proj_dims[-1]
    assert rec["collectives"]["by_axis"]["data"]["bytes"] >= \
        (4 * d + d * d) * 4
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "train_4k",
                     "--dcco-impl", "bogus", "--device", "cpu",
                     "--out", str(tmp_path / "f.json")])
    assert e.value.code == 1
    assert "unknown dcco impl 'bogus'" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()
