"""The REPRO_* multi-process contract and the multi-host
("data", "client") mesh of the port, on the CPU.

``maybe_initialize_distributed`` with and without the environment, in
this process as a gloo world of one (a FileStore under ``tmp_path``, no
TCP port); then a world of 4 gloo ranks laid out as 2 hosts of 2
(tests/_torch_dist.py): the mesh's shape and each rank's linear index,
``host_local_to_global``, and the sharded round with the axis tuple
``("data", "client")`` against the reference (its unsharded
``fed_sim.stats_round``, and its own sharded int8 and int8-tree rounds on
4 forced CPU devices fed the same rank-folded uniforms), and three
``cohort_axis=("data", "client")`` engine rounds against the unsharded
engine. Tolerances as tests/test_torch_sharded.py states them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_dist as td
import _torch_sharded_ref as sref
from repro import objectives as j_objectives
from repro.core import fed_sim as j_fed_sim
from repro.optim import optimizers as j_opt
from repro_torch import utils
from repro_torch.core import fed_sim, round_engine
from repro_torch.launch import train
from repro_torch.launch.mesh import HardwareSpec, make_debug_mesh
from repro_torch.optim import optimizers as opt_lib
from repro_torch.server import drift
from repro_torch.sharding import (host_local_to_global, make_corpus_mesh,
                                  make_multihost_mesh,
                                  maybe_initialize_distributed)

torch.set_num_threads(1)

LAM, LR, WORLD = td.LAM, td.LR, 4
AXIS = ("data", "client")


def _rel(port, ref, start):
    return (utils.tree_max_abs_diff(port, ref)
            / utils.tree_max_abs_diff(ref, start))


def _env(tmp_path, world=1, rank=0):
    return {"REPRO_COORDINATOR": f"file://{tmp_path}/store",
            "REPRO_NUM_PROCESSES": str(world),
            "REPRO_PROCESS_ID": str(rank)}


# --------------------------------------------------- the env contract --

def test_no_env_is_a_no_op():
    assert maybe_initialize_distributed({}) is False
    assert maybe_initialize_distributed({"REPRO_NUM_PROCESSES": "2"}) is False
    assert not dist.is_initialized()


def test_env_contract_makes_a_world_and_its_meshes(tmp_path):
    with pytest.raises(ValueError, match="not in"):
        maybe_initialize_distributed(_env(tmp_path, 2, 2), device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        make_debug_mesh(1)
    assert maybe_initialize_distributed(_env(tmp_path), device="cpu",
                                        timeout_s=60.0)
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        mesh = make_debug_mesh(1)
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        assert tuple(make_multihost_mesh().shape) == (1, 1)
        assert make_corpus_mesh().mesh_dim_names == ("corpus",)
        with pytest.raises(ValueError, match="needs 2 ranks"):
            make_debug_mesh(2)
        with pytest.raises(ValueError, match="world size"):
            make_corpus_mesh(2)
        tree = {"a": torch.ones(2, 3)}
        assert host_local_to_global(mesh, None, tree) is tree
        assert torch.equal(host_local_to_global(mesh, "data", tree)["a"],
                           tree["a"])
    finally:
        dist.destroy_process_group()


def test_train_main_joins_the_world_first(tmp_path, monkeypatch):
    """``launch/train.py::main`` joins the REPRO_* world before it trains,
    as the reference's does; each rank then runs the same training."""
    for k, v in _env(tmp_path / "w").items():
        monkeypatch.setenv(k, v)
    (tmp_path / "w").mkdir()
    try:
        res = train.main([
            "--device", "cpu", "--rounds", "1", "--eval-every", "1",
            "--dataset-size", "32", "--clients-per-round", "4",
            "--ckpt-dir", str(tmp_path / "ck")])
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert len(res["history"]) == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_hardware_spec_is_the_h100s():
    assert HardwareSpec.NAME == "NVIDIA H100 SXM"
    assert (HardwareSpec.PEAK_BYTES, HardwareSpec.PEAK_F32,
            HardwareSpec.PEAK_TF32, HardwareSpec.PEAK_BF16) == (
        3.35e12, 67e12, 495e12, 989e12)


# ------------------------------------------------------- a world of 4 --

@pytest.fixture(scope="module")
def ref_sharded(tmp_path_factory):
    return sref.run_reference_sharded(tmp_path_factory.mktemp("ref"), WORLD)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    params, batch, sizes = sref.cohort()
    pt = sref.to_torch(params)
    payloads = sref.payload_shapes(params)
    _, pool_b, pool_s = sref.cohort(seed=1)
    inputs = {
        "mesh": {},
        "rounds": {"axis": AXIS, "params": pt,
                   "batch": sref.to_torch(batch),
                   "sizes": torch.tensor(sizes), "edges": sref.EDGES,
                   "int8_draws": sref.shard_draws(WORLD, payloads, False),
                   "tree_draws": sref.shard_draws(WORLD, payloads, True)},
        "engine": {"axis": AXIS, "params": pt,
                   "pool": sref.to_torch(pool_b),
                   "pool_sizes": torch.tensor(pool_s), "k": 8},
    }
    outs = td.run_world(tmp_path_factory.mktemp("multihost"), WORLD,
                        list(inputs), inputs)
    return inputs, outs


def test_multihost_mesh_and_host_local_to_global(world):
    _, outs = world
    for r, o in enumerate(outs):
        m = o["mesh"]
        assert m["shape"].tolist() == [2, 2]
        assert m["names"] == ["data", "client"]
        # the linear index over ("data", "client") is the rank, row-major
        assert m["index"].tolist() == [r, r // 2, r % 2]
        g = m["global"]
        assert torch.equal(g["a"], torch.arange(WORLD, dtype=torch.float32)
                           .repeat_interleave(2)[:, None].expand(8, 3))
        assert g["b"].tolist() == [10 * q + i for q in range(WORLD)
                                   for i in range(2)]
        assert torch.equal(m["replicated"]["a"],
                           torch.full((2, 3), float(r)))


@pytest.mark.parametrize("objective", ["dcco", "dvicreg"])
def test_tuple_axis_round_matches_reference(world, objective):
    inputs, outs = world
    got = outs[0]["rounds"][objective]
    for o in outs[1:]:
        assert utils.tree_max_abs_diff(o["rounds"][objective]["params"],
                                       got["params"]) == 0.0
    params, batch, sizes = sref.cohort()
    hyper = {"lam": LAM} if objective == "dcco" else {}
    opt = j_opt.sgd(LR)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pj, _, mj = jax.jit(lambda p, o: j_fed_sim.stats_round(
        _j_apply, p, o, opt, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(sizes), client_lr=LR,
        objective=j_objectives.get_objective(objective, **hyper)))(
        jp, opt.init(jp))
    p0 = inputs["rounds"]["params"]
    assert _rel(got["params"], sref.to_torch(jax.tree.map(np.asarray, pj)),
                p0) <= 1e-4
    np.testing.assert_allclose(got["loss"].item(), float(mj.loss),
                               rtol=1e-5)


def _j_apply(p, batch):
    def enc(x):
        return jnp.tanh(x @ p["w1"]) @ p["w2"]
    return enc(batch["v1"]), enc(batch["v2"])


@pytest.mark.parametrize("case", ["int8", "tree"])
def test_tuple_axis_channel_rounds_match_the_references_sharded_draws(
        world, ref_sharded, case):
    inputs, outs = world
    want = ref_sharded[case]
    got = outs[0]["rounds"][case]
    p0 = inputs["rounds"]["params"]
    ref_p = {k: torch.tensor(want[k]) for k in ("w1", "w2")}
    assert _rel(got["params"], ref_p, p0) <= 1e-3
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=1e-4)
    assert got["wire_bytes"].item() == float(want["wire_bytes"])


def test_tuple_axis_scaffold_round_matches_unsharded(world):
    inputs, outs = world
    got = outs[0]["rounds"]["scaffold"]
    inp = inputs["rounds"]
    p0 = inp["params"]
    opt = opt_lib.sgd(LR)
    p, _, state, _ = fed_sim.dcco_round(
        td.t_apply, p0, opt.init(p0), opt, inp["batch"], inp["sizes"],
        lam=LAM, client_lr=0.01, local_steps=2,
        scaffold_state=drift.scaffold_init(p0, inp["sizes"].shape[0]))
    assert _rel(got["params"], p, p0) <= 1e-4
    scale = max(float(x.abs().max()) for x in utils.tree_leaves(
        state.c_slots))
    assert utils.tree_max_abs_diff(got["c_slots"], state.c_slots) \
        <= 1e-4 * scale


def test_tuple_axis_engine_matches_the_unsharded_engine(world):
    inputs, outs = world
    got = outs[0]["engine"]["lossless"]
    for o in outs[1:]:
        assert utils.tree_max_abs_diff(o["engine"]["lossless"]["params"],
                                       got["params"]) == 0.0
    inp = inputs["engine"]
    opt = opt_lib.sgd(LR)
    eng = round_engine.RoundEngine(
        td.t_apply, opt, td.toy_sampler(inp["pool"], inp["pool_sizes"],
                                        inp["k"]),
        round_engine.EngineConfig(lam=LAM, client_lr=LR, chunk_rounds=2,
                                  stats_kernel="off"))
    p, _, m = eng.run(inp["params"], opt.init(inp["params"]), seed=3,
                      rounds=3)
    assert _rel(got["params"], p, inp["params"]) <= 1e-4
    np.testing.assert_allclose(got["loss"].numpy(), m.loss.numpy(),
                               rtol=1e-5)
