"""The port's checkpoints against the reference's, on the CPU: the msgpack
codec against the ``msgpack`` library, files byte for byte equal to the
reference's for the same tree, each package restoring the other's files
(bf16 leaves and NamedTuples included), ``CorpusIndex.save``/``load`` in
both directions, the engine's checkpoints (the port's versions of the
reference's engine, drift, buffer and system resume tests, and the
clustered state), and the training CLI's ``--ckpt-dir``/``--ckpt-every``/
``--resume``.

Tolerances: none. Files are compared byte for byte, restored leaves bit
for bit, and within the port a resumed run is held to the uninterrupted
one exactly (the rounds' draws depend only on the seed and the round
number, and the CPU's arithmetic repeats).
"""
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

import _torch_toy as toy
from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import restore_checkpoint_flat as j_flat
from repro.checkpoint import save_checkpoint as j_save
from repro.configs.base import DualEncoderConfig as JDE
from repro.configs.base import get_config as j_get_config
from repro.models import dual_encoder as j_de
from repro.optim import optimizers as j_opt
from repro.retrieval import index as j_index
from repro.server.drift import ScaffoldState as JScaffold
from repro_torch import comm, convert, retrieval, utils
from repro_torch.checkpoint import (_msgpack, restore_checkpoint,
                                    restore_checkpoint_flat, save_checkpoint)
from repro_torch.cluster import ClusterState
from repro_torch.configs.base import DualEncoderConfig, get_config
from repro_torch.core import buffer, fed_sim, round_engine
from repro_torch.data import latency, partition, pipeline, synthetic
from repro_torch.launch import train
from repro_torch.models import dual_encoder
from repro_torch.optim import optimizers as opt_lib
from repro_torch.server import drift

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _packb(obj):
    return b"".join(bytes(c) for c in _msgpack.pack_chunks(obj))


@pytest.mark.parametrize("obj", [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
    -1, -32, -33, -128, -129, -2 ** 15, -2 ** 15 - 1, -2 ** 31 - 1,
    -2 ** 63, None, True, False, "", "a" * 31, "a" * 32,
    "é" * 200, "a" * 70000, b"", b"x" * 255, b"x" * 256, b"x" * 70000,
    list(range(15)), list(range(16)), list(range(70000)),
    {str(i): i for i in range(15)}, {str(i): [i, {"x": b"y"}]
                                     for i in range(16)},
])
def test_codec_matches_msgpack(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert _packb(obj) == want
    assert _msgpack.unpackb(want) == msgpack.unpackb(want, raw=False)


def test_codec_refuses_what_it_does_not_carry():
    for obj in ({1, 2}, 1.5):
        with pytest.raises(TypeError):
            _packb(obj)
    with pytest.raises(ValueError, match="truncated"):
        _msgpack.unpackb(_packb("abc")[:-1])
    with pytest.raises(ValueError, match="extra data"):
        _msgpack.unpackb(_packb(1) + b"\x00")
    with pytest.raises(ValueError, match="0xcb"):
        _msgpack.unpackb(msgpack.packb(1.5))


def _tree_np(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "params": {"b": [rng.randn(3).astype(np.float32),
                         rng.randn(2, 2).astype(ml_dtypes.bfloat16)],
                   "a": {"w": rng.randn(40, 5).astype(np.float32)}},
        "opt": {"step": np.asarray(7, np.int32),
                "m": {"q": rng.randint(-128, 127, (4,)).astype(np.int8)}},
        "drift": JScaffold({"x": rng.randn(2).astype(np.float32)},
                           [np.ones((3, 1), np.float32)]),
        "empty": np.zeros((0, 3), np.float32),
        "flag": np.asarray(True),
    }


def _tensor(x):
    x = np.asarray(x)
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _to_port(tree):
    """The same tree with torch tensors and the port's ScaffoldState."""
    t = utils.tree_map(_tensor, {k: v for k, v in tree.items()
                                 if k != "drift"})
    t["drift"] = drift.ScaffoldState(*utils.tree_map(_tensor,
                                                     list(tree["drift"])))
    return t


@pytest.mark.parametrize("leaves", ["numpy", "torch"])
def test_files_are_byte_identical_to_the_references(tmp_path, leaves):
    tree = _tree_np()
    j_save(str(tmp_path / "ref.msgpack"), tree, step=300)
    if leaves == "numpy":
        mine = dict(tree, drift=drift.ScaffoldState(*tree["drift"]))
    else:
        mine = _to_port(tree)
    save_checkpoint(str(tmp_path / "port.msgpack"), mine, step=300)
    ref = (tmp_path / "ref.msgpack").read_bytes()
    assert (tmp_path / "port.msgpack").read_bytes() == ref
    assert not (tmp_path / "port.msgpack.tmp").exists()
    flat, step = restore_checkpoint_flat(str(tmp_path / "ref.msgpack"))
    assert step == 300
    assert sorted(flat) == [
        "drift/.c/x", "drift/.c_slots/0", "empty", "flag", "opt/m/q",
        "opt/step", "params/a/w", "params/b/0", "params/b/1"]
    assert flat["params/b/1"].dtype == torch.bfloat16
    assert flat["empty"].shape == (0, 3) and flat["flag"].dtype == torch.bool


def _smoke_tokens_de(dtype=None):
    jc = j_get_config("tinyllama-1.1b", smoke=True)
    jde = JDE(proj_dims=(64, 64))
    jp = j_de.init_dual_encoder(jax.random.PRNGKey(0), jc, jde)
    if dtype is not None:
        jp = jax.tree.map(lambda x: x.astype(dtype), jp)
    return jc, jp


def _assert_same(a, b):
    """Two trees with the same keys, leaf for leaf the same dtype and
    bits (dict order aside)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("bf16", [False, True])
def test_reference_file_restores_in_the_port(tmp_path, bf16):
    _, jp = _smoke_tokens_de(jnp.bfloat16 if bf16 else None)
    opt = j_opt.adam(1e-3)
    js = opt.init(jp)
    js = dict(js, m=jax.tree.map(lambda x: x + 0.5, js["m"]))
    path = str(tmp_path / "ref.msgpack")
    j_save(path, {"params": jp, "opt": js}, step=5)
    tc = get_config("tinyllama-1.1b", smoke=True)
    tp = dual_encoder.init_dual_encoder(1, tc, DualEncoderConfig(
        proj_dims=(64, 64)))
    like = {"params": tp, "opt": opt_lib.adam(1e-3).init(tp)}
    got, step = restore_checkpoint(path, like, device="cpu")
    assert step == 5
    _assert_same(got["params"],
                 convert.params_from_jax(jax.tree.map(np.asarray, jp)))
    _assert_same(got["opt"]["m"],
                 convert.params_from_jax(jax.tree.map(np.asarray, js["m"])))
    assert got["opt"]["step"].dtype == torch.int32
    assert int(got["opt"]["step"]) == 0


def test_port_file_restores_in_the_reference(tmp_path):
    tc = get_config("tinyllama-1.1b", smoke=True)
    tp = utils.tree_cast(dual_encoder.init_dual_encoder(
        2, tc, DualEncoderConfig(proj_dims=(64, 64))), torch.bfloat16)
    td = drift.scaffold_init(tp, 3)
    td = drift.ScaffoldState(utils.tree_map(lambda x: x + 1.0, td.c),
                             td.c_slots)
    path = str(tmp_path / "port.msgpack")
    save_checkpoint(path, {"params": tp, "drift": td}, step=11)
    want = convert.params_to_jax(tp)
    _, jp = _smoke_tokens_de(jnp.bfloat16)
    from repro.server.drift import scaffold_init as j_scaffold_init
    blob, step = j_restore(path, {"params": jp,
                                  "drift": j_scaffold_init(jp, 3)})
    assert step == 11 and isinstance(blob["drift"], JScaffold)
    for a, b in zip(jax.tree.leaves(blob["params"]), jax.tree.leaves(want)):
        assert a.dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(a).view(np.uint16),
                                      np.asarray(b).view(np.uint16))
    c_want = convert.params_to_jax(td.c)
    for a, b in zip(jax.tree.leaves(blob["drift"].c),
                    jax.tree.leaves(c_want)):
        np.testing.assert_array_equal(np.asarray(a), b)
    flat, _ = j_flat(path)
    np.testing.assert_array_equal(
        flat["params/tower/embed/table"].view(np.uint16),
        tp["tower"]["embed"]["table"].view(torch.int16).numpy().view(
            np.uint16))


def test_restore_refusals(tmp_path):
    path = str(tmp_path / "c.msgpack")
    save_checkpoint(path, {"a": torch.ones(2)}, step=1)
    with pytest.raises(KeyError, match="'b'"):
        restore_checkpoint(path, {"b": torch.ones(2)}, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            restore_checkpoint(path, {"a": torch.ones(2)})
    with pytest.raises(TypeError, match="complex64"):
        save_checkpoint(path, {"z": torch.ones(2, dtype=torch.complex64)})


def test_checkpoint_runs_without_msgpack_or_jax():
    """The port's checkpoints need neither ``msgpack`` nor JAX nor the
    reference package: a process where importing them fails writes and
    reads a checkpoint."""
    code = (
        "import sys, tempfile\n"
        "for m in ('msgpack', 'jax', 'repro', 'ml_dtypes'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from repro_torch.checkpoint import save_checkpoint, "
        "restore_checkpoint\n"
        "p = tempfile.mkdtemp() + '/c.msgpack'\n"
        "t = {'w': torch.arange(6.).reshape(2, 3).bfloat16(), "
        "'s': torch.tensor(3, dtype=torch.int32)}\n"
        "save_checkpoint(p, t, step=4)\n"
        "got, step = restore_checkpoint(p, t, device='cpu')\n"
        "assert step == 4 and torch.equal(got['w'], t['w'])\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    for f in (ROOT / "src" / "repro_torch" / "checkpoint").glob("*.py"):
        src = f.read_text()
        for mod in ("msgpack", "jax", "repro."):
            assert f"import {mod}" not in src and f"from {mod}" not in src


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_corpus_index_save_load_both_directions(tmp_path, dtype):
    rng = np.random.RandomState(4)
    emb = retrieval.l2_normalize(torch.as_tensor(
        rng.randn(300, 24).astype(np.float32))).to(dtype)
    q = retrieval.l2_normalize(torch.as_tensor(
        rng.randn(5, 24).astype(np.float32)))
    idx = retrieval.CorpusIndex(emb)
    idx.save(str(tmp_path / "port.idx"))
    back = retrieval.CorpusIndex.load(str(tmp_path / "port.idx"),
                                      device="cpu")
    assert back.normalized and back.embeddings.dtype == dtype
    assert torch.equal(back.embeddings, emb)
    before, after = idx.search(q, 10), back.search(q, 10)
    assert torch.equal(before[0], after[0]) and torch.equal(before[1],
                                                            after[1])
    j_idx = j_index.CorpusIndex.load(str(tmp_path / "port.idx"))
    np.testing.assert_array_equal(
        np.asarray(j_idx.embeddings).astype(np.float32),
        emb.float().numpy())
    assert j_idx.normalized and j_idx.num_items == 300
    # the reference's file, unnormalized flag included
    j_emb = jnp.asarray(emb.float().numpy())
    if dtype == torch.bfloat16:
        j_emb = j_emb.astype(jnp.bfloat16)
    j_index.CorpusIndex(j_emb, normalized=False).save(
        str(tmp_path / "ref.idx"))
    got = retrieval.CorpusIndex.load(str(tmp_path / "ref.idx"), device="cpu")
    assert not got.normalized and torch.equal(got.embeddings, emb)
    assert (tmp_path / "ref.idx").read_bytes() == (
        tmp_path / "port.idx").read_bytes().replace(
            _packb({"dtype": "int32", "shape": [],
                    "data": np.int32(1).tobytes()}),
            _packb({"dtype": "int32", "shape": [],
                    "data": np.int32(0).tobytes()}))


# --------------------------------------------------------------- engine ---

def _toy_setup():
    params = toy.to_torch(toy.params_np())
    pool = toy.to_torch(toy.pool_np())
    data = {v: x[:8] for v, x in pool.items()}
    sizes = torch.tensor([3, 1, 2, 3, 3, 2, 1, 3], dtype=torch.int32)
    return params, data, sizes


def _equal(a, b):
    return utils.tree_max_abs_diff(a, b) == 0.0


def test_segments_stream_and_checkpoint(tmp_path):
    params, data, sizes = _toy_setup()
    opt = opt_lib.adam(1e-2)
    eng = round_engine.RoundEngine(
        toy.t_apply, opt, lambda gen: (data, sizes),
        round_engine.EngineConfig(lam=toy.LAM, chunk_rounds=2))
    seen = []
    p, s, m = eng.run(params, opt.init(params), 3, 6,
                      on_segment=lambda end, c, seg: seen.append(
                          (end, tuple(seg.loss.shape))),
                      ckpt_dir=str(tmp_path), ckpt_every=2, ckpt_name="eng")
    assert seen == [(2, (2,)), (4, (2,)), (6, (2,))]
    assert m.loss.shape == (6,) and m.encoding_std.shape == (6,)
    blob, step = restore_checkpoint(str(tmp_path / "eng.msgpack"),
                                    {"params": params,
                                     "opt": opt.init(params)}, "cpu")
    assert step == 6
    assert _equal(blob["params"], p) and _equal(blob["opt"], s)
    flat, _ = j_flat(str(tmp_path / "eng.msgpack"))
    assert sorted(flat) == ["opt/m/w1", "opt/m/w2", "opt/step", "opt/v/w1",
                            "opt/v/w2", "params/w1", "params/w2"]


def test_checkpoint_cadence_counts_rounds_since_the_last_write(
        tmp_path, monkeypatch):
    """As the reference's: a write at a segment boundary once
    ``ckpt_every`` rounds have run since the last one (rounds 4 and 8 of
    9 in segments of 2, every 3); none without ``ckpt_every``."""
    params, data, sizes = _toy_setup()
    steps = []

    def record(path, tree, step):
        steps.append(step)

    monkeypatch.setattr(round_engine, "save_checkpoint", record)
    opt = opt_lib.sgd(0.1)
    eng = round_engine.RoundEngine(
        toy.t_apply, opt, lambda gen: (data, sizes),
        round_engine.EngineConfig(lam=toy.LAM, chunk_rounds=2))
    eng.run(params, opt.init(params), 3, 9, start_round=10,
            ckpt_dir=str(tmp_path), ckpt_every=3)
    assert steps == [14, 18]
    steps.clear()
    eng.run(params, opt.init(params), 3, 4, ckpt_dir=str(tmp_path))
    assert steps == []


def _drift_engine(channel=None, **kw):
    params, data, sizes = _toy_setup()
    opt = opt_lib.sgd(0.1)
    kw.setdefault("chunk_rounds", 2)
    cfg = round_engine.EngineConfig(
        lam=toy.LAM, client_lr=0.05, local_steps=2, scaffold=True,
        channel=channel, **kw)
    return params, opt, cfg, (data, sizes)


def test_drift_state_resume_continues_trajectory(tmp_path):
    params, opt, cfg, (data, sizes) = _drift_engine(chunk_rounds=4)

    def sampler(gen):
        return data, sizes

    eng = round_engine.RoundEngine(toy.t_apply, opt, sampler, cfg)
    eng.run(params, opt.init(params), 9, 4, ckpt_dir=str(tmp_path),
            ckpt_every=4, ckpt_name="d")
    tmpl = {"params": params, "opt": opt.init(params),
            "drift": drift.scaffold_init(params, 8)}
    blob, step = restore_checkpoint(str(tmp_path / "d.msgpack"), tmpl,
                                    "cpu")
    assert step == 4 and isinstance(blob["drift"], drift.ScaffoldState)
    p1, _, _ = eng.run(blob["params"], blob["opt"], 9, 4, start_round=4,
                       drift_state=blob["drift"])
    d1 = eng.drift_state
    p2, _, _ = eng.run(params, opt.init(params), 9, 8)
    assert _equal(p1, p2) and _equal(d1.c, eng.drift_state.c)
    assert _equal(d1.c_slots, eng.drift_state.c_slots)


def test_checkpoint_resume_with_drift_and_lossy_channel(tmp_path):
    """SCAFFOLD variates and an int8 uplink in one run, checkpointed after
    round 4, restored and resumed in a fresh engine: the uninterrupted
    trajectory, bit for bit (the channel's draws come from the round's
    seed, so the resumed rounds replay them)."""
    params, opt, cfg, (data, sizes) = _drift_engine(
        comm.QuantizedChannel(8))

    def build():
        return round_engine.RoundEngine(toy.t_apply, opt,
                                        lambda gen: (data, sizes), cfg)

    eng_ref = build()
    p_ref, _, m_ref = eng_ref.run(params, opt.init(params), 17, 6)
    eng_a = build()
    pa, _, ma = eng_a.run(params, opt.init(params), 17, 4,
                          ckpt_dir=str(tmp_path), ckpt_every=2,
                          ckpt_name="drift_ch")
    tmpl = {"params": params, "opt": opt.init(params),
            "drift": drift.scaffold_init(params, 8)}
    blob, step = restore_checkpoint(str(tmp_path / "drift_ch.msgpack"),
                                    tmpl, "cpu")
    assert step == 4 and _equal(blob["params"], pa)
    assert _equal(blob["drift"].c_slots, eng_a.drift_state.c_slots)
    eng_b = build()
    pb, _, mb = eng_b.run(blob["params"], blob["opt"], 17, 2,
                          start_round=step, drift_state=blob["drift"])
    assert _equal(pb, p_ref)
    assert _equal(eng_b.drift_state.c, eng_ref.drift_state.c)
    assert torch.equal(mb.loss, m_ref.loss[4:])
    assert float(ma.wire_bytes.sum()) > 0 and float(mb.wire_bytes.sum()) > 0


def test_async_checkpoint_roundtrips_buffer_and_drift(tmp_path):
    """The buffered engine's resume: SCAFFOLD, an int8 uplink, heavy-tail
    stragglers and a part-full buffer checkpointed after tick 4; every
    buffer field round-trips, and the resumed ticks are the uninterrupted
    ones."""
    lat = latency.LatencyModel("heavytail", horizon=4, tail=0.8)
    params, opt, cfg, (data, sizes) = _drift_engine(
        comm.QuantizedChannel(8), async_k=3, staleness_fn="poly",
        latency=lat)
    sampler = latency.make_async_sampler(lambda gen: (data, sizes), lat, 8)

    def build():
        return round_engine.RoundEngine(toy.t_apply, opt, sampler, cfg)

    eng_ref = build()
    p_ref, _, _ = eng_ref.run(params, opt.init(params), 17, 6)
    eng_a = build()
    eng_a.run(params, opt.init(params), 17, 4, ckpt_dir=str(tmp_path),
              ckpt_every=2, ckpt_name="async_ch")
    tmpl = {"params": params, "opt": opt.init(params),
            "drift": drift.scaffold_init(params, 8),
            "buffer": eng_a._init_async_state(params)}
    blob, step = restore_checkpoint(str(tmp_path / "async_ch.msgpack"),
                                    tmpl, "cpu")
    assert step == 4 and isinstance(blob["buffer"], buffer.AsyncState)
    restored, live = blob["buffer"], eng_a.buffer_state
    assert _equal(restored.buffer._asdict(), live.buffer._asdict())
    assert _equal(restored.pending._asdict(), live.pending._asdict())
    assert int(restored.applied_total) == int(live.applied_total)
    # heavy-tail delays leave real in-flight mass at the cut
    assert float(restored.pending.mass.sum()) > 0.0
    eng_b = build()
    pb, _, _ = eng_b.run(blob["params"], blob["opt"], 17, 2, start_round=4,
                         drift_state=blob["drift"],
                         buffer_state=blob["buffer"])
    assert _equal(pb, p_ref)
    assert _equal(eng_b.drift_state.c, eng_ref.drift_state.c)
    assert int(eng_b.buffer_state.applied_total) == int(
        eng_ref.buffer_state.applied_total)


def test_clustered_checkpoint_roundtrips_the_cluster_state(tmp_path):
    params, data, sizes = _toy_setup()
    opt = opt_lib.adam(1e-2)
    cfg = round_engine.EngineConfig(lam=toy.LAM, chunk_rounds=2,
                                    num_clusters=3)

    def build():
        return round_engine.RoundEngine(toy.t_apply, opt,
                                        lambda gen: (data, sizes), cfg)

    eng_ref = build()
    p_ref, _, _ = eng_ref.run(params, opt.init(params), 5, 4)
    eng_a = build()
    eng_a.run(params, opt.init(params), 5, 2, ckpt_dir=str(tmp_path),
              ckpt_every=2, ckpt_name="cl")
    like = {"params": params, "opt": opt.init(params),
            "cluster": eng_a.cluster_state}
    blob, step = restore_checkpoint(str(tmp_path / "cl.msgpack"), like,
                                    "cpu")
    assert step == 2 and isinstance(blob["cluster"], ClusterState)
    assert blob["cluster"].initialized.dtype == torch.bool
    assert _equal(blob["cluster"]._asdict(), eng_a.cluster_state._asdict())
    eng_b = build()
    pb, _, _ = eng_b.run(blob["params"], blob["opt"], 5, 2, start_round=2,
                         cluster_state=blob["cluster"])
    assert _equal(pb, p_ref)


def test_checkpoint_resume_federated_training(tmp_path):
    """The smoke ResNet: two D-CCO rounds, a checkpoint, a restore; the
    next round from the restored state equals it from the live one."""
    cfg = get_config("resnet14-cifar", smoke=True).replace(resnet_groups=2)
    de = DualEncoderConfig(proj_dims=(32, 32), lambda_cco=5.0)
    params = dual_encoder.init_dual_encoder(0, cfg, de)
    apply = train.make_apply(cfg, de)
    imgs, labels = synthetic.synthetic_labeled_images(
        40, 4, image_size=cfg.image_size)
    ds = pipeline.FederatedDataset.build(
        {"images": imgs}, labels, num_clients=20, samples_per_client=2,
        partition=partition.PartitionSpec("dirichlet", alpha=0.0), seed=0)
    opt = opt_lib.adam(1e-3)
    p, state = params, opt.init(params)
    for r in range(2):
        batch, sizes = ds.round_batch(utils.generator(r, "cpu"), 4)
        p, state, _ = fed_sim.dcco_round(apply, p, state, opt, batch, sizes,
                                         lam=5.0)
    path = str(tmp_path / "fed.msgpack")
    save_checkpoint(path, {"params": p, "opt": state}, step=2)
    restored, step = restore_checkpoint(path, {"params": params,
                                               "opt": opt.init(params)},
                                        "cpu")
    assert step == 2
    batch, sizes = ds.round_batch(utils.generator(99, "cpu"), 4)
    p_a, _, _ = fed_sim.dcco_round(apply, p, state, opt, batch, sizes,
                                   lam=5.0)
    p_b, _, _ = fed_sim.dcco_round(apply, restored["params"],
                                   restored["opt"], opt, batch, sizes,
                                   lam=5.0)
    assert _equal(p_a, p_b)


# ------------------------------------------------------------------ CLI ---

CLI = ["--device", "cpu", "--eval-every", "1", "--dataset-size", "96",
       "--clients-per-round", "8", "--rounds", "4"]


@pytest.mark.parametrize("extra", [
    [], ["--scaffold"],
    ["--async-k", "4", "--latency-tail", "1.0", "--staleness", "poly"]],
    ids=["sync", "scaffold", "buffered"])
def test_train_resume_reproduces_the_uninterrupted_run(tmp_path,
                                                       monkeypatch, extra):
    """``--ckpt-every 2`` over 4 rounds writes at rounds 2 and 4 (each
    kept aside here); ``--resume`` from round 2 runs rounds 3-4 to the
    uninterrupted run's losses and parameters, bit for bit."""
    def keep(path, tree, step):
        save_checkpoint(path, tree, step)
        shutil.copy(path, f"{path}.{step}")

    monkeypatch.setattr(round_engine, "save_checkpoint", keep)
    ck = str(tmp_path / "ck")
    full = train.main(CLI + ["--ckpt-dir", ck, "--ckpt-every", "2", *extra])
    import json
    assert json.loads((tmp_path / "ck" / "history.json").read_text()) == \
        full["history"]
    flat, step = restore_checkpoint_flat(f"{ck}/resnet14-cifar.msgpack.2")
    assert step == 2
    assert any(k.startswith("drift/.c_slots/") for k in flat) == (
        "--scaffold" in extra)
    assert any(k.startswith("buffer/.pending/") for k in flat) == (
        "--async-k" in extra)
    resumed = train.main(CLI + ["--ckpt-dir", str(tmp_path / "r"),
                                "--ckpt-every", "0", "--resume",
                                f"{ck}/resnet14-cifar.msgpack.2", *extra])
    assert resumed["history"] == full["history"][2:]
    assert _equal(resumed["params"], full["params"])
    assert _equal(resumed["opt_state"], full["opt_state"])


def test_train_resume_of_a_sync_checkpoint_starts_an_empty_buffer(
        tmp_path, capsys):
    train.main(CLI + ["--rounds", "2", "--ckpt-dir", str(tmp_path),
                      "--ckpt-every", "2"])
    res = train.main(CLI + ["--ckpt-dir", str(tmp_path), "--ckpt-every", "0",
                            "--resume", str(tmp_path / "resnet14-cifar.msgpack"),
                            "--async-k", "4"])
    out = capsys.readouterr().out
    assert "resumed from" in out and "holds no buffer state" in out
    assert len(res["history"]) == 2
    done = train.main(CLI + ["--rounds", "2", "--ckpt-dir", str(tmp_path),
                             "--resume",
                             str(tmp_path / "resnet14-cifar.msgpack")])
    assert done["history"] == []
    assert "no rounds to run" in capsys.readouterr().out
