"""Retrieval on the port, against the reference, on the CPU: the MIPS
top-k plain version, the metrics, the corpus index on the smoke ResNet,
the drift-gated refresh, IVF, the query server, the sharded search, the
engine's periodic eval and the CLI's ``--retrieval-eval``.

Inputs are made from seeded numpy and handed to both packages. On the CPU
the port's ``mips_topk`` runs its plain version.

Tolerances. Scores: atol 2e-5. The two frameworks sum the d products of a
score in other orders (ROADMAP §3 measured up to 1.1e-5 of XLA:CPU drift
between the reference's own paths), so no bitwise equality is claimed
across frameworks. Indices: equal, except where the reference's scores of
the two picks lie within 2e-5 (a near tie). Selections that only compare
(``select_topk``, the metrics, IVF lists) are held exactly. Inside the
port, sharded search equals unsharded search bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import DualEncoderConfig as JDE
from repro.configs.base import get_config as j_get_config
from repro.core import eval as j_eval
from repro.core import round_engine as j_engine
from repro.kernels import mips_topk as j_mips
from repro.kernels import ref as j_ref
from repro.models import dual_encoder as j_de
from repro.retrieval import index as j_index
from repro.retrieval import ivf as j_ivf
from repro_torch import convert, utils
from repro_torch.configs.base import DualEncoderConfig, get_config
from repro_torch.core import eval as eval_lib, round_engine
from repro_torch.kernels import ref
from repro_torch.kernels.mips_topk import mips_topk
from repro_torch.launch import train
from repro_torch.models import dual_encoder
from repro_torch.optim import optimizers as opt_lib
from repro_torch import retrieval
from repro_torch.sharding import make_corpus_mesh, maybe_initialize_distributed

import _torch_toy as toy

# tier-1 runs 6 pytest workers on the machine's cores: one torch thread
# per worker keeps them from contending with each other and with JAX
torch.set_num_threads(1)

ATOL = 2e-5
SMALL = ["--rounds", "2", "--eval-every", "2", "--dataset-size", "64",
         "--clients-per-round", "4", "--num-classes", "3"]


def _unit(rng, n, d):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _assert_topk_close(port, want, q, corpus, off=0):
    """Scores within ATOL; indices equal except at near ties (the
    reference's scores of the two picks within ATOL)."""
    pv, pi = (np.asarray(x) for x in port)
    wv, wi = (np.asarray(x) for x in want)
    np.testing.assert_allclose(pv, wv, rtol=0, atol=ATOL)
    bad = np.argwhere(pi != wi)
    s = np.asarray(q, np.float64) @ np.asarray(corpus, np.float64).T
    for r, c in bad:
        assert abs(s[r, pi[r, c] - off] - s[r, wi[r, c] - off]) <= ATOL, \
            (r, c, pi[r, c], wi[r, c])


def _bf16_round(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


# ---------------------------------------------------------------------------
# the plain MIPS top-k
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 5, 10])
@pytest.mark.parametrize("n,bf16", [(300, False), (77, False), (300, True)])
def test_plain_mips_matches_reference_scan_and_oracle(k, n, bf16):
    rng = np.random.RandomState(k * 1000 + n + bf16)
    q, c = _unit(rng, 6, 32), _unit(rng, n, 32)
    jc = jnp.asarray(c, jnp.bfloat16) if bf16 else jnp.asarray(c)
    tc = (torch.tensor(c).to(torch.bfloat16) if bf16 else torch.tensor(c))
    got = mips_topk(torch.tensor(q), tc, k)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    cf = _bf16_round(c) if bf16 else c
    _assert_topk_close(got, j_mips.mips_topk_chunked(
        jnp.asarray(q), jc, k=k, chunk=64), q, cf)
    _assert_topk_close(got, j_ref.mips_topk_ref(jnp.asarray(q),
                                                jnp.asarray(cf), k), q, cf)


def test_plain_mips_matches_the_interpreted_pallas_kernel():
    rng = np.random.RandomState(3)
    q, c = _unit(rng, 8, 32), _unit(rng, 256, 32)
    want = j_mips.mips_topk_pallas(jnp.asarray(q), jnp.asarray(c), k=10,
                                   block_n=64, interpret=True)
    _assert_topk_close(mips_topk(torch.tensor(q), torch.tensor(c), 10),
                       want, q, c)


def test_offset_form_matches_reference_and_masks_padding_rows():
    """A 100-row shard at offset 0 of a 1000-row corpus: the reference's
    chunk padding (local rows 100..127 at chunk 64) has global positions
    below n_total, and must still never enter; indices come out global."""
    rng = np.random.RandomState(4)
    q, c = _unit(rng, 5, 16), _unit(rng, 100, 16)
    for off in (0, 300, 950):
        want = j_mips.mips_topk_chunked(
            jnp.asarray(q), jnp.asarray(c), k=5, chunk=64,
            index_offset=jnp.int32(off), n_total=1000)
        got = mips_topk(torch.tensor(q), torch.tensor(c), 5,
                        index_offset=off, n_total=1000)
        valid = min(100, 1000 - off)
        _assert_topk_close(got, want, q[:, :], c, off)
        assert (got[1].numpy() >= off).all()
        assert (got[1].numpy() < off + valid).all()


def test_select_topk_equals_the_reference_exactly():
    rng = np.random.RandomState(5)
    v = rng.randint(0, 4, (6, 40)).astype(np.float32)   # many ties
    i = rng.permutation(240).reshape(6, 40).astype(np.int32)
    v[:, :5], i[:, :5] = ref.NEG_INF, ref.BIG_IDX       # sentinels
    v[:, 10], i[:, 10] = v[:, 11], i[:, 11]             # a repeated pair
    for cols, k in ((40, 12), (8, 8), (3, 3)):           # short lists too
        want = j_mips._select_topk(jnp.asarray(v[:, :cols]),
                                   jnp.asarray(i[:, :cols]), k)
        got = ref.select_topk(torch.tensor(v[:, :cols]),
                              torch.tensor(i[:, :cols]), k)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("shards", [1, 3, 4])
def test_sharded_search_equals_unsharded_bit_for_bit(shards):
    rng = np.random.RandomState(6)
    c = _unit(rng, 203, 24)
    c[150:160] = c[3:13]                        # duplicates across shards
    q = torch.tensor(np.concatenate([c[3:6], _unit(rng, 4, 24)]))
    emb = torch.tensor(c)
    whole = mips_topk(q, emb, 7)
    stacked = retrieval.sharded.stack_shards(emb, shards)
    got = retrieval.sharded_mips_topk(q, stacked, 7, n_total=203)
    assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])
    idx = retrieval.ShardedCorpusIndex(emb, shards).search(q, 7)
    assert torch.equal(idx[1], whole[1])
    # duplicated rows tie on equal bits and go to the lowest index
    assert whole[1][:3, :2].tolist() == [[3, 150], [4, 151], [5, 152]]
    assert torch.equal(whole[0][:3, 0], whole[0][:3, 1])


def test_mips_refusals(tmp_path):
    q, c = torch.zeros(2, 4), torch.zeros(300, 4)
    with pytest.raises(ValueError, match="exceeds 256"):
        mips_topk(q, c, 257)
    with pytest.raises(ValueError, match="corpus size"):
        mips_topk(q, c[:5], 6)
    with pytest.raises(ValueError, match="dim"):
        mips_topk(q, torch.zeros(10, 5), 3)
    with pytest.raises(ValueError, match="2\\^30"):
        mips_topk(q, c, 3, index_offset=0, n_total=2 ** 30)
    with pytest.raises(ValueError, match="DeviceMesh"):
        retrieval.ShardedCorpusIndex(c, 2, mesh=object())
    with pytest.raises(ValueError, match="DeviceMesh"):
        retrieval.sharded_mips_topk(q, c.reshape(2, 150, 4), 3, n_total=300,
                                    mesh=object())
    # a corpus mesh of one rank (this process, a gloo world of one)
    assert maybe_initialize_distributed(
        {"REPRO_COORDINATOR": f"file://{tmp_path}/store",
         "REPRO_NUM_PROCESSES": "1", "REPRO_PROCESS_ID": "0"},
        device="cpu", timeout_s=60.0)
    try:
        mesh = make_corpus_mesh()
        with pytest.raises(ValueError, match="axis size 1"):
            retrieval.ShardedCorpusIndex(c, 2, mesh=mesh)
        with pytest.raises(ValueError, match="one shard"):
            retrieval.sharded_mips_topk(q, c.reshape(2, 150, 4), 3,
                                        n_total=300, mesh=mesh)
        one = retrieval.ShardedCorpusIndex(c, 1, mesh=mesh)
        assert all(torch.equal(a, b) for a, b in zip(
            one.search(q, 3), mips_topk(q, c, 3)))
    finally:
        torch.distributed.destroy_process_group()


def test_mips_cuda_tensor_never_reaches_the_plain_version(monkeypatch,
                                                          tmp_path):
    """A tensor the wrapper sees as a CUDA tensor goes to the kernel; with
    no nvcc to build it the wrapper raises, in both forms, and counts no
    launch."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import mips_topk as mips_mod

    def no_plain(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(ref, "mips_topk_ref", no_plain)
    monkeypatch.setattr(mips_mod, "_device_type", lambda t: "cuda")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build, "NVCC_FALLBACK", str(tmp_path / "nvcc"))
    before = dict(mips_topk.launches)
    q, c = torch.zeros(2, 8), torch.zeros(40, 8)
    for kw in ({}, {"index_offset": 20, "n_total": 60}):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            mips_topk(q, c, 3, **kw)
    assert mips_topk.launches == before


def test_mips_cpu_path_counts_no_launch():
    before = dict(mips_topk.launches)
    mips_topk(torch.zeros(2, 8), torch.ones(40, 8), 3)
    mips_topk(torch.zeros(2, 8), torch.ones(40, 8), 3, index_offset=0)
    assert mips_topk.launches == before


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_retrieval_metrics_equal_the_reference():
    rng = np.random.RandomState(7)
    idx = rng.randint(0, 30, (9, 10)).astype(np.int32)
    ql, cl = rng.randint(0, 3, 9), rng.randint(0, 3, 30)
    ql[0] = 7                                     # a query with no hit
    want = j_eval.retrieval_metrics(jnp.asarray(idx), jnp.asarray(ql),
                                    jnp.asarray(cl))
    got = eval_lib.retrieval_metrics(torch.tensor(idx), torch.tensor(ql),
                                     torch.tensor(cl))
    # means of the same per-query values (hits, reciprocal ranks): the
    # two frameworks may round the mean's last bit apart
    assert set(got) == set(want)
    for key in want:
        assert abs(float(got[key]) - float(want[key])) <= 1e-6, key
    rel = cl[idx] == ql[:, None]
    assert abs(float(eval_lib.mean_reciprocal_rank(torch.tensor(rel)))
               - float(j_eval.mean_reciprocal_rank(jnp.asarray(rel)))) <= 1e-6
    got = eval_lib.recall_at_k(torch.tensor(rel), ks=(2, 3))
    want = j_eval.recall_at_k(jnp.asarray(rel), ks=(2, 3))
    assert set(got) == set(want) == {2, 3}
    for key in want:
        assert abs(float(got[key]) - float(want[key])) <= 1e-6, key
    with pytest.raises(ValueError, match="recall@11"):
        eval_lib.recall_at_k(torch.tensor(rel), ks=(1, 11))


def test_knn_probe_equals_the_reference():
    rng = np.random.RandomState(8)
    tr, te = rng.randn(40, 6).astype(np.float32), rng.randn(15, 6).astype(
        np.float32)
    ytr, yte = rng.randint(0, 3, 40), rng.randint(0, 3, 15)
    want = j_eval.knn_probe(jnp.asarray(tr), jnp.asarray(ytr),
                            jnp.asarray(te), jnp.asarray(yte), k=5)
    got = eval_lib.knn_probe(torch.tensor(tr), torch.tensor(ytr),
                             torch.tensor(te), torch.tensor(yte), k=5)
    # the same 3 of 15 right; the two means round the fraction apart
    assert abs(float(got) - float(want)) <= 1e-6


# ---------------------------------------------------------------------------
# the index on the smoke ResNet, with the reference's parameters
# ---------------------------------------------------------------------------

PROJ = (64, 32)


@pytest.fixture(scope="module")
def resnet():
    jcfg = j_get_config("resnet14-cifar", smoke=True).replace(
        resnet_groups=2)
    tcfg = get_config("resnet14-cifar", smoke=True).replace(resnet_groups=2)
    jp = jax.jit(j_de.init_dual_encoder, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jcfg, JDE(proj_dims=PROJ))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    enc_j = jax.jit(lambda p, b: j_de.encode(jcfg, JDE(proj_dims=PROJ), p,
                                             b)[0])

    def enc_t(p, b):
        return dual_encoder.encode(tcfg, DualEncoderConfig(proj_dims=PROJ),
                                   p, b)[0]

    rng = np.random.RandomState(9)
    imgs = rng.rand(52, 16, 16, 3).astype(np.float32)
    labels = rng.randint(0, 3, 52).astype(np.int32)
    return {"jp": jp, "tp": tp, "enc_j": enc_j, "enc_t": enc_t,
            "imgs": imgs, "labels": labels}


def test_corpus_index_on_the_smoke_resnet_matches_reference(resnet):
    r = resnet
    corpus = r["imgs"][:40]
    want = j_index.CorpusIndex.build(r["enc_j"], r["jp"],
                                     {"images": jnp.asarray(corpus)},
                                     chunk=16)
    got = retrieval.CorpusIndex.build(r["enc_t"], r["tp"],
                                      {"images": torch.tensor(corpus)},
                                      chunk=16)
    assert got.num_items == 40 and got.dim == PROJ[-1]
    np.testing.assert_allclose(got.embeddings.numpy(),
                               np.asarray(want.embeddings), rtol=0,
                               atol=1e-5)
    qz = np.asarray(j_index.l2_normalize(
        r["enc_j"](r["jp"], {"images": jnp.asarray(r["imgs"][40:])})))
    _assert_topk_close(got.search(torch.tensor(qz), 5),
                       want.search(jnp.asarray(qz), 5), qz,
                       np.asarray(want.embeddings))
    # bf16 storage: the stored rows are the f32 rows rounded once
    half = retrieval.CorpusIndex.build(r["enc_t"], r["tp"],
                                       {"images": torch.tensor(corpus)},
                                       chunk=16, dtype=torch.bfloat16)
    assert half.embeddings.dtype == torch.bfloat16
    assert torch.equal(half.embeddings, got.embeddings.to(torch.bfloat16))


def test_retrieval_eval_on_the_smoke_resnet_matches_reference(resnet):
    r = resnet
    imgs, labels = r["imgs"], r["labels"]
    want = j_index.make_retrieval_eval(
        r["enc_j"], {"images": jnp.asarray(imgs[:40])},
        jnp.asarray(labels[:40]), {"images": jnp.asarray(imgs[40:])},
        jnp.asarray(labels[40:]), chunk=16)(r["jp"])
    got = retrieval.make_retrieval_eval(
        r["enc_t"], {"images": torch.tensor(imgs[:40])},
        torch.tensor(labels[:40]), {"images": torch.tensor(imgs[40:])},
        torch.tensor(labels[40:]), chunk=16)(r["tp"])
    assert set(got) == set(want)
    for key in want:
        # the same counts of 12 queries; the two means round apart
        assert abs(float(got[key]) - float(want[key])) <= 1e-6, key


# ---------------------------------------------------------------------------
# refresh and IVF, on the toy encoder
# ---------------------------------------------------------------------------

def _toy_enc_j(p, b):
    return jnp.tanh(b["x"] @ p["w1"]) @ p["w2"]


def _toy_enc_t(p, b):
    return torch.tanh(b["x"] @ p["w1"]) @ p["w2"]


def test_refresh_matches_the_reference():
    rng = np.random.RandomState(10)
    p0 = toy.params_np(0)
    x = rng.randn(70, toy.DIM_IN).astype(np.float32)
    # rows 0..31 move a lot (w1 input 0 scaled), the rest barely
    x[32:, 0] = 0.0
    p1 = {k: v.copy() for k, v in p0.items()}
    p1["w1"][0] *= 3.0
    emb = np.asarray(j_index.encode_corpus_chunked(
        _toy_enc_j, toy.to_jax(p0), {"x": jnp.asarray(x)}, chunk=16))
    want_e, want_s = j_index.refresh_embeddings(
        _toy_enc_j, toy.to_jax(p1), {"x": jnp.asarray(x)},
        jnp.asarray(emb), threshold=0.05, block=16, probes_per_block=4)
    got_e, got_s = retrieval.refresh_embeddings(
        _toy_enc_t, toy.to_torch(p1), {"x": torch.tensor(x)},
        torch.tensor(emb), threshold=0.05, block=16, probes_per_block=4)
    assert float(got_s["blocks_refreshed"]) == \
        float(want_s["blocks_refreshed"]) == 2.0
    for key in ("refresh_fraction", "items_encoded"):
        assert float(got_s[key]) == float(want_s[key]), key
    for key in ("max_drift", "mean_drift"):
        assert abs(float(got_s[key]) - float(want_s[key])) <= 1e-5, key
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), rtol=0,
                               atol=1e-5)
    # the index's own refresh, and the stateful eval's state
    index = retrieval.CorpusIndex(torch.tensor(emb))
    stats = index.refresh(_toy_enc_t, toy.to_torch(p1),
                          {"x": torch.tensor(x)}, threshold=0.05, block=16)
    assert stats["blocks_refreshed"] == 2.0
    assert torch.equal(index.embeddings, got_e)


def test_ivf_matches_the_reference_with_its_initial_draw():
    rng = np.random.RandomState(11)
    emb = _unit(rng, 150, 12)
    q = _unit(rng, 9, 12)
    c = 6
    init = np.array(jax.random.permutation(jax.random.PRNGKey(0), 150)[:c])
    want_c = j_ivf.train_centroids(jnp.asarray(emb), num_centroids=c,
                                   iters=8, seed=0)
    got_c = retrieval.train_centroids(torch.tensor(emb), num_centroids=c,
                                      iters=8, init_idx=init)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=1e-5)
    want = j_ivf.IVFIndex(jnp.asarray(emb), want_c, nprobe=2)
    got = retrieval.IVFIndex(torch.tensor(emb), got_c, nprobe=2)
    np.testing.assert_array_equal(got.lists_idx.numpy(),
                                  np.asarray(want.lists_idx))
    assert got.list_len == want.list_len and got.fill == want.fill
    # every list probed recovers the exact tier
    exact = got.search_exact(torch.tensor(q), 5)
    full = got.search(torch.tensor(q), 5, nprobe=c, probe_chunk=4)
    assert torch.equal(full[1], exact[1])
    # the pruned search, with a ragged last probe group
    for nprobe, chunk in ((2, 8), (3, 2)):
        w = want.search(jnp.asarray(q), 5, nprobe=nprobe, probe_chunk=chunk)
        g = got.search(torch.tensor(q), 5, nprobe=nprobe, probe_chunk=chunk)
        np.testing.assert_array_equal(g[1].numpy(), np.asarray(w[1]))
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w[0]), rtol=0,
                                   atol=ATOL)
    # nprobe <= 0 falls back to the exact tier
    assert torch.equal(got.search(torch.tensor(q), 5, nprobe=0)[1],
                       exact[1])


def test_query_server_pads_and_reports():
    rng = np.random.RandomState(12)
    index = retrieval.CorpusIndex(torch.tensor(_unit(rng, 60, 16)))
    server = retrieval.QueryServer(index, k=4, batch=8).warmup()
    assert server.stats() is None
    q = torch.tensor(_unit(rng, 8, 16))
    v, i = server.query(q[:5])
    want = index.search(q, 4)
    assert v.shape == (5, 4)
    assert torch.equal(i, index.search(q[:5], 4)[1])
    assert torch.equal(i, want[1][:5])
    server.query(q)
    st = server.stats()
    assert set(st) == {"batches", "queries", "qps", "qps_serial", "p50_us",
                       "p99_us"}
    assert st["batches"] == 2 and st["queries"] == 13
    assert st["qps"] > 0 and st["p99_us"] >= st["p50_us"] > 0
    with pytest.raises(ValueError, match="exceeds"):
        server.query(torch.zeros(9, 16))
    with pytest.raises(ValueError, match="index embedding dim"):
        server.query(torch.zeros(3, 15))
    server.reset_stats()
    assert server.stats() is None


# ---------------------------------------------------------------------------
# the engine's periodic eval
# ---------------------------------------------------------------------------

def _engine(retrieval_eval=None, every=2, chunk_rounds=3):
    pool = toy.to_torch(toy.pool_np())

    def sampler(gen):
        sel = torch.randperm(toy.N_CLIENTS, generator=gen)[:6]
        return ({k: v[sel] for k, v in pool.items()},
                torch.full((6,), toy.N_PER, dtype=torch.int32))

    opt = opt_lib.sgd(0.1)
    cfg = round_engine.EngineConfig(
        lam=toy.LAM, chunk_rounds=chunk_rounds,
        retrieval_eval=retrieval_eval, retrieval_every=every)
    p0 = toy.to_torch(toy.params_np())
    return round_engine.RoundEngine(toy.t_apply, opt, sampler, cfg), p0, opt


def _reval(stateful=False):
    rng = np.random.RandomState(13)
    x = torch.tensor(rng.randn(40, toy.DIM_IN).astype(np.float32))
    labels = torch.arange(40) % 4

    def embed(p, b):
        return _toy_enc_t(p, b)

    args = (embed, {"x": x[:32]}, labels[:32], {"x": x[32:]}, labels[32:])
    if stateful:
        return retrieval.make_refreshing_retrieval_eval(
            *args, threshold=0.0, block=8, chunk=16)
    return retrieval.make_retrieval_eval(*args, chunk=16)


def test_engine_records_retrieval_on_its_cadence():
    eng, p0, opt = _engine(_reval())
    _, _, m = eng.run(p0, opt.init(p0), 0, 4)
    assert set(m.retrieval) == {"recall_at_1", "recall_at_5",
                                "recall_at_10", "mrr"}
    for v in m.retrieval.values():
        assert v.shape == (4,) and v.dtype == torch.float32
        assert not torch.isnan(v[[0, 2]]).any()
        assert torch.isnan(v[[1, 3]]).all()
        assert ((v[[0, 2]] >= 0) & (v[[0, 2]] <= 1)).all()
    # a resumed run keeps the absolute cadence: rounds 3 and 4
    _, _, m = eng.run(p0, opt.init(p0), 0, 2, start_round=3)
    assert torch.isnan(m.retrieval["mrr"][0])
    assert not torch.isnan(m.retrieval["mrr"][1])


def test_engine_eval_only_observes():
    eng0, p0, opt = _engine()
    pa, _, ma = eng0.run(p0, opt.init(p0), 0, 4)
    eng1, p0, opt = _engine(_reval(), every=1)
    pb, _, mb = eng1.run(p0, opt.init(p0), 0, 4)
    assert ma.retrieval == {}
    assert torch.equal(ma.loss, mb.loss)
    assert utils.tree_max_abs_diff(pa, pb) == 0.0


def test_engine_threads_a_stateful_eval():
    seen = []
    eng, p0, opt = _engine(_reval(stateful=True), every=1, chunk_rounds=2)
    _, _, m = eng.run(p0, opt.init(p0), 0, 4,
                      on_segment=lambda r, carry, seg: seen.append(
                          carry.reval.clone()))
    assert "refresh_fraction" in m.retrieval and "items_encoded" in \
        m.retrieval
    # threshold 0: every block re-encodes, so the state is the encoding of
    # the segment's last params
    assert len(seen) == 2 and seen[0].shape == (32, toy.DIM_OUT)
    assert not torch.equal(seen[0], seen[1])
    assert (m.retrieval["refresh_fraction"] == 1.0).all()


@pytest.mark.parametrize("kw,match", [
    (dict(retrieval_eval=lambda p: {}, every=0), "retrieval_every"),
    (dict(retrieval_eval=1), "callable"),
])
def test_engine_validates_the_eval(kw, match):
    with pytest.raises(ValueError, match=match):
        _engine(**kw)


def test_engine_refuses_a_stateful_eval_without_init_state():
    def fn(p, s):
        return {}, s
    fn.stateful = True
    with pytest.raises(ValueError, match="init_state"):
        _engine(fn)


def test_reference_engine_takes_the_same_config_fields():
    """The port's EngineConfig names the reference's retrieval fields."""
    for name in ("retrieval_eval", "retrieval_every"):
        assert name in j_engine.EngineConfig._fields
        assert name in round_engine.EngineConfig._fields
    assert "reval" in round_engine.EngineCarry._fields
    assert "retrieval" in round_engine.EngineMetrics._fields


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_train_cli_prints_the_recall_line(capsys):
    res = train.main(["--device", "cpu", "--retrieval-eval",
                      "--retrieval-every", "1", "--retrieval-corpus", "40",
                      "--retrieval-queries", "16", *SMALL])
    out = capsys.readouterr().out
    assert "recall@1=" in out and "recall@10=" in out and "mrr=" in out
    assert set(res["retrieval"]) == {"recall_at_1", "recall_at_5",
                                     "recall_at_10", "mrr"}
    assert all(len(v) == 2 and all(0.0 <= x <= 1.0 for x in v)
               for v in res["retrieval"].values())


@pytest.mark.parametrize("flags", [
    ["--retrieval-eval", "--retrieval-every", "0"],
    ["--retrieval-eval", "--retrieval-corpus", "9"],
    ["--retrieval-eval", "--retrieval-corpus", "60",
     "--retrieval-queries", "5"],
    ["--retrieval-every", "2"],
    ["--retrieval-corpus", "30"],
    ["--retrieval-dtype", "bfloat16"],
])
def test_train_refuses_bad_retrieval_flags(flags):
    with pytest.raises(SystemExit):
        train.main(["--device", "cpu", *flags, *SMALL])


def test_profile_round_runs_the_retrieval_path_on_cpu():
    from repro_torch.launch import profile_round
    res = profile_round.main(["--device", "cpu", "--path", "retrieval",
                              "--clients-per-round", "2", "--dataset-size",
                              "32", "--warmup", "1", "--rounds", "1"])
    assert res["wall_ms"] > 0 and res["busy_ms"] is None
    assert profile_round._layer("mips_partial_kernel").startswith("MIPS")
