"""Serving on the port against the reference, on the CPU: the int8 KV
quantizer, the tied unembedding, ``prefill`` and ``decode_step`` of the
smoke ``tinyllama-1.1b`` and ``qwen3-1.7b`` towers with the model-dtype
and the int8 cache (a sliding-window ring too), the prefill and serve
steps, greedy generation, and the ``serve`` CLI: generative, sampling,
``--retrieval`` exact, ``--shards 2`` and ``--ivf``, and ``--ckpt``.

Both packages get the same numpy inputs and the reference's parameters
carried over by ``convert`` (the smoke towers are f32). Tolerances:
- the int8 quantizer: values and scales equal bit for bit (the same f32
  division, round half to even); its round trip within 1/100 of max |x|;
- logits (prefill's last position and every decode step) within 1e-5 of
  the reference's: two layers of f32 products and softmaxes summed in
  other orders (measured 1e-6 to 1.6e-6 at |logits| ~1.3);
- cache leaves: int8 values, ``kv_pos`` and ``pos`` equal; the int8
  scales to 1e-7 and model-dtype K/V to 1e-5 (measured 3e-8 and 4e-6);
- the int8 cache against the exact logits of a full forward: within
  0.05 of max(|logits|, 1), the reference's own bound
  (tests/test_perf_features.py).
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as j_save
from repro.configs.base import get_config as j_get_config
from repro.launch import steps as j_steps
from repro.models import attention as j_attn
from repro.models import common as j_common
from repro.models import transformer as j_tf
from repro_torch import convert, retrieval, utils
from repro_torch.configs.base import get_config
from repro_torch.launch import serve, steps, train
from repro_torch.models import attention, common, transformer

torch.set_num_threads(1)

ARCHS = ("tinyllama-1.1b", "qwen3-1.7b")
LOGIT_TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _towers(arch, **kw):
    jc = j_get_config(arch, smoke=True).replace(**kw)
    tc = get_config(arch, smoke=True).replace(**kw)
    jp = j_tf.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, convert.params_from_jax(_np(jp))


def _tokens(shape, vocab, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


def _assert_cache_close(jcache, tcache):
    assert int(jcache["pos"]) == int(tcache["pos"])
    for name, j in jcache["layers"]["b0"].items():
        t = tcache["layers"]["b0"][name]
        j = np.asarray(j)
        assert t.dtype == getattr(torch, j.dtype.name), name
        if name in ("kv_pos", "k", "v") and j.dtype != np.float32:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
        else:
            tol = 1e-7 if name.endswith("_scale") else 1e-5
            np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=tol,
                                       err_msg=name)


def test_quantize_kv_matches_reference_bit_for_bit():
    x = (np.random.RandomState(1).randn(2, 8, 4, 16) * 3.0).astype(
        np.float32)
    x[0, 0, 0] = 0.0                        # an all-zero row: the 1e-8 floor
    jq, js = j_attn._quantize_kv(jnp.asarray(x))
    q, s = attention._quantize_kv(torch.as_tensor(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    x2 = attention._dequantize_kv(q, s, torch.float32)
    assert float((x2 - torch.as_tensor(x)).abs().max()) < np.abs(x).max() / 100


def test_unembed_matches_reference():
    rng = np.random.RandomState(2)
    table = rng.randn(50, 16).astype(np.float32)
    x = rng.randn(3, 16).astype(np.float32)
    want = j_common.unembed({"table": jnp.asarray(table)}, jnp.asarray(x))
    got = common.unembed({"table": torch.as_tensor(table)},
                         torch.as_tensor(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    bf = torch.as_tensor(table).to(torch.bfloat16)
    assert common.unembed({"table": bf}, bf[:2]).dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv", ["model", "int8"])
def test_prefill_and_decode_match_reference(arch, kv):
    jc, tc, jp, tp = _towers(arch, kv_cache_dtype=kv)
    toks = _tokens((2, 12), jc.vocab_size)
    jcache = j_tf.init_cache(jc, 2, 20)
    tcache = transformer.init_cache(tc, 2, 20)
    jl, jcache = j_tf.prefill(jc, jp, jnp.asarray(toks), jcache)
    tl, tcache = transformer.prefill(tc, tp, torch.as_tensor(toks), tcache)
    assert tl.shape == (2, jc.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    _assert_cache_close(jcache, tcache)
    tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    for _ in range(4):
        jl, jcache = j_tf.decode_step(jc, jp, jcache, jnp.asarray(tok))
        tl, tcache = transformer.decode_step(tc, tp, tcache,
                                             torch.as_tensor(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0)
        tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    _assert_cache_close(jcache, tcache)


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_sliding_window_ring_matches_reference(kv):
    """A prompt longer than the window (12 > 8) takes prefill's ring
    branch; decode then wraps the ring, as in the reference's
    ``test_int8_sliding_window_ring``."""
    jc, tc, jp, tp = _towers("tinyllama-1.1b", kv_cache_dtype=kv,
                             sliding_window=8, attn_impl="naive")
    toks = _tokens((1, 20), jc.vocab_size, seed=3)
    jcache = j_tf.init_cache(jc, 1, max_len=8)
    tcache = transformer.init_cache(tc, 1, max_len=8)
    assert tcache["layers"]["b0"]["k"].shape[2] == 8
    jl, jcache = j_tf.prefill(jc, jp, jnp.asarray(toks[:, :12]), jcache)
    tl, tcache = transformer.prefill(tc, tp, torch.as_tensor(toks[:, :12]),
                                     tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    _assert_cache_close(jcache, tcache)
    for t in range(12, 20):
        jl, jcache = j_tf.decode_step(jc, jp, jcache,
                                      jnp.asarray(toks[:, t:t + 1]))
        tl, tcache = transformer.decode_step(
            tc, tp, tcache, torch.as_tensor(toks[:, t:t + 1]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0)
    assert bool(torch.isfinite(tl).all())
    _assert_cache_close(jcache, tcache)
    # the ring holds positions 12..19 at slot position % 8
    assert sorted(tcache["layers"]["b0"]["kv_pos"][0, 0].tolist()) == list(
        range(12, 20))


def test_prefill_on_the_flash_route_matches_reference():
    """The default blockwise route: prefill's attention through the flash
    kernel's wrapper (its plain version here), decode on naive."""
    jc, tc, jp, tp = _towers("tinyllama-1.1b")
    assert tc.attn_impl == "blockwise"
    toks = _tokens((2, 10), jc.vocab_size, seed=4)
    jl, _ = j_tf.prefill(jc, jp, jnp.asarray(toks), j_tf.init_cache(jc, 2, 16))
    tl, _ = transformer.prefill(tc, tp, torch.as_tensor(toks),
                                transformer.init_cache(tc, 2, 16))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_decode_accuracy_against_full_forward(arch):
    _, tc, _, tp = _towers(arch)
    toks = torch.as_tensor(_tokens((2, 16), tc.vocab_size, seed=5))
    h = transformer.forward(tc, tp, toks)
    want = transformer.logits_from_hidden(tc, tp, h[:, -1])
    c = tc.replace(kv_cache_dtype="int8")
    cache = transformer.init_cache(c, 2, 20)
    _, cache = transformer.prefill(c, tp, toks[:, :15], cache)
    got, _ = transformer.decode_step(c, tp, cache, toks[:, 15:16])
    scale = float(want.abs().max())
    assert float((want - got).abs().max()) < 0.05 * max(scale, 1.0)


def test_int8_cache_is_under_065_of_the_model_cache():
    cfg = get_config("tinyllama-1.1b", smoke=True)

    def nbytes(c):
        return sum(x.numel() * x.element_size() for x in utils.tree_leaves(c))

    full = transformer.init_cache(cfg, 2, 64)
    int8 = transformer.init_cache(cfg.replace(kv_cache_dtype="int8"), 2, 64)
    assert nbytes(int8) < 0.65 * nbytes(full)
    assert int8["layers"]["b0"]["k"].shape == (2, 2, 64, 2, 32)


def test_prefill_and_serve_steps_generate_the_reference_tokens():
    jc, tc, jp, tp = _towers("qwen3-1.7b")
    prompt = _tokens((2, 8), jc.vocab_size, seed=6)
    jl, jcache = j_steps.make_prefill_step(jc, 8 + 6 + 1)(
        jp, {"tokens": jnp.asarray(prompt)})
    serve_j = j_steps.make_serve_step(jc)
    want = [np.argmax(np.asarray(jl), -1)]
    for _ in range(5):
        jl, jcache = serve_j(jp, jcache,
                             {"tokens": jnp.asarray(want[-1][:, None],
                                                    jnp.int32)})
        want.append(np.argmax(np.asarray(jl), -1))
    out = serve.generate(tc, tp, torch.as_tensor(prompt), 6)
    assert out["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(out["tokens"].numpy(), np.stack(want, 1))
    np.testing.assert_allclose(out["logits"][-1].numpy(), np.asarray(jl),
                               atol=LOGIT_TOL, rtol=0)
    assert int(out["cache"]["pos"]) == 8 + 5
    # the step functions alone
    logits, cache = steps.make_prefill_step(tc, 8 + 6 + 1)(
        tp, {"tokens": torch.as_tensor(prompt)})
    logits2, cache = steps.make_serve_step(tc)(
        tp, cache, {"tokens": out["tokens"][:, :1]})
    np.testing.assert_array_equal(logits.numpy(),
                                  out["logits"][0].numpy())
    np.testing.assert_array_equal(logits2.numpy(),
                                  out["logits"][1].numpy())


def test_serve_cli_generates_greedy_and_sampled_tokens():
    base = ["--device", "cpu", "--batch", "2", "--prompt-len", "8",
            "--gen", "5"]
    out = serve.main(base)
    assert out["tokens"].shape == (2, 5)
    cfg = get_config("tinyllama-1.1b", smoke=True)
    # greedy: each token is the argmax of the logits it was picked from
    for i, lg in enumerate(out["logits"]):
        assert torch.equal(out["tokens"][:, i], lg.argmax(-1).int())
    again = serve.main(base)
    assert torch.equal(out["tokens"], again["tokens"])
    hot = serve.main(base + ["--temperature", "1.0"])
    assert hot["tokens"].shape == (2, 5)
    assert int(hot["tokens"].min()) >= 0
    assert int(hot["tokens"].max()) < cfg.vocab_size


def test_serve_cli_refuses_without_a_gpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--gen", "2"])
    with pytest.raises(SystemExit, match="separate serving tiers"):
        serve.main(["--device", "cpu", "--retrieval", "--shards", "2",
                    "--ivf", "4"])


RETRIEVAL = ["--device", "cpu", "--retrieval", "--corpus-sizes", "48,96",
             "--serve-batches", "3", "--batch", "8", "--prompt-len", "8"]


def test_serve_cli_retrieval_tiers():
    exact = serve.main(RETRIEVAL)
    sharded = serve.main(RETRIEVAL + ["--shards", "2"])
    ivf = serve.main(RETRIEVAL + ["--ivf", "8", "--nprobe", "8"])
    for res in (exact, sharded, ivf):
        assert [r["n"] for r in res] == [48, 96]
        assert all(r["batches"] == 3 and r["queries"] == 24 for r in res)
        assert all(r["p50_us"] > 0 and r["qps"] > 0 for r in res)
    for e, s, v in zip(exact, sharded, ivf):
        assert isinstance(s["index"], retrieval.ShardedCorpusIndex)
        assert isinstance(v["index"], retrieval.IVFIndex)
        q = e["query_embeddings"]
        want = e["index"].search(q, 10)
        got = s["index"].search(q, 10)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        # every list probed: the exact tier's neighbours
        full = v["index"].search(q, 10, nprobe=v["index"].num_centroids)
        assert torch.equal(full[1], want[1])


def _train_smoke_tokens(tmp_path):
    """The port's smoke train of the token tower, checkpointing once."""
    res = train.main(["--device", "cpu", "--arch", "tinyllama-1.1b",
                      "--seq-len", "8", "--rounds", "2", "--eval-every", "2",
                      "--ckpt-every", "2", "--ckpt-dir", str(tmp_path),
                      "--dataset-size", "40", "--clients-per-round", "4"])
    return res, str(tmp_path / "tinyllama-1.1b.msgpack")


def test_serve_retrieval_restores_a_checkpoint_train_wrote(tmp_path):
    res, path = _train_smoke_tokens(tmp_path)
    args = serve.build_parser().parse_args(RETRIEVAL + ["--ckpt", path])
    args.corpus_sizes = "48"
    restored = serve.run_retrieval(args)[0]
    fresh = serve.run_retrieval(
        argparse.Namespace(**{**vars(args), "ckpt": None}))[0]
    # the index the trained encoder built differs from a fresh init's,
    # and equals the trained parameters' own encoding
    assert not torch.equal(restored["index"].embeddings,
                           fresh["index"].embeddings)
    from repro_torch.configs.base import DualEncoderConfig
    from repro_torch.data import synthetic
    from repro_torch.models import dual_encoder
    cfg = get_config("tinyllama-1.1b", smoke=True)
    toks, _ = synthetic.synthetic_labeled_tokens(48, 4, 8, cfg.vocab_size)

    def embed(p, b):
        return dual_encoder.encode(cfg, DualEncoderConfig(proj_dims=(64, 64)),
                                   p, b)[0]

    want = retrieval.encode_corpus_chunked(
        embed, res["params"], {"tokens": torch.as_tensor(toks)}, chunk=48)
    assert torch.equal(restored["index"].embeddings, want)


def test_generative_ckpt_of_a_train_file_raises_as_in_the_reference(
        tmp_path):
    """A reference fault the port mirrors (ROADMAP §3): train writes the
    dual encoder under ``params/tower/...``, the generative serve path
    looks for the bare tower under ``params/...`` and raises KeyError."""
    _, path = _train_smoke_tokens(tmp_path)
    with pytest.raises(KeyError, match="params/embed/table"):
        serve.main(["--device", "cpu", "--gen", "2", "--ckpt", path])
    jc = j_get_config("tinyllama-1.1b", smoke=True)
    from repro.checkpoint import restore_checkpoint as j_restore
    with pytest.raises(KeyError):
        j_restore(path, {"params": j_tf.init_params(jc,
                                                    jax.random.PRNGKey(0))})


def test_ckpt_with_a_deeper_head_misloads_as_in_the_reference(tmp_path):
    """The other half of that fault: at full width train's head has three
    layers (the arch's projection), serve's template two; the restore
    takes the template's paths and the file's shapes, so both packages
    load the first two layers of the deeper head without an error."""
    from repro.checkpoint import restore_checkpoint as j_restore
    from repro.configs.base import DualEncoderConfig as JDE
    from repro.models import dual_encoder as j_de
    from repro_torch.configs.base import DualEncoderConfig
    from repro_torch.models import dual_encoder
    jc = j_get_config("tinyllama-1.1b", smoke=True)
    deep = j_de.init_dual_encoder(jax.random.PRNGKey(1), jc,
                                  JDE(proj_dims=(96, 80, 72)))
    path = str(tmp_path / "deep.msgpack")
    j_save(path, {"params": deep}, step=3)
    jt = j_de.init_dual_encoder(jax.random.PRNGKey(0), jc,
                                JDE(proj_dims=(64, 64)))
    jgot, _ = j_restore(path, {"params": jt})
    tc = get_config("tinyllama-1.1b", smoke=True)
    tt = dual_encoder.init_dual_encoder(0, tc, DualEncoderConfig(
        proj_dims=(64, 64)))
    from repro_torch.checkpoint import restore_checkpoint
    tgot, step = restore_checkpoint(path, {"params": tt}, "cpu")
    assert step == 3
    layers = tgot["params"]["proj"]["layers"]
    assert [tuple(lp["w"].shape) for lp in layers] == [(256, 96), (96, 80)]
    assert [np.asarray(lp["w"]).shape for lp in
            jgot["params"]["proj"]["layers"]] == [(256, 96), (96, 80)]
    np.testing.assert_array_equal(layers[1]["w"].numpy(),
                                  np.asarray(deep["proj"]["layers"][1]["w"]))
