"""Port vs reference: the quantized wire and the communication channels, on
the CPU, with the reference's random draws fed to the port.

JAX and torch draws never match, so each test draws the reference's
uniforms or normals from its key and hands them to the port. The fused
payload concatenates leaves in ``jax.tree.flatten`` order (sorted dict
keys) and the port in insertion order, and the port's convolution leaves
are OIHW where the reference's are HWIO: so the draws are split per leaf
in the reference's order and carried across client by client with
``convert.params_from_jax``. Each element takes its own leaf's scale and
its own uniform, so the result is independent of the concatenation order.

Tolerances: the quantize -> dequantize formula is bit-equal given the
same inputs (IEEE division, add, floor, clip, multiply). Weighted sums
over K clients are f32 dot products in the frameworks' own orders: rtol
1e-6 / atol 1e-7. Joint L2 clipping divides by a sum of squares taken in
another order: rtol 1e-6."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import channel as j_channel
from repro_torch import comm, convert, utils
from repro_torch.comm import channel
from repro_torch.core import cco
from repro_torch.kernels import _build, ref
from repro_torch.kernels import quantize as quantize_kernel

# both packages' comm/__init__ re-export a function named ``quantize``,
# which shadows the submodule as an attribute of the package
j_quantize = importlib.import_module("repro.comm.quantize")
quantize = importlib.import_module("repro_torch.comm.quantize")

# the suite runs under several pytest workers: one torch thread per
# worker keeps them from contending with each other and with JAX
torch.set_num_threads(1)

K = 5


def _stats_payload(seed, d=6, k=K):
    """A per-client stats payload in the port's key order (not sorted)."""
    rng = np.random.RandomState(seed)
    st = {"mean_f": rng.randn(k, d), "sq_f": rng.rand(k, d) * 3,
          "mean_g": rng.randn(k, d) * 0.1, "sq_g": rng.rand(k, d),
          "cross": rng.randn(k, d, d) * 0.5}
    st["mean_g"][1] = 0.0                        # an all-zero client row
    return {key: v.astype(np.float32) for key, v in st.items()}


def _param_payload(seed, k=K):
    """A K-stacked parameter-delta payload in the reference's layout
    (HWIO convolutions), shaped like the dual encoder's tree."""
    rng = np.random.RandomState(seed)
    tree = {"tower": {"stem": {"w": rng.randn(k, 3, 3, 3, 4)},
                      "gn": {"scale": rng.randn(k, 4), "bias": rng.randn(k, 4)}},
            "proj": {"layers": [{"w": rng.randn(k, 4, 6), "b": rng.randn(k, 6)},
                                {"w": rng.randn(k, 6, 3) * 1e-3,
                                 "b": np.zeros((k, 3))}]}}
    return jax.tree.map(lambda x: (x * 0.01).astype(np.float32), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return utils.tree_map(lambda x: torch.tensor(np.asarray(x)), tree)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _carry_params(tree_k):
    """A K-stacked reference parameter tree -> the port's layout."""
    k = jax.tree.leaves(tree_k)[0].shape[0]
    per = [convert.params_from_jax(jax.tree.map(lambda x: np.asarray(x)[i],
                                                tree_k)) for i in range(k)]
    return utils.tree_map(lambda *xs: torch.stack(xs), *per)


def _ref_draws(key, tree_k, sample):
    """The reference's one (K, n_total) draw, split per leaf in
    ``jax.tree.flatten`` order and shaped like the payload's leaves."""
    leaves, treedef = jax.tree.flatten(tree_k)
    k = leaves[0].shape[0]
    sizes = [int(np.prod(x.shape[1:])) for x in leaves]
    flat = np.asarray(sample(key, (k, sum(sizes))))
    parts = np.split(flat, np.cumsum(sizes)[:-1], axis=1)
    return jax.tree.unflatten(treedef, [p.reshape(x.shape)
                                        for p, x in zip(parts, leaves)])


def _uniform(key, shape):
    return jax.random.uniform(key, shape, jnp.float32)


def _pairs(port, ref):
    """(port leaf, reference leaf) pairs, matched by key, not by order."""
    out = []
    utils.tree_map(lambda a, b: out.append((a, np.asarray(b))), port, ref)
    return out


def _assert_tree_equal(port, ref):
    for a, b in _pairs(port, ref):
        np.testing.assert_array_equal(a.numpy(), b)


# ---------------------------------------------------------------- quantize

@pytest.mark.parametrize("bits", [2, 4, 8, 16])
@pytest.mark.parametrize("shape", [(K, 37), (3, 4, 5, 6)])
def test_quant_dequant_clients_bit_equal(bits, shape):
    key = jax.random.PRNGKey(bits)
    xk = (np.random.RandomState(1).randn(*shape) * 3).astype(np.float32)
    u = np.array(_uniform(key, (shape[0], int(np.prod(shape[1:])))))
    expected = np.asarray(j_quantize.quant_dequant_clients(
        key, jnp.asarray(xk), bits))
    np.testing.assert_array_equal(np.asarray(j_quantize.quant_dequant_clients(
        key, jnp.asarray(xk), bits, impl="interpret")), expected)
    out = quantize.quant_dequant_clients(None, torch.from_numpy(xk), bits,
                                         u=torch.from_numpy(u))
    np.testing.assert_array_equal(out.numpy(), expected)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("payload", ["stats", "params"])
def test_quant_dequant_payload_bit_equal_with_carried_draws(bits, payload):
    key = jax.random.PRNGKey(7 + bits)
    tree = _stats_payload(3) if payload == "stats" else _param_payload(3)
    expected = _np(j_quantize.quant_dequant_payload(key, _j(tree), bits))
    _assert_tree_equal(_t(expected), _np(j_quantize.quant_dequant_payload(
        key, _j(tree), bits, impl="interpret")))
    draws = _ref_draws(key, tree, _uniform)
    carry = _t if payload == "stats" else _carry_params
    out = quantize.quant_dequant_payload(None, carry(tree), bits,
                                         uniforms=carry(draws))
    _assert_tree_equal(out, carry(expected))


def test_quant_dequant_payload_error_bound_and_bias():
    tree = _t(_stats_payload(5))
    gen = torch.Generator().manual_seed(0)
    qmax = quantize.qmax_for_bits(4)
    outs = [quantize.quant_dequant_payload(gen, tree, 4) for _ in range(400)]
    for key, x in tree.items():
        step = x.reshape(K, -1).abs().amax(1) / qmax
        step = torch.where(step > 0, step, 1.0 / qmax)
        for out in outs[:20]:
            err = (out[key] - x).reshape(K, -1).abs()
            assert bool((err <= step[:, None]).all()), key
        mean = torch.stack([o[key] for o in outs]).mean(0)
        # unbiased: the mean of 400 draws is within 4 standard errors
        assert bool(((mean - x).reshape(K, -1).abs()
                     <= 4 * step[:, None] / 40 + 1e-7).all()), key
    zero = {"z": torch.zeros(2, 3)}
    assert not quantize.quant_dequant_payload(gen, zero, 8)["z"].any()
    assert quantize.quant_dequant_payload(gen, {}, 8) == {}
    with pytest.raises(ValueError):
        quantize.qmax_for_bits(1)
    with pytest.raises(ValueError, match="uniforms of shape"):
        quantize.quant_dequant_payload(
            gen, tree, 8, uniforms={**tree, "cross": tree["cross"][:, :1]})


def test_quantized_channel_never_hands_a_cuda_tensor_to_the_plain_version(
        monkeypatch, tmp_path):
    """The wire transform has one route, the kernel's wrapper: a payload
    the wrapper sees as a CUDA tensor goes to the kernel, and when the
    library cannot be built (no nvcc here) the channel raises."""
    def no_plain(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(ref, "quant_dequant_ref", no_plain)
    monkeypatch.setattr(quantize_kernel, "_device_type", lambda t: "cuda")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build, "NVCC_FALLBACK", str(tmp_path / "nvcc"))
    t_ch = channel.QuantizedChannel(8)
    ctx = t_ch.begin_round(0, torch.tensor(SIZES))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        t_ch.encode_decode(ctx, _t(_stats_payload(4)), "stats")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        quantize.quant_dequant_clients(torch.Generator(),
                                       torch.ones(K, 3), 8)


def test_quantize_dequantize_single_tensor_matches_reference():
    key = jax.random.PRNGKey(3)
    x = (np.random.RandomState(2).randn(4, 9) * 2).astype(np.float32)
    u = np.array(_uniform(key, x.shape))
    for bits in (4, 8, 12):
        jq, js = j_quantize.quantize(key, jnp.asarray(x), bits)
        tq, ts = quantize.quantize(None, torch.from_numpy(x), bits,
                                   u=torch.from_numpy(u))
        assert str(tq.dtype).split(".")[-1] == str(jq.dtype)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert float(ts) == float(js)
        np.testing.assert_array_equal(
            quantize.dequantize(tq, ts).numpy(),
            np.asarray(j_quantize.dequantize(jq, js)))
    for n, bits in ((10, 8), (1000, 4), (3, 2)):
        assert quantize.payload_bytes(n, bits) == \
            j_quantize.payload_bytes(n, bits)


# ---------------------------------------------------------------- channels

def _round_ctx(j_ch, t_ch, seed, sizes, t_draws=None):
    key = jax.random.PRNGKey(seed)
    j_ctx = j_ch.begin_round(key, jnp.asarray(sizes))
    t_ctx = t_ch.begin_round(seed, torch.tensor(sizes), t_draws)
    return key, j_ctx, t_ctx


SIZES = np.array([2, 3, 1, 2, 3], np.int32)


def test_dense_and_dropout0_bit_identical_to_no_channel():
    st = _t(_stats_payload(1))
    sizes = torch.tensor(SIZES)
    plain = cco.weighted_average_stats(st, sizes)
    for ch in (channel.DenseChannel(), channel.DropoutChannel(0.0)):
        ctx = ch.begin_round(4, sizes)
        agg = ch.aggregate(ctx, st, "stats")
        for key in plain:
            assert torch.equal(agg[key], plain[key]), (ch, key)
    j_ch = j_channel.DenseChannel()
    j_ctx = j_ch.begin_round(jax.random.PRNGKey(0), jnp.asarray(SIZES))
    ref = j_ch.aggregate(j_ctx, _j(_stats_payload(1)), "stats")
    for key in plain:
        np.testing.assert_allclose(plain[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("phase", ["stats", "update"])
def test_quantized_aggregate_matches_reference(bits, phase):
    j_ch = j_channel.QuantizedChannel(bits)
    t_ch = channel.QuantizedChannel(bits)
    key, j_ctx, t_ctx = _round_ctx(j_ch, t_ch, 11, SIZES)
    tree = _stats_payload(2) if phase == "stats" else _param_payload(2)
    carry = _t if phase == "stats" else _carry_params
    draws = carry(_ref_draws(
        jax.random.fold_in(key, j_channel.PHASE_SALT[phase]), tree, _uniform))
    # the wire transform is bit-equal; the weighted sum is a dot product
    _assert_tree_equal(
        t_ch.encode_decode(t_ctx, carry(tree), phase, draws),
        carry(_np(j_ch.encode_decode(j_ctx, _j(tree), phase))))
    ref = carry(jax.tree.map(lambda x: np.asarray(x)[None],
                             j_ch.aggregate(j_ctx, _j(tree), phase)))
    out = t_ch.aggregate(t_ctx, carry(tree), phase, draws)
    for a, b in _pairs(out, ref):
        np.testing.assert_allclose(a.numpy(), b[0], rtol=1e-6, atol=1e-7)
    assert t_ch.payload_bytes(carry(tree)) == j_ch.payload_bytes(_j(tree))
    assert float(t_ch.round_bytes(t_ctx, carry(tree))) == float(
        j_ch.round_bytes(j_ctx, _j(tree)))


def test_dropout_mask_and_renormalised_weights_match_reference():
    j_ch, t_ch = j_channel.DropoutChannel(0.4), channel.DropoutChannel(0.4)
    key = jax.random.PRNGKey(5)
    k_mask, _ = jax.random.split(key)
    u = torch.tensor(np.asarray(_uniform(k_mask, (K,))))
    j_ctx = j_ch.begin_round(key, jnp.asarray(SIZES))
    t_ctx = t_ch.begin_round(5, torch.tensor(SIZES), u)
    np.testing.assert_array_equal(t_ctx.mask.numpy(), np.asarray(j_ctx.mask))
    np.testing.assert_array_equal(t_ctx.weights.numpy(),
                                  np.asarray(j_ctx.weights))
    assert float(t_ctx.num_participants) == float(j_ctx.num_participants)
    # weights renormalise over the survivors; the aggregate is theirs
    keep = t_ctx.mask.bool()
    assert 0 < int(keep.sum()) < K
    torch.testing.assert_close(t_ctx.weights.sum(), torch.tensor(1.0))
    assert not t_ctx.weights[~keep].any()
    st = _t(_stats_payload(6))
    agg = t_ch.aggregate(t_ctx, st, "stats")
    survivors = cco.weighted_average_stats(
        {k: v[keep] for k, v in st.items()}, torch.tensor(SIZES)[keep])
    for k in st:
        torch.testing.assert_close(agg[k], survivors[k], rtol=1e-6,
                                   atol=1e-7)
    # the generator's own draw is a mask too, and all-dropped is finite
    drawn = t_ch.begin_round(9, torch.tensor(SIZES))
    assert set(drawn.mask.tolist()) <= {0.0, 1.0}
    none = t_ch.begin_round(9, torch.tensor(SIZES), torch.ones(K))
    assert not none.weights.any() and float(none.num_participants) == 0.0


def _normal(key, shape):
    return jax.random.normal(key, shape, jnp.float32)


def test_dp_clips_jointly_and_noises_only_stats():
    j_ch = j_channel.DPGaussianChannel(noise_multiplier=0.7, clip_norm=0.5)
    t_ch = channel.DPGaussianChannel(noise_multiplier=0.7, clip_norm=0.5)
    key, j_ctx, t_ctx = _round_ctx(j_ch, t_ch, 13, SIZES)
    tree = _stats_payload(4)
    np.testing.assert_array_equal(t_ctx.weights.numpy(),
                                  np.asarray(j_ctx.weights))
    clipped = t_ch.encode_decode(t_ctx, _t(tree), "stats")
    for a, b in _pairs(clipped, j_ch.encode_decode(j_ctx, _j(tree),
                                                   "stats")):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-8)
    # one joint norm over the client's whole payload, not one per leaf
    norms = torch.sqrt(sum((x.reshape(K, -1) ** 2).sum(1)
                           for x in utils.tree_leaves(clipped)))
    assert bool((norms <= 0.5 * (1 + 1e-5)).all())
    raw = torch.sqrt(sum((x.reshape(K, -1) ** 2).sum(1)
                         for x in utils.tree_leaves(_t(tree))))
    assert bool((raw > 0.5).all())
    # the noise of the stats phase: the reference's per-leaf draws
    agg_j = jax.tree.map(lambda v: jnp.tensordot(j_ctx.weights, v, axes=1),
                         j_ch.encode_decode(j_ctx, _j(tree), "stats"))
    leaves, treedef = jax.tree.flatten(agg_j)
    keys = j_channel._leaf_keys(key, "stats", len(leaves))
    noise = jax.tree.unflatten(treedef, [np.asarray(_normal(kk, x.shape))
                                         for kk, x in zip(keys, leaves)])
    ref = _np(j_ch.aggregate(j_ctx, _j(tree), "stats"))
    out = t_ch.aggregate(t_ctx, _t(tree), "stats", _t(noise))
    for k in tree:
        np.testing.assert_allclose(out[k].numpy(), ref[k], rtol=1e-5,
                                   atol=1e-6)
    # no noise on the update phase: the clipped uniform mean
    upd = _param_payload(4)
    ref_u = _carry_params(jax.tree.map(
        lambda x: np.asarray(x)[None],
        j_ch.aggregate(j_ctx, _j(upd), "update")))
    out_u = t_ch.aggregate(t_ctx, _carry_params(upd), "update")
    for a, b in _pairs(out_u, ref_u):
        np.testing.assert_allclose(a.numpy(), b[0], rtol=1e-6, atol=1e-8)
    # the generator's own noise has the calibrated scale
    drawn = t_ch.aggregate(t_ctx, _t(tree), "stats")
    resid = torch.cat([(drawn[k] - out[k] + 0.7 * 0.5 / K * _t(noise)[k])
                       .reshape(-1) for k in tree])
    assert 0.3 * 0.07 < float(resid.std()) < 3 * 0.07


def test_dp_accountant_matches_reference():
    j_ch = j_channel.DPGaussianChannel(1.3, 1.0, delta=1e-6,
                                       noise_phases=("stats", "update"))
    t_ch = channel.DPGaussianChannel(1.3, 1.0, delta=1e-6,
                                     noise_phases=("stats", "update"))
    for ch in (j_ch, t_ch):
        ch.finalize_rounds(7)
        ch.finalize_rounds(3)
    assert t_ch.accountant.steps == j_ch.accountant.steps == 20
    assert t_ch.accountant.epsilon() == j_ch.accountant.epsilon()
    assert comm.zcdp_to_epsilon(0.0, 1e-5) == 0.0
    assert comm.gaussian_rho_per_step(0.0) == float("inf")


def test_get_channel_builds_and_rejects_like_the_reference():
    for name in ("dense", "int8", "quant", "dp", "dropout"):
        t_ch = channel.get_channel(name, quant_bits=4)
        j_ch = j_channel.get_channel(name, quant_bits=4)
        assert type(t_ch).__name__ == type(j_ch).__name__
        for flag in ("supports_flat_stats", "ideal", "full_participation"):
            assert getattr(t_ch, flag) == getattr(j_ch, flag), (name, flag)
    assert channel.get_channel("quant", quant_bits=4).bits == 4
    assert channel.get_channel("none") is None
    assert channel.get_channel(None) is None
    assert channel.CHANNELS == j_channel.CHANNELS
    bad = [lambda m: m.get_channel("carrier-pigeon"),
           lambda m: m.get_channel("quant", quant_bits=1),
           lambda m: m.get_channel("quant", quant_bits=17),
           lambda m: m.get_channel("dropout", dropout_p=1.0),
           lambda m: m.get_channel("dropout", dropout_p=-0.1),
           lambda m: m.DPGaussianChannel(noise_phases=("downlink",))]
    for make in bad:
        for mod in (channel, j_channel):
            with pytest.raises(ValueError):
                make(mod)
    with pytest.raises(ValueError):
        channel.QuantizedChannel(bits=17)
