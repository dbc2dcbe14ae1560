"""The port's flash attention (its plain version, its gradient and its
``vmap`` rule) and its GQA attention against the reference, on the CPU.

The Pallas kernel runs in interpret mode, as tests/test_kernels.py runs
it; the CUDA kernel itself is held against the plain version on the card
by tests/test_torch_cuda.py (marked ``cuda``) and chip_smoke.py.

Tolerances. Forward: the reference's own, 2e-5 in f32 and 3e-2 in bf16
(tests/test_kernels.py:127-185): both sides sum the same f32 products in
other orders, and in bf16 the two round the output once each. Gradients
and the GQA block: 1e-4 of the largest magnitude (atol and rtol), f32 on
both sides; the port's backward takes the probabilities from the saved
log-sum-exp blockwise, the reference differentiates its online-softmax
scan, so sums over 64-256 keys differ in order (a few ulps of O(1)
values). The blockwise backward against the dense recompute it replaced,
in f64: 1e-10 (the same products summed over other blocks). A
per-client loop against ``vmap`` in the port: 1e-5, the same arithmetic
batched or not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.func import grad, grad_and_value, vmap

from repro.configs.base import get_config as j_get_config
from repro.kernels import ref as j_ref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as j_attn
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.dryrun import Trace
from repro_torch.models import attention

# tier-1 runs 6 pytest workers on the machine's cores: one torch thread
# per worker keeps them from contending with each other and with JAX
torch.set_num_threads(1)


def _qkv(b, h, kvh, sq, skv, dh, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, sq, dh).astype(np.float32),
            rng.randn(b, kvh, skv, dh).astype(np.float32),
            rng.randn(b, kvh, skv, dh).astype(np.float32))


def _bf16_np(t):
    return t.float().numpy()


CASES = [
    # b, h, kvh, sq, skv, dh, causal, window
    (2, 4, 2, 128, 128, 64, True, 0),       # groups of 2
    (1, 8, 1, 128, 128, 32, True, 0),       # groups of 8
    (1, 2, 2, 64, 64, 32, False, 0),        # groups of 1, non-causal
    (2, 4, 1, 64, 256, 64, True, 0),        # Sq < Skv (q_offset 192)
    (1, 4, 4, 256, 256, 64, True, 32),      # windows
    (1, 4, 4, 256, 256, 64, True, 96),
    (1, 4, 2, 100, 100, 32, True, 0),       # a ragged S
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kvh,sq,skv,dh,causal,window", CASES)
def test_plain_flash_matches_pallas_interpret_and_oracle(
        b, h, kvh, sq, skv, dh, causal, window, dtype):
    q, k, v = _qkv(b, h, kvh, sq, skv, dh, seed=b * h + sq + window)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    jq, jk, jv = (jnp.asarray(x).astype(jd) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(td) for x in (q, k, v))
    # a ragged S takes whole-S blocks in Pallas (its blocks must divide S)
    blk = 64 if sq % 64 == 0 and skv % 64 == 0 else max(sq, skv)
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                    block_q=min(blk, sq), block_kv=blk,
                                    interpret=True)
    oracle = j_ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                       window=window)
    port = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert port.dtype == td and port.shape == (b, h, sq, dh)
    tol = 2e-5 if dtype == "float32" else 3e-2
    for other in (pallas, oracle):
        np.testing.assert_allclose(_bf16_np(port),
                                   np.asarray(other, np.float32),
                                   rtol=tol, atol=tol)


def test_plain_version_returns_the_row_log_sum_exp():
    q, k, v = _qkv(1, 4, 2, 48, 80, 32, 3)
    tq, tk, tv = (torch.from_numpy(x).double() for x in (q, k, v))
    o, lse = ref.flash_attention_ref(tq, tk, tv, window=20, return_lse=True)
    s = torch.einsum("bhqd,bhsd->bhqs", tq, tk.repeat_interleave(2, 1))
    s = s / np.sqrt(32)
    valid = ref.flash_attention_mask(48, 80, True, 20, "cpu")
    want = torch.logsumexp(s.masked_fill(~valid, -torch.inf), -1)
    assert lse.dtype == torch.float64
    torch.testing.assert_close(lse, want, rtol=1e-12, atol=1e-12)
    # the kernel's semantics: the queries are the last 48 of 80 positions
    assert bool(valid[0, 32]) and not bool(valid[0, 33])
    assert not bool(valid[47, 59]) and bool(valid[47, 60])


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_gradients_match_jax_grad_of_blockwise_attention(causal, window):
    """The Function's backward (plain torch, from the saved log-sum-exp)
    against ``jax.grad`` of the reference's scan, through a weighted sum of
    the output. The reference's blockwise attention is always causal; the
    non-causal case is held against ``jax.grad`` of its oracle."""
    b, h, kvh, s, dh = 2, 4, 2, 64, 32
    q, k, v = _qkv(b, h, kvh, s, s, dh, 7)
    w = np.random.RandomState(8).randn(b, h, s, dh).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))

    def j_loss(q, k, v):
        if causal:
            out = j_attn.blockwise_attention(
                q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                v.transpose(0, 2, 1, 3), pos, pos, window, kv_block=16)
            out = out.transpose(0, 2, 1, 3)
        else:
            out = j_ref.flash_attention_ref(q, k, v, causal=False)
        return jnp.sum(out * w)

    jg = jax.grad(j_loss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                               for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (flash_attention(tq, tk, tv, causal=causal, window=window)
     * torch.from_numpy(w)).sum().backward()
    for port, want in zip((tq.grad, tk.grad, tv.grad), jg):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(port.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * scale)


def test_vmap_rule_folds_clients_into_one_call(monkeypatch):
    """Phase 2's shape: ``vmap(grad_and_value)`` over K clients of a model
    whose q, k and v depend on the (unbatched) parameters and the
    (batched) data. The forward runs once, at the folded (K*n, ...) shape,
    and the gradients equal a per-client loop."""
    kk, n, h, kvh, s, dh, d = 4, 2, 4, 2, 16, 32, 24
    rng = np.random.RandomState(9)
    params = {name: torch.from_numpy(
        (rng.randn(d, m * dh) / np.sqrt(d)).astype(np.float32))
              for name, m in (("q", h), ("k", kvh), ("v", kvh))}
    x = torch.from_numpy(rng.randn(kk, n, s, d).astype(np.float32))

    def loss(p, xb):
        bsz = xb.shape[0]
        q = (xb @ p["q"]).reshape(bsz, s, h, dh).transpose(1, 2)
        k = (xb @ p["k"]).reshape(bsz, s, kvh, dh).transpose(1, 2)
        v = (xb @ p["v"]).reshape(bsz, s, kvh, dh).transpose(1, 2)
        return (flash_attention(q, k, v, window=6) ** 2).mean()

    calls = []
    plain = ref.flash_attention_ref

    def spy(q, *a, **kw):
        calls.append(tuple(q.shape))
        return plain(q, *a, **kw)

    monkeypatch.setattr(ref, "flash_attention_ref", spy)
    before = dict(flash_attention.launches)
    with flash_mod.record_calls() as recorded:
        g, val = vmap(grad_and_value(loss), in_dims=(None, 0))(params, x)
    assert calls == [(kk * n, h, s, dh)]
    # one backward for all clients too, at the folded shape
    assert recorded == [(kind, kk * n, h, s, s, dh, dh, True, 6)
                        for kind in ("forward", "backward")]
    assert flash_attention.launches == before      # the CPU launches nothing
    for i in range(kk):
        gi = grad(loss)(params, x[i])
        for name in params:
            torch.testing.assert_close(g[name][i], gi[name], rtol=1e-5,
                                       atol=1e-6)
        torch.testing.assert_close(val[i], loss(params, x[i]), rtol=1e-5,
                                   atol=1e-7)


# ------------------------------------------------------------ backward --

# (sq, skv, causal, window): the queries are the last sq of skv positions
BWD_MASKS = [(48, 48, True, 0), (48, 48, True, 20), (40, 96, True, 0),
             (40, 96, False, 0)]


def _j_scan(q, k, v, sq, skv, causal, window, scale):
    """The reference's blockwise scan (kv blocks of 32) on (B, H, S, D)
    operands; non-causal as positions that see every key."""
    b = q.shape[0]
    q_pos = (jnp.arange(skv - sq, skv) if causal
             else jnp.full((sq,), skv - 1))
    out = j_attn.blockwise_attention(
        q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
        v.transpose(0, 2, 1, 3), jnp.broadcast_to(q_pos[None], (b, sq)),
        jnp.broadcast_to(jnp.arange(skv)[None], (b, skv)), window,
        kv_block=32, scale=scale)
    return out.transpose(0, 2, 1, 3)


@pytest.mark.parametrize("dqk,dv", flash_mod.HEAD_DIMS)
@pytest.mark.parametrize("sq,skv,causal,window", BWD_MASKS)
def test_plain_backward_matches_jax_grad_of_the_reference_scan(
        dqk, dv, sq, skv, causal, window):
    """The backward's plain version, through the Function (one kv block)
    and called at kv blocks of 32, against ``jax.grad`` of the reference's
    checkpointed scan, at every (Dqk, Dv) instance, in groups of 2, f32,
    through a weighted sum of the output: 1e-4 of each gradient's largest
    magnitude."""
    b, h, kvh = 1, 4, 2
    rng = np.random.RandomState(dqk + sq + window + causal)
    q = rng.randn(b, h, sq, dqk).astype(np.float32)
    k = rng.randn(b, kvh, skv, dqk).astype(np.float32)
    v = rng.randn(b, kvh, skv, dv).astype(np.float32)
    w = rng.randn(b, h, sq, dv).astype(np.float32)
    scale = dqk ** -0.5

    def j_loss(q, k, v):
        return jnp.sum(_j_scan(q, k, v, sq, skv, causal, window, scale) * w)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                                 for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (flash_attention(tq, tk, tv, causal=causal, window=window)
     * torch.from_numpy(w)).sum().backward()
    o, lse = ref.flash_attention_ref(tq.detach(), tk.detach(), tv.detach(),
                                     causal=causal, window=window,
                                     scale=scale, return_lse=True)
    blocks = flash_mod.attention_backward(
        tq.detach(), tk.detach(), tv.detach(), o, lse, torch.from_numpy(w),
        causal, window, scale, kv_block=32)
    for port in ((tq.grad, tk.grad, tv.grad), blocks):
        for got, j in zip(port, want):
            j = np.asarray(j)
            np.testing.assert_allclose(got.numpy(), j, rtol=1e-4,
                                       atol=1e-4 * float(np.abs(j).max()))


def _dense_backward(q, k, v, o, lse, do, causal, window, scale):
    """The dense recompute the blockwise backward replaced: every (Sq,
    Skv) score, probability and gradient at once."""
    b, h, sq, dh = q.shape
    kvh, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    g = h // kvh
    qg = q.reshape(b, kvh, g, sq, dh)
    dog = do.reshape(b, kvh, g, sq, dv)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k) * scale
    valid = ref.flash_attention_mask(sq, skv, causal, window, q.device)
    s = torch.where(valid, s, torch.full_like(s, ref.NEG_INF))
    p = torch.exp(s - lse.reshape(b, kvh, g, sq, 1))
    ds = p * (torch.einsum("bkgqd,bksd->bkgqs", dog, v) - (
        dog * o.reshape(b, kvh, g, sq, dv)).sum(-1, keepdim=True)) * scale
    return (torch.einsum("bkgqs,bksd->bkgqd", ds, k).reshape(q.shape),
            torch.einsum("bkgqs,bkgqd->bksd", ds, qg),
            torch.einsum("bkgqs,bkgqd->bksd", p, dog))


@pytest.mark.parametrize("b,h,kvh,sq,skv,dqk,dv,causal,window", [
    (2, 4, 2, 40, 100, 32, 32, True, 0),       # Sq < Skv, ragged blocks
    (1, 4, 1, 70, 70, 64, 64, True, 17),       # a window, groups of 4
    (1, 2, 2, 30, 90, 192, 128, False, 0),     # MLA's dims, non-causal
    (1, 4, 2, 30, 90, 80, 80, False, 25),      # non-causal window
])
def test_blockwise_backward_equals_the_dense_recompute_in_f64(
        b, h, kvh, sq, skv, dqk, dv, causal, window):
    gen = torch.Generator().manual_seed(sq + skv)
    q = torch.randn(b, h, sq, dqk, generator=gen, dtype=torch.float64)
    k = torch.randn(b, kvh, skv, dqk, generator=gen, dtype=torch.float64)
    v = torch.randn(b, kvh, skv, dv, generator=gen, dtype=torch.float64)
    scale = dqk ** -0.5
    o, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                     scale=scale, return_lse=True)
    do = torch.randn(o.shape, generator=gen, dtype=torch.float64)
    args = (q, k, v, o, lse, do, causal, window, scale)
    want = _dense_backward(*args)
    for kv_block in (16, flash_mod.KV_BLOCK):
        got = flash_mod.attention_backward(*args, kv_block=kv_block)
        for a, w in zip(got, want):
            assert a.dtype == torch.float64 and a.shape == w.shape
            torch.testing.assert_close(a, w, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("b,h,kvh,s,dh", [(1, 8, 2, 2048, 64),
                                           (1, 32, 4, 4096, 64)])
def test_traced_backward_holds_no_score_block(b, h, kvh, s, dh):
    """The gradient's memory shape: the dry run's trace of
    ``torch.autograd.grad`` through the flash Function on fake tensors in
    f32 peaks below one (B, H, Sq, Skv) f32 score block (128 MiB at (1, 8,
    2, 2048, 64), where the dense recompute peaked at ~650 MiB; 2 GiB at
    TinyLlama's heads over 4096 positions, ~10 GiB dense), and at or below
    XLA:CPU's temp of ``jit(grad(...))`` of the reference's checkpointed
    scan at that shape (kv blocks of 1024). Run with ``-s`` to print both."""
    with FakeTensorMode():
        q = torch.empty(b, h, s, dh, requires_grad=True)
        k = torch.empty(b, kvh, s, dh, requires_grad=True)
        v = torch.empty(b, kvh, s, dh, requires_grad=True)
        w = torch.empty(b, h, s, dh)
        with Trace(existing=[q, k, v, w]) as tr, \
                flash_mod.record_calls() as calls:
            out = flash_attention(q, k, v)
            grads = torch.autograd.grad((out * w).sum(), (q, k, v))
        assert [tuple(g.shape) for g in grads] == [
            tuple(x.shape) for x in (q, k, v)]
    assert [c[0] for c in calls] == ["forward", "backward"]

    def j_loss(q, k, v, w):
        pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
        return jnp.sum(j_attn.blockwise_attention(q, k, v, pos, pos) * w)

    spec = [jax.ShapeDtypeStruct(shape, jnp.float32) for shape in (
        (b, s, h, dh), (b, s, kvh, dh), (b, s, kvh, dh), (b, s, h, dh))]
    ref_temp = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2))).lower(
        *spec).compile().memory_analysis().temp_size_in_bytes
    print(f"({b}, {h}, {kvh}, {s}, {dh}) f32: traced backward peak "
          f"{tr.peak} bytes; the reference's temp {ref_temp} bytes")
    assert tr.peak < b * h * s * s * 4
    assert tr.peak <= ref_temp


def test_backward_flops_count_the_five_products_of_the_forward_tiles():
    """``backward_flops`` visits the forward's (64, 64) tile pairs and
    counts the gradient's five products on each: S and dP, dV and dK,
    dQ; ``call_flops`` reads a recorded call of either kind."""
    for shape in ((2, 3, 128, 128, 64, 64, False, 0),
                  (1, 1, 256, 256, 64, 64, True, 0),
                  (1, 1, 256, 256, 64, 64, True, 64),
                  (2, 4, 100, 300, 192, 128, True, 70)):
        b, h, sq, skv, dqk, dv, causal, window = shape
        fwd = flash_mod.forward_flops(*shape)
        bwd = flash_mod.backward_flops(*shape)
        assert bwd * (dqk + dv) == fwd * (3 * dqk + 2 * dv)
        assert flash_mod.call_flops(("forward", *shape)) == fwd
        assert flash_mod.call_flops(("backward", *shape)) == bwd
    # causal over 4 x 4 tiles of 64: 1 + 2 + 3 + 4 of the 16 visited
    assert flash_mod.backward_flops(1, 1, 256, 256, 64, 64, True, 0) == \
        10 * 2 * 64 * 64 * (3 * 64 + 2 * 64)


def test_backward_on_a_shape_trace_only_makes_its_outputs():
    """On meta tensors the backward reads no pointer and launches nothing:
    dq, dk and dv of the inputs' shapes and type, laid out as (B, S,
    heads, D) buffers seen as (B, heads, S, D)."""
    b, h, kvh, sq, skv, dqk, dv = 2, 8, 2, 48, 80, 192, 128
    q = torch.empty(b, h, sq, dqk, device="meta", dtype=torch.bfloat16)
    k = torch.empty(b, kvh, skv, dqk, device="meta", dtype=torch.bfloat16)
    v = torch.empty(b, kvh, skv, dv, device="meta", dtype=torch.bfloat16)
    o = torch.empty(b, h, sq, dv, device="meta", dtype=torch.bfloat16)
    lse = torch.empty(b, h, sq, device="meta")
    before = dict(flash_attention.launches)
    dq, dk, dvv = flash_mod.FlashAttentionBackward.apply(
        q, k, v, o, lse, o, True, 0, dqk ** -0.5)
    assert flash_attention.launches == before
    for g, x in ((dq, q), (dk, k), (dvv, v)):
        assert g.shape == x.shape and g.dtype == x.dtype
        assert g.is_meta and g.transpose(1, 2).is_contiguous()


def test_second_derivative_is_refused():
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(1, 4, 2, 16, 16, 32, 4))
    out = flash_attention(q, k, v)
    gq, = torch.autograd.grad(out.square().sum(), q, create_graph=True)
    with pytest.raises(RuntimeError, match="no second derivative"):
        torch.autograd.grad(gq.sum(), q)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 6, 4, 8, 8, 32, 1))
    with pytest.raises(ValueError, match="groups"):
        flash_attention(q, k, v)
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 4, 2, 16, 8, 32, 1))
    with pytest.raises(ValueError, match="Sq=16"):
        flash_attention(q, k, v)
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 4, 2, 8, 8, 32, 1))
    with pytest.raises(ValueError, match="4-D"):
        flash_attention(q[0], k, v)
    with pytest.raises(ValueError, match="k and v"):
        flash_attention(q, k, v[:, :, :4])
    with pytest.raises(TypeError, match="one type"):
        flash_attention(q, k.double(), v)


def test_cuda_tensor_never_reaches_the_plain_version(monkeypatch, tmp_path):
    """A tensor the wrapper sees as a CUDA tensor goes to the kernel; when
    the library cannot be built (no nvcc here) the wrapper raises, and
    neither falls back to the plain version nor counts a launch."""
    def no_plain(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(ref, "flash_attention_ref", no_plain)
    monkeypatch.setattr(flash_mod, "_device_type", lambda t: "cuda")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build, "NVCC_FALLBACK", str(tmp_path / "nvcc"))
    before = dict(flash_attention.launches)
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 4, 2, 8, 8, 32, 2))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        flash_attention(q, k, v)
    with pytest.raises(ValueError, match="head dim 24"):
        flash_attention(q[..., :24], k[..., :24], v[..., :24])
    assert flash_attention.launches == before


def test_cuda_backward_never_reaches_the_plain_version(monkeypatch,
                                                      tmp_path):
    """The backward of a tensor the wrapper sees as a CUDA tensor goes to
    the backward kernel; when the library cannot be built (no nvcc here)
    it raises, and neither falls back to the plain version nor counts a
    call."""
    def no_plain(*a, **k):
        raise AssertionError("plain backward called for a CUDA tensor")

    monkeypatch.setattr(flash_mod, "attention_backward", no_plain)
    monkeypatch.setattr(flash_mod, "_device_type", lambda t: "cuda")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build, "NVCC_FALLBACK", str(tmp_path / "nvcc"))
    before = dict(flash_attention.launches)
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 4, 2, 8, 8, 32, 2))
    lse = torch.zeros(1, 4, 8)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        flash_mod.FlashAttentionBackward.apply(q, k, v, q, lse, q, True, 0,
                                               0.25)
    with pytest.raises(ValueError, match="head dim 24"):
        flash_mod._backward(q[..., :24], k[..., :24], v[..., :24],
                            q[..., :24], lse, q[..., :24], True, 0, 0.25)
    with pytest.raises(TypeError, match="f32 or bf16"):
        flash_mod._backward(*(x.double() for x in (q, k, v, q)), lse,
                            q.double(), True, 0, 0.25)
    assert flash_attention.launches == before


def test_library_name_tracks_the_source():
    assert "flash_attention" in _build.KERNELS
    path = _build.library_path("flash_attention")
    assert path.name.startswith("libflash_attention-") and path.suffix == ".so"
    assert (_build.CSRC / "flash_attention.cu").exists()


def test_backward_library_is_built_beside_the_forward():
    assert "flash_attention_bwd" in _build.KERNELS
    path = _build.library_path("flash_attention_bwd")
    assert path.name.startswith("libflash_attention_bwd-")
    assert path.parent == _build.library_path("flash_attention").parent
    assert (_build.CSRC / "flash_attention_bwd.cu").exists()


def test_library_name_tracks_the_headers_a_source_includes(monkeypatch,
                                                           tmp_path):
    """A library's name hashes the local headers its source includes
    (through another header too), so an edited header is rebuilt: two
    contents of one header give two library paths. Both flash sources
    include the shared Hopper header."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint f() { return g(); }\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  # include "b.cuh"\n')
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    paths = []
    for body in ("int g() { return 1; }\n", "int g() { return 2; }\n"):
        (tmp_path / "b.cuh").write_text(body)
        paths.append(_build.library_path("k"))
    assert paths[0] != paths[1]
    assert [p.name for p in _build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    monkeypatch.undo()
    for name in ("flash_attention", "flash_attention_bwd"):
        assert "hopper.cuh" in [p.name for p in _build.sources(name)]


# ------------------------------------------------------------- GQA block --

def _gqa_setup(arch, seed=0, **replace):
    jcfg = j_get_config(arch, smoke=True).replace(**replace)
    tcfg = get_config(arch, smoke=True).replace(**replace)
    jp = j_attn.gqa_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    x = np.random.RandomState(seed).randn(2, 48, jcfg.d_model)
    return jcfg, tcfg, jp, tp, x.astype(np.float32)


@pytest.mark.parametrize("arch,replace", [
    ("tinyllama-1.1b", {}), ("qwen3-1.7b", {}),            # qwen3: qk_norm
    ("tinyllama-1.1b", {"sliding_window": 16}),
    ("tinyllama-1.1b", {"attn_impl": "naive"}),
])
def test_gqa_forward_matches_reference(arch, replace):
    jcfg, tcfg, jp, tp, x = _gqa_setup(arch, **replace)
    pos = np.broadcast_to(np.arange(48)[None], (2, 48))
    want = j_attn.gqa_forward(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    got = attention.gqa_forward(tcfg, tp, torch.from_numpy(x),
                                torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("window", [0, 20])
def test_attention_math_routes_match_the_reference_scan(window):
    """The port's three implementations against the reference's
    blockwise scan: ``attention_math`` (the flash route), the naive
    version and the plain scan kept for tests, on (B, S, H, Dh)."""
    b, s, h, kvh, dh = 2, 40, 4, 2, 32
    rng = np.random.RandomState(11)
    q = rng.randn(b, s, h, dh).astype(np.float32)
    k = rng.randn(b, s, kvh, dh).astype(np.float32)
    v = rng.randn(b, s, kvh, dh).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).copy()
    want = np.asarray(j_attn.blockwise_attention(
        *(jnp.asarray(a) for a in (q, k, v, pos, pos)), window, kv_block=16))
    cfg = get_config("tinyllama-1.1b", smoke=True).replace(
        sliding_window=window)
    tq, tk, tv, tpos = (torch.from_numpy(a) for a in (q, k, v, pos))
    outs = [attention.attention_math(cfg, tq, tk, tv, tpos, tpos),
            attention.naive_attention(tq, tk, tv, tpos, tpos, window),
            attention.blockwise_attention(tq, tk, tv, tpos, tpos, window,
                                          kv_block=16)]
    for got in outs:
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
