"""The port's MLA attention and the flash kernel's Dqk != Dv form against
the reference, on the CPU.

The flash wrapper runs its plain version here (the CUDA kernel's
(192, 128) instance is held to it on the card by tests/test_torch_cuda.py
and chip_smoke.py). Against the reference's ``blockwise_attention`` (the
jnp scan the reference's MLA prefill runs, whose v may be narrower than
q and k): 2e-5 in f32 and 3e-2 in bf16, the reference's own flash
tolerances (tests/test_kernels.py): the same f32 products summed in
other orders, a bf16 output rounded once on each side. Gradients: 1e-4
of each gradient's largest magnitude, f32 (the port's backward takes
the probabilities from the saved log-sum-exp, the reference
differentiates its scan). ``vmap`` against a loop in the port: 1e-5.

MLA blocks (``mla_forward``, ``mla_prefill``, ``mla_decode`` with
``absorb`` True and False) on the deepseek-v2-lite smoke config in f32,
the reference's parameters carried over: 1e-4 of the output's largest
magnitude (latent, rope and head products of 256-wide rows in other
orders; measured ~1e-6); the caches the prefill writes: 1e-5 (one
matrix product and an RMSNorm).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from repro.configs.base import get_config as j_get_config
from repro.models import attention as j_attn
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention

torch.set_num_threads(1)

ARCH = "deepseek-v2-lite-16b"


def _qkv(b, h, kvh, sq, skv, dqk, dv, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, sq, dqk).astype(np.float32),
            rng.randn(b, kvh, skv, dqk).astype(np.float32),
            rng.randn(b, kvh, skv, dv).astype(np.float32))


_j_blockwise = jax.jit(j_attn.blockwise_attention,
                       static_argnames=("window", "kv_block", "scale"))


def _reference(q, k, v, window, dtype):
    """The reference's scan on (B, H, S, D) inputs, back in that layout;
    the queries the last Sq positions."""
    b, _, sq, dqk = q.shape
    skv = k.shape[2]
    jq, jk, jv = (jnp.asarray(x.transpose(0, 2, 1, 3)).astype(dtype)
                  for x in (q, k, v))
    q_pos = np.broadcast_to(np.arange(skv - sq, skv)[None], (b, sq))
    kv_pos = np.broadcast_to(np.arange(skv)[None], (b, skv))
    out = _j_blockwise(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(kv_pos),
                       window=window, kv_block=32,
                       scale=float(1.0 / np.sqrt(dqk)))
    return np.asarray(out.astype(jnp.float32)).transpose(0, 2, 1, 3)


CASES = [
    # b, h, kvh, sq, skv, dqk, dv, window
    (2, 4, 4, 40, 40, 48, 32, 0),      # the smoke MLA's dims
    (1, 4, 2, 24, 64, 192, 128, 0),    # the full MLA's dims, Sq < Skv
    (1, 2, 1, 50, 50, 192, 128, 16),   # a window
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kvh,sq,skv,dqk,dv,window", CASES)
def test_plain_flash_with_narrow_v_matches_reference_scan(
        b, h, kvh, sq, skv, dqk, dv, window, dtype):
    q, k, v = _qkv(b, h, kvh, sq, skv, dqk, dv, seed=sq + dqk)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = _reference(q, k, v, window, jd)
    tq, tk, tv = (torch.from_numpy(x).to(td) for x in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=True, window=window)
    plain = ref.flash_attention_ref(tq, tk, tv, causal=True, window=window)
    assert got.shape == (b, h, sq, dv) and got.dtype == td
    tol = 2e-5 if dtype == "float32" else 3e-2
    for out in (got, plain):
        np.testing.assert_allclose(out.float().numpy(), want, rtol=tol,
                                   atol=tol)


def test_flash_gradients_with_narrow_v_match_jax_grad():
    b, h, kvh, sq, skv, dqk, dv = 1, 4, 2, 24, 40, 48, 32
    q, k, v = _qkv(b, h, kvh, sq, skv, dqk, dv, seed=3)
    w = np.random.RandomState(4).randn(b, sq, h, dv).astype(np.float32)
    q_pos = jnp.asarray(np.arange(skv - sq, skv)[None])
    kv_pos = jnp.asarray(np.arange(skv)[None])

    def j_loss(jq, jk, jv):
        out = j_attn.blockwise_attention(jq, jk, jv, q_pos, kv_pos,
                                         kv_block=16)
        return (out * w).sum()

    want = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (flash_attention(*xs) * torch.from_numpy(w).transpose(1, 2)).sum() \
        .backward()
    for x, g in zip(xs, want):
        g = np.asarray(g).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(x.grad.numpy(), g, rtol=0,
                                   atol=1e-4 * float(np.abs(g).max()))


def test_flash_vmap_rule_with_narrow_v():
    q, k, v = (torch.from_numpy(x) for x in
               _qkv(3, 4, 4, 16, 16, 48, 32, seed=5))
    fold = [x.reshape(3, 1, *x.shape[1:]) for x in (q, k, v)]
    got = vmap(flash_attention)(*fold)
    for i in range(3):
        torch.testing.assert_close(got[i], flash_attention(
            q[i:i + 1], k[i:i + 1], v[i:i + 1]), rtol=1e-5, atol=1e-5)


def test_kernel_takes_the_mla_pair_and_refuses_others(monkeypatch,
                                                      tmp_path):
    """On a tensor the wrapper sees as CUDA: (192, 128) passes the shape
    checks and goes to the build (which raises here: no nvcc); a pair
    the kernel has no instance of is refused by name."""
    assert (192, 128) in flash_mod.HEAD_DIMS
    monkeypatch.setattr(flash_mod, "_device_type", lambda t: "cuda")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build, "NVCC_FALLBACK", str(tmp_path / "nvcc"))
    before = dict(flash_attention.launches)
    q, k, v = (torch.from_numpy(x) for x in
               _qkv(1, 2, 2, 8, 8, 192, 128, seed=6))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        flash_attention(q, k, v)
    with pytest.raises(ValueError, match="head dim 48 with v head dim 32"):
        flash_attention(q[..., :48], k[..., :48], v[..., :32])
    with pytest.raises(ValueError, match="k and v"):
        flash_attention(q, k[..., :64], v)
    assert flash_attention.launches == before


# ------------------------------------------------------------- MLA block --

def _mla_setup(seed=0, **replace):
    jcfg = j_get_config(ARCH, smoke=True).replace(**replace)
    tcfg = get_config(ARCH, smoke=True).replace(**replace)
    jp = j_attn.mla_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    x = np.random.RandomState(seed).randn(2, 24, jcfg.d_model)
    return jcfg, tcfg, jp, tp, x.astype(np.float32)


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("impl", ["blockwise", "naive"])
def test_mla_forward_matches_reference(impl):
    jcfg, tcfg, jp, tp, x = _mla_setup(attn_impl=impl)
    pos = np.broadcast_to(np.arange(24)[None], (2, 24)).copy()
    want = jax.jit(j_attn.mla_forward, static_argnums=0)(
        jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    got = attention.mla_forward(tcfg, tp, torch.from_numpy(x),
                                torch.from_numpy(pos))
    _close(got, want, 1e-4)


def test_mla_prefill_and_decode_match_reference():
    """Prefill 16 positions into a 24-slot cache, then decode position 16
    with the absorbed and the naive step, each against the reference's
    and the two against each other."""
    jcfg, tcfg, jp, tp, x = _mla_setup(seed=1)
    pos = np.broadcast_to(np.arange(16)[None], (2, 16)).copy()
    jcache = j_attn.mla_cache_init(jcfg, 2, 24, jnp.float32)
    jout, jcache = jax.jit(j_attn.mla_prefill, static_argnums=0)(
        jcfg, jp, jnp.asarray(x[:, :16]), jnp.asarray(pos), jcache)
    cache = attention.mla_cache_init(tcfg, 2, 24, torch.float32)
    out, cache = attention.mla_prefill(tcfg, tp, torch.from_numpy(x[:, :16]),
                                       torch.from_numpy(pos), cache)
    _close(out, jout, 1e-4)
    for name in ("latent", "k_rope"):
        _close(cache[name], jcache[name], 1e-5)
    assert torch.equal(cache["kv_pos"], torch.from_numpy(
        np.array(jcache["kv_pos"])))
    steps = {}
    for absorb in (True, False):
        want, jc = jax.jit(j_attn.mla_decode, static_argnums=(0, 5))(
            jcfg, jp, jnp.asarray(x[:, 16:17]), jnp.int32(16), jcache,
            absorb)
        c = {k: v.clone() for k, v in cache.items()}
        got, c = attention.mla_decode(tcfg, tp, torch.from_numpy(x[:, 16:17]),
                                      torch.tensor(16), c, absorb=absorb)
        _close(got, want, 1e-4)
        _close(c["latent"], jc["latent"], 1e-5)
        assert int(c["kv_pos"][0, 16]) == 16
        steps[absorb] = got
    _close(steps[True], steps[False].numpy(), 1e-4)


def test_mla_cache_ignores_kv_cache_dtype():
    _, tcfg, _, _, _ = _mla_setup()
    for kv in ("model", "int8"):
        cache = attention.mla_cache_init(tcfg.replace(kv_cache_dtype=kv), 2,
                                         8, torch.bfloat16)
        assert sorted(cache) == ["k_rope", "kv_pos", "latent"]
        assert cache["latent"].dtype == torch.bfloat16
        assert cache["latent"].shape == (2, 8, tcfg.kv_lora_rank)
