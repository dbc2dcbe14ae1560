"""The port's Mamba2 (SSD) block against the reference, on the CPU.

Inputs come from numpy with a seed; the block's parameters are the
reference's (``repro.models.ssm.mamba2_init``), carried over by
``convert``. Config: zamba2's smoke block narrowed to d_model 64 (d_inner
128, 8 heads of 16, state 16, conv width 4), sequences of 24.

Tolerances (f32): the chunked scan, its final state and the block's
output to 1e-5 of their largest magnitude (the same f32 products, summed
by einsums in other orders); decode steps to 1e-5 against the
reference's steps and 1e-4 against the port's own full forward (a step
recurrence against a chunked scan); gradients to 1e-4 of each leaf's
largest magnitude against ``jax.grad``; ``vmap`` over 3 clients against
a loop to 1e-5. In bf16, the block's output to 3e-2 of its magnitude
(bf16 rounding of the projections and the conv output on each side).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.configs.base import SSMConfig as JSSM
from repro.configs.base import get_config as j_get_config
from repro.models import ssm as j_ssm
from repro.models import transformer as j_tf
from repro_torch import convert, utils
from repro_torch.configs.base import SSMConfig, get_config
from repro_torch.models import ssm

torch.set_num_threads(1)

ARCH = "zamba2-2.7b"
B, S, D = 2, 24, 64


def _cfgs(chunk=8, dtype="float32"):
    kw = dict(state=16, expand=2, conv_width=4, head_dim=16, chunk=chunk)
    j = j_get_config(ARCH, smoke=True).replace(d_model=D, ssm=JSSM(**kw),
                                               dtype=dtype)
    t = get_config(ARCH, smoke=True).replace(d_model=D, ssm=SSMConfig(**kw),
                                             dtype=dtype)
    return j, t


def _params(jcfg, dtype=jnp.float32, seed=0):
    jp = j_ssm.mamba2_init(jax.random.PRNGKey(seed), jcfg, dtype)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp))


def _x(seed=1, s=S, scale=1.0):
    return (np.random.RandomState(seed).randn(B, s, D) * scale).astype(
        np.float32)


def _close(got, want, rel):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _scan_inputs(seed=2):
    rng = np.random.RandomState(seed)
    h, p, n = 8, 16, 16
    x = rng.randn(B, S, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(B, S, h))).astype(np.float32)
    a = -np.exp(np.log(np.linspace(1.0, 16.0, h))).astype(np.float32)
    b = rng.randn(B, S, n).astype(np.float32)
    c = rng.randn(B, S, n).astype(np.float32)
    return x, dt, a, b, c


@pytest.mark.parametrize("chunk", [4, 8, 24])
def test_ssd_chunked_and_final_state_match_reference(chunk):
    x, dt, a, b, c = _scan_inputs()
    want = j_ssm._ssd_chunked(*map(jnp.asarray, (x, dt, a, b, c)), chunk)
    want_h = j_tf._ssd_final_state(*map(jnp.asarray, (x, dt, a, b)), chunk)
    y, h = ssm._ssd_chunked(*map(torch.from_numpy, (x, dt, a, b, c)), chunk)
    _close(y, want, 1e-5)
    _close(h, want_h, 1e-5)
    # one chunk of the whole sequence is the same recurrence
    y1, h1 = ssm._ssd_chunked(*map(torch.from_numpy, (x, dt, a, b, c)), S)
    _close(y1, want, 1e-5)
    _close(h1, want_h, 1e-5)


def test_chunk_must_divide_the_sequence():
    x, dt, a, b, c = map(torch.from_numpy, _scan_inputs())
    with pytest.raises(ValueError, match="% chunk 5"):
        ssm._ssd_chunked(x, dt, a, b, c, 5)
    jcfg, tcfg = _cfgs(chunk=5)
    _, tp = _params(jcfg)
    with pytest.raises(ValueError, match="% chunk"):
        ssm.mamba2_forward(tcfg, tp, torch.from_numpy(_x()))


@pytest.mark.parametrize("chunk", [4, 8, 24])
def test_mamba2_forward_matches_reference(chunk):
    jcfg, tcfg = _cfgs(chunk)
    jp, tp = _params(jcfg)
    x = _x()
    want = j_ssm.mamba2_forward(jcfg, jp, jnp.asarray(x))
    _close(ssm.mamba2_forward(tcfg, tp, torch.from_numpy(x)), want, 1e-5)


def test_mamba2_bf16_forward_and_dtypes_per_leaf():
    """A bf16 block keeps A_log, D, dt_bias and the norm in f32, as the
    reference's; its cache holds the conv ring in bf16 and the SSM state
    in f32."""
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    jp, tp = _params(jcfg, jnp.bfloat16)
    for name in ("A_log", "D", "dt_bias"):
        assert tp[name].dtype == torch.float32
    assert tp["in_proj"]["w"].dtype == tp["conv_w"].dtype == torch.bfloat16
    mine = ssm.mamba2_init(torch.Generator().manual_seed(0), tcfg,
                           torch.bfloat16)
    assert [(p, x.dtype, tuple(x.shape)) for p, x in
            jax.tree_util.tree_flatten_with_path(
                convert.params_to_jax(mine))[0]] == \
        [(p, x.dtype, x.shape) for p, x in
         jax.tree_util.tree_flatten_with_path(jp)[0]]
    cache = ssm.mamba2_cache_init(tcfg, B, torch.bfloat16)
    want = j_ssm.mamba2_cache_init(jcfg, B, jnp.bfloat16)
    for k in ("conv", "ssm"):
        assert tuple(cache[k].shape) == want[k].shape
        assert str(cache[k].dtype).split(".")[-1] == want[k].dtype.name
    x = _x()
    want = j_ssm.mamba2_forward(jcfg, jp, jnp.asarray(x, jnp.bfloat16))
    got = ssm.mamba2_forward(tcfg, tp, torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    _close(got, want.astype(jnp.float32), 3e-2)


def test_prefill_state_and_decode_match_reference():
    """The prefill's final state (the forward scan's carry) against the
    reference's recomputation (``_mamba2_prefill`` / ``_ssd_final_state``),
    then 4 decode steps against the reference's and against the port's
    own full forward over the longer sequence."""
    jcfg, tcfg = _cfgs(chunk=8)
    jp, tp = _params(jcfg)
    x = _x(s=S + 4)
    jcache = j_ssm.mamba2_cache_init(jcfg, B, jnp.float32)
    jy, jcache = j_tf._mamba2_prefill(jcfg, jp, jnp.asarray(x[:, :S]),
                                      jcache)
    cache = ssm.mamba2_cache_init(tcfg, B, torch.float32)
    y, state = ssm.mamba2_prefill(tcfg, tp, torch.from_numpy(x[:, :S]),
                                  cache)
    _close(y, jy, 1e-5)
    _close(state["conv"], jcache["conv"], 1e-5)
    _close(state["ssm"], jcache["ssm"], 1e-5)
    full = ssm.mamba2_forward(tcfg.replace(ssm=dataclasses.replace(
        tcfg.ssm, chunk=4)), tp, torch.from_numpy(x))
    for t in range(S, S + 4):
        jd, jcache = j_ssm.mamba2_decode(jcfg, jp,
                                         jnp.asarray(x[:, t:t + 1]), jcache)
        d, state = ssm.mamba2_decode(tcfg, tp, torch.from_numpy(
            x[:, t:t + 1]), state)
        _close(d, jd, 1e-5)
        _close(state["ssm"], jcache["ssm"], 1e-5)
        _close(d, full[:, t:t + 1], 1e-4)


def _loss_w(seed=3):
    return np.random.RandomState(seed).randn(B, S, D).astype(np.float32)


def test_mamba2_gradients_match_jax_grad():
    jcfg, tcfg = _cfgs(chunk=8)
    jp, tp = _params(jcfg)
    x, w = _x(), _loss_w()

    def j_loss(p, xx):
        return jnp.sum(j_ssm.mamba2_forward(jcfg, p, xx) * w)

    jg_p, jg_x = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jp,
                                                           jnp.asarray(x))

    def t_loss(p, xx):
        return (ssm.mamba2_forward(tcfg, p, xx) * torch.from_numpy(w)).sum()

    tg_p, tg_x = grad(t_loss, argnums=(0, 1))(tp, torch.from_numpy(x))
    _close(tg_x, jg_x, 1e-4)
    want = convert.params_from_jax(jax.tree.map(np.asarray, jg_p))
    for got, ref in zip(utils.tree_leaves(tg_p), utils.tree_leaves(want)):
        assert torch.isfinite(got).all()
        _close(got, ref.numpy(), 1e-4)


def test_vmap_over_three_clients_equals_a_loop():
    """Phase 2's form: the gradient of each client's loss, ``vmap``-ed over
    3 clients' sequences, against one call a client."""
    jcfg, tcfg = _cfgs(chunk=8)
    _, tp = _params(jcfg)
    xs = torch.from_numpy(np.stack([_x(seed=10 + i) for i in range(3)]))

    def loss(p, xx):
        return (ssm.mamba2_forward(tcfg, p, xx) ** 2).mean()

    batched = vmap(grad(loss), in_dims=(None, 0))(tp, xs)
    for i in range(3):
        one = grad(loss)(tp, xs[i])
        for a, b in zip(utils.tree_leaves(batched), utils.tree_leaves(one)):
            _close(a[i], b.numpy(), 1e-5)
