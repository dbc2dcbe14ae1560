"""The port's xLSTM blocks (mLSTM, sLSTM) against the reference, on the
CPU.

Inputs come from numpy with a seed; the blocks' parameters are the
reference's (``repro.models.xlstm.mlstm_init`` / ``slstm_init``), carried
over by ``convert``. Config: xlstm's smoke block (d_model 128, 2 heads;
the mLSTM's cells 256 wide, 128 a head), sequences of 16.

Tolerances (f32): outputs and final states to 1e-5 of their largest
magnitude (the same f32 products and exponentials, summed by einsums in
other orders); decode steps to 1e-5 against the reference's steps and
1e-4 against the port's own full forward (a one-step chunk against the
chunked scan); gradients to 1e-4 of each leaf's largest magnitude
against ``jax.grad``; ``vmap`` over 3 clients against a loop to 1e-5.
The extreme-gate case (inputs x 50, tests/test_ssm_xlstm.py) to 1e-4:
the stabiliser keeps every exponential in range, on both sides. The
whole tower at full depth in bf16: its distance from its own f32 forward
against the reference's (tests/_torch_xlstm_bf16.py).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.func import grad, vmap

from repro.configs.base import get_config as j_get_config
from repro.models import xlstm as j_xlstm
from repro_torch import convert, utils
from repro_torch.configs.base import get_config
from repro_torch.models import xlstm

import _torch_xlstm_bf16 as xlstm_bf16

torch.set_num_threads(1)

ARCH = "xlstm-350m"
B, S = 2, 16


def _cfgs(chunk=8):
    j = j_get_config(ARCH, smoke=True)
    t = get_config(ARCH, smoke=True)
    return (j.replace(xlstm=dataclasses.replace(j.xlstm, chunk=chunk)),
            t.replace(xlstm=dataclasses.replace(t.xlstm, chunk=chunk)))


def _params(kind, jcfg, seed=0):
    init = {"mlstm": j_xlstm.mlstm_init, "slstm": j_xlstm.slstm_init}[kind]
    jp = init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp))


def _x(seed=1, s=S, scale=1.0):
    d = get_config(ARCH, smoke=True).d_model
    return (np.random.RandomState(seed).randn(B, s, d) * scale).astype(
        np.float32)


def _close(got, want, rel):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _t(x):
    return torch.from_numpy(np.asarray(x))


@functools.lru_cache(maxsize=None)
def _jit(fn, cfg):
    """The reference's ``fn(cfg, ...)``, jitted (its loops unrolled op by
    op would take longer than the tests)."""
    return jax.jit(functools.partial(fn, cfg))


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_mlstm_forward_and_state_match_reference(chunk):
    jcfg, tcfg = _cfgs(chunk)
    jp, tp = _params("mlstm", jcfg)
    x = _x()
    jy, (jc, jn, jm) = _jit(j_xlstm.mlstm_forward, jcfg)(jp, jnp.asarray(x))
    y, st = xlstm.mlstm_forward(tcfg, tp, _t(x))
    _close(y, jy, 1e-5)
    for got, want in ((st["C"], jc), (st["n"], jn), (st["m"], jm)):
        _close(got, want, 1e-5)


def test_chunk_must_divide_the_sequence():
    jcfg, tcfg = _cfgs(chunk=5)
    _, tp = _params("mlstm", jcfg)
    with pytest.raises(ValueError, match="% chunk 5"):
        xlstm.mlstm_forward(tcfg, tp, _t(_x()))


def test_mlstm_decode_matches_reference_and_forward():
    jcfg, tcfg = _cfgs(chunk=8)
    jp, tp = _params("mlstm", jcfg)
    x = _x()
    full, _ = xlstm.mlstm_forward(tcfg, tp, _t(x))
    jst = j_xlstm.mlstm_state_init(jcfg, B)
    st = xlstm.mlstm_state_init(tcfg, B)
    for t in range(6):
        jy, jst = _jit(j_xlstm.mlstm_decode, jcfg)(
            jp, jnp.asarray(x[:, t:t + 1]), jst)
        y, st = xlstm.mlstm_decode(tcfg, tp, _t(x[:, t:t + 1]), st)
        _close(y, jy, 1e-5)
        _close(st["C"], jst["C"], 1e-5)
        _close(y, full[:, t:t + 1], 1e-4)


def test_mlstm_extreme_gates_stay_finite_and_match():
    jcfg, tcfg = _cfgs(chunk=8)
    jp, tp = _params("mlstm", jcfg)
    x = _x(scale=50.0)
    jy, _ = _jit(j_xlstm.mlstm_forward, jcfg)(jp, jnp.asarray(x))
    y, st = xlstm.mlstm_forward(tcfg, tp, _t(x))
    assert bool(torch.isfinite(y).all()) and all(
        bool(torch.isfinite(v).all()) for v in st.values())
    _close(y, jy, 1e-4)


def test_slstm_forward_and_decode_match_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _params("slstm", jcfg)
    x = _x()
    jy, jst = _jit(j_xlstm.slstm_forward, jcfg)(jp, jnp.asarray(x))
    y, st = xlstm.slstm_forward(tcfg, tp, _t(x))
    _close(y, jy, 1e-5)
    for k in ("c", "n", "h", "m"):
        _close(st[k], jst[k], 1e-5)
    jst = j_xlstm.slstm_state_init(jcfg, B)
    st = xlstm.slstm_state_init(tcfg, B)
    for t in range(4):
        jd, jst = _jit(j_xlstm.slstm_decode, jcfg)(
            jp, jnp.asarray(x[:, t:t + 1]), jst)
        d, st = xlstm.slstm_decode(tcfg, tp, _t(x[:, t:t + 1]), st)
        _close(d, jd, 1e-5)
        _close(d, y[:, t:t + 1], 1e-5)


def test_slstm_ffn_gelu_is_the_tanh_form(monkeypatch):
    """The FFN's GELU is ``jax.nn.gelu``'s default, the tanh
    approximation: the block's output moves if the erf form is put in."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params("slstm", jcfg)
    x = _t(_x())
    y, _ = xlstm.slstm_forward(tcfg, tp, x)
    jy, _ = _jit(j_xlstm.slstm_forward, jcfg)(jp, jnp.asarray(x.numpy()))
    _close(y, jy, 1e-5)
    exact = F.gelu
    monkeypatch.setattr(F, "gelu", lambda u, approximate="none": exact(u))
    y_erf, _ = xlstm.slstm_forward(tcfg, tp, x)
    assert float((y_erf - y).abs().max()) > 1e-4 * float(y.abs().max())


def _loss_w(seed=3):
    d = get_config(ARCH, smoke=True).d_model
    return np.random.RandomState(seed).randn(B, S, d).astype(np.float32)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_gradients_match_jax_grad(kind):
    jcfg, tcfg = _cfgs(chunk=8)
    jp, tp = _params(kind, jcfg)
    x, w = _x(), _loss_w()
    j_fwd = {"mlstm": j_xlstm.mlstm_forward,
             "slstm": j_xlstm.slstm_forward}[kind]
    t_fwd = {"mlstm": xlstm.mlstm_forward,
             "slstm": xlstm.slstm_forward}[kind]

    def j_loss(p, xx):
        return jnp.sum(j_fwd(jcfg, p, xx)[0] * w)

    jg_p, jg_x = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jp,
                                                           jnp.asarray(x))

    def t_loss(p, xx):
        return (t_fwd(tcfg, p, xx)[0] * _t(w)).sum()

    tg_p, tg_x = grad(t_loss, argnums=(0, 1))(tp, _t(x))
    _close(tg_x, jg_x, 1e-4)
    want = convert.params_from_jax(jax.tree.map(np.asarray, jg_p))
    for got, ref in zip(utils.tree_leaves(tg_p), utils.tree_leaves(want)):
        assert torch.isfinite(got).all()
        _close(got, ref.numpy(), 1e-4)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_vmap_over_three_clients_equals_a_loop(kind):
    jcfg, tcfg = _cfgs(chunk=8)
    _, tp = _params(kind, jcfg)
    fwd = {"mlstm": xlstm.mlstm_forward, "slstm": xlstm.slstm_forward}[kind]
    xs = _t(np.stack([_x(seed=10 + i) for i in range(3)]))

    def loss(p, xx):
        return (fwd(tcfg, p, xx)[0] ** 2).mean()

    batched = vmap(grad(loss), in_dims=(None, 0))(tp, xs)
    for i in range(3):
        one = grad(loss)(tp, xs[i])
        for a, b in zip(utils.tree_leaves(batched), utils.tree_leaves(one)):
            _close(a[i], b.numpy(), 1e-5)


def test_bf16_gap_of_the_full_depth_tower_is_the_references():
    """The tower at full depth (12 superblocks) and width 128, from one
    set of bf16 weights drawn by the reference (tests/_torch_xlstm_bf16.py),
    two seeds: in f32 the port's logits meet the reference's within 1e-3
    of the largest; in bf16 each package departs from its own f32
    forward by far more (over 100x that distance), and the port's gap is
    the reference's within a factor of 2 (bf16 rounding of this tower,
    the same in both frameworks)."""
    g = xlstm_bf16.gaps(seeds=(0, 1))
    assert g["layers"] == get_config(ARCH).num_layers
    for ref, port, f32 in zip(g["reference_bf16_gap"], g["port_bf16_gap"],
                              g["f32_across"]):
        assert f32 <= 1e-3
        assert min(ref, port) > 100 * f32
        assert 0.5 <= port / ref <= 2.0
