"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
``repro/models/moe.py``, on the CPU.

Inputs come from numpy with a seed; the parameters are the reference's,
carried over by ``convert``. The routing is exact on both sides (the same
f32 softmax, top-k and cumsum over 0/1 values), so the dropped share is
held equal and the other aux values to rtol 1e-6 (f32 means over the
same values, summed in other orders). The output: 1e-5 of its largest
magnitude (f32 expert products of 256-wide rows, summed in other
orders; measured ~1e-7). Gradients: 1e-4 of each leaf's largest
magnitude (f32 backward passes of two frameworks). ``vmap`` against a
per-client loop within the port: 1e-5, the same arithmetic batched or
not.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.configs.base import get_config as j_get_config
from repro.models import moe as j_moe
from repro_torch import convert, utils
from repro_torch.models import moe
from repro_torch.models.common import swiglu

torch.set_num_threads(1)

BASE = j_get_config("deepseek-moe-16b", smoke=True).moe   # E 4, k 2
WIDE = dataclasses.replace(BASE, num_experts=8, top_k=3)
D = 256


# the reference jitted (its eager dispatch compiles op by op)
_j_forward = jax.jit(j_moe.moe_forward, static_argnums=(2, 3))


@functools.lru_cache(maxsize=None)
def _j_init(mcfg, seed):
    return jax.jit(j_moe.moe_init, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(seed), D, mcfg, jnp.float32)


def _setup(mcfg, b=2, s=16, seed=0):
    jp = jax.tree.map(lambda a: a, _j_init(mcfg, seed))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    x = np.random.RandomState(seed).randn(b, s, D).astype(np.float32)
    return jp, tp, x


def _both(jp, tp, x, mcfg, group_size):
    y, aux = _j_forward(jp, jnp.asarray(x), mcfg, group_size)
    ty, taux = moe.moe_forward(tp, torch.from_numpy(x), mcfg,
                               group_size=group_size)
    return np.asarray(y), aux, ty.numpy(), taux


def _assert_same(y, aux, ty, taux):
    np.testing.assert_allclose(ty, y, rtol=0,
                               atol=1e-5 * float(np.abs(y).max()))
    assert set(taux) == set(aux) == {"balance", "router_z", "dropped_frac"}
    assert float(taux["dropped_frac"]) == pytest.approx(
        float(aux["dropped_frac"]), abs=1e-7)
    for key in ("balance", "router_z"):
        np.testing.assert_allclose(float(taux[key]), float(aux[key]),
                                   rtol=1e-6)


@pytest.mark.parametrize("experts,factor,group_size", [
    ("e4k2", 1.5, 512),          # the smoke config's factor, one group
    ("e4k2", 1e-6, 512),         # capacity 1: most choices dropped
    ("e4k2", 1.0, 2),            # groups of 2, capacity 1: drops
    ("e4k2", 8.0, 32), ("e4k2", 8.0, 4), ("e4k2", 8.0, 1),  # no drops
    ("e8k3", 1.5, 512), ("e8k3", 1.0, 2), ("e8k3", 8.0, 8),
])
def test_moe_forward_matches_reference(experts, factor, group_size):
    mcfg = dataclasses.replace({"e4k2": BASE, "e8k3": WIDE}[experts],
                               capacity_factor=factor)
    jp, tp, x = _setup(mcfg)
    y, aux, ty, taux = _both(jp, tp, x, mcfg, group_size)
    _assert_same(y, aux, ty, taux)
    if factor == 1e-6 or group_size == 2:
        assert float(taux["dropped_frac"]) > 0.0
    if factor == 8.0:
        assert float(taux["dropped_frac"]) == 0.0


def test_drop_order_is_token_major_then_rank():
    """Every token routes alike (equal rows), so each expert's queue is
    long; the reference flattens (s, k) before its cumsum, so the first
    tokens keep their picks and later ones lose them whatever their
    rank."""
    mcfg = dataclasses.replace(BASE, capacity_factor=1.0)
    jp, tp, _ = _setup(mcfg)
    row = np.random.RandomState(5).randn(1, 1, D).astype(np.float32)
    x = np.repeat(row, 8, axis=1)
    y, aux, ty, taux = _both(jp, tp, x, mcfg, 8)
    _assert_same(y, aux, ty, taux)
    # capacity ceil(8 * 2 / 4 * 1) = 4: tokens 0-3 keep both picks,
    # tokens 4-7 keep none (their routed output is 0, the shared stays)
    shared = swiglu(tp["shared"], torch.from_numpy(x)).numpy()
    assert np.abs(ty[0, 4:] - shared[0, 4:]).max() == 0.0
    assert np.abs(ty[0, :4] - shared[0, :4]).max() > 0.0
    assert float(taux["dropped_frac"]) == pytest.approx(0.5)


def test_ties_pick_the_lowest_index_first():
    """A zero router gives every expert the same probability: both pick
    experts 0 .. k-1 in order, as ``jax.lax.top_k`` does."""
    jp, tp, x = _setup(WIDE)
    jp["router"]["w"] = jnp.zeros_like(jp["router"]["w"])
    tp["router"]["w"] = torch.zeros_like(tp["router"]["w"])
    with moe.record_routes() as routes:
        y, aux, ty, taux = _both(jp, tp, x, WIDE, 512)
    _assert_same(y, aux, ty, taux)
    assert len(routes) == 1 and routes[0].shape == (2, 16, 3)
    assert torch.equal(routes[0], torch.arange(3).expand(2, 16, 3))
    _, idx = jax.lax.top_k(jnp.full((4, 8), 0.125), 3)
    assert np.array_equal(np.asarray(idx), np.tile(np.arange(3), (4, 1)))


def test_group_size_must_divide_the_tokens():
    jp, tp, x = _setup(BASE, b=3, s=10)         # 30 tokens, groups of 16
    with pytest.raises(AssertionError):
        j_moe.moe_forward(jp, jnp.asarray(x), BASE, group_size=16)
    with pytest.raises(ValueError, match="not divisible by group 16"):
        moe.moe_forward(tp, torch.from_numpy(x), BASE, group_size=16)


def _loss_weights(shape, seed=9):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_router_and_expert_gradients_match_jax_grad():
    """d/dparams of sum(w * y) + balance + router_z (with drops), against
    ``jax.grad``: the router through the renormalised weights and both
    aux terms, the experts and the shared expert through the products."""
    mcfg = dataclasses.replace(WIDE, capacity_factor=1.0)
    jp, tp, x = _setup(mcfg, s=12)
    w = _loss_weights(x.shape)

    def j_loss(p):
        y, aux = j_moe.moe_forward(p, jnp.asarray(x), mcfg, group_size=8)
        return (y * w).sum() + aux["balance"] + aux["router_z"]

    def t_loss(p):
        y, aux = moe.moe_forward(p, torch.from_numpy(x), mcfg, group_size=8)
        return (y * torch.from_numpy(w)).sum() + aux["balance"] \
            + aux["router_z"]

    want = convert.params_from_jax(jax.tree.map(
        np.asarray, jax.jit(jax.grad(j_loss))(jp)))
    got = grad(t_loss)(tp)
    for key in ("router", "experts", "shared"):
        for name in want[key]:
            a, b = got[key][name], want[key][name]
            if isinstance(a, dict):
                a, b = a["w"], b["w"]
            scale = float(b.abs().max())
            assert scale > 0, (key, name)
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * scale)


def test_vmap_over_three_clients_matches_a_loop():
    """Phase 2's ``vmap(grad)`` over clients: one-hots by comparison and
    the stable sort batch, and give each client's own gradient."""
    mcfg = dataclasses.replace(BASE, capacity_factor=1.0)
    _, tp, _ = _setup(mcfg)
    xs = torch.from_numpy(
        np.random.RandomState(4).randn(3, 2, 8, D).astype(np.float32))

    def loss(p, x):
        y, aux = moe.moe_forward(p, x, mcfg)
        return (y ** 2).mean() + aux["balance"] + 1e-4 * aux["router_z"]

    batched = vmap(grad(loss), in_dims=(None, 0))(tp, xs)
    for i in range(3):
        one = grad(loss)(tp, xs[i])
        for a, b in zip(utils.tree_leaves(batched), utils.tree_leaves(one)):
            torch.testing.assert_close(a[i], b, rtol=1e-5, atol=1e-6)


def test_forced_routes_replay_and_override_the_picks():
    """``force_routes`` with the recorded picks gives the same output bit
    for bit; other picks give another output, with those picks
    recorded."""
    mcfg = dataclasses.replace(WIDE, capacity_factor=2.0)
    _, tp, x = _setup(mcfg)
    x = torch.from_numpy(x)
    with moe.record_routes() as routes:
        y, _ = moe.moe_forward(tp, x, mcfg)
    with moe.force_routes(routes), moe.record_routes() as again:
        y2, _ = moe.moe_forward(tp, x, mcfg)
    assert torch.equal(y, y2) and torch.equal(again[0], routes[0])
    other = (routes[0] + 1) % WIDE.num_experts
    with moe.force_routes([other]), moe.record_routes() as seen:
        y3, _ = moe.moe_forward(tp, x, mcfg)
    assert torch.equal(seen[0], other) and not torch.allclose(y3, y)
