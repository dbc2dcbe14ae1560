"""Mixture-of-Experts FFN: a top-k router and capacity-based dispatch.

Port of ``repro/models/moe.py`` (DeepSeekMoE): ``num_shared_experts``
always-on experts fused into one wider SwiGLU, plus fine-grained routed
experts, top-k softmax gating with the weights renormalised over the
chosen experts. Tokens are split into groups of ``group_size``; each
group routes on its own into (experts, capacity) slots, every shape
static, as in the reference's GShard-style einsum dispatch. The
reference computes all of this outside any Pallas kernel, so the port's
torch ops are its counterpart.

Semantics kept from the reference, bit for bit where the arithmetic is
exact:
  * selection order: descending probability, the lowest expert index
    first on ties (``jax.lax.top_k``'s order);
  * queue order within an expert: token-major, then by rank k (the
    reference flattens (s, k) before its cumsum; its comment says "by k
    then s", its code does this), and a (token, rank) past the capacity
    is dropped;
  * ``dispatch = combine > 0``, so a kept token whose weight underflows
    to 0 is not sent (its contribution is 0 either way).
One-hots are comparisons against ``torch.arange`` (``F.one_hot`` checks
its indices' values, which ``torch.func.vmap`` refuses), and the k axis
of the reference's (G, S, K, E, C) one-hot is folded first: a token
picks an expert at most once, so each sum over k has one term.

:func:`record_routes` collects the experts each call picks and
:func:`force_routes` imposes picks on the calls, for checks that hold two
computations to each other: in bf16, rounding alone flips top-k picks
whose probabilities nearly tie, which moves a token's output by a whole
expert.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from repro_torch.models.common import F32, randn, swiglu, swiglu_init, \
    truncated_normal
from repro_torch.sharding import dtensor

_routes = None     # a list while record_routes() is open, else None
_forced = None     # an iterator while force_routes() is open, else None


@contextlib.contextmanager
def record_routes():
    """Within the block, every :func:`moe_forward` call appends its chosen
    experts, an int tensor (B, S, top_k) in selection order, to the list
    it yields."""
    global _routes
    prev, _routes = _routes, []
    try:
        yield _routes
    finally:
        _routes = prev


@contextlib.contextmanager
def force_routes(routes):
    """Within the block, the i-th :func:`moe_forward` call takes
    ``routes[i]`` (B, S, top_k), as :func:`record_routes` gives them, for
    its picks in place of its own top-k; their weights are still its own
    probabilities, renormalised over the picks."""
    global _forced
    prev, _forced = _forced, iter(routes)
    try:
        yield
    finally:
        _forced = prev


def moe_init(gen, d_model: int, moe_cfg, dtype, device="cpu"):
    e, dff = moe_cfg.num_experts, moe_cfg.d_ff
    std = 1.0 / math.sqrt(d_model)

    def experts(shape, scale):
        return (truncated_normal(gen, shape) * scale).to(device, dtype)

    p = {
        "router": {"w": (randn(gen, (d_model, e)) * std).to(device)},
        # stacked expert weights, leading dim = experts
        "experts": {
            "gate": experts((e, d_model, dff), std),
            "up": experts((e, d_model, dff), std),
            "down": experts((e, dff, d_model), 1.0 / math.sqrt(dff)),
        },
    }
    if moe_cfg.num_shared_experts > 0:
        p["shared"] = swiglu_init(gen, d_model,
                                  moe_cfg.num_shared_experts * dff, dtype,
                                  device)
    return p


def _capacity(tokens_per_group: int, moe_cfg) -> int:
    c = int(np.ceil(tokens_per_group * moe_cfg.top_k / moe_cfg.num_experts
                    * moe_cfg.capacity_factor))
    return max(c, 1)


def _top_k(probs, k: int):
    """The k largest of the last axis, descending, the lowest index first
    among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _group_size(x, group_size: int) -> int:
    t = x.shape[0] * x.shape[1]
    g_sz = min(group_size, t)
    if t % g_sz:
        raise ValueError(f"tokens {t} not divisible by group {g_sz}")
    return g_sz


def moe_forward(p, x, moe_cfg, group_size: int = 512):
    """x: (B, S, D) -> (y (B, S, D), aux) with aux the f32 scalars
    ``balance`` (the load-balance loss), ``router_z`` (the router
    z-loss) and ``dropped_frac`` (the share of (token, rank) choices
    past their expert's capacity).

    The B*S tokens are cut into groups of ``min(group_size, B*S)``, which
    must divide B*S (a ValueError, where the reference asserts). On
    DTensors, :func:`_moe_spmd`."""
    g_sz = _group_size(x, group_size)
    if dtensor.is_dtensor(x):
        return _moe_spmd(p, x, moe_cfg, g_sz)
    b, s, d = x.shape
    e, k = moe_cfg.num_experts, moe_cfg.top_k
    xt = x.reshape(b * s // g_sz, g_sz, d)
    logits, probs, sel, keep, combine = _route(p, xt, moe_cfg, b, s)
    y = _experts(p["experts"], combine, xt).to(x.dtype).reshape(b, s, d)

    if "shared" in p:
        y = y + swiglu(p["shared"], x)

    # aux losses: load balance (Shazeer/GShard) + router z-loss
    me = probs.mean(dim=(0, 1))                                # mean prob
    ce = sel.sum(2).mean(dim=(0, 1))                           # routed share
    balance = e * (me * ce).sum() / k
    z = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    aux = {"balance": balance, "router_z": z,
           "dropped_frac": 1.0 - keep.sum() / (sel.sum() + 1e-9)}
    return y, aux


def _route(p, xt, moe_cfg, b: int, s: int):
    """Routing of the token groups ``xt`` (G, S_g, D) over all experts:
    (router logits, probs, the one-hot picks (G, S_g, K, E), the kept
    picks, the combine weights (G, S_g, E, C)), f32 (f64 for an f64
    model)."""
    g, g_sz, _ = xt.shape
    e, k = moe_cfg.num_experts, moe_cfg.top_k
    wide = torch.promote_types(xt.dtype, F32)
    x_device = xt.device

    logits = xt.to(wide) @ p["router"]["w"].to(wide)          # (G,S,E)
    probs = torch.softmax(logits, dim=-1)
    if _forced is not None:
        topk_idx = next(_forced).reshape(g, g_sz, k).to(x_device)
        topk_p = torch.gather(probs, -1, topk_idx)
    else:
        topk_p, topk_idx = _top_k(probs, k)                    # (G,S,K)
    if _routes is not None:
        _routes.append(topk_idx.reshape(b, s, k))
    topk_w = topk_p / torch.clamp(topk_p.sum(-1, keepdim=True), min=1e-9)

    cap = _capacity(g_sz, moe_cfg)
    experts = torch.arange(e, device=x_device)
    sel = (topk_idx[..., None] == experts).to(wide)            # (G,S,K,E)
    # position of each (token, k) in its expert's queue: token-major
    pos_in_e = torch.cumsum(sel.reshape(g, g_sz * k, e), dim=1).reshape(
        g, g_sz, k, e) - 1.0
    keep = (pos_in_e < cap).to(wide) * sel                     # drop overflow
    # fold k (one term each): the weight and the slot of each kept pick
    w_e = (topk_w[..., None] * keep).sum(2)                    # (G,S,E)
    pos_e = (pos_in_e * keep).sum(2)
    kept = keep.sum(2) > 0
    slots = torch.arange(cap, device=x_device, dtype=wide)
    combine = w_e[..., None] * ((pos_e[..., None] == slots)
                                & kept[..., None]).to(wide)    # (G,S,E,C)
    return logits, probs, sel, keep, combine


def _experts(we, combine, xt):
    """The experts of ``we`` (their leading dim matching ``combine``'s E)
    on the tokens ``combine`` sends them: (G, S_g, D) in the routing's
    wide type."""
    wide = combine.dtype
    dispatch = (combine > 0).to(xt.dtype)
    xe = torch.einsum("gsec,gsd->gecd", dispatch, xt)
    h = torch.einsum("gecd,edf->gecf", xe, we["gate"])
    u = torch.einsum("gecd,edf->gecf", xe, we["up"])
    h = (torch.nn.functional.silu(h.to(wide)) * u.to(wide)).to(xt.dtype)
    ye = torch.einsum("gecf,efd->gecd", h, we["down"])
    return torch.einsum("gsec,gecd->gsd", combine, ye.to(wide))


def _moe_spmd(p, x, moe_cfg, g_sz: int):
    """``moe_forward`` on DTensors, expert parallel under ``local_map``.

    Each rank routes its rows' groups over all experts (the router is
    replicated), sends the picks of its own block of experts (their
    leading dim as the layout rules shard it over "model") and returns
    its experts' share of the output, a partial sum over the mesh
    dimensions that split the experts; the rows are gathered over those
    dimensions, and over the rest too where a rank's rows would not hold
    whole groups (a decode step's B tokens are one group). The losses'
    sums come back as partial sums as well, each rank's 1/M of its own
    (M the ranks sharing its rows), so that both their values and their
    gradients sum to the whole batch's: the losses and ``dropped_frac``
    are the reference's, over the global batch."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    b, s, d = x.shape
    e, k = moe_cfg.num_experts, moe_cfg.top_k
    mesh = x.device_mesh
    ex = p["experts"]["gate"]
    ex_pl = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
             for pl in ex.placements]
    split = [isinstance(pl, Shard) for pl in ex_pl]
    rows = [Replicate() if split[i] else pl
            for i, pl in enumerate(dtensor.row_placements(x))]
    local_rows = b // math.prod(mesh.size(i) for i, pl in enumerate(rows)
                                if isinstance(pl, Shard))
    if local_rows * s % g_sz:
        rows = [Replicate()] * mesh.ndim
    m = math.prod(mesh.size(i) for i in range(mesh.ndim) if split[i])
    rep = [Replicate()] * mesh.ndim
    e_off = dtensor.offset(ex.redistribute(mesh, ex_pl), 0)
    e_local = e // m
    part = [Partial() if split[i] or isinstance(rows[i], Shard)
            else Replicate() for i in range(mesh.ndim)]
    y_pl = [Partial() if split[i] else rows[i] for i in range(mesh.ndim)]
    x_grad = y_pl
    ex_grad = [ex_pl[i] if split[i] else
               (Partial() if isinstance(rows[i], Shard) else Replicate())
               for i in range(mesh.ndim)]

    def local(xl, router, we):
        bl = xl.shape[0]
        xt = xl.reshape(bl * s // g_sz, g_sz, d)
        logits, probs, sel, keep, combine = _route(
            {"router": router}, xt, moe_cfg, bl, s)
        y = _experts(we, combine[:, :, e_off:e_off + e_local], xt)
        lse = torch.logsumexp(logits, dim=-1)
        return (y.reshape(bl, s, d), probs.sum(dim=(0, 1)) / m,
                sel.sum(2).sum(dim=(0, 1)) / m, (lse ** 2).sum() / m,
                keep.sum() / m, sel.sum() / m)

    y, probs_sum, sel_sum, z_sum, kept, picks = dtensor.local_map_tree(
        local, mesh,
        [(x, rows, x_grad), (p["router"], rep, part),
         (p["experts"], ex_pl, ex_grad)],
        [y_pl] + [part] * 5)
    if "shared" in p:
        y = y + swiglu(p["shared"], x)
    t = b * s
    balance = e * ((probs_sum / t) * (sel_sum / t)).sum() / k
    aux = {"balance": balance, "router_z": z_sum / t,
           "dropped_frac": 1.0 - kept / (picks + 1e-9)}
    return y, aux
