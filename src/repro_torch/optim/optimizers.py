"""Minimal functional optimizers: SGD, Adam, LARS.

Interface mirrors the reference (and optax): ``opt.init(params) -> state``;
``opt.update(grads, state, params) -> (updates, state)``; apply with
``apply_updates``. Parameters, gradients and state are trees of tensors;
all state is f32 and lives on the parameters' device (the step counter
too, so a schedule never waits for the host). The *server* optimizer
consumes pseudo-gradients (negative average client deltas), per FedOpt.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.utils import tree_leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Any]   # (grads, state, params) -> (updates, state)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.to(F32) + u.to(F32)).to(p.dtype),
                    params, updates)


def _sched(lr):
    return lr if callable(lr) else (lambda step: lr)


def _step0(params):
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _zeros(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                          device=p.device), params)


def sgd(lr, momentum: float = 0.0, weight_decay: float = 0.0) -> Optimizer:
    lr_fn = _sched(lr)

    def init(params):
        state = {"step": _step0(params)}
        if momentum:
            state["mu"] = _zeros(params)
        return state

    def update(grads, state, params=None):
        step = state["step"]
        g = tree_map(lambda x: x.to(F32), grads)
        if weight_decay and params is not None:
            g = tree_map(lambda gi, p: gi + weight_decay * p.to(F32), g, params)
        if momentum:
            mu = tree_map(lambda m, gi: momentum * m + gi, state["mu"], g)
            g = mu
            new_state = {"step": step + 1, "mu": mu}
        else:
            new_state = {"step": step + 1}
        lr_t = lr_fn(step)
        return tree_map(lambda gi: -lr_t * gi, g), new_state

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    lr_fn = _sched(lr)

    def init(params):
        return {"step": _step0(params), "m": _zeros(params),
                "v": _zeros(params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        g = tree_map(lambda x: x.to(F32), grads)
        m = tree_map(lambda mi, gi: b1 * mi + (1 - b1) * gi, state["m"], g)
        v = tree_map(lambda vi, gi: b2 * vi + (1 - b2) * gi * gi,
                     state["v"], g)
        bc1 = 1 - b1 ** step.to(F32)
        bc2 = 1 - b2 ** step.to(F32)
        lr_t = lr_fn(state["step"])

        def upd(mi, vi, p):
            u = (mi / bc1) / (torch.sqrt(vi / bc2) + eps)
            if weight_decay and p is not None:
                u = u + weight_decay * p.to(F32)
            return -lr_t * u

        if params is not None:
            updates = tree_map(upd, m, v, params)
        else:
            updates = tree_map(lambda mi, vi: upd(mi, vi, None), m, v)
        return updates, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def lars(lr, momentum: float = 0.9, weight_decay: float = 0.0,
         trust_coefficient: float = 0.001, eps: float = 1e-8) -> Optimizer:
    """LARS (You et al. 2017) — the paper's server optimizer for DERM."""
    lr_fn = _sched(lr)

    def init(params):
        return {"step": _step0(params), "mu": _zeros(params)}

    def update(grads, state, params):
        step = state["step"]
        lr_t = lr_fn(step)

        def upd(g, p, mu):
            g = g.to(F32)
            pf = p.to(F32)
            if weight_decay:
                g = g + weight_decay * pf
            p_norm = torch.linalg.vector_norm(pf)
            g_norm = torch.linalg.vector_norm(g)
            trust = torch.where((p_norm > 0) & (g_norm > 0),
                                trust_coefficient * p_norm / (g_norm + eps),
                                torch.ones_like(p_norm))
            return momentum * mu + trust * g

        mu = tree_map(upd, grads, params, state["mu"])
        return tree_map(lambda m: -lr_t * m, mu), {"step": step + 1, "mu": mu}

    return Optimizer(init, update)


def get_optimizer(name: str, lr, **kw) -> Optimizer:
    return {"sgd": sgd, "adam": adam, "lars": lars}[name](lr, **kw)
