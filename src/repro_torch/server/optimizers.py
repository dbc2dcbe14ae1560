"""Adaptive federated *server* optimizers (FedOpt family, Reddi et al. 2021).

In FedOpt the server treats the negated weighted-average client delta as a
pseudo-gradient and feeds it to a first-order optimizer. Plain FedAvg is
SGD(lr=1) on that pseudo-gradient; this module adds FedAvgM / FedAdagrad /
FedAdam / FedYogi on the :class:`repro_torch.optim.Optimizer` contract
(``init``/``update`` returning additive updates applied by
``apply_updates``), so every round body consumes them like the optimizers
it already takes.

The adaptive rules keep per-parameter second moments ``v`` on the server
and damp the update by ``1/(sqrt(v) + tau)``; ``tau`` is Reddi et al.'s
adaptivity knob. There is no bias correction: ``m``/``v`` start at zero.
All state is f32 on the parameters' device, the step counter included.
"""
from __future__ import annotations

import torch

from repro_torch.optim import optimizers as opt_lib
from repro_torch.optim.optimizers import Optimizer
from repro_torch.utils import tree_map

F32 = torch.float32


def fedavgm(lr, momentum: float = 0.9) -> Optimizer:
    """FedAvgM (Hsu et al. 2019): heavy-ball momentum on the server, which
    is exactly ``repro_torch.optim.sgd(lr, momentum)``."""
    return opt_lib.sgd(lr, momentum=momentum)


def _fedopt(lr, b1: float, tau: float, v_update) -> Optimizer:
    """The adaptive family's shared step: server momentum ``m``, a
    per-variant second moment ``v`` (``v_update(v, g2) -> v``), and the
    ``m / (sqrt(v) + tau)`` preconditioned step."""
    lr_fn = opt_lib._sched(lr)

    def init(params):
        return {"step": opt_lib._step0(params), "m": opt_lib._zeros(params),
                "v": opt_lib._zeros(params)}

    def update(grads, state, params=None):
        g = tree_map(lambda x: x.to(F32), grads)
        m = tree_map(lambda mi, gi: b1 * mi + (1 - b1) * gi, state["m"], g)
        v = tree_map(lambda vi, gi: v_update(vi, gi * gi), state["v"], g)
        lr_t = lr_fn(state["step"])
        updates = tree_map(lambda mi, vi: -lr_t * mi / (torch.sqrt(vi) + tau),
                           m, v)
        return updates, {"step": state["step"] + 1, "m": m, "v": v}

    return Optimizer(init, update)


def fedadagrad(lr, b1: float = 0.0, tau: float = 1e-3) -> Optimizer:
    """FedAdagrad: ``v += g^2`` (monotone preconditioner)."""
    return _fedopt(lr, b1, tau, lambda v, g2: v + g2)


def fedadam(lr, b1: float = 0.9, b2: float = 0.99,
            tau: float = 1e-3) -> Optimizer:
    """FedAdam: EMA second moment ``v = b2*v + (1-b2)*g^2``."""
    return _fedopt(lr, b1, tau, lambda v, g2: b2 * v + (1 - b2) * g2)


def fedyogi(lr, b1: float = 0.9, b2: float = 0.99,
            tau: float = 1e-3) -> Optimizer:
    """FedYogi: additive second moment ``v = v - (1-b2) * g^2 *
    sign(v - g^2)``, which moves ``v`` toward ``g^2`` at a rate independent
    of its magnitude."""
    return _fedopt(lr, b1, tau,
                   lambda v, g2: v - (1 - b2) * g2 * torch.sign(v - g2))
