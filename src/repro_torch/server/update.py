"""ServerUpdate — the server-side model update of a federated round.

Every strategy applies the FedOpt step, whose pseudo-gradient is
``-avg_delta``. Strategy names (``get_server_update``):

  fedavg_sgd  — delegate to the provided base optimizer (or plain
                ``sgd(server_lr)``); the paper's/FedAvg's server step.
  fedavgm     — server heavy-ball momentum (Hsu et al. 2019).
  fedadagrad  — Reddi et al.'s adaptive server rules with ``tau``
  fedadam       adaptivity; see :mod:`repro_torch.server.optimizers`.
  fedyogi
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch import utils
from repro_torch.optim import optimizers as opt_lib
from repro_torch.optim.optimizers import Optimizer
from repro_torch.server import optimizers as srv_opt

SERVER_UPDATES = ("fedavg_sgd", "fedavgm", "fedadagrad", "fedadam", "fedyogi")


@dataclasses.dataclass(frozen=True)
class ServerUpdate:
    """A named server optimization strategy over pseudo-gradients."""
    opt: Optimizer
    name: str = "fedavg_sgd"

    def init(self, params) -> Any:
        return self.opt.init(params)

    def step(self, params, opt_state, avg_delta):
        """One server step from the aggregated client delta; returns
        ``(params, opt_state)``."""
        pseudo_grad = utils.tree_scale(avg_delta, -1.0)
        updates, opt_state = self.opt.update(pseudo_grad, opt_state, params)
        return opt_lib.apply_updates(params, updates), opt_state

    def __repr__(self) -> str:
        return f"ServerUpdate({self.name!r})"


def as_server_update(obj) -> ServerUpdate:
    """An Optimizer becomes the fedavg_sgd delegate; a ServerUpdate passes
    through."""
    if isinstance(obj, ServerUpdate):
        return obj
    if isinstance(obj, Optimizer):
        return ServerUpdate(obj, "fedavg_sgd")
    raise TypeError(f"expected Optimizer or ServerUpdate, got {type(obj)!r}")


def get_server_update(name: str, *, base_opt: Optional[Optimizer] = None,
                      server_lr=None, momentum: float = 0.9,
                      b1: float = 0.9, b2: float = 0.99,
                      tau: float = 1e-3) -> ServerUpdate:
    """Build a named strategy.

    ``fedavg_sgd`` uses ``base_opt`` when given, else plain SGD at
    ``server_lr``. The adaptive strategies ignore ``base_opt`` and need
    ``server_lr`` (a float or a schedule).
    """
    if name not in SERVER_UPDATES:
        raise ValueError(f"unknown server update {name!r}; "
                         f"expected one of {SERVER_UPDATES}")
    if name == "fedavg_sgd":
        if base_opt is None:
            if server_lr is None:
                raise ValueError("fedavg_sgd needs base_opt or server_lr")
            base_opt = opt_lib.sgd(server_lr)
        return ServerUpdate(base_opt, name)
    if server_lr is None:
        raise ValueError(f"{name} needs server_lr")
    if name == "fedavgm":
        opt = srv_opt.fedavgm(server_lr, momentum=momentum)
    elif name == "fedadagrad":
        opt = srv_opt.fedadagrad(server_lr, b1=0.0, tau=tau)
    elif name == "fedadam":
        opt = srv_opt.fedadam(server_lr, b1=b1, b2=b2, tau=tau)
    else:  # fedyogi
        opt = srv_opt.fedyogi(server_lr, b1=b1, b2=b2, tau=tau)
    return ServerUpdate(opt, name)
