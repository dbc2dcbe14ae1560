"""ServerUpdate — the server-side model update of a federated round.

The ``fedavg_sgd`` strategy wraps a :class:`repro_torch.optim.Optimizer`
and applies the FedOpt step: the pseudo-gradient is ``-avg_delta``. The
adaptive strategies (fedavgm, fedadagrad, fedadam, fedyogi) are not
ported yet (ROADMAP §1, "Client drift and server strategies").
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch import utils
from repro_torch.optim import optimizers as opt_lib
from repro_torch.optim.optimizers import Optimizer

SERVER_UPDATES = ("fedavg_sgd",)


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
                      server_lr=None) -> ServerUpdate:
    """Build a named strategy: ``fedavg_sgd`` uses ``base_opt`` when given,
    else plain SGD at ``server_lr``."""
    if name != "fedavg_sgd":
        raise NotImplementedError(
            f"server update {name!r} is not ported yet (ROADMAP §1, "
            f"'Client drift and server strategies'); the port has "
            f"{SERVER_UPDATES}")
    if base_opt is None:
        if server_lr is None:
            raise ValueError("fedavg_sgd needs base_opt or server_lr")
        base_opt = opt_lib.sgd(server_lr)
    return ServerUpdate(base_opt, name)
