"""Server-side model update strategies: the FedAvg delegate and the
adaptive FedOpt family (FedAvgM / FedAdagrad / FedAdam / FedYogi)."""
from repro_torch.server.optimizers import (  # noqa: F401
    fedadagrad, fedadam, fedavgm, fedyogi)
from repro_torch.server.update import (  # noqa: F401
    SERVER_UPDATES, ServerUpdate, as_server_update, get_server_update)
