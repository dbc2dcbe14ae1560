"""Server-side model update strategies (the FedAvg delegate and the
adaptive FedOpt family: FedAvgM / FedAdagrad / FedAdam / FedYogi) and
drift-corrected local training (FedProx, SCAFFOLD control variates)."""
from repro_torch.server.drift import (  # noqa: F401
    ScaffoldState, scaffold_apply_round, scaffold_corrections, scaffold_init,
    scaffold_new_slot_variates)
from repro_torch.server.optimizers import (  # noqa: F401
    fedadagrad, fedadam, fedavgm, fedyogi)
from repro_torch.server.update import (  # noqa: F401
    SERVER_UPDATES, ServerUpdate, as_server_update, get_server_update)
