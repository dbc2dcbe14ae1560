from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adam, apply_updates, get_optimizer, lars, sgd)
from repro_torch.optim.schedules import cosine_decay  # noqa: F401
