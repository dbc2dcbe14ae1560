from repro_torch.objectives.base import (  # noqa: F401
    Stats, StatsObjective, make_shard_map_loss, per_client_loss)
from repro_torch.objectives.standard import (  # noqa: F401
    CCOObjective, VicRegObjective, WMSEObjective)

# CLI-facing registry; factories take the objective's hyperparameters
_REGISTRY = {
    "dcco": CCOObjective,
    "dvicreg": VicRegObjective,
    "dwmse": WMSEObjective,
}

OBJECTIVES = tuple(_REGISTRY)


def get_objective(objective, **hyper) -> StatsObjective:
    """Resolve a name (or pass through an instance) to a StatsObjective."""
    if isinstance(objective, StatsObjective):
        if hyper:
            raise ValueError(
                f"hyperparameters {sorted(hyper)} cannot be applied to an "
                f"already-constructed objective {objective!r}")
        return objective
    if objective in _REGISTRY:
        return _REGISTRY[objective](**hyper)
    raise ValueError(f"unknown objective {objective!r}; expected one of "
                     f"{OBJECTIVES} or a StatsObjective instance")
