from repro_torch.objectives.base import Stats, StatsObjective  # noqa: F401
from repro_torch.objectives.standard import CCOObjective  # noqa: F401

# CLI-facing registry; factories take the objective's hyperparameters
_REGISTRY = {"dcco": CCOObjective}

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
    if objective in ("dvicreg", "dwmse"):
        raise NotImplementedError(
            f"objective {objective!r} needs the 'full' moment set, not "
            f"ported yet (ROADMAP §1, 'The \"full\" moment set')")
    raise ValueError(f"unknown objective {objective!r}; expected one of "
                     f"{OBJECTIVES} or a StatsObjective instance")
