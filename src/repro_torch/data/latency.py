"""Per-client arrival-latency models for the semi-synchronous engine.

The sync ``RoundEngine`` blocks every round on its whole cohort, so one
straggler stalls the fleet. The buffered engine (``EngineConfig.async_k``,
:mod:`repro_torch.core.buffer`) instead lets each dispatched client's
contribution "arrive" ``delay`` scheduler ticks after dispatch. This module
owns that delay model:

  * :class:`LatencyModel`: a small static spec (kind, ring horizon,
    heavy-tail severity, per-client seed);
  * :func:`sample_delays`: integer delays in ``[0, horizon)`` for a cohort
    of client ids. The ``heavytail`` kind gives every client a PERSISTENT
    Pareto-distributed base latency (a slow client is slow every round),
    from a counter-based generator keyed on ``(seed, client id)``: a hash
    computed on the device, so the ids never leave it and the draw does
    not depend on the round;
  * :func:`make_async_sampler`: wraps a plain ``sampler(gen) -> (batch,
    sizes)`` into the async 3-tuple form ``(batch, sizes, delays)``. The
    delays draw from a generator of their own, seeded
    ``utils.fold_in(gen.initial_seed(), _LATENCY_SALT)``, so cohort
    selection and augmentation are the synchronous sampler's own: a
    zero-latency async run sees exactly the sync engine's cohorts.

JAX's and torch's generators never agree, so the port's delays are not
the reference's; the tests hold both to the model's laws and feed the
reference's delays where they compare a tick.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import utils

LATENCY_KINDS = ("zero", "uniform", "heavytail")

_LATENCY_SALT = 0x1A7    # fold_in salt off the round seed -> delay stream
_CLIENT_SALT = 0xC1D     # fold_in salt off LatencyModel.seed -> base latency
_M32 = 0xFFFFFFFF


class LatencyModel(NamedTuple):
    """Static arrival-delay spec for the buffered engine.

    kind: "zero" (every contribution arrives the tick it was dispatched),
    "uniform" (iid delays in [0, horizon)), or "heavytail" (persistent
    per-client Pareto base latency, severity ``tail``). ``horizon`` bounds
    the in-flight ring depth: delays are clipped to ``horizon - 1``.
    """
    kind: str = "zero"
    horizon: int = 1
    tail: float = 0.7       # Pareto exponent multiplier (heavytail only)
    seed: int = 0           # per-client base-latency stream (heavytail only)


def resolve_latency(spec) -> LatencyModel:
    """Coerce None / kind-name / LatencyModel into a validated model."""
    if spec is None:
        spec = LatencyModel()
    elif isinstance(spec, str):
        defaults = {"zero": LatencyModel(),
                    "uniform": LatencyModel("uniform", horizon=4),
                    "heavytail": LatencyModel("heavytail", horizon=8)}
        if spec not in defaults:
            raise ValueError(f"unknown latency kind {spec!r}; "
                             f"expected one of {LATENCY_KINDS}")
        spec = defaults[spec]
    if not isinstance(spec, LatencyModel):
        raise ValueError(f"latency spec must be None, a kind name, or a "
                         f"LatencyModel, got {type(spec).__name__}")
    if spec.kind not in LATENCY_KINDS:
        raise ValueError(f"unknown latency kind {spec.kind!r}; "
                         f"expected one of {LATENCY_KINDS}")
    if spec.horizon < 1:
        raise ValueError(f"latency horizon must be >= 1, got {spec.horizon}")
    if spec.kind == "heavytail" and spec.tail <= 0:
        raise ValueError(f"heavytail severity must be > 0, got {spec.tail}")
    return spec


def client_uniforms(seed: int, client_ids) -> torch.Tensor:
    """(K,) f32 uniforms in [1e-6, 1), one per client id and the same in
    every round: a 32-bit integer hash of ``(seed, id)`` (two
    multiply-xorshift rounds), in int64 tensor arithmetic that never
    overflows, on the ids' device."""
    x = (client_ids.to(torch.int64) * 0x9E3779B1
         + (utils.fold_in(seed, _CLIENT_SALT) & _M32)) & _M32
    for _ in range(2):
        x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    x = (x >> 16) ^ x
    u = (x >> 8).to(torch.float32) * (1.0 / (1 << 24))          # [0, 1)
    return 1e-6 + u * (1.0 - 1e-6)


def sample_delays(model: LatencyModel, seed: int, client_ids) -> torch.Tensor:
    """Integer arrival delays in ``[0, model.horizon)`` for one cohort.

    ``seed`` is the round's delay seed (used by round-varying kinds);
    ``client_ids`` (K,) int are the sampled clients: the heavytail kind
    derives each client's PERSISTENT base latency from them, so the same
    client is slow in every round it is dispatched."""
    k, device = client_ids.shape[0], client_ids.device
    if model.kind == "zero":
        return torch.zeros((k,), dtype=torch.int32, device=device)
    if model.kind == "uniform":
        return torch.randint(0, model.horizon, (k,), dtype=torch.int32,
                             device=device,
                             generator=utils.generator(seed, device))
    u = client_uniforms(model.seed, client_ids)
    # Pareto-tail base latency: u^(-tail) - 1 is 0 for most clients and
    # large for a heavy few; floor to ticks, clip to the ring horizon
    d = torch.floor(u ** (-model.tail) - 1.0)
    return torch.clamp(d, 0, model.horizon - 1).to(torch.int32)


def delay_seed(gen: torch.Generator) -> int:
    """The delay stream's seed of a round whose sampler draws from
    ``gen``: a fold_in off its seed, so ``gen``'s own stream is untouched."""
    return utils.fold_in(gen.initial_seed(), _LATENCY_SALT)


def make_async_sampler(base_sampler, model, clients_per_round: int):
    """Wrap a plain round sampler into the async ``(batch, sizes, delays)``
    contract the buffered engine expects. Delays key off the cohort SLOT
    index (0..K-1), not true client ids; use
    ``FederatedDataset.make_async_round_sampler`` for persistent
    per-client stragglers. This wrapper is for fixed-data samplers."""
    model = resolve_latency(model)

    def sampler(gen):
        batch, sizes = base_sampler(gen)
        slots = torch.arange(clients_per_round, dtype=torch.int32,
                             device=sizes.device)
        return batch, sizes, sample_delays(model, delay_seed(gen), slots)

    sampler.latency = model
    sampler.clients_per_round = clients_per_round
    return sampler
