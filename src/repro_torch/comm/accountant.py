"""zCDP privacy accountant for the Gaussian aggregation mechanism.

One noised aggregate with noise multiplier sigma (noise std = sigma * Delta
for L2 sensitivity Delta) is rho = 1/(2 sigma^2) zero-concentrated DP
(Bun & Steinke 2016). zCDP composes additively across rounds, and converts
to (epsilon, delta)-DP via

    epsilon(delta) = rho + 2 * sqrt(rho * ln(1/delta)).

This is the standard tight-enough accountant for repeated Gaussian
releases without subsampling amplification; it is deliberately
conservative for sampled cohorts (amplification by cohort subsampling
would only lower epsilon). Host-side bookkeeping only: the engine
advances the accountant once per completed run
(`Channel.finalize_rounds`). A copy of the reference's
`repro/comm/accountant.py`, which the port does not import.
"""
from __future__ import annotations

import math


def gaussian_rho_per_step(noise_multiplier: float) -> float:
    """zCDP cost of one Gaussian release at the given noise multiplier."""
    if noise_multiplier <= 0:
        return math.inf
    return 1.0 / (2.0 * noise_multiplier ** 2)


def zcdp_to_epsilon(rho: float, delta: float) -> float:
    """Convert accumulated zCDP rho to epsilon at the given delta."""
    if rho == 0:
        return 0.0
    if not math.isfinite(rho):
        return math.inf
    return rho + 2.0 * math.sqrt(rho * math.log(1.0 / delta))


class GaussianAccountant:
    """Counts Gaussian-mechanism invocations; reports (epsilon, delta)."""

    def __init__(self, noise_multiplier: float, delta: float = 1e-5):
        self.noise_multiplier = float(noise_multiplier)
        self.delta = float(delta)
        self.steps = 0

    def step(self, n: int = 1) -> None:
        self.steps += int(n)

    @property
    def rho(self) -> float:
        return self.steps * gaussian_rho_per_step(self.noise_multiplier)

    def epsilon(self, delta: float = None) -> float:
        return zcdp_to_epsilon(self.rho,
                               self.delta if delta is None else delta)

    def __repr__(self) -> str:
        return (f"GaussianAccountant(sigma={self.noise_multiplier}, "
                f"steps={self.steps}, eps={self.epsilon():.3f} "
                f"@ delta={self.delta})")
