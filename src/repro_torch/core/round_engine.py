"""Federated round engine.

The reference compiles the multi-round loop into one ``lax.scan``; PyTorch
runs eagerly, so here it is a Python loop over rounds that never waits for
the host inside a segment: cohort sampling, augmentation, both phases, the
server step and the per-round metrics all stay on the device, and metrics
come back to the host once per segment of ``chunk_rounds`` rounds, where
``on_segment`` hooks in (evaluation, logging).

Round randomness: round ``r`` of a run seeded ``seed`` draws from a fresh
generator on the parameters' device seeded ``seed * 1_000_003 + r``, so
``start_round`` resumes the same stream. The sampler is injected —
``sampler(gen) -> (batch, sizes)`` — so a test can replay cohorts drawn by
the reference.

Phase-1 aggregate statistics go through the CUDA ``cco_stats`` kernel
when ``EngineConfig.stats_kernel == "fused"`` (the default): exact by
Eq. 3, since statistics are linear in samples.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import utils
from repro_torch.core import fed_sim
from repro_torch.kernels.cco_stats import cco_stats
from repro_torch.server import update as server_update_lib

F32 = torch.float32

ALGORITHMS = ("dcco", "centralized")
STATS_KERNELS = ("off", "fused")
_ROUND_SEED_STRIDE = 1_000_003


class EngineConfig(NamedTuple):
    """Configuration of the round loop (the fields this slice reads)."""
    algorithm: str = "dcco"
    objective: Any = None           # StatsObjective or registered name;
                                    # None = CCO with ``lam``
    lam: float = 20.0
    client_lr: float = 1.0
    local_steps: int = 1
    chunk_rounds: int = 20          # rounds per metrics segment
    stats_kernel: str = "fused"     # "fused": phase-1 aggregate through the
                                    # CUDA cco_stats kernel (its plain
                                    # version on CPU tensors); "off": the
                                    # per-client Eq.-3 average


class EngineCarry(NamedTuple):
    params: Any
    opt_state: Any


class EngineMetrics(NamedTuple):
    """Stacked per-round metrics, leading axis = rounds."""
    loss: torch.Tensor
    encoding_std: torch.Tensor


def make_kernel_agg_stats() -> Callable:
    """Aggregate cohort stats in one pass of the fused ``cco_stats`` kernel.

    Rows are pre-masked (zeroed) and the normalizer is the valid-sample
    count, read by the kernel on the device: exact for binary masks, since
    (m*f)^2 = m*f^2 and (m*f)(m*g) = m*f*g.
    """
    def agg_stats(zf, zg, mask):
        m = mask.to(F32)[:, None]
        return cco_stats(zf.to(F32) * m, zg.to(F32) * m, mask.to(F32).sum())

    return agg_stats


def _resolve_agg_stats_fn(cfg: EngineConfig) -> Optional[Callable]:
    if cfg.stats_kernel == "off":
        return None
    if cfg.stats_kernel == "fused":
        return make_kernel_agg_stats()
    raise ValueError(f"unknown stats_kernel {cfg.stats_kernel!r}; expected "
                     f"one of {STATS_KERNELS}")


def make_round_body(encoder_apply: Callable, server_opt,
                    cfg: EngineConfig) -> Callable:
    """Build round_fn(params, opt_state, batch, sizes) -> (params,
    opt_state, metrics) for ``cfg.algorithm``."""
    if cfg.algorithm not in ALGORITHMS:
        raise NotImplementedError(
            f"algorithm {cfg.algorithm!r} is not ported (the port has "
            f"{ALGORITHMS}; the fedavg baselines are ROADMAP §1, 'FedAvg "
            f"baselines')")
    objective = fed_sim.resolve_objective(cfg.objective, cfg.lam)
    server_update = server_update_lib.as_server_update(server_opt)

    if cfg.algorithm == "dcco":
        agg_stats_fn = _resolve_agg_stats_fn(cfg)

        def round_fn(params, opt_state, batch, sizes):
            return fed_sim.stats_round(
                encoder_apply, params, opt_state, server_update, batch,
                sizes, objective=objective, client_lr=cfg.client_lr,
                local_steps=cfg.local_steps, agg_stats_fn=agg_stats_fn)
        return round_fn

    # centralized: union of the cohort, one large-batch stats step
    def round_fn(params, opt_state, batch, sizes):
        n_pad = utils.tree_leaves(batch)[0].shape[1]
        union = fed_sim._flatten_clients(batch)
        mask = fed_sim._client_masks(sizes, n_pad).reshape(-1)
        return fed_sim.centralized_step(
            encoder_apply, params, opt_state, server_update, union,
            mask=mask, objective=objective)
    return round_fn


class RoundEngine:
    """Drives rounds of ``cfg.algorithm``; see the module docstring."""

    def __init__(self, encoder_apply: Callable, server_opt,
                 sampler: Callable, config: EngineConfig = EngineConfig()):
        if config.chunk_rounds < 1:
            raise ValueError(
                f"chunk_rounds must be >= 1, got {config.chunk_rounds}")
        self.config = config
        self.sampler = sampler
        self.round_fn = make_round_body(encoder_apply, server_opt, config)

    def run(self, params, opt_state, seed: int, rounds: int, *,
            start_round: int = 0, on_segment: Optional[Callable] = None):
        """Run ``rounds`` rounds; returns (params, opt_state, EngineMetrics).

        ``on_segment(round_end, carry, seg_metrics)`` fires after each
        segment of ``chunk_rounds`` rounds, with an :class:`EngineCarry`."""
        device = utils.tree_leaves(params)[0].device
        cols = ([], [])
        done = 0
        while done < rounds:
            seg = min(self.config.chunk_rounds, rounds - done)
            losses, stds = [], []
            for r in range(start_round + done, start_round + done + seg):
                gen = torch.Generator(device=device)
                gen.manual_seed(seed * _ROUND_SEED_STRIDE + r)
                batch, sizes = self.sampler(gen)
                params, opt_state, m = self.round_fn(params, opt_state,
                                                     batch, sizes)
                losses.append(m.loss)
                stds.append(m.encoding_std)
            done += seg
            m = EngineMetrics(torch.stack(losses), torch.stack(stds))
            cols[0].append(m.loss)
            cols[1].append(m.encoding_std)
            if on_segment is not None:
                on_segment(start_round + done, EngineCarry(params, opt_state),
                           m)
        metrics = EngineMetrics(*(torch.cat(c) if c else torch.zeros((0,))
                                  for c in cols))
        return params, opt_state, metrics
