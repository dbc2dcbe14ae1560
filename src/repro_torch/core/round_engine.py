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
the reference. A channel's draws come from its own per-round seed,
``utils.fold_in(round_seed, _CHANNEL_SALT)``, so the sampler's stream is
the same with and without a channel.

Phase-1 aggregate statistics go through the CUDA ``cco_stats`` kernel
when ``EngineConfig.stats_kernel == "fused"``, in the objective's moment
set: exact by Eq. 3, since statistics are linear in samples. The default
(``None``) takes that route unless the channel needs per-client payloads,
and then the per-client average; the reference makes the caller choose. ``EngineConfig.channel`` routes every client uplink through a
:mod:`repro_torch.comm` channel, with per-round ``wire_bytes``.
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
_CHANNEL_SALT = 0xC0                # fold_in salt of the per-round channel seed


class EngineConfig(NamedTuple):
    """Configuration of the round loop (the fields this slice reads)."""
    algorithm: str = "dcco"
    objective: Any = None           # StatsObjective or registered name;
                                    # None = CCO with ``lam``
    lam: float = 20.0
    client_lr: float = 1.0
    local_steps: int = 1
    chunk_rounds: int = 20          # rounds per metrics segment
    stats_kernel: Optional[str] = None
                                    # "fused": phase-1 aggregate through the
                                    # CUDA cco_stats kernel (its plain
                                    # version on CPU tensors); "off": the
                                    # per-client Eq.-3 average; None:
                                    # "fused" unless the channel needs
                                    # per-client payloads
    channel: Any = None             # repro_torch.comm.Channel or None (the
                                    # lossless wire)


class EngineCarry(NamedTuple):
    params: Any
    opt_state: Any


class EngineMetrics(NamedTuple):
    """Stacked per-round metrics, leading axis = rounds."""
    loss: torch.Tensor
    encoding_std: torch.Tensor
    wire_bytes: torch.Tensor        # uplink bytes/round (0: no channel)


def make_kernel_agg_stats(second_moments: bool = False) -> Callable:
    """Aggregate cohort stats in one pass of the fused ``cco_stats`` kernel.

    ``second_moments`` selects the kernel's moment set (the objective's
    ``second_moments`` flag): ``"full"`` adds the within-view moments the
    VICReg-family objectives need, still in one pass.

    Rows are pre-masked (zeroed) and the normalizer is the valid-sample
    count, read by the kernel on the device: exact for binary masks, since
    (m*f)^2 = m*f^2 and (m*f)(m*g) = m*f*g.
    """
    moments = "full" if second_moments else "cross"

    def agg_stats(zf, zg, mask):
        m = mask.to(F32)[:, None]
        return cco_stats(zf.to(F32) * m, zg.to(F32) * m, mask.to(F32).sum(),
                         moments=moments)

    return agg_stats


def _resolve_agg_stats_fn(cfg: EngineConfig, objective) -> Optional[Callable]:
    kernel = cfg.stats_kernel
    if kernel is None:
        flat = cfg.channel is None or cfg.channel.supports_flat_stats
        kernel = "fused" if flat else "off"
    if kernel == "off":
        return None
    if kernel == "fused":
        return make_kernel_agg_stats(objective.second_moments)
    raise ValueError(f"unknown stats_kernel {kernel!r}; expected one of "
                     f"{STATS_KERNELS} or None")


def make_round_body(encoder_apply: Callable, server_opt,
                    cfg: EngineConfig) -> Callable:
    """Build round_fn(params, opt_state, batch, sizes, channel_key=None)
    -> (params, opt_state, metrics) for ``cfg.algorithm``."""
    if cfg.algorithm not in ALGORITHMS:
        raise NotImplementedError(
            f"algorithm {cfg.algorithm!r} is not ported (the port has "
            f"{ALGORITHMS}; the fedavg baselines are ROADMAP §1, 'FedAvg "
            f"baselines')")
    objective = fed_sim.resolve_objective(cfg.objective, cfg.lam)
    server_update = server_update_lib.as_server_update(server_opt)
    channel = cfg.channel
    if channel is not None:
        if cfg.algorithm == "centralized":
            raise ValueError(
                "the centralized body has no client->server wire; "
                "channel is not applicable")
        if cfg.stats_kernel == "fused" and not channel.supports_flat_stats:
            raise ValueError(
                f"stats_kernel={cfg.stats_kernel!r} aggregates phase-1 "
                f"stats from the flattened cohort, which is incompatible "
                f"with {channel!r} (needs per-client payloads; use "
                f"stats_kernel='off' or None)")

    if cfg.algorithm == "dcco":
        agg_stats_fn = _resolve_agg_stats_fn(cfg, objective)

        def round_fn(params, opt_state, batch, sizes, channel_key=None):
            return fed_sim.stats_round(
                encoder_apply, params, opt_state, server_update, batch,
                sizes, objective=objective, client_lr=cfg.client_lr,
                local_steps=cfg.local_steps, agg_stats_fn=agg_stats_fn,
                channel=channel, channel_key=channel_key)
        return round_fn

    # centralized: union of the cohort, one large-batch stats step
    def round_fn(params, opt_state, batch, sizes, channel_key=None):
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
        channel = self.config.channel
        cols = tuple([] for _ in EngineMetrics._fields)
        done = 0
        while done < rounds:
            seg = min(self.config.chunk_rounds, rounds - done)
            per_round = tuple([] for _ in EngineMetrics._fields)
            for r in range(start_round + done, start_round + done + seg):
                round_seed = seed * _ROUND_SEED_STRIDE + r
                batch, sizes = self.sampler(utils.generator(round_seed,
                                                            device))
                key = (None if channel is None
                       else utils.fold_in(round_seed, _CHANNEL_SALT))
                params, opt_state, m = self.round_fn(params, opt_state,
                                                     batch, sizes, key)
                for col, x in zip(per_round, m):
                    col.append(x)
            done += seg
            m = EngineMetrics(*(torch.stack(c) for c in per_round))
            for col, x in zip(cols, m):
                col.append(x)
            if on_segment is not None:
                on_segment(start_round + done, EngineCarry(params, opt_state),
                           m)
        if channel is not None:
            # host-side bookkeeping (the DP epsilon accountant)
            channel.finalize_rounds(done)
        metrics = EngineMetrics(*(torch.cat(c) if c else torch.zeros((0,))
                                  for c in cols))
        return params, opt_state, metrics
