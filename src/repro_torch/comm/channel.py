"""Pluggable client -> server communication channels.

A :class:`Channel` makes the federated uplink explicit: every per-client
payload (phase-1 statistics, phase-2 parameter deltas) flows through

    begin_round  ->  encode_decode (per client)  ->  weighted sum
                 ->  post_aggregate (server side)

with bytes-on-the-wire accounting.

  DenseChannel      identity wire; bit-identical to the paths without a
                    channel (tested).
  QuantizedChannel  int-``bits`` stochastic-rounding encode/decode with
                    per-client per-tensor scales (:mod:`repro_torch.comm.
                    quantize`, through the CUDA quantize kernel).
  DPGaussianChannel per-client L2 clipping of the whole payload + Gaussian
                    noise on the aggregate (uniform client weights), with a
                    zCDP epsilon accountant.
  DropoutChannel    Bernoulli client dropout with aggregation weights
                    renormalised over the survivors; at p=0 it is
                    bit-identical to DenseChannel.

Randomness: ``ChannelContext.key`` is an integer seed; each phase draws
from a ``torch.Generator`` seeded ``utils.fold_in(key, PHASE_SALT[phase])``
and the dropout mask from one seeded with its own salt. Every method that
draws also takes the draws themselves (``draws=``), which is how the tests
feed the port the reference's random numbers.

The two-level tree is :class:`repro_torch.hierarchy.HierarchicalChannel`,
which composes two of these as its hops. Three phases ride the wire: the
phase-1 ``"stats"``, the phase-2 ``"update"`` and SCAFFOLD's ``"variate"``
(the per-client control-variate deltas, :mod:`repro_torch.server.drift`),
so quantization, DP noise and dropout compose with drift correction and
its bytes are counted. ``chunk_fold`` is the streaming engine's partial
fold of one cohort chunk (:mod:`repro_torch.hierarchy.streaming`), and
``local_fold`` a rank's partial fold of its shard of a cohort sharded
over devices (``round_engine.stats_round_sharded``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import utils
from repro_torch.comm.accountant import GaussianAccountant
from repro_torch.comm.quantize import (payload_bytes as quant_payload_bytes,
                                       qmax_for_bits, quant_dequant_payload)

F32 = torch.float32

# salts folded into the round's channel seed so the stats, update and
# variate phases (and the dropout mask) draw independent randomness
PHASE_SALT = {"stats": 0x57A75, "update": 0x0BDA7E, "variate": 0x5CAF0}
_MASK_SALT = 0x3A5C


class ChannelContext(NamedTuple):
    """Per-round channel state, computed once by ``begin_round``."""
    key: int                       # per-round seed of the payload draws
    mask: torch.Tensor             # (K,) f32 — 1 for participating clients
    weights: torch.Tensor          # (K,) f32 — normalized agg weights
    num_participants: torch.Tensor  # f32 scalar = sum(mask)


def phase_generator(ctx: ChannelContext, phase: str, device):
    """The generator of ``phase``'s draws in this round."""
    return utils.generator(utils.fold_in(ctx.key, PHASE_SALT[phase]), device)


def _weighted_sum(weights, tree_k):
    return utils.tree_map(
        lambda v: torch.tensordot(weights.to(v.dtype), v, dims=1), tree_k)


class Channel:
    """Base channel: full participation, size-weighted lossless aggregation.

    Subclasses override any of ``begin_round`` (participation + weights),
    ``encode_decode`` (the per-client wire transform), ``post_aggregate``
    (server-side processing of the aggregate), and ``payload_bytes``
    (per-client wire cost of one payload).
    """

    name = "dense"
    # whether the engine may compute phase-1 aggregate stats from the
    # flattened cohort (the cco_stats kernel path) instead of per-client
    # payloads: only lossless, size-weighted, full-participation channels
    supports_flat_stats = True
    # a lossless identity wire with size-weighted aggregation; False on the
    # base class, so a subclass that forgets it only loses a fast path
    ideal = False
    # whether begin_round always returns an all-ones participation mask
    full_participation = True

    def begin_round(self, key: int, client_sizes, draws=None) -> ChannelContext:
        del draws
        k = client_sizes.shape[0]
        s = client_sizes.to(F32)
        return ChannelContext(
            int(key), torch.ones((k,), dtype=F32, device=s.device),
            s / s.sum(), torch.tensor(float(k), dtype=F32, device=s.device))

    def encode_decode(self, ctx: ChannelContext, tree_k, phase: str,
                      draws=None):
        del ctx, phase, draws
        return tree_k

    def post_aggregate(self, ctx: ChannelContext, tree, phase: str,
                       draws=None):
        del ctx, phase, draws
        return tree

    def aggregate(self, ctx: ChannelContext, tree_k, phase: str, draws=None):
        """Weighted average of per-client payloads through the wire.

        ``draws`` replaces this phase's random draws: the uniforms of a
        quantized wire (the payload's structure) or the unit normals of the
        DP noise (the aggregate's structure)."""
        dec = self.encode_decode(ctx, tree_k, phase, draws)
        return self.post_aggregate(ctx, _weighted_sum(ctx.weights, dec),
                                   phase, draws)

    def local_fold(self, ctx_local: ChannelContext, dec_tree, phase: str, *,
                   num_shards: int = 1, draws=None):
        """Fold one rank's already-decoded payloads into its partial
        aggregate (the sharded cohort: the sum over ranks of these
        partials is the server aggregate). ``ctx_local`` holds the rank's
        slice of the mask and weights and a rank-folded seed;
        ``num_shards`` is the size of the cohort's mesh axis, by which a
        two-level tree places its edges on ranks, and ``draws`` that
        tree's edge-hop draws. The base fold is ``aggregate``'s weighted
        sum, the same code, so a lossless channel's sharded round is the
        sharded round without a channel, bit for bit."""
        del phase, num_shards, draws
        return _weighted_sum(ctx_local.weights, dec_tree)

    def chunk_fold(self, ctx: ChannelContext, tree_chunk, phase: str,
                   chunk_index: int, chunk_weights, draws=None):
        """Partial aggregate of one cohort chunk (the streaming engine):
        encode/decode the chunk's per-client payloads under the round's
        seed folded with ``chunk_index``, then fold them with the chunk's
        slice of the GLOBAL aggregation weights. Summing the partials over
        all chunks and applying ``post_aggregate`` once equals
        ``aggregate`` on the materialized cohort up to float regrouping
        (exactly, in math, by Eq.-3 linearity). ``draws``: this chunk's
        ``encode_decode`` draws."""
        ctx_c = ctx._replace(key=utils.fold_in(ctx.key, chunk_index))
        dec = self.encode_decode(ctx_c, tree_chunk, phase, draws)
        return _weighted_sum(chunk_weights, dec)

    def payload_bytes(self, tree) -> float:
        """Static per-client uplink bytes for one payload tree (shapes of
        one client's slice — equivalently, of the aggregate)."""
        return float(sum(4.0 * x.numel() for x in utils.tree_leaves(tree)))

    def round_bytes(self, ctx: ChannelContext, payload_template):
        """Per-round uplink bytes: participants x payload size."""
        return ctx.num_participants * self.payload_bytes(payload_template)

    def finalize_rounds(self, num_rounds: int) -> None:
        """Host-side hook after a run completes (privacy accounting)."""

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class DenseChannel(Channel):
    """Identity wire — f32 payloads, lossless, full participation."""

    ideal = True


class QuantizedChannel(Channel):
    """Stochastic-rounding integer quantization of every payload tensor,
    through the CUDA quantize kernel (its plain version on CPU tensors)."""

    name = "quantized"
    supports_flat_stats = False

    def __init__(self, bits: int = 8):
        qmax_for_bits(bits)                  # validate eagerly
        self.bits = bits

    def encode_decode(self, ctx, tree_k, phase, draws=None):
        # one pass over the whole payload tree, per-client per-leaf scales
        gen = None
        if draws is None:
            device = utils.tree_leaves(tree_k)[0].device
            gen = phase_generator(ctx, phase, device)
        return quant_dequant_payload(gen, tree_k, self.bits, uniforms=draws)

    def payload_bytes(self, tree) -> float:
        return float(sum(quant_payload_bytes(x.numel(), self.bits)
                         for x in utils.tree_leaves(tree)))

    def __repr__(self) -> str:
        return f"QuantizedChannel(bits={self.bits})"


class DPGaussianChannel(Channel):
    """Differentially-private aggregation: clip each client's payload to
    L2 norm ``clip_norm``, average with uniform weights, add Gaussian noise
    of std ``noise_multiplier * clip_norm / K`` to the mean.

    Noise is applied to the phases in ``noise_phases`` (default: the
    phase-1 statistics, the setting of Ning et al. 2021); clipping bounds
    per-client sensitivity in every phase. The zCDP accountant advances one
    step per noised aggregate via ``finalize_rounds``.
    """

    name = "dp_gaussian"
    supports_flat_stats = False

    def __init__(self, noise_multiplier: float = 1.0, clip_norm: float = 1.0,
                 delta: float = 1e-5,
                 noise_phases: Tuple[str, ...] = ("stats",)):
        unknown = set(noise_phases) - set(PHASE_SALT)
        if unknown:
            raise ValueError(f"unknown noise_phases {sorted(unknown)}; "
                             f"valid: {sorted(PHASE_SALT)}")
        self.noise_multiplier = float(noise_multiplier)
        self.clip_norm = float(clip_norm)
        self.noise_phases = tuple(noise_phases)
        self.accountant = GaussianAccountant(noise_multiplier, delta)

    def begin_round(self, key, client_sizes, draws=None):
        del draws
        k = client_sizes.shape[0]
        dev = client_sizes.device
        return ChannelContext(int(key), torch.ones((k,), dtype=F32, device=dev),
                              torch.full((k,), 1.0 / k, dtype=F32, device=dev),
                              torch.tensor(float(k), dtype=F32, device=dev))

    def encode_decode(self, ctx, tree_k, phase, draws=None):
        # joint L2 norm over each client's whole payload tree
        sq = sum((x.to(F32) ** 2).reshape(x.shape[0], -1).sum(1)
                 for x in utils.tree_leaves(tree_k))
        factor = torch.clamp(
            self.clip_norm / torch.clamp(torch.sqrt(sq), min=1e-12),
            max=1.0)                                             # (K,)
        return utils.tree_map(
            lambda x: x.to(F32) * factor.reshape((-1,) + (1,) * (x.dim() - 1)),
            tree_k)

    def post_aggregate(self, ctx, tree, phase, draws=None):
        if phase not in self.noise_phases:
            return tree
        std = self.noise_multiplier * self.clip_norm / torch.clamp(
            ctx.num_participants, min=1.0)
        if draws is None:
            gen = phase_generator(ctx, phase,
                                  utils.tree_leaves(tree)[0].device)
            return utils.tree_map(
                lambda x: x + std * torch.randn(
                    x.shape, generator=gen, dtype=F32, device=x.device),
                tree)
        return utils.tree_map(lambda x, z: x + std * z.to(F32), tree, draws)

    def finalize_rounds(self, num_rounds: int) -> None:
        self.accountant.step(num_rounds * len(self.noise_phases))

    def __repr__(self) -> str:
        return (f"DPGaussianChannel(sigma={self.noise_multiplier}, "
                f"clip={self.clip_norm}, phases={self.noise_phases})")


class DropoutChannel(Channel):
    """Bernoulli client dropout: each sampled client independently fails to
    report with probability ``p``. Aggregation weights renormalize over the
    surviving cohort, so Eq. 3's normalizer is the surviving sample count.
    """

    name = "dropout"
    supports_flat_stats = False
    full_participation = False

    def __init__(self, p: float = 0.1):
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout p must be in [0, 1), got {p}")
        self.p = float(p)

    def begin_round(self, key, client_sizes, draws=None):
        """``draws``: (K,) uniforms in [0, 1) in place of the mask's draw;
        a client survives where its uniform is below ``1 - p``."""
        k = client_sizes.shape[0]
        dev = client_sizes.device
        if draws is None:
            gen = utils.generator(utils.fold_in(key, _MASK_SALT), dev)
            draws = torch.rand((k,), generator=gen, dtype=F32, device=dev)
        keep = (draws < 1.0 - self.p).to(F32)
        s = client_sizes.to(F32) * keep
        # guard only the all-dropped round (weights 0 -> zero stats/delta);
        # any survivor makes the denominator >= 1 sample
        w = s / torch.clamp(s.sum(), min=1e-12)
        return ChannelContext(int(key), keep, w, keep.sum())

    def __repr__(self) -> str:
        return f"DropoutChannel(p={self.p})"


CHANNELS = ("dense", "int8", "quant", "dp", "dropout")


def get_channel(name: Optional[str], *, quant_bits: int = 8,
                dp_sigma: float = 1.0,
                dp_clip: float = 1.0, dp_delta: float = 1e-5,
                dropout_p: float = 0.1) -> Optional[Channel]:
    """CLI-facing factory. ``None``/"none" -> no channel."""
    if name is None or name == "none":
        return None
    if name == "dense":
        return DenseChannel()
    if name == "int8":
        return QuantizedChannel(8)
    if name == "quant":
        return QuantizedChannel(quant_bits)
    if name == "dp":
        return DPGaussianChannel(dp_sigma, dp_clip, dp_delta)
    if name == "dropout":
        return DropoutChannel(dropout_p)
    raise ValueError(f"unknown channel {name!r}; expected one of "
                     f"{('none',) + CHANNELS}")
