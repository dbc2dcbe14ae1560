"""Two-level aggregation topology: clients -> edge aggregators -> server.

Cross-device federated populations do not report to one server socket:
clients upload to regional *edge aggregators*, which forward partial
aggregates upstream. Every payload the stats protocol ships is linear in
samples (paper Eq. 3), so aggregation is exact under ANY summation tree:
the edge hop changes the wire, not the math.

:class:`HierarchicalChannel` makes that tree a drop-in
:class:`repro_torch.comm.Channel` composing two hop channels,

    clients --client_channel--> edges --edge_channel--> server

so the client uplink may run int8 while the edge backbone stays dense, an
edge-hop ``DropoutChannel`` models a regional outage (every client behind
the edge vanishes at once), and ``round_bytes`` accounts both hops.

Exactness contract:

  * **ideal hops collapse**: when both hops are ideal identity wires the
    tree equals the flat weighted sum in math, so the aggregate is
    computed AS the flat sum, bit-identical (``== 0.0``) to the
    un-channeled and DenseChannel paths. ``collapse_ideal=False`` forces
    the real tree.
  * **lossy hops run the real tree**: per-client encode on the client
    hop, one segment-sum fold of w_k * payload_k into per-edge partials
    (the CUDA kernel of :mod:`repro_torch.kernels.segment_sum`), per-edge
    encode on the edge hop, then the server sum.

Every segment sum here, the per-edge mass included, goes through that
kernel's wrapper: on the card it is the kernel, deterministic and without
atomics; the plain version runs only on CPU tensors. The reference's
``fold_impl`` has no counterpart.

Randomness: the round's channel seed (an int) gives each hop its own seed
through ``utils.fold_in`` with the salts below. Methods that draw take the
draws themselves: ``begin_round`` and ``aggregate`` a dict with optional
``"client"`` and ``"edge"`` entries (each hop's own draws, as that hop's
methods take them), ``encode_decode`` the client hop's, ``post_aggregate``
and ``with_edge_ids`` the edge hop's.

DP hops are refused: calibrating per-hop Gaussian noise and keeping the
epsilon accountant honest across a two-level tree is its own design
problem, and a silently mis-calibrated epsilon is worse than no DP.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import utils
from repro_torch.comm.channel import Channel, ChannelContext, DenseChannel
from repro_torch.kernels.segment_sum import segment_sum

F32 = torch.float32

# fold_in salts of each hop's seed off the round's channel seed
_CLIENT_HOP_SALT = 0xC11E
_EDGE_HOP_SALT = 0xED6E


def contiguous_edge_ids(num_clients: int, num_edges: int,
                        device=None) -> torch.Tensor:
    """Edge assignment: client k reports to edge k // (K/E), contiguous
    equal-size groups. Requires K % E == 0."""
    if num_clients % num_edges:
        raise ValueError(
            f"cohort of {num_clients} clients does not divide into "
            f"{num_edges} equal edges")
    return torch.arange(num_clients, dtype=torch.int32, device=device) // (
        num_clients // num_edges)


def _flat_rows(leaves, k: int) -> torch.Tensor:
    flats = [leaf.to(F32).reshape(k, -1) for leaf in leaves]
    return (torch.cat(flats, dim=1) if len(flats) > 1
            else flats[0]).contiguous()


def fold_to_edges(tree_k, weights, seg_ids, num_edges: int):
    """Fold stacked per-client payloads (leading axis K) into per-edge
    partial sums (leading axis E): out[e] = sum_{k in e} w_k * leaf[k].

    The leaves are flattened and concatenated into ONE (K, D) row matrix,
    so the whole payload folds in a single kernel launch."""
    leaves = utils.tree_leaves(tree_k)
    k = leaves[0].shape[0]
    rows = _flat_rows(leaves, k)
    folded = segment_sum(rows, seg_ids.to(torch.int32).contiguous(),
                         num_edges, weights.to(F32).contiguous())
    parts = iter(torch.split(
        folded, [leaf[0].numel() for leaf in leaves], dim=1))
    return utils.tree_map(
        lambda leaf: next(parts).reshape((num_edges,) + tuple(leaf.shape[1:])),
        tree_k)


def segment_mass(values, seg_ids, num_segments: int) -> torch.Tensor:
    """(E,) per-segment sums of the (K,) ``values``: one kernel launch."""
    return segment_sum(values.to(F32).reshape(-1, 1).contiguous(),
                       seg_ids.to(torch.int32).contiguous(),
                       num_segments)[:, 0]


class HierarchicalContext(NamedTuple):
    """Composite per-round context. The first four fields mirror
    :class:`repro_torch.comm.ChannelContext` (mask and weights are the
    *effective* per-client values with the edge hop folded in), so every
    consumer of a plain context works unchanged."""
    key: int
    mask: torch.Tensor                 # (K,) client mask x edge mask
    weights: torch.Tensor              # (K,) edge-masked, renormalized
    num_participants: torch.Tensor     # f32, surviving clients
    client_ctx: ChannelContext
    edge_ctx: ChannelContext
    edge_ids: torch.Tensor             # (K,) int32, client -> edge


class HierarchicalChannel(Channel):
    """Two-level aggregation tree as a pluggable comm Channel."""

    name = "hierarchical"

    def __init__(self, num_edges: int,
                 client_channel: Optional[Channel] = None,
                 edge_channel: Optional[Channel] = None,
                 collapse_ideal: bool = True):
        if num_edges < 1:
            raise ValueError(f"num_edges must be >= 1, got {num_edges}")
        self.num_edges = int(num_edges)
        self.client_channel = client_channel or DenseChannel()
        self.edge_channel = edge_channel or DenseChannel()
        for hop_name, hop in (("client", self.client_channel),
                              ("edge", self.edge_channel)):
            if isinstance(hop, HierarchicalChannel):
                raise ValueError(
                    f"nested hierarchical {hop_name} hop: flatten the tree "
                    f"into one client->edge->server topology instead")
            if getattr(hop, "noise_phases", None) is not None:
                raise ValueError(
                    f"{hop!r} as the {hop_name} hop: DP noise calibration "
                    f"and epsilon accounting across a two-level tree are "
                    f"not defined here; run the DP channel flat")
        # both hops ideal: the tree is the flat sum in math; compute it as
        # the flat sum, bit-identical to the un-channeled paths
        self.collapses = bool(collapse_ideal and self.client_channel.ideal
                              and self.edge_channel.ideal)
        self.supports_flat_stats = self.collapses
        self.full_participation = (self.client_channel.full_participation
                                   and self.edge_channel.full_participation)

    # ------------------------------------------------------------ round --
    def _compose(self, cctx, ectx, edge_ids):
        """Effective (mask, weights, participants) of the two hops."""
        if self.edge_channel.full_participation:
            # an all-ones edge mask: the client hop's weights are already
            # the effective ones, reused untouched (so the ideal-ideal
            # collapse stays == the flat dense path)
            return cctx.mask, cctx.weights, cctx.num_participants
        keep = ectx.mask[edge_ids.long()]                        # (K,)
        mask = cctx.mask * keep
        w_raw = cctx.weights * keep
        return mask, w_raw / torch.clamp(w_raw.sum(), min=1e-12), mask.sum()

    def begin_round(self, key: int, client_sizes,
                    draws=None) -> HierarchicalContext:
        draws = draws or {}
        k = client_sizes.shape[0]
        edge_ids = contiguous_edge_ids(k, self.num_edges,
                                       client_sizes.device)
        cctx = self.client_channel.begin_round(
            utils.fold_in(key, _CLIENT_HOP_SALT), client_sizes,
            draws.get("client"))
        # per-edge mass of *reporting* clients drives the edge hop's sizes
        edge_mass = segment_mass(client_sizes.to(F32) * cctx.mask, edge_ids,
                                 self.num_edges)
        ectx = self.edge_channel.begin_round(
            utils.fold_in(key, _EDGE_HOP_SALT), edge_mass,
            draws.get("edge"))
        mask, weights, num = self._compose(cctx, ectx, edge_ids)
        return HierarchicalContext(int(key), mask, weights, num, cctx, ectx,
                                   edge_ids)

    def with_edge_ids(self, ctx: HierarchicalContext, edge_ids,
                      draws=None) -> HierarchicalContext:
        """Re-route the round through a SEMANTIC edge assignment (the
        clustered round's cluster ids) instead of the contiguous one: the
        edge hop re-runs ``begin_round`` on the new per-edge mass with the
        same edge seed, and the effective mask and weights are recomposed
        as ``begin_round`` composes them. No K % E divisibility is
        assumed: an edge may be empty this round. ``draws``: the edge
        hop's begin draws."""
        cctx = ctx.client_ctx
        # the client hop's masked weights stand in for sizes (proportional:
        # the edge hop only normalizes its per-edge mass)
        mass = segment_mass(cctx.weights * cctx.mask, edge_ids,
                            self.num_edges)
        ectx = self.edge_channel.begin_round(
            utils.fold_in(ctx.key, _EDGE_HOP_SALT), mass, draws)
        mask, weights, num = self._compose(cctx, ectx, edge_ids)
        return ctx._replace(mask=mask, weights=weights, num_participants=num,
                            edge_ctx=ectx,
                            edge_ids=edge_ids.to(torch.int32))

    # ------------------------------------------------------------- wire --
    def _client_view(self, ctx) -> ChannelContext:
        """The client hop's view of a context: the composite's client
        context with the effective mask and weights, or a plain context
        as it is (a rank's slice in the sharded round)."""
        if isinstance(ctx, HierarchicalContext):
            return ctx.client_ctx._replace(mask=ctx.mask,
                                           weights=ctx.weights)
        return ctx

    def encode_decode(self, ctx, tree_k, phase: str, draws=None):
        return self.client_channel.encode_decode(self._client_view(ctx),
                                                 tree_k, phase, draws)

    def post_aggregate(self, ctx, tree, phase: str, draws=None):
        if isinstance(ctx, HierarchicalContext):
            return self.edge_channel.post_aggregate(ctx.edge_ctx, tree,
                                                    phase, draws)
        return tree

    def aggregate(self, ctx: HierarchicalContext, tree_k, phase: str,
                  draws=None):
        draws = draws or {}
        if self.collapses:
            return self.client_channel.aggregate(
                self._client_view(ctx), tree_k, phase, draws.get("client"))
        dec = self.client_channel.encode_decode(ctx.client_ctx, tree_k,
                                                phase, draws.get("client"))
        partials = fold_to_edges(dec, ctx.weights, ctx.edge_ids,
                                 self.num_edges)
        enc = self.edge_channel.encode_decode(ctx.edge_ctx, partials, phase,
                                              draws.get("edge"))
        agg = utils.tree_map(
            lambda v: torch.tensordot(ctx.edge_ctx.mask, v, dims=1), enc)
        return self.edge_channel.post_aggregate(ctx.edge_ctx, agg, phase,
                                                draws.get("edge"))

    def local_fold(self, ctx_local, dec_tree, phase: str, *,
                   num_shards: int = 1, draws=None):
        """Sharded-cohort fold: edges align with the mesh. Each rank folds
        its K/num_shards clients into its E/num_shards edges (one launch
        of the segment-sum kernel) and runs the edge hop on them under its
        seed folded with the edge salt; the sum over ranks (the caller's
        all-reduce) is the edge->server sum. ``draws``: the edge hop's
        draws for this rank's edges."""
        if self.collapses:
            return super().local_fold(ctx_local, dec_tree, phase)
        if self.num_edges % num_shards:
            raise ValueError(
                f"{self.num_edges} edges do not align with {num_shards} "
                f"shards: num_edges must be a multiple of the cohort mesh "
                f"axis size")
        e_local = self.num_edges // num_shards
        k_local = utils.tree_leaves(dec_tree)[0].shape[0]
        dev = ctx_local.weights.device
        partials = fold_to_edges(dec_tree, ctx_local.weights,
                                 contiguous_edge_ids(k_local, e_local, dev),
                                 e_local)
        ectx_l = ChannelContext(
            utils.fold_in(ctx_local.key, _EDGE_HOP_SALT),
            torch.ones((e_local,), dtype=F32, device=dev),
            torch.full((e_local,), 1.0 / e_local, dtype=F32, device=dev),
            torch.tensor(float(e_local), dtype=F32, device=dev))
        enc = self.edge_channel.encode_decode(ectx_l, partials, phase, draws)
        return utils.tree_map(lambda v: v.sum(0), enc)

    def chunk_fold(self, ctx: HierarchicalContext, tree_chunk, phase: str,
                   chunk_index: int, chunk_weights, draws=None):
        """Streaming fold: the cohort chunk must hold whole edges, so each
        chunk folds its clients into its own edges (one segment-sum
        launch), runs the edge hop on them and hands back a partial the
        streaming round adds up. Each hop draws under its seed folded with
        ``chunk_index``; ``draws``: a dict with optional ``"client"`` and
        ``"edge"`` entries, this chunk's draws of each hop."""
        chunk = utils.tree_leaves(tree_chunk)[0].shape[0]
        k = ctx.weights.shape[0]
        edge_size = k // self.num_edges
        if chunk % edge_size:
            raise ValueError(
                f"cohort chunk of {chunk} does not hold whole edges "
                f"(edge size {edge_size}): pick cohort_chunk a multiple "
                f"of clients-per-round / num_edges")
        if self.collapses:
            return super().chunk_fold(ctx, tree_chunk, phase, chunk_index,
                                      chunk_weights,
                                      (draws or {}).get("client"))
        draws = draws or {}
        e_chunk = chunk // edge_size
        cctx_c = ctx.client_ctx._replace(
            key=utils.fold_in(ctx.client_ctx.key, chunk_index))
        dec = self.client_channel.encode_decode(cctx_c, tree_chunk, phase,
                                                draws.get("client"))
        partials = fold_to_edges(
            dec, chunk_weights,
            contiguous_edge_ids(chunk, e_chunk, chunk_weights.device),
            e_chunk)
        ectx_c = ctx.edge_ctx._replace(
            key=utils.fold_in(ctx.edge_ctx.key, chunk_index))
        enc = self.edge_channel.encode_decode(ectx_c, partials, phase,
                                              draws.get("edge"))
        emask = ctx.edge_ctx.mask[chunk_index * e_chunk:
                                  (chunk_index + 1) * e_chunk]
        return utils.tree_map(
            lambda v: torch.tensordot(emask, v, dims=1), enc)

    # ------------------------------------------------------- accounting --
    def round_bytes(self, ctx: HierarchicalContext, payload_template):
        per_hop = self.hop_bytes(ctx, payload_template)
        return per_hop["client_edge"] + per_hop["edge_server"]

    def hop_bytes(self, ctx: HierarchicalContext, payload_template):
        """Per-hop uplink bytes this round: surviving clients x the client
        hop's payload width, surviving edges x the edge hop's width."""
        return {
            "client_edge": ctx.num_participants *
            self.client_channel.payload_bytes(payload_template),
            "edge_server": ctx.edge_ctx.num_participants *
            self.edge_channel.payload_bytes(payload_template),
        }

    def payload_bytes(self, tree) -> float:
        # per-client wire width = the client hop's encoding
        return self.client_channel.payload_bytes(tree)

    def finalize_rounds(self, num_rounds: int) -> None:
        self.client_channel.finalize_rounds(num_rounds)
        self.edge_channel.finalize_rounds(num_rounds)

    def __repr__(self) -> str:
        return (f"HierarchicalChannel(edges={self.num_edges}, "
                f"client={self.client_channel!r}, "
                f"edge={self.edge_channel!r})")
