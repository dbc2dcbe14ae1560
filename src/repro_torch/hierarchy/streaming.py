"""Streaming cohorts: the cohort size as a knob that costs no memory.

The materialized round stacks the whole cohort on one axis: a round of K
clients holds (K, n, ...) batches and K per-client deltas at once, which
caps the clients a round far below the cross-device populations FedAvg
targets (thousands of devices, a few samples each). On one H100 the
full-width TinyLlama-1.1B tower runs out of memory at K = 8.

Every payload is linear in samples (paper Eq. 3), so the round does not
need the cohort in memory: this module runs the two-phase statistics
protocol over fixed-size cohort *chunks*, a Python loop over chunks that
keeps only the running sums of statistics and deltas. Peak memory is
O(cohort_chunk), whatever K, and the result equals the materialized round
up to float regrouping. The streamed round is the Fig.-2 protocol read
literally: the server only ever touches aggregates.

  phase 1: for each chunk, encode its clients (no gradient), take their
           statistics and fold them with the chunk's slice of the global
           Eq.-3 weights (``Channel.chunk_fold``, so quantization, dropout
           and the edge tree compose); chunk 0 seeds the sum, the others
           add to it in chunk order; then one ``post_aggregate``;
  phase 2: for each chunk again, its clients take their local steps
           against the stop-grad combine with the phase-1 aggregate, and
           only the weighted sum of their deltas survives the chunk.

Phase 2 gathers and augments each chunk again (``sample_chunk`` is
deterministic in the round's prepared state), which costs no encoder
FLOPs beyond the materialized round's: phase 1 there is forward-only too.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch import utils
from repro_torch.core import fed_sim
from repro_torch.server import update as server_update_lib

F32 = torch.float32


class StreamingSampler(NamedTuple):
    """A chunkable cohort sampler for the streaming engine path.

    ``prepare(gen)`` makes the round's O(K)-scalar state once, before
    either phase: the cohort's selection and every augmentation draw of
    its K*n samples, from the round's generator. ``sample_chunk(state,
    c)`` returns chunk ``c`` of the cohort, ``(batch (chunk, n, ...),
    sizes (chunk,))``, and is deterministic in its arguments (phase 2
    replays it); ``cohort_sizes(state)`` returns the full (K,) client
    sizes (channels need them for participation and the Eq.-3 weights:
    the *batches* are what never materialize).
    ``FederatedDataset.make_streaming_sampler`` builds one whose chunks
    concatenate to exactly ``make_round_sampler``'s cohort for the same
    generator.
    """
    clients_per_round: int
    cohort_chunk: int
    prepare: Callable
    sample_chunk: Callable
    cohort_sizes: Callable

    @property
    def num_chunks(self) -> int:
        return self.clients_per_round // self.cohort_chunk


def _fold_into(acc, part):
    """``acc + part`` leaf by leaf, in place; ``part``'s leaves are
    dropped as they are added, so no second tree is held."""
    if acc is None:
        return part
    if isinstance(acc, dict):
        for key in acc:
            acc[key] = _fold_into(acc[key], part.pop(key))
        return acc
    if isinstance(acc, list):
        for i in range(len(acc)):
            acc[i] = _fold_into(acc[i], part[i])
            part[i] = None
        return acc
    return acc.add_(part)


def _weighted_fold(weights, tree_k):
    """``tensordot(weights, leaf)`` of each (chunk, ...) leaf, popping the
    leaves as they are folded."""
    if isinstance(tree_k, dict):
        return {key: _weighted_fold(weights, tree_k.pop(key))
                for key in list(tree_k)}
    if isinstance(tree_k, list):
        out = []
        for i in range(len(tree_k)):
            out.append(_weighted_fold(weights, tree_k[i]))
            tree_k[i] = None
        return out
    return torch.tensordot(weights.to(tree_k.dtype), tree_k, dims=1)


def streaming_stats_round(encoder_apply: Callable, params, opt_state,
                          server_opt, sample_chunk: Callable,
                          num_chunks: int, client_sizes, *, objective,
                          client_lr: float = 1.0, local_steps: int = 1,
                          channel=None, channel_key=None,
                          channel_draws=None, prox_mu: float = 0.0):
    """One two-phase statistics round streamed over ``num_chunks`` cohort
    chunks: ``fed_sim.stats_round`` on the concatenated cohort (the same
    objective, channel and FedProx contracts, minus SCAFFOLD, whose slot
    variates are cohort-resident state, which is what streaming removes).
    Returns (params, opt_state, RoundMetrics).

    ``sample_chunk(c) -> (batch, sizes)`` is the round's chunk closure;
    ``client_sizes`` the full (K,) cohort sizes. ``channel_draws`` (a dict
    with optional ``"begin"``, ``"stats"`` and ``"update"`` entries; the
    last two lists of one entry a chunk, that chunk's ``chunk_fold``
    draws) replaces the channel's random draws, for tests that feed the
    reference's.
    """
    server_update = server_update_lib.as_server_update(server_opt)
    k = client_sizes.shape[0]
    if k % num_chunks:
        raise ValueError(f"cohort of {k} does not divide into "
                         f"{num_chunks} chunks")
    chunk = k // num_chunks
    draws = channel_draws or {}
    if channel is not None:
        if channel_key is None:
            raise ValueError("channel requires channel_key")
        ctx = channel.begin_round(channel_key, client_sizes,
                                  draws.get("begin"))
        w = ctx.weights
    else:
        ctx = None
        w = client_sizes.to(F32) / client_sizes.to(F32).sum()

    def chunk_draws(phase, c):
        per_chunk = draws.get(phase)
        return None if per_chunk is None else per_chunk[c]

    def w_slice(c):
        return w[c * chunk:(c + 1) * chunk]

    def fold(tree_k, phase, c):
        if ctx is None:
            return _weighted_fold(w_slice(c), tree_k)
        return channel.chunk_fold(ctx, tree_k, phase, c, w_slice(c),
                                  chunk_draws(phase, c))

    # ---- phase 1: stream the chunks, add up the statistics' partials.
    # Chunk 0 seeds the sum, as in the reference.
    agg = None
    with torch.no_grad():
        for c in range(num_chunks):
            batch, sizes_c = sample_chunk(c)
            n_pad = utils.tree_leaves(batch)[0].shape[1]
            masks = fed_sim._client_masks(sizes_c, n_pad)
            zf, zg = encoder_apply(params, fed_sim._flatten_clients(batch))
            del batch
            d = zf.shape[-1]
            st_k = torch.func.vmap(objective.stats_masked)(
                zf.reshape(chunk, n_pad, d), zg.reshape(chunk, n_pad, d),
                masks)
            del zf, zg
            agg = _fold_into(agg, fold(st_k, "stats", c))
        if ctx is not None:
            agg = channel.post_aggregate(ctx, agg, "stats")

    # ---- phase 2: stream again; clients step against the combine, and
    # each chunk's stacked deltas are released before the next chunk
    def client_update(b, m):
        def loss_fn(p):
            zf_k, zg_k = encoder_apply(p, b)
            local = objective.stats_masked(zf_k, zg_k, m)
            return objective.loss_from_stats(objective.combine(local, agg))

        return fed_sim.client_local_steps(loss_fn, params, client_lr,
                                          local_steps, prox_mu=prox_mu)

    delta_sum, loss = None, None
    for c in range(num_chunks):
        batch, sizes_c = sample_chunk(c)
        n_pad = utils.tree_leaves(batch)[0].shape[1]
        masks = fed_sim._client_masks(sizes_c, n_pad)
        deltas, losses_k = fed_sim._vmap_clients(client_update, batch, masks,
                                                 None)
        del batch
        with torch.no_grad():
            part_loss = (w_slice(c) * losses_k).sum()
            loss = part_loss if loss is None else loss + part_loss
            delta_sum = _fold_into(delta_sum, fold(deltas, "update", c))
        del deltas
    with torch.no_grad():
        avg_delta = (delta_sum if ctx is None else
                     channel.post_aggregate(ctx, delta_sum, "update"))
        del delta_sum
        wire = torch.zeros((), dtype=F32, device=w.device)
        edge_wire = torch.zeros((), dtype=F32, device=w.device)
        if ctx is not None:
            for payload in (agg, avg_delta):
                total, edge = fed_sim.channel_bytes(channel, ctx, payload)
                wire, edge_wire = wire + total, edge_wire + edge
    params, opt_state = server_update.step(params, opt_state, avg_delta)
    return params, opt_state, fed_sim.RoundMetrics(
        loss, objective.encoding_std(agg), wire, edge_wire)
