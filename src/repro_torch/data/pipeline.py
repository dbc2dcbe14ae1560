"""Federated data pipeline: owns the client partition and emits per-round
batches in the (K, n, ...) layout expected by :mod:`repro_torch.core.fed_sim`.

Randomness comes from a ``torch.Generator``: the generator's device is
where cohort selection and the augmentation draws happen.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.data import augment
from repro_torch.data import latency as latency_lib
from repro_torch.data import partition as partition_lib


class FederatedDataset:
    """Wraps (data, labels) + a client partition.

    data: dict with ``"images"`` (N,H,W,C) float32 numpy or ``"tokens"``
    (N,S) int numpy; client_index: (num_clients, samples_per_client) int; client_sizes:
    (num_clients,) valid-sample counts — rows of client_index beyond a
    client's size are padding, masked out of every stats/loss computation
    downstream.
    """

    def __init__(self, data: Dict[str, np.ndarray], labels: np.ndarray,
                 client_index: np.ndarray,
                 client_sizes: Optional[np.ndarray] = None):
        if set(data) not in ({"images"}, {"tokens"}):
            raise NotImplementedError(
                f"the port takes one leaf, 'images' or 'tokens', got "
                f"{sorted(data)}: as in the reference, whose pipeline "
                f"augments only those, a vision-text tower trains on its "
                f"text views")
        self.leaf = next(iter(data))
        self.data = data
        self.labels = labels
        self.client_index = client_index
        if client_sizes is None:
            client_sizes = np.full((client_index.shape[0],),
                                   client_index.shape[1], np.int64)
        self.client_sizes = np.asarray(client_sizes, np.int64)
        if self.client_sizes.shape != (client_index.shape[0],):
            raise ValueError(
                f"client_sizes shape {self.client_sizes.shape} does not "
                f"match {client_index.shape[0]} clients")
        self._staged: Dict[torch.device, tuple] = {}

    @property
    def num_clients(self) -> int:
        return self.client_index.shape[0]

    @property
    def samples_per_client(self) -> int:
        return self.client_index.shape[1]

    @classmethod
    def build(cls, data, labels, *, num_clients, samples_per_client,
              partition: partition_lib.PartitionSpec, seed: int = 0):
        """Cut the client partition a ``PartitionSpec`` describes."""
        idx, sizes = partition_lib.build_partition(
            partition, labels, num_clients=num_clients,
            samples_per_client=samples_per_client, seed=seed)
        return cls(data, labels, idx, client_sizes=sizes)

    # ------------------------------------------------------------- rounds --

    def _draw_views(self, gen, raw_shape):
        """Both views' augmentation draws for a batch of ``raw_shape``,
        view 1's then view 2's, as the reference's ``two_views_image``
        and ``two_views_tokens`` draw them."""
        b = raw_shape[0]
        if self.leaf == "tokens":
            return tuple(augment.draw_augment_tokens(gen, b, raw_shape[1])
                         for _ in range(2))
        return tuple(augment.draw_augment(gen, b, *raw_shape[1:3])
                     for _ in range(2))

    def _apply_views(self, raw, draws, k: int, n: int):
        """Augment gathered (k*n, ...) raw samples with both views'
        draws into stacked two-view batches (k, n, ...): the one view
        pipeline of every sampler, so a streamed chunk's views are the
        materialized cohort's."""
        fn = (augment.augment_tokens if self.leaf == "tokens"
              else augment.augment_images)
        v1, v2 = (fn(raw, d) for d in draws)
        return {"v1": v1.reshape(k, n, *v1.shape[1:]),
                "v2": v2.reshape(k, n, *v2.shape[1:])}

    def _two_views(self, gen, raw, k: int, n: int):
        return self._apply_views(raw, self._draw_views(gen, raw.shape), k, n)

    def _select(self, gen, clients_per_round: int):
        return torch.randperm(self.num_clients, generator=gen,
                              device=gen.device)[:clients_per_round]

    def round_batch(self, gen: torch.Generator, clients_per_round: int,
                    device=None):
        """Sample K clients, gather raw samples on the HOST, build two
        augmented views on ``device`` (default: the generator's).

        Returns (client_data {"v1", "v2"} (K, n, H, W, C), sizes (K,)
        int32). Only the cohort touches the device."""
        device = gen.device if device is None else torch.device(device)
        sel = self._select(gen, clients_per_round).cpu().numpy()
        idx = self.client_index[sel]                          # (K, n)
        k, n = idx.shape
        raw = torch.as_tensor(self.data[self.leaf][idx.reshape(-1)],
                              device=device)
        sizes = torch.as_tensor(self.client_sizes[sel], dtype=torch.int32,
                                device=device)
        return self._two_views(gen, raw, k, n), sizes

    def flat_round_batch(self, gen: torch.Generator, clients_per_round: int,
                         device=None):
        """``round_batch``'s sampling, flattened to (K*n, ...)."""
        batch, sizes = self.round_batch(gen, clients_per_round, device)
        flat = {k: x.reshape((-1,) + tuple(x.shape[2:]))
                for k, x in batch.items()}
        return flat, sizes

    def _stage(self, device: torch.device):
        """Device-resident (data, client_index, client_sizes), staged once
        per device and shared by every sampler."""
        if device not in self._staged:
            self._staged[device] = (
                torch.as_tensor(self.data[self.leaf], device=device),
                torch.as_tensor(self.client_index, device=device),
                torch.as_tensor(self.client_sizes, dtype=torch.int32,
                                device=device))
        return self._staged[device]

    def make_round_sampler(self, clients_per_round: int, device):
        """A ``sampler(gen) -> (batch, sizes)`` working on ``device``.

        The dataset and client index are staged on the device once, as in
        the reference (the paper's corpora are small); each call selects
        the cohort, gathers and augments on the device, with ``gen`` (a
        generator on that device) supplying every draw.
        """
        return self._sampler(clients_per_round, device, None)

    def make_async_round_sampler(self, clients_per_round: int, device,
                                 latency=None):
        """``make_round_sampler``'s semi-synchronous twin: ``sampler(gen)
        -> (batch, sizes, delays)`` for the buffered engine
        (``EngineConfig.async_k``).

        ``delays`` (K,) int32 are per-contribution arrival delays in
        scheduler ticks, drawn from the ``latency`` model
        (:mod:`repro_torch.data.latency`) on the TRUE sampled client ids,
        so a heavy-tail model's stragglers persist across rounds. The
        delays come from a stream of their own (``latency.delay_seed``),
        so cohort selection and augmentation are ``make_round_sampler``'s
        for the same generator: zero-latency async runs see exactly the
        sync engine's batches.
        """
        sampler = self._sampler(clients_per_round, device,
                                latency_lib.resolve_latency(latency))
        sampler.clients_per_round = clients_per_round
        return sampler

    def make_streaming_sampler(self, clients_per_round: int,
                               cohort_chunk: int, device):
        """A chunkable sampler for the streaming engine path
        (``EngineConfig.cohort_chunk``), working on ``device``:
        ``prepare(gen)`` does the round's O(K)-scalar work once (the
        cohort's selection and both views' augmentation draws for all K*n
        samples, drawn in ``make_round_sampler``'s order), and
        ``sample_chunk(state, c)`` gathers and augments ONLY chunk ``c``
        with its slice of those draws, so a round never holds more than
        ``cohort_chunk`` clients of batch data. The chunks concatenate to
        exactly the cohort ``make_round_sampler`` draws from the same
        generator (tested bit for bit), which is what makes the streamed
        and materialized rounds comparable."""
        from repro_torch.hierarchy.streaming import StreamingSampler
        if cohort_chunk < 1 or clients_per_round % cohort_chunk:
            raise ValueError(
                f"clients_per_round={clients_per_round} does not divide "
                f"into chunks of {cohort_chunk}")
        raw, cindex, csizes = self._stage(torch.device(device))
        n, k, chunk = (self.samples_per_client, clients_per_round,
                       cohort_chunk)

        def prepare(gen: torch.Generator):
            sel = self._select(gen, k)
            return sel, self._draw_views(gen, (k * n,) + tuple(raw.shape[1:]))

        def sample_chunk(state, c: int):
            sel, draws = state
            sel_c = sel[c * chunk:(c + 1) * chunk]
            rows = slice(c * chunk * n, (c + 1) * chunk * n)
            draws_c = tuple(type(d)(*(x[rows] for x in d)) for d in draws)
            gathered = raw[cindex[sel_c].reshape(-1)]        # (chunk*n, ...)
            return (self._apply_views(gathered, draws_c, chunk, n),
                    csizes[sel_c])

        def cohort_sizes(state):
            return csizes[state[0]]

        return StreamingSampler(k, chunk, prepare, sample_chunk,
                                cohort_sizes)

    def _sampler(self, k: int, device, latency):
        device = torch.device(device)
        raw, cindex, csizes = self._stage(device)
        n = self.samples_per_client

        def sampler(gen: torch.Generator):
            sel = self._select(gen, k)
            gathered = raw[cindex[sel].reshape(-1)]           # (K*n, ...)
            out = (self._two_views(gen, gathered, k, n), csizes[sel])
            if latency is None:
                return out
            return out + (latency_lib.sample_delays(
                latency, latency_lib.delay_seed(gen), sel),)

        if latency is not None:
            sampler.latency = latency
        return sampler
