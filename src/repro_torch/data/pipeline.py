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
from repro_torch.data import partition as partition_lib


class FederatedDataset:
    """Wraps (data, labels) + a client partition.

    data: dict with ``"images"`` (N,H,W,C) float32 numpy; client_index:
    (num_clients, samples_per_client) int; client_sizes: (num_clients,)
    valid-sample counts — rows of client_index beyond a client's size are
    padding, masked out of every stats/loss computation downstream.
    """

    def __init__(self, data: Dict[str, np.ndarray], labels: np.ndarray,
                 client_index: np.ndarray,
                 client_sizes: Optional[np.ndarray] = None):
        if set(data) != {"images"}:
            raise NotImplementedError(
                f"only image data is ported, got {sorted(data)} (token "
                f"data comes with ROADMAP §1, 'Transformer families')")
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

    def _two_views(self, gen, images, k: int, n: int):
        v1, v2 = augment.two_views_image(gen, images)
        return {"v1": v1.reshape(k, n, *v1.shape[1:]),
                "v2": v2.reshape(k, n, *v2.shape[1:])}

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
        images = torch.as_tensor(self.data["images"][idx.reshape(-1)],
                                 device=device)
        sizes = torch.as_tensor(self.client_sizes[sel], dtype=torch.int32,
                                device=device)
        return self._two_views(gen, images, k, n), sizes

    def _stage(self, device: torch.device):
        """Device-resident (images, client_index, client_sizes), staged once
        per device and shared by every sampler."""
        if device not in self._staged:
            self._staged[device] = (
                torch.as_tensor(self.data["images"], device=device),
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
        device = torch.device(device)
        images, cindex, csizes = self._stage(device)
        n = self.samples_per_client
        k = clients_per_round

        def sampler(gen: torch.Generator):
            sel = self._select(gen, k)
            gathered = images[cindex[sel].reshape(-1)]        # (K*n, ...)
            return self._two_views(gen, gathered, k, n), csizes[sel]

        return sampler
