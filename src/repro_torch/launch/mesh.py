"""Meshes and the card's constants.

``make_production_mesh`` and ``make_debug_mesh`` are the reference's
("data", "model") meshes, here ``torch.distributed.device_mesh.DeviceMesh``
objects over the world that
:func:`repro_torch.sharding.maybe_initialize_distributed` initialized
(functions, never module-level constants, so importing this module
touches no device and no process group).
"""
from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from repro_torch.sharding import multihost
from repro_torch.sharding.multihost import init_mesh, ranks_on_this_host

PODS = 2                # the reference's multi-pod mesh: 2 pods in front


def make_production_mesh(*, multi_pod: bool = False,
                         ranks_per_host: Optional[int] = None,
                         device_type: Optional[str] = None):
    """The production layout of the world it is given: ("data", "model"),
    "model" over the ranks of one host and "data" over the hosts;
    ``multi_pod=True`` splits the hosts into ("pod", "data") with 2 pods
    in front. ``ranks_per_host`` defaults to the ranks sharing this host's
    name (one collective); a fake world of 256 or 512 ranks in one process
    gives it as 16 for the reference's (16, 16) and (2, 16, 16) layouts.
    ``device_type`` defaults to the backend's (``cuda`` for NCCL, else
    ``cpu``). A world that does not split so raises ValueError."""
    multihost._device_type()        # raises without a process group
    world = dist.get_world_size()
    per = ranks_per_host or ranks_on_this_host()
    if world % per:
        raise ValueError(f"{world} ranks do not split into hosts of "
                         f"{per} ranks")
    hosts = world // per
    if not multi_pod:
        return init_mesh((hosts, per), ("data", "model"), device_type)
    if hosts % PODS:
        raise ValueError(f"multi_pod needs the hosts to split into {PODS} "
                         f"pods; the world has {hosts} host(s) of {per} "
                         f"ranks")
    return init_mesh((PODS, hosts // PODS, per), ("pod", "data", "model"),
                     device_type)


def make_debug_mesh(data: int = 1, model: int = 1):
    """A (data, model) mesh with axes ("data", "model") over the whole
    world (data * model ranks); the tests' and the card's world of one is
    ``make_debug_mesh(1)``."""
    return init_mesh((data, model), ("data", "model"))


class HardwareSpec:
    """NVIDIA H100 SXM constants (NVIDIA's data sheet; dense rates, no
    sparsity, at the 700 W power limit) for the bounds that
    ``chip_smoke.py`` and the tools compute. A card set below 700 W runs
    slower under load: print ``nvidia-smi``'s power.limit beside a bound's
    share."""
    NAME = "NVIDIA H100 SXM"
    PEAK_BYTES = 3.35e12            # HBM3 bytes/s
    PEAK_F32 = 67e12                # f32 FLOP/s outside the tensor cores
    PEAK_TF32 = 495e12              # TF32 tensor-core FLOP/s
    PEAK_BF16 = 989e12              # bf16 tensor-core FLOP/s
    HBM_BYTES = 80e9                # 80 GB of HBM3
    # the links of the dry run's roofline (data-sheet rates, none
    # measured): NVLink 4 inside one 8-card HGX H100 host, 900 GB/s a
    # card in all, 450 GB/s each way; across hosts a ConnectX-7 NIC a
    # card, 400 Gb/s
    HOST_CARDS = 8
    NVLINK_BW = 450e9               # bytes/s each way, a card
    NIC_BW = 50e9                   # bytes/s a card
