"""The multi-process world of the sharded paths, over ``torch.distributed``.

The reference grows its single-process ``shard_map`` path into a
``jax.distributed`` mesh of processes x local devices. Here one process
drives one device (one rank per GPU), the world is a
``torch.distributed`` process group, and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names: ``make_multihost_mesh`` lays the world out as (hosts, ranks per
host) = ("data", "client"), and the engine's sharded round runs with
``cohort_axis=("data", "client")``, the all-reduce over both axes the same
Eq.-3 sum, re-associated.

Environment contract (set per process by the launcher), the reference's:

  REPRO_COORDINATOR    host:port of rank 0 (e.g. "127.0.0.1:12345"), or
                       an init-method URL with its scheme ("tcp://...",
                       "file:///path": a FileStore, no port at all)
  REPRO_NUM_PROCESSES  world size
  REPRO_PROCESS_ID     this process's rank in [0, world)

``maybe_initialize_distributed`` is a no-op returning False when
REPRO_COORDINATOR is unset, so single-process runs never touch
``torch.distributed``. On the card it initializes NCCL, and gloo only
when the caller asks for the CPU (``device="cpu"``); NCCL that fails to
initialize raises, and nothing falls back to gloo or to one process.
NCCL takes one rank per device, so a world on one card is a world of one.
"""
from __future__ import annotations

import datetime
import os
import socket
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import utils
from repro_torch.sharding import collectives

COORDINATOR_ENV = "REPRO_COORDINATOR"
NUM_PROCESSES_ENV = "REPRO_NUM_PROCESSES"
PROCESS_ID_ENV = "REPRO_PROCESS_ID"


def maybe_initialize_distributed(env: Optional[dict] = None, *,
                                 device=None,
                                 timeout_s: float = 600.0) -> bool:
    """Initialize the default process group from the REPRO_* contract.

    Returns True when a process group was initialized, False for the
    single-process no-op. ``device`` is the entry point's (``"cuda"``
    unless ``"cpu"``, as :func:`repro_torch.utils.resolve_device`): NCCL
    on the card, with this rank's device ``cuda:<rank % device count>``
    made current; gloo on the CPU. A collective that waits longer than
    ``timeout_s`` raises instead of hanging.
    """
    env = os.environ if env is None else env
    coordinator = env.get(COORDINATOR_ENV)
    if not coordinator:
        return False
    world = int(env[NUM_PROCESSES_ENV])
    rank = int(env[PROCESS_ID_ENV])
    if not 0 <= rank < world:
        raise ValueError(f"{PROCESS_ID_ENV}={rank} is not in [0, "
                         f"{NUM_PROCESSES_ENV}={world})")
    dev = utils.resolve_device(device)
    init_method = (coordinator if "://" in coordinator
                   else f"tcp://{coordinator}")
    kw = {}
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return True


def _device_type() -> str:
    """The device type of the initialized world's backend."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call repro_torch.sharding."
            "maybe_initialize_distributed (the REPRO_* env) first")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def init_mesh(shape: Tuple[int, ...], axis_names: Tuple[str, ...],
              device_type: Optional[str] = None):
    """A DeviceMesh of ``shape`` over the initialized world, ranks in
    row-major order, dimensions named ``axis_names``, on the backend's
    device type unless ``device_type`` is given."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = device_type or _device_type()
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of shape {shape} needs {n} ranks, the "
                         f"world has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def ranks_on_this_host() -> int:
    """How many ranks of the world run on this rank's host (by host
    name; one collective)."""
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    return names.count(socket.gethostname())


def make_multihost_mesh(axis_names: Tuple[str, str] = ("data", "client"),
                        ranks_per_host: Optional[int] = None):
    """(hosts, ranks per host) mesh over the whole world: axis 0
    ("data") spans hosts, axis 1 ("client") each host's ranks, ranks
    enumerated host by host as a launcher numbers them.
    ``ranks_per_host`` defaults to the ranks sharing this host's name.
    On one host it is a (1, R) mesh whose "client" axis is the single-host
    ``cohort_axis`` layout."""
    _device_type()
    world = dist.get_world_size()
    per = ranks_per_host or ranks_on_this_host()
    if world % per:
        raise ValueError(f"{world} ranks do not split into hosts of "
                         f"{per} ranks")
    return init_mesh((world // per, per), axis_names)


def make_corpus_mesh(num_shards: Optional[int] = None,
                     axis: str = "corpus"):
    """1-D retrieval-serving mesh: one index shard per rank along
    ``axis``. ``num_shards`` (default: the world) must be the world's
    size, since a DeviceMesh spans the world here."""
    _device_type()
    world = dist.get_world_size()
    s = world if num_shards is None else num_shards
    if s != world:
        raise ValueError(f"num_shards={s} must equal the world size "
                         f"{world}: one shard per rank")
    return init_mesh((s,), (axis,))


def host_local_to_global(mesh, axis, tree):
    """Assemble the ranks' slices of a leading axis into the global tensor.

    In the reference each process passes its slice and gets back one
    global array laid out on the mesh. In SPMD torch there is no global
    array object: each rank holds tensors, so the global tensor is the
    concatenation of the slices over ``axis`` in rank order, materialized
    on every rank (an ``all_gather``). ``axis=None`` is the reference's
    replicated ``P()``: every rank already holds the whole tree, which is
    returned as it is."""
    if axis is None:
        return tree
    collectives.check_mesh(mesh, axis)
    return collectives.all_gather_tree(tree, mesh, axis)
