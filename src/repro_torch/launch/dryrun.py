"""Multi-pod dry run: trace every (arch x input shape) step on the
production mesh, without running it, and record what a device of that
mesh would hold, compute and send.

Port of ``repro/launch/dryrun.py``. The reference lowers and compiles
each step with ``jax.jit`` against 512 forced XLA host devices and reads
XLA's analyses. Here one process starts a fake process group of 256
("data", "model") = (16, 16) or 512 ("pod", "data", "model") = (2, 16,
16) ranks (``torch.testing._internal.distributed.fake_pg``), lays the
parameters, the Adam state, the batch and the decode cache out as
DTensors of fake tensors (``FakeTensorMode``: shapes only, nothing
allocated) by the reference's rules (``sharding/specs.py``: tensor- or
fully-sharded parameters, ZeRO-1 moments, the batch over the data axes,
the cache), and runs one step of ``launch/steps.py`` on them as a DTensor
program: every op runs its sharding rule, and the redistributions it
needs issue functional collectives. One dispatch mode (:class:`Trace`)
watches the local ops each rank runs:

  * ``memory``: ``argument_size_in_bytes`` and ``output_size_in_bytes``
    are one rank's blocks of the step's inputs and outputs (train
    returns new parameters and optimizer state, which the reference
    donates; decode updates the cache in place; XLA's output figure adds
    8 bytes a leaf for its output tuple, ``output_leaves`` of them);
    ``temp_size_in_bytes``
    is the peak of the bytes the step allocates and holds at once (the
    arguments stay live throughout, so a device's peak is arguments +
    temp: ``peak_bytes``). XLA's ``generated_code_size_in_bytes`` has no
    counterpart (nothing is compiled).
  * ``flops_per_device``: the local ops' FLOPs by ``torch.utils.
    flop_counter``'s formulas (``FlopCounterMode``'s), plus the flash
    kernels' forward and backward (:func:`repro_torch.kernels.
    flash_attention.forward_flops` and ``backward_flops`` over the calls
    the wrapper records: a dispatch mode cannot see inside a kernel; a
    traced backward only makes its outputs). The ops counted are each
    rank's local ones, not DTensor's global ones.
  * ``bytes_per_device``: the sum of each local op's input and output
    bytes (views and allocations excluded). Nothing is fused, so it lies
    above XLA's "bytes accessed".
  * ``collectives``: :func:`collective_stats` of the functional
    collectives the trace issues (and any c10d collective of
    ``sharding/collectives.py``, seen once, as the op it dispatches):
    bytes (each op's result, as the reference reads HLO result shapes)
    and calls by op, the ring-model wire (all-reduce 2x, the rest 1x) and
    the same split by mesh axis.
  * ``roofline`` on the H100 data sheet (``launch/mesh.HardwareSpec``):
    compute at the bf16 tensor-core peak, memory at the HBM rate, each
    axis's wire at NVLink's rate when its groups fit one 8-card host,
    else at the NIC's; ``dominant`` the largest. Estimates, not
    measurements.
  * ``trace_s`` in place of ``compile_s``: the time to build and trace.

Run: ``PYTHONPATH=src python -m repro_torch.launch.dryrun --all`` on the
card (fake ``cuda`` tensors), ``--device cpu`` anywhere. Results go to
``build/repro_torch/dryrun_results.json`` (``--out``), one record a
``tag/arch/shape/single|multi`` key; cases already there are skipped
unless ``--force``. Exits 1 when a case fails.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import utils
from repro_torch.configs.base import (ARCH_IDS, TrainConfig, get_config,
                                      get_dual_encoder_config)
from repro_torch.core import dcco
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.launch import inputs as inp
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import HardwareSpec, make_production_mesh
from repro_torch.models import common
from repro_torch.optim import optimizers as opt_lib
from repro_torch.sharding import collectives
from repro_torch.sharding import specs as shard_specs

DRYRUN_ARCHS = tuple(a for a in ARCH_IDS if a != "resnet14-cifar")
RESULTS_PATH = os.path.join("build", "repro_torch", "dryrun_results.json")
RANKS_PER_HOST = 16      # the reference's "model" axis
POD_RANKS = 256          # one (16, 16) pod

# op -> the reference's HLO name of the collective
_COLLECTIVES = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_NO_BYTES = ("empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh")


def _tensors(tree):
    from torch.utils import _pytree as pytree
    return [t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _op_tensors(values) -> list:
    """The tensors among an op's arguments or results (a tensor list
    argument included)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(x for x in v if isinstance(x, torch.Tensor))
    return out


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def local_bytes(tree) -> int:
    """One rank's bytes of the tensors of ``tree`` (a DTensor's local
    block), each storage once."""
    seen, total = set(), 0
    for t in _tensors(tree):
        t = _local(t)
        key = id(t.untyped_storage())
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


class Trace(TorchDispatchMode):
    """Counts the local ops each rank runs in a (fake or real) DTensor or
    plain program: FLOPs, bytes read and written, the collectives (with
    their process groups' names) and the peak of the bytes allocated
    after it was entered (``existing``: the storages already live). A
    DTensor op is let through (its local ops come back to this mode); the
    ops of DTensor's shape propagation (run on fake tensors of global
    shapes) and ops on ``meta`` tensors (a tree of shapes the step reads)
    are not counted."""

    def __init__(self, existing=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        from torch.distributed.tensor import DTensor
        self._flops = flop_registry
        self._dtensor = DTensor
        self.flops = 0
        self.bytes = 0
        self.collectives = []          # (op, result bytes, group name)
        self.live = 0
        self.peak = 0
        self._seen = {id(_local(t).untyped_storage()) for t in existing}

    def __enter__(self):
        # DTensor infers an op's global output shape by running the op on
        # fake tensors (of this trace's own fake mode when one is active)
        # on a cache miss: those ops are not the program's
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        self._prop_cls = ShardingPropagator
        self._prop_fn = getattr(ShardingPropagator,
                                "_propagate_tensor_meta_non_cached", None)
        if self._prop_fn is None:
            # without it DTensor's global-shape ops would be counted as
            # each rank's: refuse rather than inflate the numbers
            raise RuntimeError(
                "this torch's DTensor has no ShardingPropagator."
                "_propagate_tensor_meta_non_cached; the dry run cannot "
                "tell its shape propagation from the program's ops")
        self._in_prop = 0
        trace, inner = self, self._prop_fn

        def propagate(prop, op_schema):
            trace._in_prop += 1
            try:
                return inner(prop, op_schema)
            finally:
                trace._in_prop -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        return super().__enter__()

    def __exit__(self, *exc):
        self._prop_cls._propagate_tensor_meta_non_cached = self._prop_fn
        return super().__exit__(*exc)

    def _track(self, t, inputs) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen or key in inputs:
            return
        self._seen.add(key)
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        self.live -= n
        self._seen.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        if ns == "prim" or self._in_prop:
            return out
        ins = _op_tensors(args) + _op_tensors(kwargs.values())
        outs = _op_tensors(out if isinstance(out, (tuple, list)) else (out,))
        if any(t.device.type == "meta" for t in ins + outs):
            return out          # shapes only (a tree of shapes), no work
        name = func.__name__.split(".")[0]
        if ns in ("_c10d_functional", "c10d") and name in _COLLECTIVES:
            # a functional collective's group name is its last str
            # argument (the reduce op comes before it)
            group = ([a for a in list(args) + list(kwargs.values())
                      if isinstance(a, str)] or [None])[-1]
            if ns == "c10d":
                group = _c10d_group(args)
            res = outs[0] if ns == "_c10d_functional" else ins[0]
            self.collectives.append((_COLLECTIVES[name],
                                     res.numel() * res.element_size(), group))
            return out
        packet = func._overloadpacket
        if packet in self._flops:
            self.flops += int(self._flops[packet](*args, **kwargs,
                                                  out_val=out))
        if not (func.is_view or name in _NO_BYTES or name == "wait_tensor"):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
        in_st = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            self._track(t, in_st)
        return out


def _c10d_group(args) -> Optional[str]:
    """The name of the process group among a c10d op's arguments (the op
    receives it boxed, as a ``ScriptObject``)."""
    from torch._C._distributed_c10d import ProcessGroup
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                a = ProcessGroup.unbox(a)
            except (RuntimeError, TypeError):
                continue
        name = getattr(a, "group_name", None)
        if name is not None:
            return name
    return None


def collective_stats(trace: Trace, mesh) -> Dict[str, Any]:
    """Per-device collective bytes of a traced step: by op, and split by
    the mesh axis each call's group spans (``"pod+data"`` for the group
    of several axes that ``sharding.collectives`` made, ``"world"`` for
    any other group over several axes). Ring-model wire estimate:
    all-reduce ~ 2x its payload, the others ~ 1x. A Python loop is
    traced in full, so unlike the reference's HLO reading there are no
    loop trip counts to scale by."""
    names = mesh.mesh_dim_names
    axis_of = {g: "+".join(axes)
               for g, axes in collectives.group_axes.items()
               if set(axes) <= set(names)}
    axis_of.update({mesh.get_group(i).group_name: name
                    for i, name in enumerate(names)})
    per_op: Dict[str, float] = {}
    count: Dict[str, int] = {}
    axes: Dict[str, Dict[str, float]] = {}
    wire = 0.0
    for op, b, group in trace.collectives:
        w = b * (2.0 if op == "all-reduce" else 1.0)
        per_op[op] = per_op.get(op, 0.0) + b
        count[op] = count.get(op, 0) + 1
        wire += w
        ax = axes.setdefault(axis_of.get(group, "world"),
                             {"bytes": 0.0, "wire_bytes": 0.0, "calls": 0})
        ax["bytes"] += b
        ax["wire_bytes"] += w
        ax["calls"] += 1
    return {"bytes_by_op": per_op, "count_by_op": count, "wire_bytes": wire,
            "total_bytes": sum(per_op.values()), "by_axis": axes}


def _within_host(mesh, dim_name: str) -> bool:
    """Whether every group along mesh axis ``dim_name`` (or axes,
    ``"pod+data"``) lies on one host of ``HardwareSpec.HOST_CARDS``
    consecutive ranks."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    dims = [mesh.mesh_dim_names.index(n) for n in dim_name.split("+")]
    size = math.prod(mesh.size(i) for i in dims)
    with unset_fake_temporarily():     # the mesh's ranks are real
        groups = mesh.mesh.movedim(dims, list(range(-len(dims), 0))) \
            .reshape(-1, size)
        hosts = groups // HardwareSpec.HOST_CARDS
        return bool((hosts == hosts[:, :1]).all())


def roofline(flops: float, bytes_: float, coll: Dict[str, Any],
             mesh) -> Dict[str, Any]:
    """Seconds a step needs at the card's data-sheet rates."""
    hw = HardwareSpec
    coll_s = 0.0
    for ax, rec in coll["by_axis"].items():
        fast = ax != "world" and _within_host(mesh, ax)
        coll_s += rec["wire_bytes"] / (hw.NVLINK_BW if fast else hw.NIC_BW)
    terms = {"compute_s": flops / hw.PEAK_BF16,
             "memory_s": bytes_ / hw.PEAK_BYTES, "collective_s": coll_s}
    terms["dominant"] = max(("compute_s", "memory_s", "collective_s"),
                            key=lambda k: terms[k])
    return terms


# ------------------------------------------------------------- the case ---

def place(tree, specs, mesh):
    """``tree`` laid out on ``mesh`` by ``specs`` as DTensors: a ``meta``
    leaf becomes an empty local block (a fake one under
    ``FakeTensorMode``), a real leaf (the same on every rank) is
    distributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    device = torch.device(mesh.device_type)

    def one(leaf, spec):
        pl = shard_specs.named(mesh, spec)
        if leaf.device.type != "meta":
            return distribute_tensor(leaf.to(device), mesh, pl)
        local = torch.empty(shard_specs.local_shape(leaf.shape, spec, mesh),
                            dtype=leaf.dtype, device=device)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=leaf.shape, stride=leaf.stride())

    return utils.tree_map(one, tree, specs)


def _fsdp_cfg(cfg, mesh, act_axes):
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return cfg.replace(act_shard_axes=tuple(act_axes),
                       fsdp_model_size=sizes["model"])


def build_case(arch: str, shape_name, mesh, *, dcco_impl: str = "fused",
               remat: str = "auto", num_microbatches: int = 16,
               sharding: str = "tp", parallel_block: bool = False,
               kv_int8: bool = False, cfg=None, values=None):
    """Returns (step, args): the step of ``shape_name`` (a name of
    ``launch.inputs.INPUT_SHAPES`` or an ``InputShape``) and its inputs
    laid out on ``mesh`` as DTensors: empty (meta leaves made local, fake
    under ``FakeTensorMode``), or the real trees of ``values`` (a dict
    with any of "params", "opt_state", "batch", "cache", each the same on
    every rank), distributed.

    The reference's overrides: bf16, the blockwise (flash) attention,
    remat on train shapes, the long-context variant. Train: the D-CCO
    step with the loss of ``dcco_impl`` (micro ``num_microbatches``; 1 in
    FSDP mode, which spreads the batch over every axis and pins
    activations so that the products gather weights, not activations,
    and 1 for ``"shard_map"``, whose loss runs on each rank's rows over
    the data axes; the microbatched step takes every impl's gradient as
    the combine's, as the reference's does), tp or fsdp parameters,
    ZeRO-1 Adam moments. ``cfg`` replaces the arch's config (the tests'
    smoke towers: the overrides still apply, but the dtype is kept)."""
    shape = (inp.INPUT_SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    if remat == "auto":
        remat = "full" if shape.kind == "train" else "none"
    base = get_config(arch) if cfg is None else cfg
    cfg = base.replace(dtype="bfloat16" if cfg is None else base.dtype,
                       attn_impl="blockwise", remat=remat,
                       parallel_block=parallel_block,
                       kv_cache_dtype="int8" if kv_int8 else "model")
    cfg = inp.arch_variant_for_shape(cfg, shape)
    de_cfg = get_dual_encoder_config(arch)
    names = tuple(mesh.mesh_dim_names)
    data_ax = tuple(a for a in ("pod", "data") if a in names)
    values = values or {}

    def fill(name, tree):
        return values.get(name, tree)

    if shape.kind == "train":
        if dcco_impl not in dcco.IMPLS:
            raise ValueError(f"unknown dcco impl {dcco_impl!r}; expected "
                             f"one of {dcco.IMPLS}")
        tcfg = TrainConfig(global_batch=shape.global_batch,
                           samples_per_client=1, dcco_impl=dcco_impl)
        opt = opt_lib.adam(5e-3)
        total = math.prod(tuple(mesh.shape))
        if sharding == "fsdp":
            num_microbatches = 1
            cfg = _fsdp_cfg(cfg, mesh, names)
        if dcco_impl == "shard_map":
            # the loss on each rank's rows over the data axes, their
            # statistics reduced by one all-reduce; no microbatching
            num_microbatches = 1
        step = steps_lib.make_dcco_train_step(
            cfg, de_cfg, tcfg, opt, num_microbatches=num_microbatches,
            constrain_sharding=True, data_axes=data_ax)
        params = inp.dual_encoder_shapes(cfg, de_cfg)
        opt_state = inp.opt_state_shapes(opt, params)
        batch = inp.train_input_specs(cfg, shape)
        pspecs = shard_specs.param_pspecs(params, mesh, mode=sharding)
        ospecs = shard_specs.opt_state_pspecs(
            shard_specs.param_pspecs(opt_state, mesh, mode=sharding),
            opt_state, mesh)

        def bspec(x):
            if sharding == "fsdp" and x.shape[0] % total == 0:
                return shard_specs.P(names, *([None] * (x.ndim - 1)))
            return shard_specs.batch_pspec(mesh, x.ndim, x.shape[0])

        bspecs = utils.tree_map(bspec, batch)
        mspecs = {"loss": shard_specs.P(), "encoding_std": shard_specs.P()}
        return _laid_out(step, (pspecs, ospecs, mspecs), mesh), (
            place(fill("params", params), pspecs, mesh),
            place(fill("opt_state", opt_state), ospecs, mesh),
            place(fill("batch", batch), bspecs, mesh))

    params = inp.param_shapes(cfg)
    if shape.kind == "prefill":
        if sharding == "fsdp":
            cfg = _fsdp_cfg(cfg, mesh, data_ax)
        step = steps_lib.make_prefill_step(cfg, max_len=shape.seq_len)
        batch = inp.prefill_input_specs(cfg, shape)
        pspecs = shard_specs.param_pspecs(params, mesh, mode=sharding)
        bspecs = utils.tree_map(lambda x: shard_specs.batch_pspec(
            mesh, x.ndim, x.shape[0]), batch)
        return step, (place(fill("params", params), pspecs, mesh),
                      place(fill("batch", batch), bspecs, mesh))

    step = steps_lib.make_serve_step(cfg)
    cache = inp.cache_shapes(cfg, shape.global_batch, shape.seq_len)
    batch = inp.decode_input_specs(cfg, shape)
    pspecs = shard_specs.param_pspecs(params, mesh)
    cspecs = shard_specs.cache_pspecs(cache, mesh,
                                      seq_shard=shape.global_batch == 1)
    bspecs = utils.tree_map(lambda x: shard_specs.batch_pspec(
        mesh, x.ndim, x.shape[0]), batch)
    logits = shard_specs.batch_pspec(mesh, 2, shape.global_batch)
    return _laid_out(step, (logits, cspecs), mesh), (
                  place(fill("params", params), pspecs, mesh),
                  place(fill("cache", cache), cspecs, mesh),
                  place(fill("batch", batch), bspecs, mesh))


def _laid_out(step, out_specs, mesh):
    """``step`` with its outputs redistributed to ``out_specs`` (the
    reference's ``out_shardings``: the gathers of ZeRO-1's updated
    parameters are the step's own)."""
    def laid_out(*args):
        return utils.tree_map(
            lambda t, spec: t.redistribute(mesh, shard_specs.named(
                mesh, spec)), step(*args), out_specs)
    laid_out.grads = getattr(step, "grads", None)
    return laid_out


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks in this process (rank 0),
    destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        collectives.group_axes.clear()
        dist.destroy_process_group()


def trace_step(step, args, mesh) -> Dict[str, Any]:
    """Run ``step(*args)`` under :class:`Trace` and the flash recorder,
    the recurrences' steps folded into the batch
    (:func:`repro_torch.models.common.fold_scans`); returns the record's numbers (memory, FLOPs, bytes, collectives,
    roofline)."""
    arg_bytes = local_bytes(args)
    with flash_mod.record_calls() as calls, common.fold_scans(), \
            Trace(existing=_tensors(args)) as tr:
        out = step(*args)
        out_bytes = local_bytes(out)
        n_out = len(_tensors(out))
    flash = sum(flash_mod.call_flops(c) for c in calls)
    flops = tr.flops + flash
    coll = collective_stats(tr, mesh)
    return {
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "output_size_in_bytes": out_bytes,
                   "temp_size_in_bytes": tr.peak,
                   "peak_bytes": arg_bytes + tr.peak,
                   "output_leaves": n_out},
        "flops_per_device": float(flops), "flash_flops": float(flash),
        "flash_calls": sum(c[0] == "forward" for c in calls),
        "flash_backward_calls": sum(c[0] == "backward" for c in calls),
        "bytes_per_device": float(tr.bytes),
        "collectives": coll,
        "roofline": roofline(flops, tr.bytes, coll, mesh),
    }


def run_case(arch: str, shape_name, multi_pod: bool, *, device="cuda",
             world: Optional[int] = None, ranks_per_host: int = RANKS_PER_HOST,
             **kw) -> Dict[str, Any]:
    """Trace one case on a fake world (the reference's (16, 16), or (2,
    16, 16) with ``multi_pod``; ``world`` and ``ranks_per_host`` give
    the tests' small worlds) and return its record."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    dev = utils.resolve_device(device)
    world = world or (2 * POD_RANKS if multi_pod else POD_RANKS)
    with fake_world(world):
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    ranks_per_host=ranks_per_host,
                                    device_type=dev.type)
        t0 = time.time()
        with FakeTensorMode(allow_non_fake_inputs=True):
            step, args = build_case(arch, shape_name, mesh, **kw)
            rec = trace_step(step, args, mesh)
    name = shape_name if isinstance(shape_name, str) else shape_name.name
    kind = (inp.INPUT_SHAPES[shape_name] if isinstance(shape_name, str)
            else shape_name).kind
    impl = {"dcco_impl": kw.get("dcco_impl", "fused")} \
        if kind == "train" else {}
    return {"arch": arch, "shape": name, "multi_pod": multi_pod, **impl,
            "chips": world, "mesh": dict(zip(mesh.mesh_dim_names,
                                             tuple(mesh.shape))),
            "device": dev.type, "trace_s": round(time.time() - t0, 2),
            **rec}


def _case(job):
    """One case of the sweep: (key, record or error record, log)."""
    key, arch, shape_name, mp, kw = job
    kw = dict(kw)
    if kw.pop("bf16_comm"):
        common.set_matmul_preferred(torch.bfloat16)
    log = f"[dryrun] {key} ...\n"
    try:
        rec = run_case(arch, shape_name, mp, **kw)
        r, m = rec["roofline"], rec["memory"]
        log += (f"  ok trace={rec['trace_s']}s "
                f"peak={m['peak_bytes'] / 2 ** 30:.3f}GiB "
                f"compute={r['compute_s']:.4f}s mem={r['memory_s']:.4f}s "
                f"coll={r['collective_s']:.4f}s dom={r['dominant']}\n")
    except Exception as e:  # noqa: BLE001 (a case's failure is recorded
        # and the sweep goes on)
        log += traceback.format_exc()
        rec = {"error": f"{type(e).__name__}: {e}", "arch": arch,
               "shape": shape_name, "multi_pod": mp}
    finally:
        common.set_matmul_preferred(None)
    return key, rec, log


def load_results(path: str) -> Dict[str, Any]:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--out", default=RESULTS_PATH)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--dcco-impl", default="fused")
    ap.add_argument("--remat", default="auto")
    ap.add_argument("--micro", type=int, default=16)
    ap.add_argument("--sharding", choices=["tp", "fsdp"], default="tp")
    ap.add_argument("--parallel-block", action="store_true")
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--bf16-comm", action="store_true",
                    help="bf16 matmul partial sums -> bf16 TP all-reduces")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--device", default=None,
                    help="cuda (default: fake tensors of the card) or cpu")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cases traced at once, each in a process of its "
                         "own (a trace is single-threaded Python)")
    args = ap.parse_args(argv)

    if args.arch is not None and args.arch not in DRYRUN_ARCHS:
        ap.error(f"unknown arch {args.arch!r}; expected one of "
                 f"{DRYRUN_ARCHS}")
    if args.shape is not None and args.shape not in inp.INPUT_SHAPES:
        ap.error(f"unknown shape {args.shape!r}; expected one of "
                 f"{tuple(inp.INPUT_SHAPES)}")
    if not (args.all or args.arch or args.shape):
        ap.error("give --arch, --shape or --all")
    device = utils.resolve_device(args.device)
    archs = [args.arch] if args.arch else list(DRYRUN_ARCHS)
    shapes = [args.shape] if args.shape else list(inp.INPUT_SHAPES)
    pods = {"single": [False], "multi": [True],
            "both": [False, True]}[args.multi_pod]
    results = load_results(args.out)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    kw = {"device": device.type, "dcco_impl": args.dcco_impl,
          "remat": args.remat, "num_microbatches": args.micro,
          "sharding": args.sharding, "parallel_block": args.parallel_block,
          "kv_int8": args.kv_int8, "bf16_comm": args.bf16_comm}
    cases = []
    for arch in archs:
        for shape_name in shapes:
            for mp in pods:
                key = (f"{args.tag}/{arch}/{shape_name}/"
                       f"{'multi' if mp else 'single'}")
                if key in results and not args.force:
                    print(f"[skip cached] {key}")
                    continue
                cases.append((key, arch, shape_name, mp, kw))
    failures = []
    if args.jobs > 1:
        import multiprocessing
        pool = multiprocessing.get_context("spawn").Pool(args.jobs,
                                                         maxtasksperchild=1)
        done = pool.imap_unordered(_case, cases)
    else:
        pool, done = None, map(_case, cases)
    try:
        for key, rec, log in done:
            print(log, end="", flush=True)
            results[key] = rec
            if "error" in rec:
                failures.append((key, rec["error"]))
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    finally:
        if pool is not None:
            pool.close()
            pool.join()
    print(f"done. {len(failures)} failures")
    for k, e in failures:
        print(" FAIL", k, e[:300])
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
