"""DTensor support of the model code: the helpers that let a tower run on
``torch.distributed.tensor.DTensor`` parameters and activations, as the
reference's towers run under XLA's SPMD partitioner.

XLA reshards whatever a program needs by itself; DTensor runs each op
by its sharding rule and refuses what it has no rule for. So the model
code calls these at the few places a rule is missing or would move the
wrong data:

  ``is_dtensor``       whether a tensor is a DTensor;
  ``replicated``       a tensor every rank computes alike (a frequency
                       table, an ``arange``), as a replicated DTensor on
                       a DTensor's mesh;
  ``positions``        the (B, S) positions of an activation, its rows
                       placed as the activation's are;
  ``settle``           the pending sums of a ``Partial`` placement
                       reduced (one all-reduce each) and the result cast;
  ``replicate_dim``    a tensor dimension gathered over the mesh
                       dimensions that shard it (XLA's reshard before a
                       reshape that does not split evenly);
  ``offset``           where this rank's block of a dimension starts;
  ``grad_as``          a tensor whose gradient arrives in its own layout;
  ``replicated_call``  small math on replicated DTensors under
                       ``local_map`` (each rank on its copy);
  ``rows_map``         a block run under ``local_map`` on this rank's
                       rows of a batch-sharded activation, its weights
                       replicated: each rank computes its rows, which is
                       what XLA SPMD compiles for the recurrent mixers.

Each helper returns a plain tensor's value unchanged, so the single-device
path computes exactly what it computed without them.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils import _pytree as pytree


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def replicated(t: torch.Tensor, ref) -> torch.Tensor:
    """``t`` (the same value on every rank) as a replicated DTensor on
    ``ref``'s mesh when ``ref`` is a DTensor and ``t`` is not; else
    ``t``."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def row_placements(x) -> list:
    """``x``'s placements on its leading (row) dimension alone: ``Shard(0)``
    where ``x`` shards it, ``Replicate()`` elsewhere."""
    return [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in x.placements]


def positions(x, s: int) -> torch.Tensor:
    """The positions 0..s-1 of each row of ``x`` (B, ...): (B, s) int64,
    a DTensor whose rows are placed as ``x``'s when ``x`` is one."""
    b = x.shape[0]
    if not is_dtensor(x):
        return torch.arange(s, device=x.device)[None].expand(b, s)
    rows = row_placements(x)
    local_b = b // _blocks(x.device_mesh, rows, 0)
    local = torch.arange(s, device=x.device)[None].expand(local_b, s)
    return DTensor.from_local(local, x.device_mesh, rows, run_check=False,
                              shape=torch.Size((b, s)), stride=(0, 1))


def _blocks(mesh, placements, dim: int) -> int:
    """How many blocks ``placements`` cut tensor dimension ``dim`` into
    (the layouts here split evenly)."""
    n = 1
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            n *= mesh.size(i)
    return n


def shards(x, dim: int) -> int:
    """How many blocks ``x``'s dimension ``dim`` is cut into."""
    if not is_dtensor(x):
        return 1
    return _blocks(x.device_mesh, x.placements, dim % x.ndim)


def offset(x, dim: int) -> int:
    """Where this rank's block of ``x``'s dimension ``dim`` starts (0 for
    a plain tensor): its index over the mesh dimensions that split
    ``dim``, row-major in mesh order (DTensor's nesting), times the
    block's size."""
    if not is_dtensor(x):
        return 0
    mesh, dim = x.device_mesh, dim % x.ndim
    coord = mesh.get_coordinate()
    idx = 0
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            idx = idx * mesh.size(i) + coord[i]
    return idx * (x.shape[dim] // shards(x, dim))


def is_pending(y) -> bool:
    """Whether ``y`` is a DTensor holding pending (``Partial``) sums."""
    return is_dtensor(y) and any(p.is_partial() for p in y.placements)


def settle(y, dtype=None):
    """``y`` with each ``Partial`` placement reduced to ``Replicate()`` (an
    all-reduce in ``y``'s type), then cast to ``dtype`` where given."""
    if is_pending(y):
        y = y.redistribute(y.device_mesh, [
            Replicate() if p.is_partial() else p for p in y.placements])
    return y if dtype is None else y.to(dtype)


def replicate_dim(x, dim: int):
    """``x`` with tensor dimension ``dim`` whole on every rank: each mesh
    dimension that shards it becomes ``Replicate()`` (an all-gather)."""
    if not is_dtensor(x):
        return x
    dim %= x.ndim
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(
        x.device_mesh, pl)


def grad_as(x):
    """``x``, whose gradient arrives laid out as ``x`` is (redistributed
    there, where an op's rule left it elsewhere): a reshape whose
    backward could not split the gradient's layout (attention heads
    that do not divide over a mesh axis) then sees its own layout."""
    if not is_dtensor(x):
        return x
    return DTensor.from_local(x.to_local(grad_placements=x.placements),
                              x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def local_map_tree(fn, mesh, args: Sequence, out_placements):
    """``local_map`` over trees: ``args`` is a list of (tree, placements,
    gradient placements) triples, every tensor leaf of a tree laid out by
    that triple's placements (inputs are redistributed to them; None:
    each leaf's own) and its gradient by the gradient placements (None:
    the placements); ``out_placements`` is the flat list of the outputs'
    placements, in ``torch.utils._pytree`` order. ``fn`` takes the trees'
    local values."""
    from torch.distributed.tensor.experimental import local_map

    trees, in_pl, grad_pl = [], [], []
    for tree, pl, gpl in args:
        trees.append(tree)
        for leaf in pytree.tree_leaves(tree):
            if not isinstance(leaf, torch.Tensor):
                in_pl.append(None)
                grad_pl.append(None)
                continue
            lpl = tuple(leaf.placements if pl is None else pl)
            in_pl.append(lpl)
            grad_pl.append(tuple(gpl) if gpl is not None else lpl)
    return local_map(fn, out_placements=tuple(out_placements),
                     in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                     redistribute_inputs=True)(*trees)


def replicated_call(fn, *args):
    """``fn(*args)`` of DTensors that every rank holds whole (statistics
    once reduced), under ``local_map`` on each rank's copy: the result is
    replicated, and so are the gradients. Plain tensors call ``fn``
    itself. DTensor has no rule for some ops of such small math (the CCO
    loss's ``diagonal`` backward)."""
    tensors = [t for t in pytree.tree_leaves(args) if is_dtensor(t)]
    if not tensors:
        return fn(*args)
    mesh = tensors[0].device_mesh
    rep = [Replicate()] * mesh.ndim
    return local_map_tree(lambda *a: fn(*a), mesh,
                          [(a, rep, None) for a in args], [rep])


def rows_map(fn, x, params, state=None):
    """``fn(x, params[, state])`` on this rank's rows of the activation
    ``x`` (B, ...), or of each leaf of a tree of such (laid out as its
    first leaf's rows), and replicated ``params``, under ``local_map``:
    the output and the new state (the recurrent blocks' ``(y, state)``,
    or ``y``) have ``x``'s row placements. A weight's gradient is a
    partial sum over the mesh dimensions that shard the rows; parameters
    stored sharded (tensor parallel or FSDP) are gathered for the call."""
    lead = pytree.tree_leaves(x)[0]
    mesh = lead.device_mesh
    rows = row_placements(lead)
    rep = [Replicate()] * mesh.ndim
    wgrad = [Partial() if isinstance(p, Shard) else Replicate()
             for p in rows]
    args = [(x, rows, None), (params, rep, wgrad)]
    if state is None:
        return local_map_tree(fn, mesh, args, [rows])
    args.append((state, rows, None))
    n_state = len(pytree.tree_leaves(state))
    return local_map_tree(fn, mesh, args, [rows] * (1 + n_state))
