"""The mesh collectives of the sharded paths, over ``torch.distributed``.

The reference writes its sharded paths as ``shard_map`` bodies over a JAX
``Mesh``: ``psum``/``pmean`` over a mesh axis (or a tuple of axes),
``all_gather`` along one, and ``lax.axis_index`` for the shard's place.
Here every rank runs the same program (SPMD) over a
``torch.distributed.device_mesh.DeviceMesh`` whose dimension names are the
reference's axis names, and these helpers are those primitives:

  ``axis_size``      the number of shards over an axis or a tuple of axes;
  ``axis_index``     this rank's linear index over them, row-major over
                     the tuple (the reference's ``_linear_axis_index``);
  ``psum_tree``      ``psum`` of a tree: the leaves of one dtype are
                     packed into one buffer and summed by ONE
                     ``all_reduce``;
  ``all_gather_tree`` ``all_gather`` of the leading axis of a tree,
                     packed the same way, in rank order.

``counts`` records each collective's calls and the bytes of the buffers
it reduced or gathered (this rank's buffer, from shapes): the counterpart
of the reference's ``dryrun.collective_stats``, which reads XLA's HLO;
PyTorch has no program to read, so the collectives count themselves.
``reset_counts()`` sets them to 0.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch import utils

counts = {"all_reduce": {"calls": 0, "bytes": 0},
          "all_gather": {"calls": 0, "bytes": 0}}


def reset_counts() -> None:
    for c in counts.values():
        c["calls"] = c["bytes"] = 0


def _count(kind: str, t: torch.Tensor) -> None:
    counts[kind]["calls"] += 1
    counts[kind]["bytes"] += t.numel() * t.element_size()


def axis_names(axis) -> Tuple[str, ...]:
    """One axis name or a tuple of them -> a tuple of names."""
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def check_mesh(mesh, axis) -> None:
    """Raise unless ``mesh`` is a DeviceMesh with every name of ``axis``."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise ValueError(
            f"mesh must be a torch.distributed.device_mesh.DeviceMesh over "
            f"the initialized world (repro_torch.launch.mesh."
            f"make_debug_mesh, repro_torch.sharding.make_multihost_mesh or "
            f"make_corpus_mesh), got {type(mesh).__name__}")
    missing = [n for n in axis_names(axis)
               if n not in (mesh.mesh_dim_names or ())]
    if missing:
        raise ValueError(f"mesh {mesh.mesh_dim_names} has no axis "
                         f"{missing[0]!r}")


def axis_size(mesh, axis) -> int:
    size = 1
    for name in axis_names(axis):
        size *= mesh.size(mesh.mesh_dim_names.index(name))
    return size


def axis_index(mesh, axis) -> int:
    """This rank's linear index over ``axis``: row-major over a tuple."""
    coord = mesh.get_coordinate()
    idx = 0
    for name in axis_names(axis):
        dim = mesh.mesh_dim_names.index(name)
        idx = idx * mesh.size(dim) + coord[dim]
    return idx


# the process groups that ``axis_group`` made for tuples of axes: group
# name -> the axes, so that a count can be told by its axes
group_axes = {}
_axes_groups = {}


def axis_group(mesh, axis):
    """The process group of ``axis``: a dimension's group, for a tuple of
    axes spanning the whole world the world's, and for a tuple of some
    of the axes the group of this rank's block of ranks that differ
    only there (the reference's psum over a tuple of axes is one
    collective). Its group ranks are the linear indices of
    ``axis_index``, which is what makes a gather in rank order the
    reference's concatenation of shards."""
    names = axis_names(axis)
    if len(names) == 1:
        return mesh.get_group(names[0])
    if list(names) != [n for n in mesh.mesh_dim_names if n in names]:
        raise ValueError(
            f"a tuple of axes {names} must name dimensions in the mesh's "
            f"order {mesh.mesh_dim_names}")
    if axis_size(mesh, names) != dist.get_world_size():
        return _axes_group(mesh, names)
    if dist.get_rank() != axis_index(mesh, names):
        raise ValueError("the mesh must enumerate the world's ranks in "
                         "row-major order (init_device_mesh does)")
    return dist.group.WORLD


def _axes_group(mesh, names):
    """The process group of this rank's block of ranks that differ only
    over the mesh dimensions ``names`` (every rank makes every block's
    group, in one order), made once a world. It is a group of its own,
    not a flattened dimension of the mesh, so DTensor's own reductions
    over those dimensions go on as they were."""
    from torch.utils._python_dispatch import _disable_current_modes

    dims = [mesh.mesh_dim_names.index(n) for n in names]
    # the mesh's rank table is a real tensor, whatever mode traces the
    # caller (the dry run's fake tensors and counters)
    with _disable_current_modes():
        blocks = mesh.mesh.movedim(dims, list(range(-len(dims), 0))) \
            .reshape(-1, axis_size(mesh, names)).tolist()
    key = (tuple(map(tuple, blocks)), tuple(names))
    group = _axes_groups.get(key)
    if group is not None:
        try:
            dist.get_group_rank(group, dist.get_rank())
        except (ValueError, RuntimeError):
            group = None                # an earlier world's
    if group is None:
        group, _ = dist.new_subgroups_by_enumeration(blocks)
        if dist.get_group_rank(group, dist.get_rank()) != \
                axis_index(mesh, names):
            raise ValueError("the mesh must enumerate its ranks in "
                             "row-major order (init_device_mesh does)")
        _axes_groups[key] = group
    group_axes[group.group_name] = tuple(names)
    return group


def _by_dtype(leaves):
    """Leaf positions grouped by dtype, in first-seen order."""
    groups = {}
    for i, x in enumerate(leaves):
        groups.setdefault(x.dtype, []).append(i)
    return groups.values()


def psum_tree(tree, mesh, axis):
    """The sum of ``tree`` over the ranks of ``axis``, on every rank: one
    ``all_reduce`` for each dtype among the leaves. Not differentiable:
    callers reduce values, never a graph."""
    group = axis_group(mesh, axis)
    leaves = utils.tree_leaves(tree)
    out = list(leaves)
    for idx in _by_dtype(leaves):
        flat = torch.cat([leaves[i].detach().reshape(-1) for i in idx])
        _count("all_reduce", flat)
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        for i, part in zip(idx, torch.split(
                flat, [leaves[i].numel() for i in idx])):
            out[i] = part.view(leaves[i].shape)
    it = iter(out)
    return utils.tree_map(lambda _: next(it), tree)


def pmean_tree(tree, mesh, axis):
    """The mean of ``tree`` over the ranks of ``axis`` (equal shards)."""
    s = axis_size(mesh, axis)
    return utils.tree_map(lambda x: x / s, psum_tree(tree, mesh, axis))


def all_gather_tree(tree, mesh, axis):
    """Concatenate the leading axis of ``tree``'s leaves over the ranks of
    ``axis`` in rank order: (k, ...) on each rank -> (S * k, ...) on every
    rank. One ``all_gather`` for each dtype among the leaves."""
    group = axis_group(mesh, axis)
    s = axis_size(mesh, axis)
    leaves = utils.tree_leaves(tree)
    k = leaves[0].shape[0]
    out = list(leaves)
    for idx in _by_dtype(leaves):
        rows = torch.cat([leaves[i].detach().reshape(k, -1) for i in idx],
                         dim=1).contiguous()
        parts = [torch.empty_like(rows) for _ in range(s)]
        _count("all_gather", rows)
        dist.all_gather(parts, rows, group=group)
        full = torch.cat(parts)
        widths = [leaves[i][0].numel() for i in idx]
        for i, part in zip(idx, torch.split(full, widths, dim=1)):
            out[i] = part.reshape((s * k,) + tuple(leaves[i].shape[1:]))
    it = iter(out)
    return utils.tree_map(lambda _: next(it), tree)
