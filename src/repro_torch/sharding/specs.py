"""Logical-axis sharding rules -> partition-spec trees, and their DTensor
placements.

Mesh axes: ("pod",)? + ("data", "model"). Batch/client dims shard over
(pod, data); weight feature dims shard over model (tensor parallel);
MoE expert dims shard over model (expert parallel). Every rule is
divisibility-aware: a dim that does not divide by the axis size stays
replicated (e.g. kv_heads=8 on model=16).

Baseline policy (the reference's): SSM / xLSTM mixer weights replicated
(their fused in-projections interleave semantic segments, so naive column
sharding would need resharding collectives); attention + FFN + MoE +
embedding sharded. The FSDP mode (see ``param_pspecs``) shards every >=2D
weight by storage, the recurrent mixers included.

The rules read a mesh's axis names and sizes only: they take a
``torch.distributed.device_mesh.DeviceMesh`` or any stand-in with its
``mesh_dim_names`` and ``shape``, so a 256-rank layout is checked without
256 ranks. A spec (:class:`PartitionSpec`, alias ``P``) has one entry per
tensor dimension, each an axis name, a tuple of names (one dimension over
several mesh axes, major to minor) or None; ``P()`` replicates a tensor of
any rank. ``named(mesh, spec)`` turns a spec into the DTensor placements
of ``torch.distributed.tensor.distribute_tensor``. Leaves are addressed by
their path, the ``/``-joined dict keys and list indices of the tree (e.g.
``layers/b0/attn/wq/w``), as the reference's ``_path_str`` joins JAX's
key paths; stacked superblock leaves carry their leading layer axis.
"""
from __future__ import annotations

import math
from typing import Any, Tuple

DATA_AXES: Tuple[str, ...] = ("pod", "data")   # present subset used


class PartitionSpec:
    """One entry per tensor dimension: an axis name, a tuple of axis
    names, or None (replicated along that dimension)."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(tuple(p) if isinstance(p, list) else p
                           for p in parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self):
        return len(self.parts)

    def __eq__(self, other):
        return (isinstance(other, PartitionSpec)
                and self.parts == other.parts)

    def __hash__(self):
        return hash(self.parts)

    def __repr__(self):
        return f"P{self.parts!r}" if len(self.parts) != 1 \
            else f"P({self.parts[0]!r})"


P = PartitionSpec


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _axis_size(mesh, name: str) -> int:
    return _sizes(mesh).get(name, 1)


def data_axes(mesh):
    """The data axes present in ``mesh``: a tuple of two, one name, or
    None."""
    axes = tuple(a for a in DATA_AXES if a in mesh.mesh_dim_names)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def _names(ax) -> Tuple[str, ...]:
    return ax if isinstance(ax, tuple) else ((ax,) if ax else ())


def _data_size(mesh) -> int:
    return math.prod(_axis_size(mesh, a) for a in _names(data_axes(mesh)))


def named(mesh, spec: PartitionSpec):
    """The DTensor placements of ``spec`` on ``mesh``: one per mesh
    dimension, ``Shard(d)`` where tensor dimension ``d`` names it, else
    ``Replicate()``. A dimension over a tuple of axes is sharded in mesh
    order, which is the tuple's major-to-minor order only when the tuple
    lists them in mesh order; any other order raises ValueError."""
    from torch.distributed.tensor import Replicate, Shard

    dims = list(mesh.mesh_dim_names)
    placements = [Replicate() for _ in dims]
    for d, entry in enumerate(spec):
        names = _names(entry)
        where = []
        for a in names:
            if a not in dims:
                raise ValueError(f"spec {spec} names axis {a!r}, not in the "
                                 f"mesh's {tuple(dims)}")
            if not isinstance(placements[dims.index(a)], Replicate):
                raise ValueError(f"spec {spec} uses axis {a!r} twice")
            where.append(dims.index(a))
            placements[dims.index(a)] = Shard(d)
        if where != sorted(where):
            raise ValueError(
                f"spec {spec} lists axes {names} out of the mesh's order "
                f"{tuple(dims)}: DTensor shards one dimension over several "
                f"mesh axes in mesh order only")
    return placements


def _map_with_path(fn, tree, *rest, path: str = ""):
    """``fn(path, leaf, *rest_leaves)`` over a tree of dicts and lists
    (tuples); a :class:`PartitionSpec` is a leaf."""
    def join(k):
        return f"{path}/{k}" if path else str(k)

    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], *(r[k] for r in rest),
                                  path=join(k)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [_map_with_path(fn, t, *(r[i] for r in rest), path=join(i))
               for i, t in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(path, tree, *rest)


def _maybe(dim: int, size: int) -> bool:
    return size > 1 and dim % size == 0 and dim >= size


def _spec(ndim: int, shard_dim, axis) -> PartitionSpec:
    if shard_dim is None or axis is None:
        return P()
    parts = [None] * ndim
    parts[shard_dim] = axis
    return P(*parts)


# param-name rules: (substring, which dim of the *unstacked* weight to shard)
_OUT = ("wq/w", "wk/w", "wv/w", "gate/w", "up/w", "ffn_up/w", "w_uk/w", "w_uv/w")
_IN = ("wo/w", "down/w", "ffn_down/w", "out_proj/w")
_REPLICATE = ("router", "norm", "scale", "bias", "A_log", "dt_bias", "conv_w",
              "conv_b", "r_i", "r_f", "r_z", "r_o", "w_i", "w_f", "w_gates",
              "in_proj", "w_dkv", "kv_norm")


def param_pspecs(params: Any, mesh, mode: str = "tp") -> Any:
    """The spec tree of ``params`` (real or ``meta`` tensors).

    mode="tp"   — tensor parallel: attention-head/FFN/expert dims shard over
                  ``model``; contractions need per-layer activation
                  all-reduces. The baseline.
    mode="fsdp" — fully-sharded data parallel: every >=2D weight shards its
                  largest divisible dim over ``model`` as storage, gathered
                  a layer at a time.
    """
    if mode == "fsdp":
        return _fsdp_pspecs(params, mesh)
    if mode != "tp":
        raise ValueError(f"mode must be 'tp' or 'fsdp', got {mode!r}")
    msize = _axis_size(mesh, "model")

    def rule(pstr, leaf):
        shape = leaf.shape
        nd = len(shape)

        if any(s in pstr for s in _REPLICATE):
            return P()
        if "experts/" in pstr:
            # expert weights are 3D (E, d, f)/(E, f, d), 4D when stacked
            # (paths may carry tower/ or optimizer-state prefixes)
            e_dim = nd - 3
            if e_dim >= 0 and _maybe(shape[e_dim], msize):
                return _spec(nd, e_dim, "model")
            return P()
        if "embed/table" in pstr:               # (V, D)
            return _spec(nd, 0, "model") if _maybe(shape[0], msize) else P()
        if "unembed/w" in pstr:                 # (D, V)
            return _spec(nd, 1, "model") if _maybe(shape[1], msize) else P()
        if any(pstr.endswith(s) or f"/{s}" in pstr for s in _OUT):
            return _spec(nd, nd - 1, "model") if _maybe(shape[-1], msize) else P()
        if any(pstr.endswith(s) or f"/{s}" in pstr for s in _IN):
            return _spec(nd, nd - 2, "model") if _maybe(shape[-2], msize) else P()
        if pstr.endswith("up/w"):               # mlstm up proj
            return _spec(nd, nd - 1, "model") if _maybe(shape[-1], msize) else P()
        return P()

    return _map_with_path(rule, params)


def _fsdp_pspecs(params: Any, mesh) -> Any:
    msize = _axis_size(mesh, "model")

    def rule(pstr, leaf):
        shape = leaf.shape
        nd = len(shape)
        if nd < 2 or msize <= 1:
            return P()
        # a stacked leaf keeps its layer axis whole
        start = 1 if ("layers/" in pstr and nd >= 3) else 0
        cands = [(shape[i], i) for i in range(start, nd) if _maybe(shape[i], msize)]
        if not cands:
            return P()
        _, dim = max(cands)
        return _spec(nd, dim, "model")

    return _map_with_path(rule, params)


def opt_state_pspecs(opt_specs: Any, opt_state: Any, mesh) -> Any:
    """ZeRO-1: additionally shard optimizer moments over the data axes.

    Starting from the parameter-aligned specs ``opt_specs`` (e.g.
    ``param_pspecs(opt_state, mesh)``), the largest still-unsharded dim
    of every >=2D leaf of ``opt_state`` is sharded over (pod, data) when
    divisible."""
    ax = data_axes(mesh)
    dsize = _data_size(mesh)

    def rule(_, spec, leaf):
        shape = leaf.shape
        if len(shape) < 2 or dsize <= 1:
            return spec
        parts = list(spec) + [None] * (len(shape) - len(spec))
        cands = [(shape[i], i) for i in range(len(shape))
                 if parts[i] is None and _maybe(shape[i], dsize)]
        if not cands:
            return spec
        _, dim = max(cands)
        parts[dim] = ax
        return P(*parts)

    return _map_with_path(rule, opt_specs, opt_state)


def batch_pspec(mesh, ndim: int = 2, batch: int = 0) -> PartitionSpec:
    """Shard the leading (batch/client) dim over (pod, data) when it
    divides (``batch`` 0: unchecked)."""
    ax = data_axes(mesh)
    if batch and not _maybe(batch, _data_size(mesh)):
        return P(*([None] * ndim))
    return P(ax, *([None] * (ndim - 1)))


def cache_pspecs(cache: Any, mesh, *, seq_shard: bool = False) -> Any:
    """Specs of a decode cache (``transformer.init_cache``'s tree).

    Layouts: attn k/v (n_super, B, W, kvh, dh); mla latent (n_super, B, S,
    r), k_rope (n_super, B, S, dr); kv_pos (n_super, B, W); mamba conv
    (n_super, B, w-1, conv_dim), ssm (n_super, B, H, N, P); xlstm C/n/m
    (n_super, B, ...). Batch shards over (pod, data) when divisible, and
    then the seq/window dim of attention caches over ``model``. With
    ``seq_shard=True`` (batch 1, e.g. long_500k) the seq/window dim shards
    over the data axes instead, and kv heads over ``model`` when
    divisible."""
    ax = data_axes(mesh)
    dsize = _data_size(mesh)
    msize = _axis_size(mesh, "model")

    def rule(pstr, leaf):
        shape = leaf.shape
        nd = len(shape)
        if pstr.endswith("pos") and nd == 0:
            return P()
        has_super = pstr.startswith("layers/")
        b_dim = 1 if has_super else 0
        if nd <= b_dim:
            return P()
        parts = [None] * nd
        if not seq_shard and _maybe(shape[b_dim], dsize):
            parts[b_dim] = ax
            if nd >= b_dim + 2 and _maybe(shape[b_dim + 1], msize) and (
                    "kv_pos" in pstr or "scale" in pstr or
                    pstr.rsplit("/", 1)[-1] in ("k", "v") or
                    "latent" in pstr or "k_rope" in pstr):
                parts[b_dim + 1] = "model"
        elif seq_shard:
            if "kv_pos" in pstr and nd >= b_dim + 2 and _maybe(shape[b_dim + 1], dsize):
                parts[b_dim + 1] = ax
            elif any(k in pstr for k in ("/k", "/v", "latent", "k_rope", "scale")) \
                    and nd >= b_dim + 2 and _maybe(shape[b_dim + 1], dsize):
                parts[b_dim + 1] = ax
            if nd >= b_dim + 3 and pstr.rsplit("/", 1)[-1] in ("k", "v") \
                    and _maybe(shape[b_dim + 2], msize):
                parts[b_dim + 2] = "model"
        return P(*parts)

    return _map_with_path(rule, cache)


def local_shape(shape, spec: PartitionSpec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a tensor of ``shape`` laid out by
    ``spec`` (its dims divide, as the rules ensure)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        out[d] //= math.prod(_axis_size(mesh, a) for a in _names(entry))
    return tuple(out)


def device_bytes(tree: Any, specs: Any, mesh) -> int:
    """The bytes of one rank's blocks of ``tree`` laid out by ``specs``."""
    total = 0

    def add(_, leaf, spec):
        nonlocal total
        total += math.prod(local_shape(leaf.shape, spec, mesh)) \
            * leaf.element_size()
    _map_with_path(add, tree, specs)
    return total
