"""msgpack checkpoints of tensor trees, in the reference's file format.

One file per checkpoint: a msgpack map ``{"step", "paths", "leaves"}``
where ``paths`` names each leaf and every leaf is ``{"dtype", "shape",
"data"}`` (the dtype's numpy name, the shape, the raw C-order bytes).
It is written to ``path + ".tmp"`` and then moved over ``path``, so a
reader never sees half a file. The bytes are the reference's
(``repro.checkpoint``) for the same tree, and each package restores the
other's files.

Leaf paths are the reference's: the keys from the root joined by ``/``,
a dict key as itself, a list or tuple position as its index and a
NamedTuple field as ``"." + name`` (``drift/.c/tower/...``); dict keys
are visited sorted, as JAX flattens them. ``None`` and empty containers
hold no leaf. bfloat16 leaves are stored under the dtype ``"bfloat16"``
with their raw bits.

Tensors are written in the layout they have: a ResNet checkpoint of the
port holds OIHW convolution weights where the reference's holds HWIO
(``repro_torch.convert`` carries parameters across).
"""
from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack
from repro_torch.utils import resolve_device

_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_paths(tree, prefix=()):
    """[(path tuple, leaf)] in the reference's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten_with_paths(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [item for name, v in zip(tree._fields, tree)
                for item in _flatten_with_paths(v, prefix + ("." + name,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in _flatten_with_paths(v, prefix + (str(i),))]
    return [(prefix, tree)]


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in flatten order,
    by the iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        new = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        out = [_unflatten(v, leaves) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    return next(leaves)


def _record(x) -> dict:
    """One leaf's ``{"dtype", "shape", "data"}``, gathered to the host."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype not in _NAMES:
            raise TypeError(f"cannot checkpoint a {t.dtype} tensor")
        data = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        return {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                "data": data}
    a = np.asarray(x)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "data": np.ascontiguousarray(a).tobytes()}


def _tensor(rec, device) -> torch.Tensor:
    """A record's tensor on ``device`` (a copy: it does not alias the
    file's buffer)."""
    name = rec["dtype"]
    if name not in _DTYPES:
        raise TypeError(f"checkpoint leaf of dtype {name!r} has no torch "
                        f"counterpart")
    dtype, shape = _DTYPES[name], tuple(rec["shape"])
    if not memoryview(rec["data"]).nbytes:
        return torch.empty(shape, dtype=dtype, device=device)
    t = torch.frombuffer(rec["data"], dtype=dtype).reshape(shape)
    return t.clone() if torch.device(device).type == "cpu" else t.to(device)


def save_checkpoint(path: str, tree: Any, step: int = 0) -> None:
    """Write ``tree`` (nested dicts, lists, tuples and NamedTuples of
    tensors or arrays) and ``step`` to ``path``."""
    flat = _flatten_with_paths(tree)
    payload = {"step": int(step),
               "paths": ["/".join(p) for p, _ in flat],
               "leaves": [_record(x) for _, x in flat]}
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        f.writelines(_msgpack.pack_chunks(payload))
    os.replace(tmp, path)


def _read(path: str) -> dict:
    with open(path, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        f.readinto(buf)
    return _msgpack.unpackb(buf)


def restore_checkpoint_flat(path: str, device="cpu"):
    """Templateless restore: ``({path: tensor}, step)`` keyed by the
    '/'-joined leaf paths the checkpoint was saved with, the tensors on
    ``device`` (the host by default). For consumers that own their layout
    (``CorpusIndex.load``) and rebuild it from the keys."""
    payload = _read(path)
    flat = {p: _tensor(rec, device)
            for p, rec in zip(payload["paths"], payload["leaves"])}
    return flat, payload["step"]


def restore_checkpoint(path: str, like: Any, device: Optional[Any] = None):
    """Restore into the structure of ``like``: ``(tree, step)``. Each leaf
    of ``like`` is looked up by its path in the file (a missing path
    raises ``KeyError``; leaves of the file that ``like`` lacks are
    ignored) and takes the file's dtype and shape, as the reference's
    restore does. Tensors land on ``device``: the card unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    payload = _read(path)
    stored = dict(zip(payload["paths"], payload["leaves"]))
    leaves = []
    for p, _ in _flatten_with_paths(like):
        key = "/".join(p)
        if key not in stored:
            raise KeyError(f"{key!r} is not in checkpoint {path}")
        leaves.append(_tensor(stored[key], dev))
    return _unflatten(like, iter(leaves)), payload["step"]
