"""Small shared utilities: tree helpers over nested dicts/lists of tensors,
and the device policy of every entry point."""
from __future__ import annotations

from typing import Any, Callable

import torch

PyTree = Any  # nested dict / list / tuple of tensors

F32 = torch.float32


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, or in its own type where that is wider (f64): the
    reference computes statistics and norms in f32 whatever the model's
    type; the port lets an f64 model stay in f64."""
    return x.to(torch.promote_types(x.dtype, F32))


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """Apply ``fn`` leafwise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def tree_leaves(tree: PyTree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_cast(tree: PyTree, dtype) -> PyTree:
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


def tree_sub(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.sub, a, b)


def tree_scale(a: PyTree, s) -> PyTree:
    return tree_map(lambda x: x * s, a)


def tree_max_abs_diff(a: PyTree, b: PyTree) -> float:
    diffs = [float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
             for x, y in zip(tree_leaves(a), tree_leaves(b))]
    return max(diffs) if diffs else 0.0


def resolve_device(device=None) -> torch.device:
    """The device of an entry point: ``cuda`` unless ``device="cpu"``.

    Raises when CUDA is asked for (explicitly or by default) and none is
    present: nothing falls back to the CPU silently. It also pins f32
    math, since every entry point passes through here: cuDNN convolutions
    default to TF32, and the reference computes in f32.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return dev


_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` (splitmix64 of their
    mix): the port's counterpart of ``jax.random.fold_in``, for deriving
    independent ``torch.Generator`` streams from one seed."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(data) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen
