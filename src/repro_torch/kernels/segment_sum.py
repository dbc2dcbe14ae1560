"""Weighted segment sum of per-client rows: the wrapper of
``csrc/segment_sum.cu``.

Replaces ``repro/kernels/segment_sum.py::segment_sum_pallas`` (kernel body
``_segment_sum_kernel``): ``out[e] = sum_{k: ids[k] == e} w_k * rows[k]``
on (K, D) f32 rows in one pass, bit-identical to the plain version and the
same on every run. It is the one fold of the two-level tree
(:mod:`repro_torch.hierarchy`), the clustered round and k-means
(:mod:`repro_torch.cluster`) and the buffered engine's dispatch
(:mod:`repro_torch.core.buffer`). See the source for the design and its
bound on the card.

On a CUDA tensor the wrapper launches the kernel, or raises: it never
hands a CUDA tensor to the plain version. On a CPU tensor it runs the
plain version in :mod:`repro_torch.kernels.ref`. ``segment_sum.launches``
counts kernel launches (``{"fold": n}``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

F32 = torch.float32
I32 = torch.int32


def _device_type(t: torch.Tensor) -> str:
    return t.device.type


def _kernel():
    fn = _build.load("segment_sum").segment_sum_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def segment_sum(rows: torch.Tensor, ids: torch.Tensor, num_segments: int,
                weights: torch.Tensor = None) -> torch.Tensor:
    """rows: (K, D) f32; ids: (K,) int32; weights: (K,) f32 or None
    (w = 1) -> (num_segments, D) f32. Ids outside [0, num_segments)
    contribute nothing."""
    if rows.dim() != 2 or ids.shape != rows.shape[:1]:
        raise ValueError(f"rows must be (K, D) and ids (K,), got "
                         f"{tuple(rows.shape)} and {tuple(ids.shape)}")
    if weights is not None and weights.shape != ids.shape:
        raise ValueError(f"weights must be {tuple(ids.shape)}, got "
                         f"{tuple(weights.shape)}")
    if rows.dtype != F32 or ids.dtype != I32 or (
            weights is not None and weights.dtype != F32):
        raise TypeError(
            f"f32 rows and weights and int32 ids expected, got {rows.dtype}, "
            f"{None if weights is None else weights.dtype}, {ids.dtype}")
    if any(t.device != rows.device for t in (ids, weights)
           if t is not None):
        raise ValueError("rows, ids and weights must be on one device")
    k, d = rows.shape
    if k == 0 or d == 0 or num_segments < 1:
        raise ValueError(f"empty input: rows {(k, d)}, {num_segments} "
                         f"segments")
    if not all(t.is_contiguous() for t in (rows, ids, weights)
               if t is not None):
        raise ValueError("segment_sum needs contiguous inputs")
    kind = _device_type(rows)
    if kind == "cpu":
        return ref.segment_sum_ref(rows, ids, num_segments, weights)
    if kind != "cuda":
        raise ValueError(f"segment_sum runs on cuda or cpu tensors, got "
                         f"{kind}")
    if k >= 2**31 or num_segments >= 2**31:
        raise ValueError(f"K = {k} and E = {num_segments} must be < 2^31")
    fn = _kernel()
    out = torch.empty((num_segments, d), dtype=F32, device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = fn(rows.data_ptr(), ids.data_ptr(),
                 None if weights is None else weights.data_ptr(),
                 out.data_ptr(), k, d, int(num_segments), stream)
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error "
                           f"{err}")
    segment_sum.launches["fold"] += 1
    return out


segment_sum.launches = {"fold": 0}
