"""Fused quantize -> dequantize of wire payloads: the wrapper of
``csrc/quantize.cu``.

Replaces ``repro/kernels/quantize.py::quant_dequant_pallas`` (kernel bodies
``_qdq_kernel`` for one scale per row and ``_qdq_kernel_2d`` for
column-mapped scales): ``clip(floor(flat / s + u), -qmax, qmax) * s`` on
(K, n) f32 rows in one pass, bit-identical to the plain version given the
same uniforms. See the source for the design and its bound on the card.

On a CUDA tensor the wrapper launches the kernel, or raises: it never
hands a CUDA tensor to the plain version. On a CPU tensor it runs the
plain version in :mod:`repro_torch.kernels.ref`.
``quant_dequant.launches`` counts kernel launches by scale form
(``{"per_row": n, "column": n}``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

F32 = torch.float32


def _device_type(t: torch.Tensor) -> str:
    return t.device.type


def _kernel():
    fn = _build.load("quantize").quant_dequant_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def quant_dequant(flat: torch.Tensor, u: torch.Tensor, scales: torch.Tensor,
                  qmax: float) -> torch.Tensor:
    """flat, u: (K, n) f32; scales: (K,) or (K, n) f32 -> (K, n) f32."""
    if flat.dim() != 2 or u.shape != flat.shape:
        raise ValueError(f"flat and u must be (K, n) of one shape, got "
                         f"{tuple(flat.shape)} and {tuple(u.shape)}")
    k, n = flat.shape
    if scales.shape not in ((k,), (k, n)):
        raise ValueError(f"scales must be ({k},) or ({k}, {n}), got "
                         f"{tuple(scales.shape)}")
    if not all(t.dtype == F32 for t in (flat, u, scales)):
        raise TypeError(f"f32 inputs expected, got {flat.dtype}, {u.dtype}, "
                        f"{scales.dtype}")
    if not (flat.device == u.device == scales.device):
        raise ValueError("flat, u and scales must be on one device")
    if k == 0 or n == 0:
        raise ValueError(f"empty input of shape {(k, n)}")
    if not all(t.is_contiguous() for t in (flat, u, scales)):
        raise ValueError("quant_dequant needs contiguous inputs")
    kind = _device_type(flat)
    if kind == "cpu":
        return ref.quant_dequant_ref(flat, u, scales, qmax)
    if kind != "cuda":
        raise ValueError(f"quant_dequant runs on cuda or cpu tensors, got "
                         f"{kind}")
    fn = _kernel()
    out = torch.empty_like(flat)
    scale_2d = scales.dim() == 2
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        err = fn(flat.data_ptr(), u.data_ptr(), scales.data_ptr(),
                 out.data_ptr(), k, n, int(scale_2d), float(qmax), stream)
    if err != 0:
        raise RuntimeError(f"quant_dequant kernel launch failed: CUDA error "
                           f"{err}")
    quant_dequant.launches["column" if scale_2d else "per_row"] += 1
    return out


quant_dequant.launches = {"per_row": 0, "column": 0}
