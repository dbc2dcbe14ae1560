"""Fused encoding statistics: the wrapper of ``csrc/cco_stats.cu``.

Replaces ``repro/kernels/cco_stats.py::cco_stats_pallas`` in both moment
sets: ``moments="cross"`` (the kernel body ``_stats_kernel``) gives mean_f,
sq_f, mean_g, sq_g (d,) and cross = zf^T zg / n (d, d); ``moments="full"``
(``_stats_kernel_full``) adds cov_f = zf^T zf / n and cov_g = zg^T zg / n
(d, d). All f32, in one pass over N. See the source for the design and its
bound on the card.

On a CUDA tensor the wrapper launches the kernel, or raises: it never
hands a CUDA tensor to the plain version. On a CPU tensor it runs the
plain version in :mod:`repro_torch.kernels.ref`. ``cco_stats.launches``
counts kernel launches by moment set (``{"cross": n, "full": n}``), so a
run can show which kernel it went through.
"""
from __future__ import annotations

import ctypes

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import _build, ref

F32 = torch.float32


def _device_type(t: torch.Tensor) -> str:
    """``"meta"`` for a shape trace (a meta or fake tensor, which the
    wrapper refuses: it never reads a fake tensor's pointer), else the
    tensor's device type."""
    return "meta" if is_fake(t) else t.device.type


_OUTS = {"cross": 5, "full": 7}   # output pointers of each entry point


def _kernel(moments: str):
    """The entry point of ``moments``; its argument types are set at its
    first use (ctypes keeps one function object per loaded library)."""
    fn = getattr(_build.load("cco_stats"), f"cco_stats_{moments}_f32")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * (3 + _OUTS[moments])
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def cco_stats(zf: torch.Tensor, zg: torch.Tensor, num_valid=None, *,
              moments: str = "cross"):
    """zf, zg: (N, d) -> dict of f32 statistics of the moment set
    ``moments`` (``"cross"``: five statistics; ``"full"``: seven).

    ``num_valid`` (a scalar tensor on the inputs' device) overrides the
    normaliser with ``1 / max(num_valid, 1)``: it is used with pre-masked
    encodings (rows zeroed for padding samples). It is read on the device,
    so the call never waits for the host.
    """
    if moments not in ref.MOMENT_SETS:
        raise ValueError(f"unknown moment set {moments!r}; expected one of "
                         f"{ref.MOMENT_SETS}")
    if zf.dim() != 2 or zf.shape != zg.shape:
        raise ValueError(f"zf and zg must be (N, d) of one shape, got "
                         f"{tuple(zf.shape)} and {tuple(zg.shape)}")
    if not (zf.is_floating_point() and zg.is_floating_point()):
        raise TypeError(f"floating inputs expected, got {zf.dtype}/{zg.dtype}")
    if zf.device != zg.device:
        raise ValueError(f"zf on {zf.device} but zg on {zg.device}")
    n, d = zf.shape
    if n == 0 or d == 0:
        raise ValueError(f"empty input of shape {(n, d)}")
    zf, zg = zf.to(F32), zg.to(F32)      # the reference's .astype(F32)
    if not (zf.is_contiguous() and zg.is_contiguous()):
        raise ValueError("cco_stats needs row-major contiguous (N, d) inputs")
    kind = _device_type(zf)
    if kind == "cpu":
        return ref.cco_stats_ref(zf, zg, num_valid, moments)
    if kind != "cuda":
        raise ValueError(f"cco_stats runs on cuda or cpu tensors, got {kind}")
    if num_valid is not None:
        if not (isinstance(num_valid, torch.Tensor)
                and num_valid.numel() == 1
                and num_valid.device == zf.device):
            raise ValueError("num_valid must be a one-element tensor on the "
                             "inputs' device")
        num_valid = num_valid.to(F32).contiguous()
    fn = _kernel(moments)
    mats = 1 if moments == "cross" else 3     # cross[, cov_f, cov_g]
    # one buffer: the (d, d) matrices, then mean_f, sq_f, mean_g, sq_g
    buf = torch.empty(mats * d * d + 4 * d, dtype=F32, device=zf.device)
    base = buf.data_ptr()
    ptrs = [base + 4 * (mats * d * d + i * d) for i in range(4)]
    ptrs += [base + 4 * i * d * d for i in range(1, mats)]
    err = fn(zf.data_ptr(), zg.data_ptr(),
             None if num_valid is None else num_valid.data_ptr(), base, *ptrs,
             n, d, torch.cuda.current_stream(zf.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cco_stats kernel launch failed: CUDA error {err}")
    cco_stats.launches[moments] += 1
    m = buf[:mats * d * d].view(mats, d, d)
    v = buf[mats * d * d:].view(4, d)
    out = {"mean_f": v[0], "sq_f": v[1], "mean_g": v[2], "sq_g": v[3],
           "cross": m[0]}
    if moments == "full":
        out["cov_f"], out["cov_g"] = m[1], m[2]
    return out


cco_stats.launches = {m: 0 for m in ref.MOMENT_SETS}
