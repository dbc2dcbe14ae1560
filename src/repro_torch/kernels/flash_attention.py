"""Causal or sliding-window GQA attention with an online softmax: the
wrapper of ``csrc/flash_attention.cu``, and its gradient.

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas``
(kernel body ``_flash_kernel``), in its layout: q (B, H, Sq, Dqk), k
(B, KVH, Skv, Dqk) and v (B, KVH, Skv, Dv) -> (B, H, Sq, Dv), query head h
reading kv head ``h // (H / KVH)``, the queries the last Sq of the Skv
positions. The kernel's (Dqk, Dv) instances are ``HEAD_DIMS``: equal
dims 32, 64, 80 (zamba2-2.7b's attention) and 128, and MLA's (192, 128)
(the reference's MLA prefill runs its jnp scan at those dims; the Pallas
kernel takes one Dh). See the source for the design and its bound on the
card. The Pallas kernel's ``block_q``, ``block_kv`` and ``interpret``
have no counterpart: there is one route. A ragged Sq or Skv is masked,
where the Pallas kernel asserts that its blocks divide them.

The kernel reads its operands where they lie through TMA tensor maps: a
strided view (the model's (B, S, H, Dh) activations seen as (B, H, S, Dh))
is not copied unless a stride is not a multiple of 16 bytes or the head
dim is not unit-stride; only data that start off a 16-byte boundary are
copied (:func:`_aligned`). The output is allocated as (B, Sq, H, Dv), the
layout the model reads next, and returned as its (B, H, Sq, Dv) view.

On a CUDA tensor the wrapper launches the kernel, or raises: it never
hands a CUDA tensor to the plain version. On a CPU tensor it runs the
plain version, :func:`repro_torch.kernels.ref.flash_attention_ref` (and on
a ``meta`` tensor or a ``FakeTensor`` of any device, a shape trace, it
only makes the outputs: it never reads a pointer or launches).
``flash_attention.launches["forward"]`` counts kernel launches. Within
:func:`record_calls` every forward, on any route, appends its shape, from
which :func:`forward_flops` counts the kernel's work (a dispatch-mode FLOP
counter cannot see inside the kernel).

The Pallas kernel has no backward; the reference trains through the
``jax.checkpoint``-ed jnp scan of ``models/attention.py``. Here the
differentiable entry is a ``torch.autograd.Function``: the forward saves
q, k, v, the output and the row log-sum-exp, and the backward recomputes
the probabilities from them in plain PyTorch (it launches nothing). Its
``vmap`` rule folds a vmapped dimension into B, so ``torch.func.vmap``
over K clients (phase 2 of a round) makes ONE launch for all of them.
"""
from __future__ import annotations

import contextlib
import ctypes
import math

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import _build, ref

F32 = torch.float32
# the kernel's (Dqk, Dv) template instances
HEAD_DIMS = ((32, 32), (64, 64), (80, 80), (128, 128), (192, 128))

BQ = BKV = 64                  # the query and kv tile rows forward_flops counts


def _device_type(t: torch.Tensor) -> str:
    """``"meta"`` for a shape trace (a meta or fake tensor), else the
    tensor's device type."""
    return "meta" if is_fake(t) else t.device.type


_calls = None       # a list while record_calls() is open, else None


@contextlib.contextmanager
def record_calls():
    """Within the block every forward appends ``(b, h, sq, skv, dqk, dv,
    causal, window)`` to the list it yields."""
    global _calls
    prev, _calls = _calls, []
    try:
        yield _calls
    finally:
        _calls = prev


def forward_flops(b, h, sq, skv, dqk, dv, causal, window) -> int:
    """The forward's work as the dry run and ``chip_smoke.py`` count it,
    tiled as the Pallas body tiles it: for each of the B * H (batch,
    head) pairs and each 64-row query tile, the 64-row kv tiles it
    visits, each tile ``2 * 64 * 64 * (Dqk + Dv)`` FLOPs (the Q K^T and
    P V products over the whole tile, masked rows included). A causal
    tile sees kv tiles up to its last row's position, a window starts at
    the tile holding its first row's ``position - window + 1``: skipped
    tiles are not counted. (The kernel's own tiles pack a GQA group's
    heads and start a window at its first row: their count can differ by
    a tile at a window's edge, and the P V product runs twice, on P_hi
    and P_lo.) The gradient is not the kernel's:
    its plain-torch recompute (:func:`attention_backward`) is counted as
    the dense products it runs, by whatever counts the other ops."""
    tiles = 0
    q_offset = skv - sq
    for q0 in range(0, sq, BQ):
        last = min(q0 + BQ, sq) - 1
        end = q_offset + last + 1 if causal else skv
        begin = max(0, q_offset + q0 - window + 1) if window > 0 else 0
        begin = begin // BKV * BKV
        tiles += -(-(end - begin) // BKV)
    return b * h * tiles * 2 * BQ * BKV * (dqk + dv)


def _kernel():
    fn = _build.load("flash_attention").flash_attention_fwd
    if fn.argtypes is None:             # the library's one function object
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p]
                       + [ctypes.c_longlong] * 9)  # q, k, v strides (b, h, s)
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k and v must be 4-D (B, H, S, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, sq, dh = q.shape
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != b
            or k.shape[3] != dh):
        raise ValueError(f"k and v must be (B={b}, KVH, Skv, Dqk={dh}) and "
                         f"(B={b}, KVH, Skv, Dv), got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    kvh, skv = k.shape[1], k.shape[2]
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads do not split into {kvh} groups")
    if not 0 < sq <= skv:
        raise ValueError(f"Sq={sq} must be in [1, Skv={skv}]: the queries "
                         f"are the last Sq of the Skv positions")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k and v must have one type, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy of it (its strides kept) whose data starts on a
    16-byte boundary: a TMA tensor map needs one."""
    return x.clone() if x.data_ptr() % 16 else x


def _in_place(x: torch.Tensor):
    """``(x, strides)``: ``x`` where the kernel's tensor maps can read it
    as it lies (the head dim unit-stride, every other dim longer than one
    at a positive stride of whole 16 bytes), else its contiguous copy, then
    aligned; ``strides`` its element strides along (b, h, s), a dim of
    length one given 16 bytes' worth (the map reads its one index at any
    stride, but wants strides of whole 16 bytes). Written out, not looped:
    this runs three times on every call of host-bound rounds."""
    unit = 16 // x.element_size()
    n0, n1, n2, _ = x.shape
    s0, s1, s2, s3 = x.stride()
    if (s3 != 1 or (n0 > 1 and (s0 <= 0 or s0 % unit))
            or (n1 > 1 and (s1 <= 0 or s1 % unit))
            or (n2 > 1 and (s2 <= 0 or s2 % unit))):
        x = x.contiguous()
        s0, s1, s2, _ = x.stride()
    if x.data_ptr() % 16:
        x = _aligned(x)
        s0, s1, s2, _ = x.stride()
    return x, (s0 if n0 > 1 else unit, s1 if n1 > 1 else unit,
               s2 if n2 > 1 else unit)


def _forward(q, k, v, causal: bool, window: int, scale: float):
    """(output, row log-sum-exp): the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    kind = _device_type(q)
    if _calls is not None:
        _calls.append((q.shape[0], q.shape[1], q.shape[2], k.shape[2],
                       q.shape[3], v.shape[3], causal, window))
    if kind == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale, return_lse=True)
    if kind == "meta":
        return (q.new_empty(q.shape[:3] + v.shape[3:]), torch.empty(
            q.shape[:3], dtype=torch.promote_types(q.dtype, F32),
            device=q.device))
    if kind != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got "
                         f"{kind}")
    if q.dtype not in (F32, torch.bfloat16):
        raise TypeError(f"the kernel takes f32 or bf16, got {q.dtype}")
    b, h, sq, dh = q.shape
    kvh, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    if (dh, dv) not in HEAD_DIMS:
        raise ValueError(f"head dim {dh}"
                         + (f" with v head dim {dv}" if dv != dh else "")
                         + f" is not one of the kernel's (Dqk, Dv) "
                           f"{HEAD_DIMS}")
    fn = _kernel()
    q, q_st = _in_place(q)
    k, k_st = _in_place(k)
    v, v_st = _in_place(v)
    # a (B, Sq, H, Dv) buffer, made as its (B, H, Sq, Dv) view
    o = torch.empty_strided((b, h, sq, dv), (sq * h * dv, dv, h * dv, 1),
                            dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=F32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), int(q.dtype == torch.bfloat16), b, h, kvh,
                 sq, skv, dh, dv, int(causal), int(window), scale, stream,
                 *q_st, *k_st, *v_st)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches["forward"] += 1
    return o, lse


def attention_backward(q, k, v, o, lse, do, causal: bool, window: int,
                       scale: float):
    """Gradients of the output w.r.t. q, k and v, recomputed in plain
    PyTorch from the saved row log-sum-exp: ``p = exp(s - lse)``, ``dv =
    p^T do``, ``ds = p (do v^T - rowsum(do o))``, ``dq = ds k scale``, ``dk
    = ds^T q scale``, the kv gradients summed over each head group. In f32
    (f64 for f64 inputs), cast to the inputs' types."""
    b, h, sq, dh = q.shape
    kvh, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    g = h // kvh
    wide = torch.promote_types(q.dtype, F32)
    qg = q.reshape(b, kvh, g, sq, dh).to(wide)
    kw, vw = k.to(wide), v.to(wide)
    dog = do.reshape(b, kvh, g, sq, dv).to(wide)
    og = o.reshape(b, kvh, g, sq, dv).to(wide)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, kw) * scale
    valid = ref.flash_attention_mask(sq, skv, causal, window, q.device)
    s = torch.where(valid, s, torch.full_like(s, ref.NEG_INF))
    p = torch.exp(s - lse.reshape(b, kvh, g, sq, 1).to(wide))
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dog)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dog, vw)
    ds = p * (dp - (dog * og).sum(-1, keepdim=True)) * scale
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kw)
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qg)
    return dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """``(o, lse) = FlashAttention.apply(q, k, v, causal, window, scale)``,
    differentiable in q, k and v, composable with ``torch.func.grad`` and
    ``torch.func.vmap``."""

    @staticmethod
    def forward(q, k, v, causal, window, scale):
        return _forward(q, k, v, causal, window, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, scale = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, scale)
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        return (*attention_backward(q, k, v, o, lse, do, *ctx.args),
                None, None, None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, scale):
        """Fold the vmapped dimension into B (an unbatched input is
        expanded) and launch once at the folded shape."""
        n = info.batch_size

        def fold(x, dim):
            x = x.expand(n, *x.shape) if dim is None else x.movedim(dim, 0)
            return x.reshape(n * x.shape[1], *x.shape[2:])

        o, lse = FlashAttention.apply(fold(q, in_dims[0]),
                                      fold(k, in_dims[1]),
                                      fold(v, in_dims[2]), causal, window,
                                      scale)
        return ((o.reshape(n, -1, *o.shape[1:]),
                 lse.reshape(n, -1, *lse.shape[1:])), (0, 0))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale=None) -> torch.Tensor:
    """q: (B, H, Sq, Dqk), k: (B, KVH, Skv, Dqk), v: (B, KVH, Skv, Dv) ->
    (B, H, Sq, Dv) in q's type; the scale defaults to 1 / sqrt(Dqk).
    Differentiable (see :class:`FlashAttention`)."""
    _check(q, k, v)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    return FlashAttention.apply(q, k, v, bool(causal), int(window),
                                scale)[0]


flash_attention.launches = {"forward": 0}
