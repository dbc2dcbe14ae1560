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
:func:`record_calls` every forward and every backward, on any route,
appends its kind and shape, from which :func:`call_flops` counts the
kernels' work (a dispatch-mode FLOP counter cannot see inside a kernel).

The Pallas kernel has no backward; the reference trains through the
``jax.checkpoint``-ed online-softmax scan of ``models/attention.py``,
whose gradient recomputes each kv block's probabilities and never holds
more than one (Sq, kv_block) block of them. Here the differentiable entry
is a ``torch.autograd.Function``: the forward saves q, k, v, the output
and the row log-sum-exp; the backward is a second Function,
:class:`FlashAttentionBackward`, that recomputes the probabilities tile
by tile from the log-sum-exp in ``csrc/flash_attention_bwd.cu`` (the row
pass ``delta = rowsum(do o)``, then the kv-tile pass for dk and dv and
the query-tile pass for dq on wgmma, both passes in one grid, f32 on
TF32 and bf16 split terms, and, where :func:`bwd_splits` splits a GQA
group over blocks, a fold of their f32 partials; no tensor of (Sq, Skv)
is ever made), or on CPU tensors in
:func:`attention_backward`, its plain version, blockwise over kv blocks
of the reference's 1024. ``flash_attention.launches["backward"]`` counts
backward calls on the card (each call its two or three launches). Both
Functions have a ``vmap`` rule that folds a vmapped dimension into B, so
``torch.func.vmap(torch.func.grad(...))`` over K clients (phase 2 of a
round) makes ONE forward and ONE backward call for all of them. The
backward is not differentiable again: a second derivative raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import _build, ref

F32 = torch.float32
# the kernel's (Dqk, Dv) template instances
HEAD_DIMS = ((32, 32), (64, 64), (80, 80), (128, 128), (192, 128))

BQ = BKV = 64                  # the query and kv tile rows the FLOPs count
KV_BLOCK = 1024                # the plain backward's kv block, the reference's


def bwd_splits(b: int, kvh: int, skv: int, group: int, sms: int) -> int:
    """The backward kernel's split of each GQA group's heads over its
    kv-tile blocks (one a batch, kv head and BKV kv rows), in both types: a
    power of two dividing ``group``, doubled while those blocks number
    fewer than ``sms``. The splits' f32 partials take ``nsplit * b * kvh *
    skv * (Dqk + Dv)`` floats of scratch, which the doubling keeps under
    ``2 * sms * 64`` rows (20.6 MiB at (192, 128) on 132 SMs)."""
    blocks = b * kvh * -(-skv // BKV)
    n = 1
    while group % (2 * n) == 0 and blocks * n < sms:
        n *= 2
    return n


def _device_type(t: torch.Tensor) -> str:
    """``"meta"`` for a shape trace (a meta or fake tensor), else the
    tensor's device type."""
    return "meta" if is_fake(t) else t.device.type


_calls = None       # a list while record_calls() is open, else None


@contextlib.contextmanager
def record_calls():
    """Within the block every forward appends ``("forward", b, h, sq,
    skv, dqk, dv, causal, window)`` to the list it yields, and every
    backward the same tuple under ``"backward"``."""
    global _calls
    prev, _calls = _calls, []
    try:
        yield _calls
    finally:
        _calls = prev


def _record(kind, q, k, v, causal, window):
    if _calls is not None:
        _calls.append((kind, q.shape[0], q.shape[1], q.shape[2], k.shape[2],
                       q.shape[3], v.shape[3], causal, window))


def _tiles(sq, skv, causal, window) -> int:
    """The (64-row query tile, 64-row kv tile) pairs one (batch, head)
    visits, as the Pallas body tiles them: a causal query tile sees kv
    tiles up to its last row's position, a window starts at the tile
    holding its first row's ``position - window + 1``; skipped tiles are
    not counted. The backward kernel's two passes visit the same pairs."""
    tiles = 0
    q_offset = skv - sq
    for q0 in range(0, sq, BQ):
        last = min(q0 + BQ, sq) - 1
        end = q_offset + last + 1 if causal else skv
        begin = max(0, q_offset + q0 - window + 1) if window > 0 else 0
        begin = begin // BKV * BKV
        tiles += -(-(end - begin) // BKV)
    return tiles


def forward_flops(b, h, sq, skv, dqk, dv, causal, window) -> int:
    """The forward's work as the dry run and ``chip_smoke.py`` count it:
    for each of the B * H (batch, head) pairs and each visited tile pair
    (:func:`_tiles`), ``2 * 64 * 64 * (Dqk + Dv)`` FLOPs (the Q K^T and P
    V products over the whole tile, masked rows included). (The kernel's
    own tiles pack a GQA group's heads and start a window at its first
    row: their count can differ by a tile at a window's edge, and the P V
    product runs twice, on P_hi and P_lo.)"""
    return (b * h * _tiles(sq, skv, causal, window) * 2 * BQ * BKV
            * (dqk + dv))


def backward_flops(b, h, sq, skv, dqk, dv, causal, window) -> int:
    """The backward's work, counted as :func:`forward_flops` counts the
    forward's: for each (batch, head) and visited tile pair, the five
    products of the gradient, S = Q K^T (Dqk), dP = dO V^T (Dv), dV = P^T
    dO (Dv), dK = dS^T Q (Dqk) and dQ = dS K (Dqk): ``2 * 64 * 64 * (3
    Dqk + 2 Dv)`` FLOPs. (The kernel recomputes S and dP in its query-tile
    pass, seven products in all.)"""
    return (b * h * _tiles(sq, skv, causal, window) * 2 * BQ * BKV
            * (3 * dqk + 2 * dv))


def call_flops(call) -> int:
    """The FLOPs of one entry of :func:`record_calls`."""
    kind, *shape = call
    return (forward_flops if kind == "forward" else backward_flops)(*shape)


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
    _record("forward", q, k, v, causal, window)
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
                       scale: float, kv_block: int = KV_BLOCK):
    """The backward kernel's plain version: gradients of the output w.r.t.
    q, k and v, recomputed from the saved row log-sum-exp blockwise over
    kv blocks of ``kv_block`` rows, as the reference's checkpointed scan
    recomputes them (one (B, H, Sq, kv_block) block of scores at a time):
    ``delta = rowsum(do o)``, then for each block ``p = exp(s - lse)``,
    ``dv = p^T do``, ``ds = p (do v^T - delta) scale``, ``dq += ds k``,
    ``dk = ds^T q``, the kv gradients summed over each head group. In f32
    (f64 for f64 inputs), cast to the inputs' types."""
    b, h, sq, dh = q.shape
    kvh, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    g = h // kvh
    wide = torch.promote_types(q.dtype, F32)
    qg = q.reshape(b, kvh, g, sq, dh).to(wide)
    dog = do.reshape(b, kvh, g, sq, dv).to(wide)
    delta = (dog * o.reshape(b, kvh, g, sq, dv).to(wide)).sum(
        -1, keepdim=True)
    lse = lse.reshape(b, kvh, g, sq, 1).to(wide)
    valid = ref.flash_attention_mask(sq, skv, causal, window, q.device)
    dq = torch.zeros_like(qg)
    dks, dvs = [], []
    for j0 in range(0, skv, kv_block):
        kb = k[:, :, j0:j0 + kv_block].to(wide)
        vb = v[:, :, j0:j0 + kv_block].to(wide)
        s = torch.einsum("bkgqd,bksd->bkgqs", qg, kb) * scale
        s = torch.where(valid[:, j0:j0 + kv_block], s,
                        torch.full_like(s, ref.NEG_INF))
        p = torch.exp(s - lse)
        del s
        dvs.append(torch.einsum("bkgqs,bkgqd->bksd", p, dog))
        ds = p * (torch.einsum("bkgqd,bksd->bkgqs", dog, vb) - delta) * scale
        del p
        dq += torch.einsum("bkgqs,bksd->bkgqd", ds, kb)
        dks.append(torch.einsum("bkgqs,bkgqd->bksd", ds, qg))
    return (dq.reshape(q.shape).to(q.dtype), torch.cat(dks, 2).to(k.dtype),
            torch.cat(dvs, 2).to(v.dtype))


def _bwd_kernel():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd
    if fn.argtypes is None:             # the library's one function object
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                       + [ctypes.c_float] + [ctypes.c_void_p] * 3
                       + [ctypes.c_int])  # ..., strides, scratch, nsplit
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _backward(q, k, v, o, lse, do, causal: bool, window: int, scale: float):
    """(dq, dk, dv): the backward kernel on CUDA tensors, the plain version
    on CPU tensors; on a shape trace only the outputs and the kernel's
    (B, H, Sq) f32 ``delta`` scratch are made. The gradients are allocated
    as (B, S, heads, D) buffers seen as (B, heads, S, D), the layout of
    the model's activations. The operands go to the kernel as
    :func:`_in_place` leaves them (the kernel reads q, k, v and do through
    TMA tensor maps); a group split over blocks (:func:`bwd_splits`) takes
    an f32 scratch for its partials."""
    kind = _device_type(q)
    _record("backward", q, k, v, causal, window)
    if kind == "cpu":
        return attention_backward(q, k, v, o, lse, do, causal, window, scale)
    if kind not in ("meta", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got "
                         f"{kind}")
    b, h, sq, dh = q.shape
    kvh, skv, dv = k.shape[1], k.shape[2], v.shape[3]

    def out(heads, s, d):
        return torch.empty_strided((b, heads, s, d),
                                   (s * heads * d, d, heads * d, 1),
                                   dtype=q.dtype, device=q.device)

    if kind == "cuda":
        if q.dtype not in (F32, torch.bfloat16):
            raise TypeError(f"the kernel takes f32 or bf16, got {q.dtype}")
        if (dh, dv) not in HEAD_DIMS:
            raise ValueError(f"head dim {dh}"
                             + (f" with v head dim {dv}" if dv != dh else "")
                             + f" is not one of the kernel's (Dqk, Dv) "
                               f"{HEAD_DIMS}")
        fn = _bwd_kernel()
    delta = torch.empty((b, h, sq), dtype=F32, device=q.device)
    dq, dk, dvv = out(h, sq, dh), out(kvh, skv, dh), out(kvh, skv, dv)
    if kind == "meta":
        return dq, dk, dvv
    ins, sts = zip(*(_in_place(x) for x in (q, k, v, o, do.to(q.dtype))))
    lse = lse.contiguous()
    strides = (ctypes.c_longlong * 24)(*(
        st for x in (*sts, dq.stride()[:3], dk.stride()[:3],
                     dvv.stride()[:3]) for st in x))
    is_bf16 = q.dtype == torch.bfloat16
    nsplit = bwd_splits(b, kvh, skv, h // kvh, _sm_count(q.device.index))
    scratch = (torch.empty(b * kvh * nsplit * skv * (dh + dv), dtype=F32,
                           device=q.device) if nsplit > 1 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(x.data_ptr() for x in ins), lse.data_ptr(),
                 delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dvv.data_ptr(), int(is_bf16), b, h, kvh, sq, skv, dh, dv,
                 int(causal), int(window), scale, stream, strides,
                 None if scratch is None else scratch.data_ptr(), nsplit)
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed: "
                           f"CUDA error {err}")
    flash_attention.launches["backward"] += 1
    return dq, dk, dvv


def _fold(n, x, dim):
    """``x`` with its vmapped dimension ``dim`` (None: unbatched, then
    expanded) folded into its first: (n, B, ...) -> (n * B, ...)."""
    x = x.expand(n, *x.shape) if dim is None else x.movedim(dim, 0)
    return x.reshape(n * x.shape[1], *x.shape[2:])


class FlashAttentionBackward(torch.autograd.Function):
    """``(dq, dk, dv) = FlashAttentionBackward.apply(q, k, v, o, lse, do,
    causal, window, scale)``: :func:`_backward` as a Function, so that
    ``torch.func.vmap`` batches it by its ``vmap`` rule (one call for all
    clients) instead of reaching the kernel's launch with batched tensors.
    Not differentiable: its backward raises."""

    @staticmethod
    def forward(q, k, v, o, lse, do, causal, window, scale):
        return _backward(q, k, v, o, lse, do, causal, window, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("flash_attention has no second derivative: its "
                           "backward is not differentiable")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, lse, do, causal, window, scale):
        """Fold the vmapped dimension into B (an unbatched input is
        expanded) and run the backward once at the folded shape."""
        n = info.batch_size
        folded = [_fold(n, x, d) for x, d in zip((q, k, v, o, lse, do),
                                                   in_dims)]
        grads = FlashAttentionBackward.apply(*folded, causal, window, scale)
        return (tuple(x.reshape(n, -1, *x.shape[1:]) for x in grads),
                (0, 0, 0))


class FlashAttention(torch.autograd.Function):
    """``(o, lse) = FlashAttention.apply(q, k, v, causal, window, scale)``,
    differentiable in q, k and v (through :class:`FlashAttentionBackward`),
    composable with ``torch.func.grad`` and ``torch.func.vmap``."""

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
        return (*FlashAttentionBackward.apply(q, k, v, o, lse, do,
                                              *ctx.args),
                None, None, None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, scale):
        """Fold the vmapped dimension into B (an unbatched input is
        expanded) and launch once at the folded shape."""
        n = info.batch_size
        o, lse = FlashAttention.apply(_fold(n, q, in_dims[0]),
                                      _fold(n, k, in_dims[1]),
                                      _fold(n, v, in_dims[2]), causal, window,
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


flash_attention.launches = {"forward": 0, "backward": 0}
