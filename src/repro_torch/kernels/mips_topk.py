"""Maximum inner product search with a fused top-k: the wrapper of
``csrc/mips_topk.cu``.

Replaces ``repro/kernels/mips_topk.py::mips_topk_pallas`` in both its
forms: the whole-corpus search (kernel body ``_mips_kernel``) and the
shard-local search of rows [offset, offset + N) of an ``n_total``-row
corpus that emits global indices (``_mips_kernel_offset``). Scores are
f32 inner products (a bf16 corpus is upcast as it is read), ordered by
score descending and, on equal scores, by ascending index; the (Q, N)
score matrix is never written. See the source for the design and its
bound on the card.

On a CUDA tensor the wrapper launches the kernel, or raises: it never
hands a CUDA tensor to the plain version. On a CPU tensor it runs the
plain version, :func:`repro_torch.kernels.ref.mips_topk_ref`.
``mips_topk.launches`` counts kernel launches by form (``{"search": n,
"offset": n}``). The reference's ``backend=``, ``block_q``, ``block_n``,
``chunk`` and ``interpret`` have no counterpart: there is one route.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

F32 = torch.float32
I32 = torch.int32
MAX_K = 256            # the kernel's running lists live in shared memory
ROWS_PER_TILE = 256    # corpus rows a block scores at a time
MAX_SPLITS = 1024
BLOCKS_PER_SM = 4      # pass 1 aims for this many blocks on each SM


def _device_type(t: torch.Tensor) -> str:
    return t.device.type


def _kernel(offset: bool):
    lib = _build.load("mips_topk")
    fn = lib.mips_topk_offset if offset else lib.mips_topk_search
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 4
                   + [ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                      ctypes.c_int]
                   + ([ctypes.c_int64] if offset else [])
                   + [ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def plan(qn: int, n: int, sms: int):
    """(query tile BQ, splits S, rows a split) for pass 1: BQ = 16 for a
    batch of at most 16 queries, else 32; S splits of whole 256-row tiles,
    as many as give ``BLOCKS_PER_SM`` blocks on each of ``sms`` SMs."""
    bq = 16 if qn <= 16 else 32
    q_tiles = -(-qn // bq)
    tiles = -(-n // ROWS_PER_TILE)
    s = max(1, min(MAX_SPLITS, tiles,
                   -(-BLOCKS_PER_SM * sms // q_tiles)))
    rows = -(-(-(-n // s)) // ROWS_PER_TILE) * ROWS_PER_TILE
    return bq, -(-n // rows), rows


def mips_topk(q: torch.Tensor, corpus: torch.Tensor, k: int, *,
              index_offset=None, n_total: int = None):
    """q: (Q, d), corpus: (N, d) f32 or bf16 -> ((Q, k) f32 scores, (Q, k)
    int32 indices), score descending, ties by ascending index.

    ``index_offset`` (an int or a scalar tensor) selects the shard-local
    form: ``corpus`` is rows [offset, offset + N) of an ``n_total``-row
    corpus, indices come out global, and rows past ``n_total`` never
    enter. Slots no valid row fills hold (``ref.NEG_INF``,
    ``ref.BIG_IDX``)."""
    if q.dim() != 2 or corpus.dim() != 2:
        raise ValueError(f"q and corpus must be (Q, d) and (N, d), got "
                         f"{tuple(q.shape)} and {tuple(corpus.shape)}")
    qn, d = q.shape
    n, d2 = corpus.shape
    if d != d2:
        raise ValueError(f"query dim {d} != corpus dim {d2}")
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must be in [1, corpus size {n}]")
    if k > MAX_K:
        raise ValueError(
            f"k={k} exceeds {MAX_K}: the kernel keeps each query's running "
            f"top-k in shared memory, sized for at most {MAX_K}")
    nt = n if n_total is None else int(n_total)
    if nt >= ref.BIG_IDX:
        raise ValueError(f"n_total={nt} must be below 2^30, the sentinel "
                         f"index BIG_IDX")
    off = None if index_offset is None else int(index_offset)
    if off is not None and not 0 <= off < ref.BIG_IDX:
        raise ValueError(f"index_offset={off} must be in [0, 2^30)")
    if q.device != corpus.device:
        raise ValueError("q and corpus must be on one device")
    kind = _device_type(q)
    if kind == "cpu":
        return ref.mips_topk_ref(q, corpus, k, index_offset=off, n_total=nt)
    if kind != "cuda":
        raise ValueError(f"mips_topk runs on cuda or cpu tensors, got {kind}")
    if corpus.dtype not in (F32, torch.bfloat16):
        raise TypeError(f"the corpus must be f32 or bf16, got {corpus.dtype}")
    if not corpus.is_contiguous():
        raise ValueError("mips_topk needs a contiguous corpus")
    if qn == 0:
        raise ValueError("no queries")
    fn = _kernel(off is not None)
    q = q.to(F32).contiguous()
    dev = q.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bq, splits, rows = plan(qn, n, sms)
    part_v = torch.empty((splits, qn, k), dtype=F32, device=dev)
    part_i = torch.empty((splits, qn, k), dtype=I32, device=dev)
    out_v = torch.empty((qn, k), dtype=F32, device=dev)
    out_i = torch.empty((qn, k), dtype=I32, device=dev)
    bf16 = int(corpus.dtype == torch.bfloat16)
    ptrs = (q.data_ptr(), corpus.data_ptr(), bf16, part_v.data_ptr(),
            part_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), qn, n, d,
            k)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if off is None:
            err = fn(*ptrs, nt, splits, rows, bq, stream)
        else:
            err = fn(*ptrs, off, nt, splits, rows, bq, stream)
    if err != 0:
        raise RuntimeError(f"mips_topk kernel launch failed: CUDA error {err}")
    mips_topk.launches["search" if off is None else "offset"] += 1
    return out_v, out_i


mips_topk.launches = {"search": 0, "offset": 0}
