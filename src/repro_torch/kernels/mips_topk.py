"""Maximum inner product search with a fused top-k: the wrapper of
``csrc/mips_topk.cu``.

Replaces ``repro/kernels/mips_topk.py::mips_topk_pallas`` in both its
forms: the whole-corpus search (kernel body ``_mips_kernel``) and the
shard-local search of rows [offset, offset + N) of an ``n_total``-row
corpus that emits global indices (``_mips_kernel_offset``). Scores are
inner products at f32 accuracy (on the card, from TF32 and bf16 parts on
the tensor cores; each score the same bits wherever its row lies),
ordered by score descending and, on equal scores, by ascending index;
the (Q, N) score matrix is never written. See the source for the design
and its bound on the card.

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
FULL_TILE_K = 64       # the largest k a 64-query tile's lists leave room for
ROWS_PER_TILE = 256    # corpus rows a block scores at a time
MAX_SPLITS = 1024


def _device_type(t: torch.Tensor) -> str:
    return t.device.type


def _kernel(offset: bool):
    lib = _build.load("mips_topk")
    fn = lib.mips_topk_offset if offset else lib.mips_topk_search
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 5
                   + [ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                      ctypes.c_int]
                   + ([ctypes.c_int64] if offset else [])
                   + [ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def plan(qn: int, n: int, k: int, sms: int):
    """(query tile BQ, splits S, rows a split) for pass 1.

    BQ is 16 for at most 16 queries, 32 for at most 32 or for k above
    ``FULL_TILE_K``, else 64: a batch of up to 64 queries is one tile and
    reads the corpus once. Where 64-query tiles would leave SMs idle (a
    corpus of fewer row tiles than SMs, or many query tiles on a small
    one) BQ = 32 doubles the blocks instead; such a corpus is small enough
    that a second read costs little. A block fills an SM's shared memory,
    so pass 1 runs one wave of
    at most ``sms`` blocks: S splits of whole 256-row tiles, as few as
    keep every SM busy (each split's running lists take insertions in
    proportion to the log of its length, so longer splits insert less per
    row)."""
    tiles = -(-n // ROWS_PER_TILE)
    if qn <= 16:
        bq = 16
    elif qn <= 32 or k > FULL_TILE_K or -(-qn // 64) * tiles < sms:
        bq = 32
    else:
        bq = 64
    q_tiles = -(-qn // bq)
    s = max(1, min(MAX_SPLITS, tiles, sms // q_tiles))
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
    bq, splits, rows = plan(qn, n, k, sms)
    qparts = torch.empty((2, qn, -(-d // 4) * 4), dtype=F32, device=dev)
    part_v = torch.empty((splits, qn, k), dtype=F32, device=dev)
    part_i = torch.empty((splits, qn, k), dtype=I32, device=dev)
    out_v = torch.empty((qn, k), dtype=F32, device=dev)
    out_i = torch.empty((qn, k), dtype=I32, device=dev)
    bf16 = int(corpus.dtype == torch.bfloat16)
    ptrs = (q.data_ptr(), corpus.data_ptr(), bf16, qparts.data_ptr(),
            part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(),
            out_i.data_ptr(), qn, n, d, k)
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
