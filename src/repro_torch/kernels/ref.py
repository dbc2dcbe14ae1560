"""Plain PyTorch versions of the port's kernels: the CPU path of each
wrapper, and what ``chip_smoke.py`` holds each kernel against on the card."""
from __future__ import annotations

import math

import torch

F32 = torch.float32

MOMENT_SETS = ("cross", "full")


def _mirror_upper(m):
    """``m`` with its strict lower triangle replaced by the transpose of its
    strict upper one: exactly symmetric, as the kernel writes it."""
    upper = torch.triu(m)
    return upper + torch.triu(m, 1).T


def cco_stats_ref(zf, zg, num_valid=None, moments: str = "cross"):
    """The fused statistics kernel's function, in either moment set.

    zf, zg: (N, d). Returns a dict of f32: mean_f/sq_f/mean_g/sq_g (d,) and
    cross = zf^T zg * inv_n (d, d), with ``inv_n = 1 / max(num_valid, 1)``
    when ``num_valid`` (a scalar tensor, for pre-masked rows) is given,
    else ``1 / N``. ``moments="full"`` adds the within-view moments
    cov_f = zf^T zf * inv_n and cov_g = zg^T zg * inv_n (d, d), each
    mirrored from its upper triangle so that it is exactly symmetric.
    """
    if moments not in MOMENT_SETS:
        raise ValueError(f"unknown moment set {moments!r}; expected one of "
                         f"{MOMENT_SETS}")
    zf = zf.to(F32)
    zg = zg.to(F32)
    if num_valid is None:
        inv_n = 1.0 / zf.shape[0]
    else:
        inv_n = 1.0 / torch.clamp(torch.as_tensor(num_valid, dtype=F32,
                                                  device=zf.device), min=1.0)
    st = {
        "mean_f": zf.sum(0) * inv_n,
        "sq_f": (zf * zf).sum(0) * inv_n,
        "mean_g": zg.sum(0) * inv_n,
        "sq_g": (zg * zg).sum(0) * inv_n,
        "cross": (zf.T @ zg) * inv_n,
    }
    if moments == "full":
        st["cov_f"] = _mirror_upper((zf.T @ zf) * inv_n)
        st["cov_g"] = _mirror_upper((zg.T @ zg) * inv_n)
    return st


def quant_dequant_ref(flat, u, scales, qmax: float):
    """Stochastic-rounding quantize -> dequantize of (K, n) f32 rows:
    ``clip(floor(flat / s + u), -qmax, qmax) * s``, with ``s`` one scale per
    row (``scales`` of shape (K,)) or column-mapped (``scales`` of shape
    (K, n)). ``u`` holds the uniforms in [0, 1). The formula of
    ``repro/comm/quantize.py::_qdq_formula``; IEEE division, so it is
    bit-identical to the kernel given the same inputs."""
    s = scales[:, None] if scales.dim() == 1 else scales
    q = torch.clamp(torch.floor(flat / s + u), -qmax, qmax)
    return q * s


def segment_sum_ref(rows, ids, num_segments: int, weights=None):
    """Weighted segment sum: ``out[e] = sum_{k: ids[k] == e} w_k * rows[k]``
    for e in [0, num_segments); ids outside that range (the padding id
    ``num_segments``) contribute nothing, an empty segment is zeros.

    rows: (K, D), ids: (K,) int, weights: (K,) or None (w = 1) -> (E, D)
    f32. Each element is summed over k in ascending order as
    ``acc + (w_k * x)`` from ``acc = 0``, two separate roundings with no
    fused multiply-add, which is what the kernel does: the two are equal
    bit for bit. One vectorised step per rank within a segment (the
    largest segment's size), so no index repeats inside a step."""
    rows = rows.to(F32)
    k, d = rows.shape
    out = torch.zeros((num_segments, d), dtype=F32, device=rows.device)
    ids = ids.to(torch.int64)
    valid = (ids >= 0) & (ids < num_segments)
    if k == 0 or not bool(valid.any()):
        return out
    w = (torch.ones((k,), dtype=F32, device=rows.device) if weights is None
         else weights.to(F32))
    safe = torch.where(valid, ids, 0)
    onehot = torch.nn.functional.one_hot(safe, num_segments) * valid[:, None]
    rank = onehot.cumsum(0).gather(1, safe[:, None])[:, 0] - 1
    for r in range(int(rank[valid].max()) + 1):
        sel = valid & (rank == r)
        e = ids[sel]
        out[e] = out[e] + w[sel][:, None] * rows[sel]
    return out


NEG_INF = -1e30       # sentinel score of a masked row or an empty slot
BIG_IDX = 2 ** 30     # sentinel index (beats any real corpus index in min)


def select_topk(cand_v, cand_i, k: int):
    """k rounds of (max, lowest-index pick, mask) over candidate rows: the
    counterpart of ``repro/kernels/mips_topk.py::_select_topk``.

    cand_v, cand_i: (m, c) f32 scores and int32 indices -> ((m, k) f32,
    (m, k) int32), by value descending, ties by ascending index. Each round
    masks every position holding the picked (value, index) pair, so a
    candidate listed twice is emitted once. Comparisons only, so it equals
    the reference exactly, sentinels and short lists included (where the
    reference re-emits a taken index at ``NEG_INF``). ``torch.topk`` does
    not promise an order for ties, hence the explicit rounds."""
    cand_v = cand_v.to(F32).clone()
    cand_i = cand_i.to(torch.int32)
    big = torch.tensor(BIG_IDX, dtype=torch.int32, device=cand_i.device)
    outs_v, outs_i = [], []
    for _ in range(k):
        m = cand_v.amax(dim=1)
        at_max = cand_v == m[:, None]
        pick = torch.where(at_max, cand_i, big).amin(dim=1)
        taken = at_max & (cand_i == pick[:, None])
        cand_v = cand_v.masked_fill(taken, NEG_INF)
        outs_v.append(m)
        outs_i.append(pick)
    return torch.stack(outs_v, dim=1), torch.stack(outs_i, dim=1)


def _ordered_topk(cand_v, cand_i, k: int):
    """The best k of candidate rows with distinct indices (sentinels
    aside), value descending, ties by ascending index: two stable sorts,
    by index and then by value."""
    by_idx, perm = torch.sort(cand_i, dim=1, stable=True)
    v = torch.gather(cand_v, 1, perm)
    v, perm2 = torch.sort(v, dim=1, descending=True, stable=True)
    return v[:, :k], torch.gather(by_idx, 1, perm2[:, :k])


def mips_topk_ref(q, corpus, k: int, index_offset=None, n_total=None,
                  chunk: int = 512):
    """Top-k maximum inner product search: the counterpart of
    ``repro/kernels/mips_topk.py::mips_topk_chunked``, a scan over corpus
    chunks carrying the running top-k, so the (Q, N) score matrix never
    exists.

    q: (Q, d), corpus: (N, d) f32 or bf16 (upcast to f32 a chunk at a
    time) -> ((Q, k) f32 scores, (Q, k) int32 indices), value descending,
    ties by ascending index. With ``index_offset`` the corpus is rows
    [offset, offset + N) of an ``n_total``-row corpus: indices come out
    global, and a row is valid when its local position is below N and its
    global position below ``n_total``; invalid rows never enter, and slots
    left empty hold (``NEG_INF``, ``BIG_IDX``).

    Each score is an elementwise product summed over d in one reduction of
    the last axis, whose order depends on d alone: a score is the same
    bits whatever chunk or shard its row lies in, which is what makes the
    sharded search equal the unsharded one here."""
    qn, d = q.shape
    n, d2 = corpus.shape
    if d != d2:
        raise ValueError(f"query dim {d} != corpus dim {d2}")
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must be in [1, corpus size {n}]")
    nt = n if n_total is None else int(n_total)
    off = 0 if index_offset is None else int(index_offset)
    q = q.to(F32)
    dev = q.device
    vals = torch.full((qn, k), NEG_INF, dtype=F32, device=dev)
    idxs = torch.full((qn, k), BIG_IDX, dtype=torch.int32, device=dev)
    ch = min(chunk, n)
    for start in range(0, n, ch):
        block = corpus[start:start + ch].to(F32)
        s = (q[:, None, :] * block[None, :, :]).sum(-1)         # (Q, ch)
        local = torch.arange(start, start + block.shape[0], device=dev)
        pos = local + off
        valid = pos < nt
        s = torch.where(valid[None, :], s, torch.full_like(s, NEG_INF))
        pos = torch.where(valid, pos, torch.full_like(pos, BIG_IDX))
        cand_v = torch.cat([vals, s], dim=1)
        cand_i = torch.cat([idxs, pos.to(torch.int32)[None, :].expand(
            qn, -1)], dim=1)
        vals, idxs = _ordered_topk(cand_v, cand_i, k)
    return vals, idxs


def flash_attention_mask(sq: int, skv: int, causal: bool, window: int,
                         device):
    """(Sq, Skv) validity of the flash kernel's scores: the queries are the
    last Sq of Skv positions; ``kv <= q`` when causal and ``kv > q -
    window`` when ``window > 0``."""
    q_pos = torch.arange(skv - sq, skv, device=device)[:, None]
    kv_pos = torch.arange(skv, device=device)[None, :]
    valid = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        valid = valid & (kv_pos <= q_pos)
    if window > 0:
        valid = valid & (kv_pos > q_pos - window)
    return valid


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        scale=None, return_lse: bool = False):
    """The flash-attention kernel's function.

    q: (B, H, Sq, Dqk), k: (B, KVH, Skv, Dqk), v: (B, KVH, Skv, Dv), query
    head h reading kv head ``h // (H / KVH)``; the queries are the last Sq
    of the Skv positions. Scores ``q.k * scale`` (default ``1 /
    sqrt(Dqk)``) and the product with v are computed in f32 (f64 for f64
    inputs); masked scores are ``NEG_INF``. Returns the output (B, H, Sq,
    Dv) in q's type and,
    with ``return_lse``, the row log-sum-exp (B, H, Sq) in f32 (f64)."""
    b, h, sq, dh = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    wide = torch.promote_types(q.dtype, F32)
    qg = q.reshape(b, kvh, g, sq, dh).to(wide)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.to(wide)) * scale
    valid = flash_attention_mask(sq, skv, causal, window, q.device)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(wide))
    o = o.reshape(b, h, sq, v.shape[3]).to(q.dtype)
    return (o, lse.reshape(b, h, sq)) if return_lse else o
