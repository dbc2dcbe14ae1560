"""Attention: GQA with optional QK-RMSNorm, RoPE and a sliding window,
and MLA (DeepSeek-V2 multi-head latent attention).

Layouts are the reference's: q (B, Sq, H, Dh), k and v (B, Skv, KVH, Dh),
query head h reading kv head ``h // (H / KVH)``, positions (B, S).

Two implementations, as in the reference:
  * ``naive``     — materializes the (B, H, Sq, Skv) scores (plain torch);
  * ``blockwise`` — for Sq > 1, the CUDA flash-attention kernel
                    (:mod:`repro_torch.kernels.flash_attention`), whose
                    gradient is recomputed in plain torch. The reference
                    runs its jnp online-softmax scan here; the Pallas
                    kernel it calls "the analogue" of that scan is what
                    the port's kernel replaces. The plain scan is kept
                    as :func:`blockwise_attention`, for the parity tests.

The flash route takes the positions of a full sequence: queries are the
last Sq of ``kv_pos = 0 .. Skv-1``, which is what ``gqa_forward`` and
``gqa_prefill`` pass.

Decode keeps a KV cache in the reference's layout: ``k``/``v`` (B, W,
KVH, Dh) and ``kv_pos`` (B, W) int32 (-1 = slot not written), W the
sequence capacity or, with a sliding window, a ring of ``sliding_window``
slots (slot = position % W). ``cfg.kv_cache_dtype == "int8"`` stores int8
values with one f32 max-abs scale per (position, head) in
``k_scale``/``v_scale``. The cache is written in place (the reference's
scan carries it the same way, donated). Prefill attends over the full
sequence on the flash kernel; a decode step's one query attends to the
cache in plain torch (``naive_attention``), as the reference's decode
does outside any Pallas kernel.

MLA (the reference's ``mla_*``): one down-projection gives a latent of
``kv_lora_rank`` (RMS-normalised) and a rotary key of
``qk_rope_head_dim`` shared by the heads; per-head keys (nope + rope,
``qk_nope_head_dim + qk_rope_head_dim`` wide) and values
(``v_head_dim``) are expanded from the latent, and attention runs at
scale 1 / sqrt(dn + dr) through ``attention_math``: for Sq > 1 the flash
kernel with Dqk != Dv (192 and 128 at deepseek-v2-lite-16b). The decode
cache holds the latent and the rotary key (``latent`` (B, L, r),
``k_rope`` (B, L, dr), ``kv_pos``) in the model's dtype: it ignores
``kv_cache_dtype``, as the reference's does. ``mla_decode`` with
``absorb=True`` (the default) attends in the latent space, the cache
never expanded; ``absorb=False`` expands the cache every step.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import (F32, apply_rope, linear, linear_init,
                                       rmsnorm, rmsnorm_init)
from repro_torch.sharding import dtensor

NEG_INF = -1e30


def _mask(q_pos, kv_pos, window: int):
    """(..., Sq, Skv) boolean validity. q_pos: (..., Sq), kv_pos: (..., Skv)."""
    m = kv_pos[..., None, :] <= q_pos[..., :, None]
    if window > 0:
        m = m & (kv_pos[..., None, :] > (q_pos[..., :, None] - window))
    return m & (kv_pos[..., None, :] >= 0)   # ring slots not yet written


def naive_attention(q, k, v, q_pos, kv_pos, window: int = 0, scale=None):
    """q: (B,Sq,H,Dh) k: (B,Skv,KVH,Dk) v: (B,Skv,KVH,Dv); H % KVH == 0.
    Scores and the product with v accumulate in f32; ``p`` is rounded to
    v's type first, as in the reference."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    out, _ = _naive_parts(q, k, v, q_pos, kv_pos, window, scale, lse=False)
    return out.to(q.dtype)


def _naive_parts(q, k, v, q_pos, kv_pos, window: int, scale,
                 lse: bool = True):
    """``naive_attention`` before its cast: (out (B, Sq, H, Dv) in f32,
    and with ``lse`` the rows' log-sum-exp (B, Sq, H), else None). A
    decode over a sequence-sharded cache runs it on each block of slots
    and merges the blocks by their log-sum-exp (``_decode_spmd``)."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    wide = torch.promote_types(q.dtype, F32)
    qg = q.reshape(b, sq, kvh, g, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.to(wide),
                          k.to(wide)) * scale
    m = _mask(q_pos, kv_pos, window)[:, None, None]          # (B,1,1,Sq,Skv)
    scores = torch.where(m, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).to(wide),
                       v.to(wide)).reshape(b, sq, h, v.shape[-1])
    if not lse:
        return out, None
    total = torch.logsumexp(scores, -1)                      # (B,KVH,G,Sq)
    return out, total.permute(0, 3, 1, 2).reshape(b, sq, h)


def blockwise_attention(q, k, v, q_pos, kv_pos, window: int = 0,
                        kv_block: int = 1024, scale=None):
    """The reference's online-softmax scan over kv blocks, in plain torch
    (same semantics as ``naive_attention``; all reductions in f32). Kept
    for the parity tests; the model's blockwise route is the kernel."""
    b, sq, h, dh = q.shape
    skv, kvh, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // kvh
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    wide = torch.promote_types(q.dtype, F32)
    kv_block = min(kv_block, skv)
    pad = -(-skv // kv_block) * kv_block - skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=-2)
    qg = q.reshape(b, sq, kvh, g, dh).to(wide)
    acc = torch.zeros((b, kvh, g, sq, dv), dtype=wide, device=q.device)
    m_run = torch.full((b, kvh, g, sq), NEG_INF, dtype=wide, device=q.device)
    l_run = torch.zeros((b, kvh, g, sq), dtype=wide, device=q.device)
    for s0 in range(0, skv + pad, kv_block):
        ki = k[:, s0:s0 + kv_block]
        vi = v[:, s0:s0 + kv_block]
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, ki.to(wide)) * scale
        valid = _mask(q_pos, kv_pos[:, s0:s0 + kv_block], window)[:, None,
                                                                  None]
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m_run, s.amax(-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None])
        l_run = l_run * alpha + p.sum(-1)
        pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(vi.dtype).to(wide),
                          vi.to(wide))
        acc = acc * alpha[..., None] + pv
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]     # (B,KVH,G,Sq,Dv)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)


def _placements(x, keep):
    """``x``'s placements with only the tensor dims in ``keep`` sharded
    (the others replicated)."""
    from torch.distributed.tensor import Replicate, Shard
    return [p if isinstance(p, Shard) and p.dim in keep else Replicate()
            for p in x.placements]


def _kv_slice(q_off: int, h_l: int, h: int, kvh: int, kvh_l: int):
    """The kv heads this rank's query heads ``q_off .. q_off + h_l - 1``
    read, as (first, count) into its ``kvh_l`` local kv heads: all of
    them when the kv heads are split as the query heads are, else the
    group's own kv heads out of the whole set."""
    g = h // kvh
    if kvh_l * g == h_l:
        return 0, kvh_l
    if h_l % g and g % h_l:
        raise ValueError(f"{h_l} local query heads of {h} do not align "
                         f"with groups of {g}")
    first = q_off // g
    return first, (q_off + h_l - 1) // g - first + 1


def _attention_spmd(cfg, q, k, v, q_pos, kv_pos, scale):
    """Attention on DTensors under ``local_map``: each rank runs
    :func:`attention_math` (the flash kernel for Sq > 1) on its batch
    rows and query heads, as XLA SPMD runs the Pallas body on its shard.
    The kv heads are split as the query heads where their count divides,
    else kept whole and each rank reads its group's; a whole kv head's
    gradient is then a partial sum over the ranks sharing it."""
    from torch.distributed.tensor import Partial, Shard
    q = _settled(q, (0, 2))
    k = _settled(k, (0, 2))
    v = _settled(v, (0, 2))
    rows = _placements(q, (0,))
    kv_pl, kv_grad = [], []
    for i, (pq, pk) in enumerate(zip(q.placements, k.placements)):
        heads_q = isinstance(pq, Shard) and pq.dim == 2
        heads_k = isinstance(pk, Shard) and pk.dim == 2
        if heads_q and heads_k:
            kv_pl.append(pk)
        else:
            kv_pl.append(rows[i])
        kv_grad.append(Partial() if heads_q and not heads_k else kv_pl[-1])
    h, kvh = q.shape[2], k.shape[2]
    q_off = dtensor.offset(q, 2)
    h_l = h // dtensor.shards(q, 2)
    kvh_l = kvh // math.prod(q.device_mesh.size(i) for i, p in
                             enumerate(kv_pl) if isinstance(p, Shard)
                             and p.dim == 2)

    def local(ql, kl, vl, qp, kp):
        first, n = _kv_slice(q_off, h_l, h, kvh, kvh_l)
        return attention_math(cfg, ql, kl[:, :, first:first + n],
                              vl[:, :, first:first + n], qp, kp, scale)

    return dtensor.local_map_tree(
        local, q.device_mesh,
        [(q, q.placements, None), (k, kv_pl, kv_grad), (v, kv_pl, kv_grad),
         (q_pos, rows, None), (kv_pos, rows, None)], [q.placements])


def _settled(x, keep):
    """A DTensor ``x`` with its pending sums reduced and only the dims in
    ``keep`` sharded."""
    x = dtensor.settle(x)
    pl = _placements(x, keep)
    return x if pl == list(x.placements) else x.redistribute(
        x.device_mesh, pl)


def attention_math(cfg, q, k, v, q_pos, kv_pos, scale=None):
    """``cfg.attn_impl == "blockwise"`` with Sq > 1: the flash kernel, its
    (B, S, H, Dh) operands transposed to (B, H, S, Dh) and back; else the
    naive version. On DTensors, each rank's batch rows and heads under
    ``local_map`` (:func:`_attention_spmd`)."""
    if dtensor.is_dtensor(q):
        return _attention_spmd(cfg, q, k, v, q_pos, kv_pos, scale)
    if cfg.attn_impl == "blockwise" and q.shape[1] > 1:
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True,
                              window=cfg.sliding_window, scale=scale)
        return out.transpose(1, 2)
    return naive_attention(q, k, v, q_pos, kv_pos, cfg.sliding_window,
                           scale=scale)


# =========================================================================
# GQA block
# =========================================================================

def gqa_init(gen, cfg, dtype, device="cpu"):
    d, h, kvh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    dh = cfg.resolved_head_dim
    p = {
        "wq": linear_init(gen, d, h * dh, dtype, device=device),
        "wk": linear_init(gen, d, kvh * dh, dtype, device=device),
        "wv": linear_init(gen, d, kvh * dh, dtype, device=device),
        "wo": linear_init(gen, h * dh, d, dtype, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(dh, device)
        p["k_norm"] = rmsnorm_init(dh, device)
    return p


def _split_heads(t, n: int, d: int, dtype):
    """(B, S, n * d) -> (B, S, n, d) in ``dtype`` (the projection's input
    type). A DTensor projection left pending (where DTensor chose to
    split its contraction) is reduced, then cast, as ``linear`` asks of
    its callers. A DTensor whose last dim is cut into more blocks than
    its n heads split into (TinyLlama's 4 kv heads on a "model" axis of
    16) is gathered first, the reshard XLA inserts by itself before such
    a reshape."""
    if dtensor.is_dtensor(t):
        t = dtensor.settle(t, dtype)
        if n % dtensor.shards(t, -1):
            t = dtensor.replicate_dim(t, -1)
    return t.reshape(t.shape[0], t.shape[1], n, d)


def _merge_heads(out):
    """(B, S, H, Dv) -> (B, S, H * Dv) for the output projection; on
    DTensors its gradient is brought back to the heads' layout before the
    reshape's backward (``dtensor.grad_as``)."""
    return dtensor.grad_as(out.reshape(out.shape[0], out.shape[1], -1))


def _gqa_qkv(cfg, p, x, positions):
    h, kvh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = _split_heads(linear(p["wq"], x), h, dh, x.dtype)
    k = _split_heads(linear(p["wk"], x), kvh, dh, x.dtype)
    v = _split_heads(linear(p["wv"], x), kvh, dh, x.dtype)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_forward(cfg, p, x, positions):
    """Self-attention over a full sequence. x: (B,S,D); positions: (B,S)."""
    b, s, _ = x.shape
    q, k, v = _gqa_qkv(cfg, p, x, positions)
    out = attention_math(cfg, q, k, v, positions, positions)
    return linear(p["wo"], _merge_heads(out))


# =========================================================================
# KV cache (decode)
# =========================================================================

def _quantize_kv(x):
    """Per-(position, head) max-abs int8 quantization of x (B, S, KVH, Dh):
    (int8 values, (B, S, KVH) f32 scales)."""
    xf = x.to(F32)
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0,
                        min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def _dequantize_kv(q, scale, dtype):
    return (q.to(F32) * scale[..., None]).to(dtype)


def gqa_cache_init(cfg, batch: int, max_len: int, dtype, device="cpu"):
    """One layer's empty cache (see the module docstring)."""
    kvh, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    w = (min(max_len, cfg.sliding_window) if cfg.sliding_window > 0
         else max_len)
    cache = {"kv_pos": torch.full((batch, w), -1, dtype=torch.int32,
                                  device=device)}
    if cfg.kv_cache_dtype == "int8":
        for name in ("k", "v"):
            cache[name] = torch.zeros((batch, w, kvh, dh), dtype=torch.int8,
                                      device=device)
            cache[name + "_scale"] = torch.zeros((batch, w, kvh), dtype=F32,
                                                 device=device)
    else:
        for name in ("k", "v"):
            cache[name] = torch.zeros((batch, w, kvh, dh), dtype=dtype,
                                      device=device)
    return cache


def _ring_write(cache, new, first, count: int, w: int, w_off: int = 0):
    """Write ``new`` ({leaf name: (B, count, ...)}, the values of
    positions ``first .. first + count - 1``, count <= w) into the ring
    slots position % w of the cache leaves of those names, in place. The
    leaves hold slots ``w_off .. w_off + W_l - 1`` of the ring (all of
    it by default; a rank's block of a sequence-sharded cache), and only
    the positions whose slots lie there are written. ``first`` is an
    int (prefill: the slots form at most two runs, each a slice) or a
    0-d tensor with ``count == 1`` (decode: one slot; a block that does
    not hold it writes its own value back)."""
    w_l = cache["kv_pos"].shape[1]
    if not torch.is_tensor(first):
        start = first % w
        head = min(count, w - start)
        for j0, s0, n in ((0, start, head), (head, 0, count - head)):
            lo, hi = max(s0, w_off), min(s0 + n, w_off + w_l)
            if lo >= hi:
                continue
            for name, x in new.items():
                cache[name][:, lo - w_off:hi - w_off].copy_(
                    x[:, j0 + lo - s0:j0 + hi - s0])
        return
    assert count == 1, "a tensor position writes one slot"
    slot = (first % w - w_off).reshape(1).long()
    held = (slot >= 0) & (slot < w_l)
    if w_l < w:
        slot = slot.clamp(0, w_l - 1)
    for name, x in new.items():
        dst = cache[name]
        x = x.to(dst.dtype)
        if w_l < w:
            x = torch.where(held.reshape((1, 1) + (1,) * (dst.dim() - 2)), x,
                            dst.index_select(1, slot))
        dst.index_copy_(1, slot, x)


def _cache_write(cache, new, first, count: int):
    """Write ``new`` ({leaf name: (B, count, ...)}, "kv_pos" the
    positions ``first .. first + count - 1`` among them) into the cache
    ring by :func:`_ring_write`, in place. On a DTensor cache each rank
    writes the slots of its own block of the ring (under ``local_map``),
    the new values laid out as the cache's batch and head dims, their
    positions whole."""
    ref = cache["kv_pos"]
    w = ref.shape[1]
    if not dtensor.is_dtensor(ref):
        _ring_write(cache, new, first, count, w)
        return
    w_off = dtensor.offset(ref, 1)
    names = list(new)
    args = [(cache, None, None)] + [
        (new[n], _placements(cache[n], (0, 2)), None) for n in names]
    traced = torch.is_tensor(first)
    if traced:
        first = dtensor.replicated(first, ref)
        args.append((first, list(first.placements), None))

    def local(c, *vals):
        _ring_write(c, dict(zip(names, vals)), vals[-1] if traced else first,
                    count, w, w_off)
        return ()

    dtensor.local_map_tree(local, ref.device_mesh, args, [])


def _cache_read(cfg, cache, dtype):
    if cfg.kv_cache_dtype == "int8":
        return (_dequantize_kv(cache["k"], cache["k_scale"], dtype),
                _dequantize_kv(cache["v"], cache["v_scale"], dtype))
    return cache["k"], cache["v"]


def _kv_values(cfg, k, v):
    """The cache leaves' new values: k/v, or their int8 codes and
    scales."""
    if cfg.kv_cache_dtype != "int8":
        return {"k": k, "v": v}
    (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
    return {"k": kq, "k_scale": ks, "v": vq, "v_scale": vs}


def gqa_prefill(cfg, p, x, positions, cache):
    """Full-sequence forward that also fills the cache (positions start at
    0). Attention runs on the full-precision K/V; the cache keeps the
    (possibly int8) copies of the last W positions, each at slot
    position % W."""
    b, s, _ = x.shape
    q, k, v = _gqa_qkv(cfg, p, x, positions)
    out = attention_math(cfg, q, k, v, positions, positions)
    first = max(s - cache["k"].shape[1], 0)
    _cache_write(cache, {"kv_pos": positions[:, first:],
                         **_kv_values(cfg, k[:, first:], v[:, first:])},
                 first, s - first)
    return linear(p["wo"], _merge_heads(out)), cache


def _decode_spmd(q, pos, cache, weights, local_fn):
    """A decode step's attention over a DTensor cache: each rank attends
    over its block of the cache's slots, and the blocks merge by their
    log-sum-exp (the all-reduces XLA inserts for a sharded sequence).

    ``q`` (B, 1, H, Dq) is laid out as the cache's batch (and its heads,
    where the cache splits heads); ``weights`` (a dict, replicated) and
    the cache leaves reach ``local_fn(q_l, pos_l, weights_l, cache_l) ->
    (out (B, 1, H, Dv) f32, lse (B, 1, H))``. Returns the merged
    attention (B, 1, H, Dv), f32."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache["kv_pos"].device_mesh
    # the batch, and a GQA cache's heads (an MLA latent has none)
    kv, keep = (cache["k"], (0, 2)) if "k" in cache else (cache["latent"],
                                                          (0,))
    q_pl = _placements(kv, keep)
    # the blocks of slots become a leading axis of the partial results
    out_pl = [Shard(0) if isinstance(pk, Shard) and pk.dim == 1 else
              Shard(pq.dim + 1) if isinstance(pq, Shard) else Replicate()
              for pk, pq in zip(kv.placements, q_pl)]
    rep = [Replicate()] * mesh.ndim

    def local(ql, pl, wl, cl):
        out, lse = local_fn(ql, pl, wl, cl)
        return out[None], lse[None]

    out, lse = dtensor.local_map_tree(
        local, mesh, [(dtensor.settle(q), q_pl, None), (pos, rep, None),
                      (weights, rep, None), (cache, None, None)],
        [out_pl, out_pl])
    w = torch.exp(lse - lse.amax(0, keepdim=True))
    return (w[..., None] * out).sum(0) / w.sum(0)[..., None]


def gqa_decode(cfg, p, x, pos, cache):
    """One-token decode. x: (B, 1, D); pos: () int tensor, the token's
    position. Writes its K/V at slot pos % W and attends to the cache."""
    b = x.shape[0]
    spmd = dtensor.is_dtensor(cache["k"])
    positions = (dtensor.positions(x, 1) + pos if spmd
                 else pos.reshape(1, 1).expand(b, 1))
    q, k, v = _gqa_qkv(cfg, p, x, positions)
    _cache_write(cache, {"kv_pos": positions, **_kv_values(cfg, k, v)}, pos,
                 1)
    if spmd:
        scale = 1.0 / math.sqrt(q.shape[-1])

        def local(ql, pl, _, cl):
            kl, vl = _cache_read(cfg, cl, ql.dtype)
            q_pos = pl.reshape(1, 1).expand(ql.shape[0], 1)
            return _naive_parts(ql, kl, vl, q_pos, cl["kv_pos"],
                                cfg.sliding_window, scale)

        out = _decode_spmd(q, pos, cache, {}, local)
    else:
        k_full, v_full = _cache_read(cfg, cache, k.dtype)
        out = naive_attention(q, k_full, v_full, positions, cache["kv_pos"],
                              cfg.sliding_window)
    return linear(p["wo"], _merge_heads(out.to(q.dtype))), cache


# =========================================================================
# MLA (multi-head latent attention, DeepSeek-V2) block
# =========================================================================

def mla_init(gen, cfg, dtype, device="cpu"):
    d, h = cfg.d_model, cfg.num_heads
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    return {
        "wq": linear_init(gen, d, h * (dn + dr), dtype, device=device),
        # latent + shared rope key
        "w_dkv": linear_init(gen, d, r + dr, dtype, device=device),
        "kv_norm": rmsnorm_init(r, device),
        "w_uk": linear_init(gen, r, h * dn, dtype, device=device),
        "w_uv": linear_init(gen, r, h * dv, dtype, device=device),
        "wo": linear_init(gen, h * dv, d, dtype, device=device),
    }


def _mla_latent(cfg, p, x, positions):
    """(latent (B, S, r) normalised, k_rope (B, S, 1, dr) rotated)."""
    r = cfg.kv_lora_rank
    ckv = linear(p["w_dkv"], x)
    latent = rmsnorm(p["kv_norm"], ckv[..., :r], cfg.norm_eps)
    k_rope = apply_rope(ckv[..., None, r:], positions, cfg.rope_theta)
    return latent, k_rope


def _mla_q(cfg, p, x, positions):
    h, dn, dr = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = _split_heads(linear(p["wq"], x), h, dn + dr, x.dtype)
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _mla_expand_kv(cfg, p, latent, k_rope):
    """Per-head K (nope + rope) and V, expanded from the latent."""
    b, s, _ = latent.shape
    h, dn, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    k_nope = _split_heads(linear(p["w_uk"], latent), h, dn,
                          latent.dtype)
    v = _split_heads(linear(p["w_uv"], latent), h, dv, latent.dtype)
    k_rope = k_rope.expand(b, s, h, k_rope.shape[-1])
    if dtensor.is_dtensor(k_rope):
        # the shared rotary key split as the heads are (a local slice)
        k_rope = k_rope.redistribute(k_nope.device_mesh, k_nope.placements)
    return torch.cat([k_nope, k_rope], -1), v


def _mla_scale(cfg) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def _mla_attend(cfg, p, x, positions, latent, k_rope):
    b, s, _ = x.shape
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    k, v = _mla_expand_kv(cfg, p, latent, k_rope)
    q = torch.cat([q_nope, q_rope], -1)
    out = attention_math(cfg, q, k, v, positions, positions,
                         scale=_mla_scale(cfg))
    return linear(p["wo"], _merge_heads(out))


def mla_forward(cfg, p, x, positions):
    """Self-attention over a full sequence. x: (B,S,D); positions: (B,S)."""
    latent, k_rope = _mla_latent(cfg, p, x, positions)
    return _mla_attend(cfg, p, x, positions, latent, k_rope)


def mla_cache_init(cfg, batch: int, max_len: int, dtype, device="cpu"):
    """One layer's empty MLA cache, in ``dtype`` whatever
    ``cfg.kv_cache_dtype`` says."""
    return {
        "latent": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                              dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                              dtype=dtype, device=device),
        "kv_pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                             device=device),
    }


def mla_prefill(cfg, p, x, positions, cache):
    """``mla_forward`` that also writes the prompt's latent and rotary
    key into the cache from position 0, in place."""
    latent, k_rope = _mla_latent(cfg, p, x, positions)
    out = _mla_attend(cfg, p, x, positions, latent, k_rope)
    _cache_write(cache, {"latent": latent, "k_rope": k_rope[:, :, 0],
                         "kv_pos": positions}, 0, x.shape[1])
    return out, cache


def _mla_absorbed_parts(cfg, q_nope, q_rope, w_uk, w_uv, lat, krope_c,
                        q_pos, kv_pos, dtype, lse: bool = True):
    """The absorbed MLA decode (``mla_decode``) over the cache's slots
    ``lat``/``krope_c``/``kv_pos`` before its cast: (out (B, 1, H, Dv) in
    f32, and with ``lse`` the rows' log-sum-exp (B, 1, H), else None),
    the products rounded where the reference's are. A decode over a
    sequence-sharded cache runs it on each block of slots and merges the
    blocks by their log-sum-exp (``_decode_spmd``)."""
    h, dn, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    wide = torch.promote_types(dtype, F32)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.to(wide),
                         w_uk.reshape(r, h, dn).to(wide))
    s_lat = torch.einsum("bqhr,bsr->bhqs", q_lat.to(lat.dtype).to(wide),
                         lat.to(wide))
    s_rope = torch.einsum("bqhd,bsd->bhqs", q_rope.to(wide),
                          krope_c.to(wide))
    scores = (s_lat + s_rope) * _mla_scale(cfg)
    m = _mask(q_pos, kv_pos, 0)[:, None]
    scores = torch.where(m, scores, torch.full_like(scores, NEG_INF))
    pr = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhqs,bsr->bqhr", pr.to(lat.dtype).to(wide),
                         lat.to(wide))                        # (B,1,h,r)
    out = torch.einsum("bqhr,rhd->bqhd", o_lat.to(dtype).to(wide),
                       w_uv.reshape(r, h, dv).to(wide))
    if not lse:
        return out, None
    return out, torch.logsumexp(scores, -1).transpose(1, 2)


def mla_decode(cfg, p, x, pos, cache, absorb: bool = True):
    """One-token MLA decode. x: (B, 1, D); pos: () int tensor.

    ``absorb=True`` folds W_uk into the query and W_uv into the output,
    so attention runs over the cached latent itself (scores =
    (q_nope W_uk^T) . latent + q_rope . k_rope); ``absorb=False``
    expands the whole cache to per-head K/V every step. The products
    accumulate in f32 and round where the reference's do."""
    b = x.shape[0]
    dn = cfg.qk_nope_head_dim
    spmd = dtensor.is_dtensor(cache["latent"])
    if spmd and not absorb:
        raise ValueError("on DTensors MLA decode takes the absorbed form "
                         "only (absorb=True)")
    positions = (dtensor.positions(x, 1) + pos if spmd
                 else pos.reshape(1, 1).expand(b, 1))
    latent, k_rope = _mla_latent(cfg, p, x, positions)
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    _cache_write(cache, {"latent": latent, "k_rope": k_rope[:, :, 0],
                         "kv_pos": positions}, pos, 1)
    lat, krope_c, kv_pos = cache["latent"], cache["k_rope"], cache["kv_pos"]
    if spmd:
        def local(ql, pl, wl, cl):
            q_pos = pl.reshape(1, 1).expand(ql.shape[0], 1)
            return _mla_absorbed_parts(
                cfg, ql[..., :dn], ql[..., dn:], wl["w_uk"], wl["w_uv"],
                cl["latent"], cl["k_rope"], q_pos, cl["kv_pos"], x.dtype)

        out = _decode_spmd(torch.cat([q_nope, q_rope], -1), pos, cache,
                           {"w_uk": p["w_uk"]["w"], "w_uv": p["w_uv"]["w"]},
                           local)
    elif absorb:
        out, _ = _mla_absorbed_parts(
            cfg, q_nope, q_rope, p["w_uk"]["w"], p["w_uv"]["w"], lat,
            krope_c, positions, kv_pos, x.dtype, lse=False)
    else:
        k, v = _mla_expand_kv(cfg, p, lat, krope_c[:, :, None, :])
        q = torch.cat([q_nope, q_rope], -1)
        out = naive_attention(q, k, v, positions, kv_pos, 0,
                              scale=_mla_scale(cfg))
    return linear(p["wo"], _merge_heads(out.to(x.dtype))), cache
