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
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    wide = torch.promote_types(q.dtype, F32)
    qg = q.reshape(b, sq, kvh, g, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.to(wide),
                          k.to(wide)) * scale
    m = _mask(q_pos, kv_pos, window)[:, None, None]          # (B,1,1,Sq,Skv)
    scores = torch.where(m, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).to(wide),
                       v.to(wide))
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


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


def attention_math(cfg, q, k, v, q_pos, kv_pos, scale=None):
    """``cfg.attn_impl == "blockwise"`` with Sq > 1: the flash kernel, its
    (B, S, H, Dh) operands transposed to (B, H, S, Dh) and back; else the
    naive version."""
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


def _gqa_qkv(cfg, p, x, positions):
    b, s, _ = x.shape
    h, kvh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = linear(p["wq"], x).reshape(b, s, h, dh)
    k = linear(p["wk"], x).reshape(b, s, kvh, dh)
    v = linear(p["wv"], x).reshape(b, s, kvh, dh)
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
    return linear(p["wo"], out.reshape(b, s, -1))


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


def _cache_write(cfg, cache, k, v, positions, slots):
    """Write k/v (B, S, KVH, Dh) and their positions (B, S) into the cache
    slots ``slots`` (an (S,) index tensor on the cache's device), in
    place."""
    def put(name, x):
        cache[name].index_copy_(1, slots, x.to(cache[name].dtype))

    put("kv_pos", positions)
    if cfg.kv_cache_dtype == "int8":
        for name, x in (("k", k), ("v", v)):
            q, scale = _quantize_kv(x)
            put(name, q)
            put(name + "_scale", scale)
    else:
        put("k", k)
        put("v", v)


def _cache_read(cfg, cache, dtype):
    if cfg.kv_cache_dtype == "int8":
        return (_dequantize_kv(cache["k"], cache["k_scale"], dtype),
                _dequantize_kv(cache["v"], cache["v_scale"], dtype))
    return cache["k"], cache["v"]


def gqa_prefill(cfg, p, x, positions, cache):
    """Full-sequence forward that also fills the cache (positions start at
    0). Attention runs on the full-precision K/V; the cache keeps the
    (possibly int8) copies of the last W positions, each at slot
    position % W."""
    b, s, _ = x.shape
    q, k, v = _gqa_qkv(cfg, p, x, positions)
    out = attention_math(cfg, q, k, v, positions, positions)
    w = cache["k"].shape[1]
    first = max(s - w, 0)
    slots = torch.arange(first, s, device=x.device) % w
    _cache_write(cfg, cache, k[:, first:], v[:, first:],
                 positions[:, first:], slots)
    return linear(p["wo"], out.reshape(b, s, -1)), cache


def gqa_decode(cfg, p, x, pos, cache):
    """One-token decode. x: (B, 1, D); pos: () int tensor, the token's
    position. Writes its K/V at slot pos % W and attends to the cache."""
    b = x.shape[0]
    positions = pos.reshape(1, 1).expand(b, 1)
    q, k, v = _gqa_qkv(cfg, p, x, positions)
    w = cache["k"].shape[1]
    _cache_write(cfg, cache, k, v, positions, (pos % w).reshape(1).long())
    k_full, v_full = _cache_read(cfg, cache, k.dtype)
    out = naive_attention(q, k_full, v_full, positions, cache["kv_pos"],
                          cfg.sliding_window)
    return linear(p["wo"], out.reshape(b, 1, -1)), cache


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
    b, s, _ = x.shape
    h, dn, dr = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = linear(p["wq"], x).reshape(b, s, h, dn + dr)
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _mla_expand_kv(cfg, p, latent, k_rope):
    """Per-head K (nope + rope) and V, expanded from the latent."""
    b, s, _ = latent.shape
    h, dn, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    k_nope = linear(p["w_uk"], latent).reshape(b, s, h, dn)
    v = linear(p["w_uv"], latent).reshape(b, s, h, dv)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, k_rope.shape[-1])], -1)
    return k, v


def _mla_scale(cfg) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def _mla_attend(cfg, p, x, positions, latent, k_rope):
    b, s, _ = x.shape
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    k, v = _mla_expand_kv(cfg, p, latent, k_rope)
    q = torch.cat([q_nope, q_rope], -1)
    out = attention_math(cfg, q, k, v, positions, positions,
                         scale=_mla_scale(cfg))
    return linear(p["wo"], out.reshape(b, s, -1))


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


def _mla_cache_write(cache, latent, k_rope, positions, slots):
    for name, x in (("latent", latent), ("k_rope", k_rope[:, :, 0]),
                    ("kv_pos", positions)):
        cache[name].index_copy_(1, slots, x.to(cache[name].dtype))


def mla_prefill(cfg, p, x, positions, cache):
    """``mla_forward`` that also writes the prompt's latent and rotary
    key into the cache from position 0, in place."""
    latent, k_rope = _mla_latent(cfg, p, x, positions)
    out = _mla_attend(cfg, p, x, positions, latent, k_rope)
    _mla_cache_write(cache, latent, k_rope, positions,
                     torch.arange(x.shape[1], device=x.device))
    return out, cache


def mla_decode(cfg, p, x, pos, cache, absorb: bool = True):
    """One-token MLA decode. x: (B, 1, D); pos: () int tensor.

    ``absorb=True`` folds W_uk into the query and W_uv into the output,
    so attention runs over the cached latent itself (scores =
    (q_nope W_uk^T) . latent + q_rope . k_rope); ``absorb=False``
    expands the whole cache to per-head K/V every step. The products
    accumulate in f32 and round where the reference's do."""
    b = x.shape[0]
    h, dn, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    scale = _mla_scale(cfg)
    positions = pos.reshape(1, 1).expand(b, 1)
    latent, k_rope = _mla_latent(cfg, p, x, positions)
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    _mla_cache_write(cache, latent, k_rope, positions,
                     pos.reshape(1).long())
    lat, krope_c, kv_pos = cache["latent"], cache["k_rope"], cache["kv_pos"]
    if absorb:
        wide = torch.promote_types(x.dtype, F32)
        wuk = p["w_uk"]["w"].reshape(r, h, dn)
        q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.to(wide), wuk.to(wide))
        s_lat = torch.einsum("bqhr,bsr->bhqs", q_lat.to(lat.dtype).to(wide),
                             lat.to(wide))
        s_rope = torch.einsum("bqhd,bsd->bhqs", q_rope.to(wide),
                              krope_c.to(wide))
        scores = (s_lat + s_rope) * scale
        m = _mask(positions, kv_pos, 0)[:, None]
        scores = torch.where(m, scores, torch.full_like(scores, NEG_INF))
        pr = torch.softmax(scores, dim=-1)
        o_lat = torch.einsum("bhqs,bsr->bqhr", pr.to(lat.dtype).to(wide),
                             lat.to(wide))                    # (B,1,h,r)
        wuv = p["w_uv"]["w"].reshape(r, h, dv)
        out = torch.einsum("bqhr,rhd->bqhd", o_lat.to(x.dtype).to(wide),
                           wuv.to(wide)).to(x.dtype)
    else:
        k, v = _mla_expand_kv(cfg, p, lat, krope_c[:, :, None, :])
        q = torch.cat([q_nope, q_rope], -1)
        out = naive_attention(q, k, v, positions, kv_pos, 0, scale=scale)
    return linear(p["wo"], out.reshape(b, 1, -1)), cache
