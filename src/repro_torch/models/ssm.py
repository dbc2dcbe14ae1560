"""Mamba2 (SSD) block, the reference's chunked formulation in plain torch.

The sequence is split into chunks of length L: the intra-chunk term is a
masked (L x L) product, batched over heads, and the inter-chunk term a
short loop over chunk states. The reference computes all of this outside
any Pallas kernel (``repro/models/ssm.py``), so there is no kernel to
port; the matrix products run on cuBLAS.

Dtypes as in the reference: ``A_log``, ``D`` and ``dt_bias`` are f32 in
a bf16 tower, the scan runs in f32 (f64 for an f64 model), and the
decode state is (conv ring (B, W-1, conv_dim) in the model's dtype,
holding the raw pre-conv inputs; SSM state (B, H, N, P) in f32), O(1) in
the sequence length. ``_ssd_chunked`` raises ValueError where the chunk
does not divide the sequence (the reference asserts); it does not pad.

The reference's prefill runs the forward and then recomputes the
projection, the conv and the scan for the final state
(``transformer._mamba2_prefill`` / ``_ssd_final_state``); here
:func:`mamba2_prefill` takes the final state from the forward scan's own
carry, the same arithmetic.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import (F32, linear, linear_init, randn,
                                       rmsnorm, rmsnorm_init, scan_steps)

NEG_INF = -1e30


def _dims(cfg):
    d_inner = cfg.ssm.expand * cfg.d_model
    heads = d_inner // cfg.ssm.head_dim
    conv_dim = d_inner + 2 * cfg.ssm.state
    return d_inner, heads, conv_dim


def _wide(dtype):
    return torch.promote_types(dtype, F32)


def mamba2_init(gen, cfg, dtype, device="cpu"):
    d = cfg.d_model
    d_inner, heads, conv_dim = _dims(cfg)
    n, w = cfg.ssm.state, cfg.ssm.conv_width
    conv_w = randn(gen, (w, conv_dim)) / math.sqrt(w)
    return {
        # order: [z (gate, d_inner) | x (d_inner) | B (n) | C (n) | dt (heads)]
        "in_proj": linear_init(gen, d, 2 * d_inner + 2 * n + heads, dtype,
                               device=device),
        "conv_w": conv_w.to(device, dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, heads, dtype=F32,
                                          device=device)),
        "D": torch.ones((heads,), dtype=F32, device=device),
        "dt_bias": torch.log(torch.expm1(torch.linspace(
            1e-3, 1e-1, heads, dtype=F32, device=device))),
        "norm": rmsnorm_init(d_inner, device),
        "out_proj": linear_init(gen, d_inner, d, dtype, device=device),
    }


def _split_proj(cfg, proj):
    d_inner, heads, _ = _dims(cfg)
    n = cfg.ssm.state
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:d_inner + d_inner + 2 * n]
    dt = proj[..., -heads:]
    return z, xbc, dt


def _causal_conv(p, xbc):
    """Depthwise causal conv over (B, S, conv_dim), then SiLU."""
    w = p["conv_w"].shape[0]
    s = xbc.shape[1]
    wide = _wide(xbc.dtype)
    pad = F.pad(xbc, (0, 0, w - 1, 0))
    out = sum(pad[:, i:i + s, :] * p["conv_w"][i].to(wide)
              for i in range(w))
    return F.silu(out + p["conv_b"].to(wide)).to(xbc.dtype)


def _ssd_chunked(x, dt, a, b, c, chunk: int):
    """Chunked SSD scan from a zero state.

    x: (B,S,H,P) inputs; dt: (B,S,H) > 0; a: (H,) negative decay;
    b, c: (B,S,N) (single group). Returns (y (B,S,H,P), the final state
    (B,H,N,P)), both in dt's type:
    h_t = exp(dt_t a) h_{t-1} + dt_t * b_t x_t^T ; y_t = c_t . h_t (the
    caller adds D x).
    """
    bb, s, h, pdim = x.shape
    n = b.shape[-1]
    l = min(chunk, s)
    if s % l:
        raise ValueError(f"seq {s} % chunk {l} != 0")
    nc = s // l
    wide = dt.dtype
    xs = x.reshape(bb, nc, l, h, pdim).to(wide)
    dts = dt.reshape(bb, nc, l, h)
    bs = b.reshape(bb, nc, l, n).to(wide)
    cs = c.reshape(bb, nc, l, n).to(wide)
    mask = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    mask = mask[None, :, :, None]
    hprev = x.new_zeros((bb, h, n, pdim), dtype=wide)

    def chunk_step(carry, inputs):
        (hprev,), (x_g, dt_g, b_g, c_g) = carry, inputs
        da = dt_g * a                                     # (B,l,H) log-decay
        cum = torch.cumsum(da, dim=1)
        tot = cum[:, -1]                                  # (B,H)
        # intra: y[t] = sum_{s<=t} exp(cum_t - cum_s) dt_s (c_t.b_s) x_s
        # (mask BEFORE exp: the s > t exponents overflow, and inf * 0 in
        # the backward pass poisons the gradients)
        seg = cum[:, :, None, :] - cum[:, None, :, :]     # (B,t,s,H)
        decay = torch.exp(torch.where(mask, seg, NEG_INF))
        cb = torch.einsum("btn,bsn->bts", c_g, b_g)
        w_ts = cb[..., None] * decay * dt_g[:, None, :, :]
        y_intra = torch.einsum("btsh,bshp->bthp", w_ts, x_g)
        # inter: y[t] += exp(cum_t) c_t . h_prev
        y_inter = torch.einsum("bth,btn,bhnp->bthp", torch.exp(cum), c_g,
                               hprev)
        # state: h_new = exp(tot) h_prev + sum_s exp(tot - cum_s) dt_s
        # b_s x_s^T
        sdecay = torch.exp(tot[:, None, :] - cum) * dt_g  # (B,l,H)
        states = torch.einsum("bsh,bsn,bshp->bhnp", sdecay, b_g, x_g)
        hprev = hprev * torch.exp(tot)[..., None, None] + states
        return (hprev,), y_intra + y_inter

    (hprev,), ys = scan_steps(chunk_step, (hprev,), (xs, dts, bs, cs), nc)
    return ys.reshape(bb, s, h, pdim), hprev


def _gate_out(cfg, p, y, z, dtype):
    """RMSNorm of y * silu(z), then the out projection."""
    y = rmsnorm(p["norm"], y * F.silu(z.to(_wide(dtype))).to(dtype),
                cfg.norm_eps)
    return linear(p["out_proj"], y)


def _forward(cfg, p, x):
    """(y (B,S,D), the raw pre-conv xbc (B,S,conv_dim), the final SSM
    state (B,H,N,P))."""
    bsz, s, _ = x.shape
    d_inner, heads, _ = _dims(cfg)
    pdim, n = cfg.ssm.head_dim, cfg.ssm.state
    wide = _wide(x.dtype)
    z, xbc_raw, dt_pre = _split_proj(cfg, linear(p["in_proj"], x))
    xbc = _causal_conv(p, xbc_raw)
    xi = xbc[..., :d_inner].reshape(bsz, s, heads, pdim)
    b = xbc[..., d_inner:d_inner + n]
    c = xbc[..., d_inner + n:]
    dt = F.softplus(dt_pre.to(wide) + p["dt_bias"])
    a = -torch.exp(p["A_log"].to(wide))
    y, h_final = _ssd_chunked(xi, dt, a, b, c, cfg.ssm.chunk)
    y = y + p["D"].to(wide)[None, None, :, None] * xi.to(wide)
    y = y.reshape(bsz, s, d_inner).to(x.dtype)
    return _gate_out(cfg, p, y, z, x.dtype), xbc_raw, h_final


def mamba2_forward(cfg, p, x):
    """x: (B,S,D) -> (B,S,D). Training / prefill (no cache)."""
    return _forward(cfg, p, x)[0]


def mamba2_prefill(cfg, p, x, cache):
    """The forward over the prompt and the final (conv, ssm) state: the
    last W-1 raw inputs in the conv ring's type, the scan's final carry.
    Returns (y, new state); the caller writes the state into its cache."""
    y, xbc_raw, h_final = _forward(cfg, p, x)
    w = cfg.ssm.conv_width
    return y, {"conv": xbc_raw[:, -(w - 1):, :].to(cache["conv"].dtype),
               "ssm": h_final.to(cache["ssm"].dtype)}


# ------------------------------------------------------------------ decode ---

def mamba2_cache_init(cfg, batch: int, dtype, device="cpu"):
    d_inner, heads, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm.conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, heads, cfg.ssm.state, cfg.ssm.head_dim),
                           dtype=_wide(dtype), device=device),
    }


def mamba2_decode(cfg, p, x, cache):
    """x: (B,1,D), one step against ``cache``; returns (y, new state)."""
    bsz = x.shape[0]
    d_inner, heads, _ = _dims(cfg)
    pdim, n = cfg.ssm.head_dim, cfg.ssm.state
    wide = _wide(x.dtype)
    z, xbc, dt_pre = _split_proj(cfg, linear(p["in_proj"], x))
    # conv ring: window = [cache, current]
    win = torch.cat([cache["conv"], xbc], dim=1)           # (B, W, conv_dim)
    conv = torch.einsum("bwc,wc->bc", win.to(wide), p["conv_w"].to(wide))
    xbc1 = F.silu(conv + p["conv_b"].to(wide)).to(x.dtype)[:, None, :]
    xi = xbc1[..., :d_inner].reshape(bsz, heads, pdim).to(wide)
    b = xbc1[:, 0, d_inner:d_inner + n].to(wide)
    c = xbc1[:, 0, d_inner + n:].to(wide)
    dt = F.softplus(dt_pre[:, 0].to(wide) + p["dt_bias"])  # (B,H)
    a = -torch.exp(p["A_log"].to(wide))
    decay = torch.exp(dt * a)                              # (B,H)
    h = cache["ssm"] * decay[..., None, None] + torch.einsum(
        "bh,bn,bhp->bhnp", dt, b, xi)
    y = torch.einsum("bn,bhnp->bhp", c, h) \
        + p["D"].to(wide)[None, :, None] * xi
    y = y.reshape(bsz, 1, d_inner).to(x.dtype)
    return _gate_out(cfg, p, y, z, x.dtype), {"conv": win[:, 1:, :], "ssm": h}
