"""xLSTM blocks: mLSTM (matrix memory, chunkwise-recurrent) and sLSTM
(scalar memory, exponential gating, sequential scan). arXiv:2405.04517.

The reference's formulation in plain torch (it runs outside any Pallas
kernel, so there is no kernel to port):
  * mLSTM — chunkwise: intra-chunk a gated (L x L) product, inter-chunk a
    short loop over chunk states, stabilised with the running max-state
    m (as in the paper);
  * sLSTM — inherently sequential (recurrent weights): a loop over time
    with per-head block-diagonal recurrent matrices, in f32.

Decode state is O(1): mLSTM carries (C: (B,H,dk,dv), n: (B,H,dk), m:
(B,H)); sLSTM carries (c, n, h, m): (B,D) each; all f32, the stabiliser
starting at -1e30. The sLSTM FFN's GELU is the tanh approximation
(``jax.nn.gelu``'s default). ``_mlstm_chunk_scan`` raises ValueError
where the chunk does not divide the sequence (the reference asserts).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import (F32, linear, linear_init, randn,
                                       rmsnorm, rmsnorm_init, scan_steps)

LOG_EPS = -1e30


def _heads_dims(cfg):
    h = cfg.num_heads
    d_in = int(cfg.d_model * cfg.xlstm.proj_factor_mlstm)
    d_in -= d_in % (h * 2)
    dh = d_in // h
    return h, d_in, dh


def _wide(dtype):
    return torch.promote_types(dtype, F32)


# =========================================================================
# mLSTM block (pre-up-projection, as in the paper)
# =========================================================================

def mlstm_init(gen, cfg, dtype, device="cpu"):
    d = cfg.d_model
    h, d_in, _ = _heads_dims(cfg)

    def lin(d_i, d_o, bias=False):
        return linear_init(gen, d_i, d_o, dtype, bias=bias, device=device)

    return {
        "up": lin(d, 2 * d_in),                  # [cell path | gate path]
        "wq": lin(d_in, d_in),
        "wk": lin(d_in, d_in),
        "wv": lin(d_in, d_in),
        "w_i": lin(d_in, h, bias=True),
        "w_f": lin(d_in, h, bias=True),
        "norm": rmsnorm_init(d_in, device),
        "down": lin(d_in, d),
    }


def _mlstm_chunk_scan(q, k, v, i_pre, f_pre, state, chunk: int):
    """Stabilised chunkwise mLSTM.

    q, k, v: (B,S,H,dh); i_pre, f_pre: (B,S,H) gate preactivations.
    state: (C (B,H,dk,dv), n (B,H,dk), m (B,H)).
    Returns (y (B,S,H,dh), new state), in the state's type.
    """
    bb, s, h, dh = q.shape
    l = min(chunk, s)
    if s % l:
        raise ValueError(f"seq {s} % chunk {l} != 0")
    nc = s // l
    c_prev, n_prev, m_prev = state
    wide = c_prev.dtype
    root = math.sqrt(dh)
    logf = F.logsigmoid(f_pre.to(wide))                    # (B,S,H)
    mask = torch.ones((l, l), dtype=torch.bool, device=q.device).tril()
    mask = mask[None, :, :, None]

    def r(t):
        return t.to(wide).reshape(bb, nc, l, *t.shape[2:])

    qs, ks, vs, is_, fs = r(q), r(k), r(v), r(i_pre), r(logf)

    def chunk_step(carry, inputs):
        c_prev, n_prev, m_prev = carry
        q_g, k_g, v_g, i_g, f_g = inputs                   # (B,l,H,dh) (B,l,H)
        b_cum = torch.cumsum(f_g, dim=1)                   # (B,l,H)
        a_run = torch.cummax(i_g - b_cum, dim=1).values    # running max of
                                                           # (i_s - b_s)
        m_t = b_cum + torch.maximum(m_prev[:, None, :], a_run)
        # intra weights W[t,s] = exp(b_t - b_s + i_s - m_t), s <= t
        seg = (b_cum[:, :, None, :] - b_cum[:, None, :, :]
               + i_g[:, None, :, :] - m_t[:, :, None, :])  # (B,t,s,H)
        # mask BEFORE exp (s > t exponents overflow; inf * 0 NaNs the
        # backward)
        w_ts = torch.exp(torch.where(mask, seg, LOG_EPS))
        qk = torch.einsum("bthd,bshd->btsh", q_g, k_g) / root
        num_intra = torch.einsum("btsh,bshd->bthd", w_ts * qk, v_g)
        den_intra = (w_ts * qk).sum(2)                     # (B,t,H)
        # inter: scale exp(m_prev + b_t - m_t); c_prev and n_prev already
        # accumulate k / sqrt(dh), q is not rescaled
        g_t = torch.exp(m_prev[:, None, :] + b_cum - m_t)  # (B,l,H)
        num_inter = torch.einsum("bthd,bhde->bthe", q_g, c_prev) \
            * g_t[..., None]
        den_inter = torch.einsum("bthd,bhd->bth", q_g, n_prev) * g_t
        num = num_intra + num_inter
        den = den_intra + den_inter
        m_last = m_t[:, -1]                                # (B,H)
        y = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
        # state update to the chunk's end
        b_tot = b_cum[:, -1]                               # (B,H)
        sc = torch.exp(m_prev + b_tot - m_last)            # (B,H)
        kv_dec = torch.exp(b_tot[:, None, :] - b_cum + i_g
                           - m_last[:, None, :])           # (B,l,H)
        k_s = k_g / root
        c_prev = c_prev * sc[..., None, None] + torch.einsum(
            "bsh,bshd,bshe->bhde", kv_dec, k_s, v_g)
        n_prev = n_prev * sc[..., None] + torch.einsum(
            "bsh,bshd->bhd", kv_dec, k_s)
        return (c_prev, n_prev, m_last), y

    state, ys = scan_steps(chunk_step, (c_prev, n_prev, m_prev),
                           (qs, ks, vs, is_, fs), nc)
    return ys.reshape(bb, s, h, dh), state


def mlstm_state_init(cfg, batch: int, device="cpu", dtype=F32):
    h, _, dh = _heads_dims(cfg)
    return {"C": torch.zeros((batch, h, dh, dh), dtype=dtype, device=device),
            "n": torch.zeros((batch, h, dh), dtype=dtype, device=device),
            "m": torch.full((batch, h), LOG_EPS, dtype=dtype, device=device)}


def _mlstm_cell_io(cfg, p, x):
    bb, s, _ = x.shape
    h, d_in, dh = _heads_dims(cfg)
    up = linear(p["up"], x)
    cell_in, gate = up[..., :d_in], up[..., d_in:]
    q = linear(p["wq"], cell_in).reshape(bb, s, h, dh)
    k = linear(p["wk"], cell_in).reshape(bb, s, h, dh)
    v = linear(p["wv"], cell_in).reshape(bb, s, h, dh)
    i_pre = linear(p["w_i"], cell_in)
    f_pre = linear(p["w_f"], cell_in)
    return q, k, v, i_pre, f_pre, gate


def _mlstm(cfg, p, x, state, chunk):
    """The mLSTM block from ``state`` (a dict as ``mlstm_state_init``):
    (y (B,S,D), the final state dict)."""
    bb, s, _ = x.shape
    _, d_in, _ = _heads_dims(cfg)
    q, k, v, i_pre, f_pre, gate = _mlstm_cell_io(cfg, p, x)
    y, (c, n, m) = _mlstm_chunk_scan(q, k, v, i_pre, f_pre,
                                     (state["C"], state["n"], state["m"]),
                                     chunk)
    y = y.reshape(bb, s, d_in).to(x.dtype)
    y = rmsnorm(p["norm"], y, cfg.norm_eps) \
        * F.silu(gate.to(_wide(x.dtype))).to(x.dtype)
    return linear(p["down"], y), {"C": c, "n": n, "m": m}


def mlstm_forward(cfg, p, x, state=None):
    """x: (B,S,D) -> (y, final state dict), from a fresh state unless
    ``state`` is given."""
    if state is None:
        state = mlstm_state_init(cfg, x.shape[0], x.device, _wide(x.dtype))
    return _mlstm(cfg, p, x, state, cfg.xlstm.chunk)


def mlstm_decode(cfg, p, x, state):
    """x: (B,1,D); state dict as ``mlstm_state_init``."""
    return _mlstm(cfg, p, x, state, 1)


# =========================================================================
# sLSTM block (post-up-projection, per the paper)
# =========================================================================

def slstm_init(gen, cfg, dtype, device="cpu"):
    d = cfg.d_model
    h = cfg.num_heads
    dh = d // h
    d_ff = int(d * cfg.xlstm.proj_factor_slstm)

    # 4 gates (i, f, z, o): input weights (d -> 4d) and per-head
    # recurrent (h, dh, dh)
    def rec():
        r = randn(gen, (h, dh, dh)) / math.sqrt(dh)
        return r.to(device, dtype)

    return {
        "w_gates": linear_init(gen, d, 4 * d, dtype, bias=True,
                               device=device),
        "r_i": rec(), "r_f": rec(), "r_z": rec(), "r_o": rec(),
        "norm": rmsnorm_init(d, device),
        "ffn_up": linear_init(gen, d, 2 * d_ff, dtype, device=device),
        "ffn_down": linear_init(gen, d_ff, d, dtype, device=device),
    }


def slstm_state_init(cfg, batch: int, device="cpu", dtype=F32):
    def z():
        return torch.zeros((batch, cfg.d_model), dtype=dtype, device=device)
    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((batch, cfg.d_model), LOG_EPS, dtype=dtype,
                            device=device)}


def _slstm_step(cfg, r_all, carry, g_x):
    """One timestep. carry: (c, n, h, m) each (B,D); g_x: (B,4D) the input
    gate preactivations; r_all: (4, H, dh, dh) the recurrent matrices of
    the gates i, f, z, o in the state's type. The reference's arithmetic,
    each shared term formed once (a step is a handful of small ops, and
    the loop is host-bound)."""
    c, n, hh, m = carry
    heads = cfg.num_heads
    d = cfg.d_model
    rec = torch.einsum("bhd,ghde->bghe", hh.reshape(-1, heads, d // heads),
                       r_all)
    gi, gf, gz, go = (g_x.reshape(-1, 4, d)
                      + rec.reshape(-1, 4, d)).unbind(1)
    fm = F.logsigmoid(gf) + m
    m_new = torch.maximum(fm, gi)
    e_f = torch.exp(fm - m_new)
    e_i = torch.exp(gi - m_new)
    c_new = e_f * c + e_i * torch.tanh(gz)
    n_new = e_f * n + e_i
    h_new = torch.sigmoid(go) * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, h_new, m_new


def slstm_forward(cfg, p, x, state=None):
    """x: (B,S,D) -> (y, final state dict), a step at a time from a fresh
    state unless ``state`` is given."""
    bb, s, _ = x.shape
    wide = _wide(x.dtype)
    st = slstm_state_init(cfg, bb, x.device, wide) if state is None \
        else state
    g_all = linear(p["w_gates"], x).to(wide)               # (B,S,4D)
    r_all = torch.stack([p[k].to(wide) for k in ("r_i", "r_f", "r_z",
                                                 "r_o")])
    carry = (st["c"], st["n"], st["h"], st["m"])

    def time_step(carry, inputs):
        carry = _slstm_step(cfg, r_all, carry, inputs[0])
        return carry, carry[2]

    carry, y = scan_steps(time_step, carry, (g_all,), s)
    y = y.to(x.dtype)                                      # (B,S,D)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    up = linear(p["ffn_up"], y)
    d_ff = up.shape[-1] // 2
    y = linear(p["ffn_down"], F.gelu(up[..., :d_ff], approximate="tanh")
               * up[..., d_ff:])
    return y, dict(zip(("c", "n", "h", "m"), carry))


def slstm_decode(cfg, p, x, state):
    return slstm_forward(cfg, p, x, state)
