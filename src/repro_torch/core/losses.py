"""Comparative losses (paper Sec. 4): NT-Xent contrastive (SimCLR, tau=0.1),
supervised cross-entropy, and the predictive-loss collapse probe (App. C).

Everything is computed in f32. Indexing is by ``gather``, so the losses
run under ``torch.func.vmap`` over clients (the FedAvg round's phase)."""
from __future__ import annotations

import torch

F32 = torch.float32


def _unit_rows(z: torch.Tensor) -> torch.Tensor:
    return z / torch.clamp(torch.linalg.norm(z, dim=-1, keepdim=True),
                           min=1e-8)


def ntxent_loss(zf, zg, temperature: float = 0.1) -> torch.Tensor:
    """SimCLR NT-Xent over a batch of paired encodings zf, zg: (N, d).

    Each zf[i] is contrasted against zg[i] (positive) and all other
    encodings in the union of {zf, zg} minus itself (negatives);
    symmetrized: the mean over the 2N rows. The diagonal is masked with
    -1e9, as in the reference.
    """
    n = zf.shape[0]
    za = _unit_rows(torch.cat([zf.to(F32), zg.to(F32)], dim=0))   # (2N, d)
    sim = za @ za.T / temperature                                 # (2N, 2N)
    eye = torch.eye(2 * n, dtype=torch.bool, device=sim.device)
    sim = torch.where(eye, torch.full_like(sim, -1e9), sim)
    # positives: i <-> i+N
    ar = torch.arange(n, device=sim.device)
    pos_idx = torch.cat([ar + n, ar])
    logprob = torch.log_softmax(sim, dim=-1)
    return -logprob.gather(-1, pos_idx[:, None])[:, 0].mean()


def softmax_cross_entropy(logits, labels, num_classes=None) -> torch.Tensor:
    """logits: (..., C); labels int (...)."""
    del num_classes
    logp = torch.log_softmax(logits.to(F32), dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    return nll.mean()


def byol_predictive_loss(z_online, z_target) -> torch.Tensor:
    """Normalized MSE predictive loss (BYOL/SimSiam family), used by the
    App.-C collapse probe: without batch statistics this loss can be driven
    to ~0 by a constant encoder. The target is detached (the reference's
    ``stop_gradient``)."""
    zo = _unit_rows(z_online.to(F32))
    zt = _unit_rows(z_target.to(F32).detach())
    return (2.0 - 2.0 * (zo * zt).sum(-1)).mean()


def encoding_variance(z) -> torch.Tensor:
    """Mean per-dimension std of encodings: a collapse indicator
    (VICReg-style)."""
    return torch.sqrt(torch.var(z.to(F32), dim=0, correction=0)
                      + 1e-8).mean()
