"""Evaluation protocol (paper Sec. 4): linear evaluation on frozen
encodings, by a closed-form ridge classifier on one-hot targets."""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32


def ridge_linear_probe(train_z, train_y, test_z, test_y, num_classes: int,
                       l2: float = 1e-2):
    """Fit W on (train_z -> one-hot) in closed form; return test accuracy
    (a scalar tensor on the encodings' device)."""
    z = train_z.to(F32)
    z = torch.cat([z, torch.ones((z.shape[0], 1), dtype=F32,
                                 device=z.device)], dim=1)      # bias
    y = F.one_hot(train_y.long(), num_classes).to(F32)
    d = z.shape[1]
    a = z.T @ z + l2 * torch.eye(d, dtype=F32, device=z.device)
    w = torch.linalg.solve(a, z.T @ y)
    zt = torch.cat([test_z.to(F32), torch.ones((test_z.shape[0], 1),
                                               dtype=F32, device=z.device)],
                   dim=1)
    pred = torch.argmax(zt @ w, dim=-1)
    return (pred == test_y.long()).to(F32).mean()
