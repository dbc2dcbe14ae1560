"""Learning-rate schedules (paper App. B uses cosine decay everywhere).
A schedule maps the step counter (a device tensor) to an f32 tensor on the
same device, so it never waits for the host."""
from __future__ import annotations

import math

import torch


def cosine_decay(base_lr: float, total_steps: int, warmup_steps: int = 0,
                 final_scale: float = 0.0):
    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        if warmup_steps > 0:
            warm = torch.clamp(step / warmup_steps, max=1.0)
        else:
            warm = torch.ones_like(step)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return base_lr * warm * (final_scale + (1.0 - final_scale) * cos)
    return schedule
