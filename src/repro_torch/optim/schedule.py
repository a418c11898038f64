"""Learning-rate schedules (port of `repro.optim.schedule`)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step: torch.Tensor, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total: int = 10000,
                    floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to `peak_lr`, then a cosine to floor_frac of it;
    float32, the reference's operations in its order (its python
    constants folded as python folds them)."""
    f32 = torch.float32
    step = step.to(f32)

    def c(v):
        return torch.tensor(v, dtype=f32, device=step.device)

    warm = c(peak_lr) * step / c(max(warmup, 1))
    frac = torch.clamp((step - c(warmup)) / c(max(total - warmup, 1)),
                       0.0, 1.0)
    cos = c(peak_lr) * (c(floor_frac) + c((1 - floor_frac) * 0.5) * (
        c(1.0) + torch.cos(c(math.pi) * frac)))
    return torch.where(step < c(warmup), warm, cos)
