"""Learning-rate schedules as step -> lr functions on tensors
(``training/schedule.py``), composable with ``AdamW.lr``."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.1):
    def f(step):
        s = torch.as_tensor(step).float()
        warm = peak * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return f


def inverse_sqrt(peak: float, warmup: int):
    def f(step):
        s = torch.clamp(torch.as_tensor(step).float(), min=1.0)
        return peak * torch.minimum(s / max(warmup, 1),
                                    torch.sqrt(warmup / s))
    return f
