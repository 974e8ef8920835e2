"""RMSNorm (``nn/norms.py``): statistics and the elementwise tail in f32,
cast back to the input dtype at the end."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.nn.module import param


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, dtype=torch.float32, device=None):
        super().__init__()
        self.scale = param((d,), dtype, device)

    def init_(self, gen=None):
        self.scale.fill_(1.0)


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p.scale.float()).to(dt)
