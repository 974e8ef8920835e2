"""SwiGLU feed-forward block (``nn/mlp.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn.module import Linear, linear


class SwiGLU(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.w_gate = Linear(d_model, d_ff, dtype=dtype, device=device)
        self.w_up = Linear(d_model, d_ff, dtype=dtype, device=device)
        self.w_down = Linear(d_ff, d_model, dtype=dtype, device=device)

    def init_(self, gen: torch.Generator):
        for lin in (self.w_gate, self.w_up, self.w_down):
            lin.init_(gen)


def swiglu(p: SwiGLU, x: torch.Tensor, compute_dtype=torch.bfloat16):
    g = linear(p.w_gate, x, compute_dtype=compute_dtype)
    u = linear(p.w_up, x, compute_dtype=compute_dtype)
    return linear(p.w_down, F.silu(g) * u, compute_dtype=compute_dtype)
