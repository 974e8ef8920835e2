"""Token embedding and the tied output head (``nn/embedding.py``)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.nn.module import normal_, param


class Embedding(nn.Module):
    def __init__(self, vocab: int, d_model: int, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.table = param((vocab, d_model), dtype, device)

    def init_(self, gen: torch.Generator):
        normal_(self.table, gen, 0.02)


def embed(p: Embedding, tokens: torch.Tensor,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    return p.table.to(compute_dtype)[tokens.long()]


def unembed(p: Embedding, x: torch.Tensor,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Logits in f32."""
    return (x.to(compute_dtype) @ p.table.to(compute_dtype).T).float()
