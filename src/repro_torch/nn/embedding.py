"""Token embeddings and output heads (``nn/embedding.py``), with the audio
family's per-codebook tables.

On a DeviceMesh a vocab-split table gives each rank the rows it holds
(zeros elsewhere, a partial sum over ``model``) and one all-reduce makes
it whole (``distributed.sharding.vocab_lookup``), so the residual stream
stays whole on ``model``."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed.sharding import is_dtensor, vocab_lookup
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
    return vocab_lookup(p.table.to(compute_dtype), tokens.long())


def unembed(p: Embedding, x: torch.Tensor,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Logits in f32."""
    return (x.to(compute_dtype) @ p.table.to(compute_dtype).T).float()


class CodebookEmbedding(nn.Module):
    """One table per codebook, (K, V, d): the audio family's input
    embedding and, through ``codebook_unembed``, its K output heads."""

    def __init__(self, n_codebooks: int, vocab: int, d_model: int, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.table = param((n_codebooks, vocab, d_model), dtype, device)

    def init_(self, gen: torch.Generator):
        normal_(self.table, gen, 0.02)


def codebook_embed(p: CodebookEmbedding, tokens: torch.Tensor,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """tokens (..., K) -> the sum over codebooks of each book's embedding,
    added in the compute dtype in book order, as the reference adds."""
    tab = p.table.to(compute_dtype)
    tokens = tokens.long()
    out = vocab_lookup(tab[0], tokens[..., 0])
    for k in range(1, tokens.shape[-1]):
        out = out + vocab_lookup(tab[k], tokens[..., k])
    return out


def codebook_unembed(p: CodebookEmbedding, x: torch.Tensor,
                     compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(..., d) -> (..., K, V) per-codebook logits in f32."""
    tab = p.table.to(compute_dtype)
    x = x.to(compute_dtype)
    if is_dtensor(tab):   # a vocab split: one product a codebook
        return torch.stack([(x @ tab[k].T).float()
                            for k in range(tab.shape[0])], dim=-2)
    return torch.einsum("...d,kvd->...kv", x, tab).float()
