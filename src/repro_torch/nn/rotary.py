"""Rotary position embeddings (``nn/rotary.py``): the half-split
(GPT-NeoX) convention, not interleaved pairs, computed in f32.

The angles depend only on the positions, so a decode step computes them
once (``rope_angles``) and every layer's q and k reuse them
(``rotate``); in eager PyTorch that saves the launches XLA saved by
common-subexpression elimination.
"""
from __future__ import annotations

from typing import Tuple

import torch


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim//2,), float32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 1e4) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of shape ``positions.shape + (1, head_dim//2)``: one
    position per row (e.g. the (B,) position vector of a decode step)."""
    inv = rope_freqs(head_dim, theta, positions.device)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` of shape (..., H, D) by precomputed angles."""
    d = x.shape[-1]
    x1f, x2f = x[..., : d // 2].float(), x[..., d // 2:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """Rotate ``x`` of shape (..., H, D); ``positions`` has shape
    ``x.shape[:-2]``."""
    return rotate(x, *rope_angles(positions, x.shape[-1], theta))
