"""Parameter containers and the linear layer.

The JAX package keeps parameters as nested dicts of arrays; the port keeps
them in ``nn.Module``s whose attribute paths mirror those dicts
(``blocks.3.attn.wq.w`` for the reference's stacked
``blocks/attn/wq/w[3]``), so ``repro_torch.bridge`` can carry a reference
tree across leaf by leaf.  The modules hold parameters only; the
computation is plain functions on tensors.  Parameters are made without
gradients, so serving builds no autograd graph; the trainer calls
``requires_grad_`` on the model it trains (``training/loop.py``).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from repro_torch.distributed.sharding import settle


def resolve_device(device) -> torch.device:
    """``None`` means the card.  Raises when a CUDA device is asked for and
    there is none: the port never slides to the CPU on its own."""
    d = torch.device("cuda" if device is None else device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                               "the CPU")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    return d


def param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised, gradient-free parameter."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Linear(nn.Module):
    """``w``: (d_in, d_out), the reference's layout (``x @ w``)."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.w = param((d_in, d_out), dtype, device)
        self.b = param((d_out,), dtype, device) if bias else None

    def init_(self, gen: torch.Generator, stddev: Optional[float] = None):
        """The reference's ``init_linear``: normal(0, 1/sqrt(d_in)) weights,
        zero bias."""
        sd = stddev if stddev is not None else 1.0 / math.sqrt(self.w.shape[0])
        normal_(self.w, gen, sd)
        if self.b is not None:
            self.b.zero_()


class LayerStack(nn.ModuleList):
    """The layers of one of the reference's stacked leaves (its layers
    stacked on a leading axis): a ``ModuleList`` that can also build a
    layer of its own, ``make(device)``, so that an empty stack still knows
    its leaves' shapes (``repro_torch.bridge`` carries it as zero-length
    leaves, as the reference stacks zero layers)."""

    def __init__(self, make: Callable[[object], nn.Module], n: int,
                 device=None):
        super().__init__(make(device) for _ in range(n))
        self.make = make


def normal_(t: torch.Tensor, gen: torch.Generator, stddev: float) -> None:
    """In-place normal(0, stddev) draw from ``gen`` (on ``t``'s device)."""
    t.normal_(0.0, stddev, generator=gen)


def linear(p: Linear, x: torch.Tensor, *,
           compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``nn/module.py::linear``: with ``compute_dtype`` both operands are
    cast to it before the product, as the reference casts them."""
    w = p.w
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    y = x @ w
    if type(y) is not torch.Tensor:   # a DTensor of partial sums
        y = settle(y)
    if p.b is not None:
        y = y + p.b.to(y.dtype)
    return y


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log1p(exp(-|x|)) + max(x, 0)."""
    return torch.log1p(torch.exp(-torch.abs(x))) + torch.clamp(x, min=0.0)
