"""One call site per kernel, chosen by where the tensors lie.

A CPU tensor goes to the kernel's plain PyTorch version.  A CUDA tensor
goes to the hand-written kernel, which raises on anything it does not
take: there is no global switch and no fallback.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention_backward,
                                                 flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.monitor_combine import (monitor_combine_cuda,
                                                 monitor_combine_plain)


def decode_attention(q, k_cache, v_cache, pos):
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, pos)
    return decode_attention_cuda(q, k_cache, v_cache, pos)


def monitor_combine(u, v, f, *, s: float, threshold: float = 0.0,
                    margin: float = 0.25):
    if u.device.type == "cpu":
        return monitor_combine_plain(u, v, f, s=s, threshold=threshold,
                                     margin=margin)
    return monitor_combine_cuda(u, v, f, s=s, threshold=threshold,
                                margin=margin)


def flash_attention_fwd(q, k, v, *, window: int = 0):
    """Causal (o, lse): the plain version for CPU tensors, the kernel for
    CUDA."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window=window)
    return flash_attention_cuda(q, k, v, window=window)


class FlashAttention(torch.autograd.Function):
    """Forward through ``flash_attention_fwd``; backward in tensor ops from
    the saved output and log-sum-exp (``flash_attention_backward``: the
    reference differentiates this attention with XLA, outside any kernel).
    Under ``torch.utils.checkpoint`` the forward runs again in the backward
    pass and saves a fresh ``lse``."""

    @staticmethod
    def forward(ctx, q, k, v, window: int):
        o, lse = flash_attention_fwd(q, k, v, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window = window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        with record_function("flash_attention_backward"):
            dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do,
                                                  window=ctx.window)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, window: int = 0):
    """q: (B, S, Hq, D); k, v: (B, T, Hkv, D) -> (B, S, Hq, D), causal,
    differentiable."""
    return FlashAttention.apply(q, k, v, window)
