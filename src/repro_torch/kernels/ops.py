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
from repro_torch.kernels.ssm_scan import ssd_scan_cuda, ssd_scan_plain


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
    """q: (B, S, Hq, D); k: (B, T, Hkv, D); v: (B, T, Hkv, Dv) -> (B, S,
    Hq, Dv), causal, differentiable."""
    return FlashAttention.apply(q, k, v, window)


def ssd_scan_fwd(xdt, la, Bm, Cm, *, chunk: int = 128):
    """(y, h_final): the plain version for CPU tensors, the kernel for
    CUDA."""
    if xdt.device.type == "cpu":
        return ssd_scan_plain(xdt, la, Bm, Cm, chunk=chunk)
    return ssd_scan_cuda(xdt, la, Bm, Cm, chunk=chunk)


class SSDScan(torch.autograd.Function):
    """Forward through ``ssd_scan_fwd``.  The backward is tensor ops: the
    reference has no backward kernel and trains through XLA's gradient of
    ``ssd_chunked``, so the backward recomputes the plain chunked form
    from the saved inputs and differentiates it with autograd.  Under
    ``torch.utils.checkpoint`` the forward runs again in the backward
    pass."""

    @staticmethod
    def forward(ctx, xdt, la, Bm, Cm, chunk: int):
        y, h = ssd_scan_fwd(xdt, la, Bm, Cm, chunk=chunk)
        ctx.save_for_backward(xdt, la, Bm, Cm)
        ctx.chunk = chunk
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        with record_function("ssd_scan_backward"), torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            y, h = ssd_scan_plain(*ins, chunk=ctx.chunk)
            grads = torch.autograd.grad((y, h), ins, (dy, dh))
        return (*grads, None)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 128, h0=None):
    """The reference's call site (``repro/kernels/ops.py:56``), with the
    signature of ``ssd_chunked``: x (B, S, H, P), dt (B, S, H), A (H,),
    Bm, Cm (B, S, N) -> (y (B, S, H, P), h_final (B, H, P, N)), f32,
    differentiable.  xdt = x * dt and la = dt * A are formed here in f32
    tensor ops, so autograd carries x, dt and A to them."""
    if h0 is not None:
        raise ValueError("ssd_scan takes no initial state: every path "
                         "starts from h0 = 0")
    dtf = dt.float()
    xdt = x.float() * dtf[..., None]
    la = dtf * A.float()[None, None, :]
    return SSDScan.apply(xdt.contiguous(), la.contiguous(),
                         Bm.float().contiguous(), Cm.float().contiguous(),
                         chunk)
