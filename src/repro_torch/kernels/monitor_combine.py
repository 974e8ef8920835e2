"""Fused monitor combine: the plain PyTorch version and the wrapper of the
hand-written Hopper kernel ``csrc/monitor_combine.cu``.

The kernel replaces the Pallas TPU kernel
``repro/kernels/monitor_combine.py:52`` (``monitor_combine``); the plain
version is the reference's oracle ``repro/kernels/ref.py:72``.  Over flat
(N,) scores:

    fhat   = u - s * sigmoid(v)
    mask   = u > threshold - margin
    counts = [n_triggered, n_violations (f > u)]   (f32)
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, stream_handle

KERNEL = CudaKernel(
    "monitor_combine.cu", "monitor_combine",
    [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_float, ctypes.c_float,
                             ctypes.c_void_p])


def monitor_combine_plain(u, v, f, *, s: float, threshold: float = 0.0,
                          margin: float = 0.25):
    uf, vf, ff = u.float(), v.float(), f.float()
    fhat = uf - s * torch.sigmoid(vf)
    mask = (uf > threshold - margin).float()
    counts = torch.stack([mask.sum(), (ff > uf).float().sum()])
    return fhat, mask, counts


def monitor_combine_cuda(u, v, f, *, s: float, threshold: float = 0.0,
                         margin: float = 0.25):
    """Launch the Hopper kernel on PyTorch's current stream.  Takes (N,)
    float32 contiguous CUDA tensors; raises on anything else."""
    if u.device.type != "cuda":
        raise ValueError(f"monitor_combine kernel needs CUDA tensors, got "
                         f"{u.device}")
    n = u.shape[0]
    for name, t in (("u", u), ("v", v), ("f", f)):
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{name} must have shape ({n},), got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != u.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {u.device}")
    if n == 0 or n >= 2**31:
        raise ValueError(f"kernel takes 0 < N < 2**31, got {n}")
    fhat = torch.empty_like(u)
    mask = torch.empty_like(u)
    counts = torch.empty(2, dtype=torch.float32, device=u.device)
    scratch = torch.zeros(3, dtype=torch.int32, device=u.device)
    KERNEL(u.data_ptr(), v.data_ptr(), f.data_ptr(), fhat.data_ptr(),
           mask.data_ptr(), scratch.data_ptr(), counts.data_ptr(), n,
           float(s), float(threshold - margin), stream_handle(u.device))
    return fhat, mask, counts
