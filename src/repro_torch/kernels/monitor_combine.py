"""Fused monitor combine: the plain PyTorch version and the wrapper of the
hand-written Hopper kernel ``csrc/monitor_combine.cu``.

The kernel replaces the Pallas TPU kernel
``repro/kernels/monitor_combine.py:52`` (``monitor_combine``); the plain
version is the reference's oracle ``repro/kernels/ref.py:72``.  Over flat
(N,) scores:

    fhat   = u - s * sigmoid(v)
    mask   = u > threshold - margin
    counts = [n_triggered, n_violations (f > u)]   (f32)

Up to ``ONE_BLOCK_MAX`` scores (the serving paths combine one per stream)
one block does the whole pass and writes the counts itself: one device
kernel a call.  Past it the kernel spreads over blocks whose counts meet
in a zeroed int32 scratch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, stream_handle

THREADS = 256
MAX_BLOCKS = 1024
# the most scores one block takes: chip_smoke.py's combine sweep times one
# block against the grid at each N
ONE_BLOCK_MAX = 2048

KERNEL = CudaKernel(
    "monitor_combine.cu", "monitor_combine",
    [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                             ctypes.c_float, ctypes.c_void_p])


def combine_blocks(n: int) -> int:
    """The blocks ``monitor_combine_cuda`` launches for ``n`` scores: 1 up
    to ONE_BLOCK_MAX, else one per THREADS scores, at most MAX_BLOCKS
    (which then meet in a zeroed scratch)."""
    return 1 if n <= ONE_BLOCK_MAX else min(-(-n // THREADS), MAX_BLOCKS)


def monitor_combine_plain(u, v, f, *, s: float, threshold: float = 0.0,
                          margin: float = 0.25):
    uf, vf, ff = u.float(), v.float(), f.float()
    fhat = uf - s * torch.sigmoid(vf)
    mask = (uf > threshold - margin).float()
    counts = torch.stack([mask.sum(), (ff > uf).float().sum()])
    return fhat, mask, counts


def monitor_combine_cuda(u, v, f, *, s: float, threshold: float = 0.0,
                         margin: float = 0.25):
    """Launch the Hopper kernel on PyTorch's current stream on
    ``combine_blocks`` blocks.  Takes (N,) float32 contiguous CUDA tensors;
    raises on anything else."""
    return monitor_combine_blocks(u, v, f, combine_blocks(u.numel()),
                                  s=s, threshold=threshold, margin=margin)


def monitor_combine_blocks(u, v, f, blocks: int, *, s: float,
                           threshold: float = 0.0, margin: float = 0.25):
    """``monitor_combine_cuda`` on ``blocks`` blocks (1 to MAX_BLOCKS), for
    tests and the sweep that sets ONE_BLOCK_MAX.  fhat, mask and counts
    are three tensors (the ``monitor_combine`` op's outputs alias
    nothing)."""
    if u.device.type != "cuda":
        raise ValueError(f"monitor_combine kernel needs CUDA tensors, got "
                         f"{u.device}")
    if any(type(t) is not torch.Tensor for t in (u, v, f)):
        raise ValueError("monitor_combine kernel takes plain tensors: a "
                         "DTensor goes through kernels/ops.py's region")
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
    if not 1 <= blocks <= MAX_BLOCKS:
        raise ValueError(f"blocks must be in 1..{MAX_BLOCKS}, got {blocks}")
    fhat = torch.empty(n, dtype=torch.float32, device=u.device)
    mask = torch.empty(n, dtype=torch.float32, device=u.device)
    counts = torch.empty(2, dtype=torch.float32, device=u.device)
    scratch = (torch.zeros(3, dtype=torch.int32, device=u.device)
               if blocks > 1 else None)
    KERNEL(u.data_ptr(), v.data_ptr(), f.data_ptr(), fhat.data_ptr(),
           mask.data_ptr(), None if scratch is None else scratch.data_ptr(),
           counts.data_ptr(), n, blocks, float(s), float(threshold - margin),
           stream_handle(u.device))
    return fhat, mask, counts


def launch_floor(device) -> None:
    """Launch an empty one-warp kernel on ``device``'s current stream (not
    counted): the floor under any launch, timed beside the combine."""
    KERNEL.call("launch_floor", [ctypes.c_void_p], stream_handle(device))
