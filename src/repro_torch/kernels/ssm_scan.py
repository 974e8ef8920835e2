"""Mamba2 SSD chunked scan: the plain PyTorch version and the wrapper of
the hand-written Hopper kernel ``csrc/ssd_scan.cu``.

The kernel replaces the Pallas TPU kernel ``repro/kernels/ssm_scan.py:53``
(``ssd_scan``).  Both versions take the pre-activated inputs of that
kernel, xdt = x * dt (B, S, H, P) and the per-step log-decay la = dt * A
(B, S, H), with the shared B and C projections (B, S, N), all f32, and
return (y (B, S, H, P), h_final (B, H, P, N)) in f32:

    h_t = exp(la_t) h_{t-1} + xdt_t B_t^T,     y_t = h_t C_t

The plain version is the reference's XLA form ``ssd_chunked``
(``repro/nn/ssm.py:72``) written on xdt and la, with its chunking rule
(chunks of ``chunk`` rows when they divide S, else one chunk of S rows).
The TPU kernel drops the final state (``repro/kernels/ops.py:64``); both
versions here return it.  The gradient is ``kernels.ops.SSDScan``: the
reference has no backward kernel and trains through XLA's gradient of
``ssd_chunked``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.build import CudaKernel, stream_handle

# the kernel's limits: a chunk of at most 128 rows, P and N at most 64,
# each a multiple of 16 (its 16 x 16 thread layout)
MAX_CHUNK, MAX_P, MAX_N = 128, 64, 64

KERNEL = CudaKernel(
    "ssd_scan.cu", "ssd_scan",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def ssd_scan_plain(xdt: torch.Tensor, la: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, *, chunk: int = 128
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``ssd_chunked`` on xdt and la: every weight is the
    exp of a difference of cumulative log-decays inside a chunk, so no
    term overflows however strong the decay.  Computes in f32 (in f64 for
    f64 inputs, a reference for the f32 versions' rounding)."""
    B_, S, H, P = xdt.shape
    N = Bm.shape[-1]
    L = chunk if S % chunk == 0 else S
    nch = S // L
    ft = torch.promote_types(xdt.dtype, torch.float32)  # f32, or f64 if given
    xdtc = xdt.to(ft).reshape(B_, nch, L, H, P)
    lac = la.to(ft).reshape(B_, nch, L, H)
    Bc = Bm.to(ft).reshape(B_, nch, L, N)
    Cc = Cm.to(ft).reshape(B_, nch, L, N)

    cums = torch.cumsum(lac, dim=2)                                # (B,c,L,H)
    tril = torch.tril(torch.ones((L, L), dtype=torch.bool, device=xdt.device))
    # intra-chunk: W[t, s, h] = exp(cums_t - cums_s) for s <= t
    diff = cums[:, :, :, None, :] - cums[:, :, None, :, :]        # (B,c,L,L,H)
    W = torch.exp(torch.where(tril[None, None, :, :, None], diff, -torch.inf))
    CB = torch.einsum("bcln,bcmn->bclm", Cc, Bc)
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", CB[..., None] * W, xdtc)

    # per-chunk state contributions and decays
    dte = torch.exp(cums[:, :, -1:, :] - cums)                     # (B,c,L,H)
    S_c = torch.einsum("bclh,bcln,bclhp->bchpn", dte, Bc, xdtc)
    chunk_decay = torch.exp(cums[:, :, -1, :])                     # (B,c,H)
    h = torch.zeros((B_, H, P, N), dtype=ft, device=xdt.device)
    h_in = []
    for c in range(nch):  # the state entering each chunk
        h_in.append(h)
        h = chunk_decay[:, c, :, None, None] * h + S_c[:, c]
    h_in = torch.stack(h_in, dim=1)                               # (B,c,H,P,N)

    # inter-chunk: the carried state seen through C
    y_inter = (torch.einsum("bcln,bchpn->bclhp", Cc, h_in)
               * torch.exp(cums)[..., None])
    return (y_intra + y_inter).reshape(B_, S, H, P), h


def ssd_scan_cuda(xdt: torch.Tensor, la: torch.Tensor, Bm: torch.Tensor,
                  Cm: torch.Tensor, *, chunk: int = 128
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel on PyTorch's current stream; returns
    (y, h_final).  The kernel walks chunks of ``chunk`` (<= 128) rows and
    masks a ragged last chunk by index; the plain version's single S-row
    chunk for a ragged S is the same sum in another order.  Raises on any
    input it does not take; never falls back."""
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_scan kernel needs CUDA tensors, got "
                         f"{xdt.device}")
    if xdt.dim() != 4 or la.dim() != 3 or Bm.dim() != 3 \
            or Cm.shape != Bm.shape:
        raise ValueError("need xdt (B,S,H,P), la (B,S,H) and equal Bm, Cm "
                         f"(B,S,N), got {tuple(xdt.shape)}, "
                         f"{tuple(la.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    B, S, H, P = xdt.shape
    N = Bm.shape[-1]
    if tuple(la.shape) != (B, S, H) or tuple(Bm.shape[:2]) != (B, S) \
            or S == 0:
        raise ValueError(f"shape mismatch: xdt {tuple(xdt.shape)}, la "
                         f"{tuple(la.shape)}, Bm {tuple(Bm.shape)}")
    if chunk <= 0 or chunk % 16 or chunk > MAX_CHUNK or P % 16 \
            or P > MAX_P or N % 16 or N > MAX_N:
        raise ValueError(f"kernel takes chunk, P and N multiples of 16, "
                         f"chunk <= {MAX_CHUNK}, P and N <= {MAX_P}, got "
                         f"chunk={chunk}, P={P}, N={N}")
    for name, t in (("xdt", xdt), ("la", la), ("Bm", Bm), ("Cm", Cm)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != xdt.device:
            raise ValueError(f"{name} on {t.device}, xdt on {xdt.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    y = torch.empty_like(xdt)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=xdt.device)
    KERNEL(xdt.data_ptr(), la.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
           y.data_ptr(), h.data_ptr(), B, S, H, P, N, chunk,
           stream_handle(xdt.device))
    return y, h
