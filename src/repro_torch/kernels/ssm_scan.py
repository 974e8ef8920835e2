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
versions here return it.  The gradient is the ``ssd_scan_fwd`` op's
registered backward (``kernels/ops.py``): the reference has no backward
kernel and trains through XLA's gradient of
``ssd_chunked``.

One call of the kernel is two device kernels: the first writes C B^T
once per (batch row, chunk) and the f64 cumsum of la per (batch row,
head, chunk); the second runs the scan with the P columns split over
blocks, the tile chosen by ``ssd_plan`` from the shapes alone.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels.build import CudaKernel, stream_handle

# the kernel's limits: a chunk of at most 128 rows, P and N at most 64,
# each a multiple of 16 (the tensor cores' 16-row tiles)
MAX_CHUNK, MAX_P, MAX_N = 128, 64, 64
# the columns of P one scan block owns, and the H100 it is planned for
TILES = (64, 32, 16)
SM_COUNT = 132
SMEM_PER_SM = 233_472     # 228 KB of shared memory an SM
SMEM_RESERVED = 1_024     # that the card keeps for each resident block
SMEM_LIMIT = 232_448      # the most one block may use
THREADS_PER_SM = 2_048
THREADS = 128             # a scan block: four warps, each on all pt columns
# blocks an SM each tile's registers are budgeted for (its launch bounds)
REG_BLOCKS = {64: 2, 32: 3, 16: 3}
# what a block's G weights and C B^T reads cost, in columns of products
# (fitted to chip_smoke.py's tile sweep at the hybrid train shape)
G_COLS = 64

KERNEL = CudaKernel(
    "ssd_scan.cu", "ssd_scan",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def tile_smem_bytes(pt: int, L: int, N: int) -> int:
    """Shared memory of a scan block (``smem_layout`` in the source): two
    stages of the xdt tile (L x (pt + 4)) and of the chunk's record (4 L)
    and the state (pt x (N + 8)), in f32."""
    return 4 * (2 * L * (pt + 4) + 8 * L + pt * (N + 8))


def ssd_plan(B: int, S: int, H: int, P: int, N: int, L: int) -> dict:
    """The launch ``ssd_scan_cuda`` makes: the tile ``pt`` (columns of P a
    block owns), ``blocks`` (P / pt x H x B, of THREADS threads each),
    ``smem_bytes``, ``resident`` (blocks an SM holds: the least of what
    the shared bytes, the threads and the registers allow), ``rounds``
    (blocks the busiest SM runs), ``idle``, the share of the SMs' rounds
    that the last one leaves empty, and ``cost``.

    Every block walks all S / L chunks, so blocks take equal time and an
    SM's time is its rounds times a block's work: ``pt`` columns of
    products plus the G weights and C B^T reads, which every block forms
    for itself and which cost about ``G_COLS`` columns' worth.  The plan
    takes the tile of least ``cost``, and the widest of equals."""
    opts = []
    for pt in TILES:
        if P % pt:
            continue
        smem = tile_smem_bytes(pt, L, N)
        resident = min(SMEM_PER_SM // (smem + SMEM_RESERVED),
                       THREADS_PER_SM // THREADS, REG_BLOCKS[pt])
        blocks = (P // pt) * H * B
        rounds = math.ceil(blocks / SM_COUNT)
        opts.append(dict(pt=pt, blocks=blocks, smem_bytes=smem,
                         resident=resident, rounds=rounds,
                         idle=1.0 - blocks / (rounds * SM_COUNT),
                         cost=rounds * (pt + G_COLS)))
    if not opts:
        raise ValueError(f"no tile of {TILES} divides P={P}")
    return min(opts, key=lambda o: (o["cost"], -o["pt"]))


def ssd_flops(B: int, S: int, H: int, L: int, P: int, N: int) -> float:
    """Flops the SSD scan's inputs need in its lower-triangular form, chunk
    by chunk: C B^T over the n(n+1)/2 pairs s <= t of a chunk of n rows,
    once per (batch row, chunk), as B and C are shared by the heads; then
    per (batch row, head, chunk) G @ xdt over the same pairs and the
    carried state through C and the state update, n N P multiply-adds
    each."""
    full, tail = S // L, S % L
    total = 0.0
    for n, count in ((L, full), (tail, 1 if tail else 0)):
        total += count * (B * n * (n + 1) * N
                          + B * H * (n * (n + 1) * P + 4.0 * n * N * P))
    return total


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


def _shapes(xdt, la, Bm, Cm, chunk):
    """(B, S, H, P, N) of inputs the kernel takes; raises on any other."""
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
    return B, S, H, P, N


def ssd_scan_cuda(xdt: torch.Tensor, la: torch.Tensor, Bm: torch.Tensor,
                  Cm: torch.Tensor, *, chunk: int = 128
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel on PyTorch's current stream with the tile
    ``ssd_plan`` picks; returns (y, h_final).  The kernel walks chunks of
    ``chunk`` (<= 128) rows and masks a ragged last chunk by index; the
    plain version's single S-row chunk for a ragged S is the same sum in
    another order.  Raises on any input it does not take; never falls
    back."""
    B, S, H, P, N = _shapes(xdt, la, Bm, Cm, chunk)
    return _launch(xdt, la, Bm, Cm, chunk,
                   ssd_plan(B, S, H, P, N, chunk)["pt"])


def ssd_scan_tiled(xdt: torch.Tensor, la: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, pt: int, *, chunk: int = 128
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ssd_scan_cuda`` with the tile forced to ``pt`` columns of P a
    block (16, 32 or 64, dividing P), for tests and the tile sweep."""
    _, _, _, P, _ = _shapes(xdt, la, Bm, Cm, chunk)
    if pt not in TILES or P % pt:
        raise ValueError(f"tile must be one of {TILES} dividing P={P}, "
                         f"got {pt}")
    return _launch(xdt, la, Bm, Cm, chunk, pt)


def _launch(xdt, la, Bm, Cm, chunk, pt):
    """Both kernels of one call (C B^T and the cumsum records, then the
    scan) on scratch from ``torch.empty``: one counted launch."""
    B, S, H, P = xdt.shape
    N = Bm.shape[-1]
    nch = -(-S // chunk)
    dev = xdt.device
    y = torch.empty_like(xdt)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    cb = torch.empty((B, nch, chunk, chunk), dtype=torch.float32, device=dev)
    rec = torch.empty((B, H, nch, 4 * chunk), dtype=torch.float32,
                      device=dev)
    KERNEL(xdt.data_ptr(), la.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
           y.data_ptr(), h.data_ptr(), cb.data_ptr(), rec.data_ptr(), B, S,
           H, P, N, chunk, pt, stream_handle(dev))
    return y, h


def max_active_blocks(pt: int, chunk: int, N: int) -> int:
    """Scan blocks of tile ``pt`` one SM of the card holds at once (the
    CUDA occupancy calculation; chip_smoke.py prints it beside the
    plan's ``resident``)."""
    out = ctypes.c_int(0)
    KERNEL.call("ssd_max_active_blocks",
                [ctypes.c_int] * 3 + [ctypes.c_void_p], pt, chunk, N,
                ctypes.byref(out))
    return out.value
