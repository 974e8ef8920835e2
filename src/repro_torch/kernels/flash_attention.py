"""Causal GQA prefill attention, optionally in a sliding window: the plain
PyTorch version, the wrapper of the hand-written Hopper kernel
``csrc/flash_attention.cu``, and the gradient in tensor ops.

The kernel replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py:73`` (``flash_attention``): in bf16 a
warp-specialised tensor-core kernel (TMA loads, ``wgmma`` products), in
f32 a scalar one (see the note in the CUDA source).  Both
forward versions return the output and the per-row log-sum-exp
``lse`` (B, Hq, S) f32.  The plain version is the reference's XLA form
(``repro/nn/attention.py:90``, ``chunked_attention``), blockwise over
query rows: scores in f32 from the input-dtype operands, softmax in f32,
p rounded to the value dtype before the PV product, output in q's dtype.

The backward is not a kernel, and not the plain version standing in for
one: the reference has no backward kernel (its Pallas kernel cannot be
differentiated) and trains through XLA's gradient of ``chunked_attention``,
outside any Pallas kernel.  ``flash_attention_backward`` is that gradient
written out in tensor ops, on every device: it rebuilds P from the saved
log-sum-exp one block of query rows at a time, so memory stays
O(block x T) instead of O(S x T).  ``kernels.ops.flash_attention`` wraps
forward and backward in a ``torch.autograd.Function``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels.build import CudaKernel, stream_handle

NEG_INF = -1e30
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
HEAD_DIMS = (32, 64, 112, 128)
# f32 bytes of one score block (B, Hq, rows, T) in the plain forward and
# the backward: bounds their temporaries (256 rows at the server shape)
BLOCK_BYTES = 1 << 28

KERNEL = CudaKernel(
    "flash_attention.cu", "flash_attention",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
    + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
# the tilings csrc/flash_attention.cu instantiates (it checks block_q and
# block_k against its own): bf16 runs the tensor-core kernel, two consumer
# warpgroups and a producer warp on 128 query rows, K/V tiles loaded as
# boxes of 64 columns (128 bytes) into a 2-stage ring; f32 the scalar one
TC_THREADS, TC_BLOCK_Q, TC_BLOCK_K, TC_STAGES = 288, 128, 128, 2
F32_THREADS, F32_BLOCK_Q, F32_BLOCK_K = 128, 64, 64
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on the H100


def flash_plan(B: int, S: int, Hq: int, D: int, dtype: torch.dtype) -> dict:
    """The tiling and grid ``flash_attention_cuda`` launches for these
    shapes.  bf16: query tiles of 128 rows, ``box_cols`` = D rounded up to
    64 or 128 columns (the columns past D are TMA's zero fill), K/V tiles
    of 128 rows (a consumer thread holds block_k/2 score and box_cols/2
    output floats in registers).  f32: the scalar kernel's 64-row tiles.
    One block per (query tile, q head, batch row)."""
    if dtype == torch.bfloat16:
        cols = 64 if D <= 64 else 128
        bq, bk, threads = TC_BLOCK_Q, TC_BLOCK_K, TC_THREADS
        smem = 1024 + 2 * (bq * cols + 2 * TC_STAGES * bk * cols)
    else:
        cols = (D + 31) // 32 * 32
        bq, bk, threads = F32_BLOCK_Q, F32_BLOCK_K, F32_THREADS
        smem = 4 * (bk * cols + bq * (D + 4) + bk * (D + 4) + bq * (bk + 4))
    tiles = -(-S // bq)
    return {"block_q": bq, "block_k": bk, "box_cols": cols,
            "threads": threads, "smem_bytes": smem, "query_tiles": tiles,
            "blocks": B * Hq * tiles}


def _block_rows(B: int, Hq: int, S: int, T: int) -> int:
    return max(1, min(S, BLOCK_BYTES // (4 * B * Hq * max(T, 1))))


def _kv_span(q0: int, q1: int, T: int, window: int) -> Tuple[int, int]:
    """Columns [lo, hi) that rows q0..q1-1 may attend to: the blocks above
    the diagonal or outside the window are skipped, as the TPU kernel
    skips them (masked entries would contribute exactly 0)."""
    hi = min(T, q1)
    lo = max(0, q0 - window + 1) if window else 0
    return lo, max(lo, hi)


def _mask(q0: int, q1: int, lo: int, hi: int, window: int,
          device) -> torch.Tensor:
    row = torch.arange(q0, q1, device=device)[:, None]
    col = torch.arange(lo, hi, device=device)[None, :]
    ok = col <= row
    if window:
        ok = ok & (col > row - window)
    return ok


def _heads_first(x: torch.Tensor, Hkv: int) -> torch.Tensor:
    """(B, L, Hkv*G, D) -> (B, Hkv, G, L, D) f32."""
    B, L, H, D = x.shape
    return x.float().reshape(B, L, Hkv, H // Hkv, D).permute(0, 2, 3, 1, 4)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, window: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, S, Hq, D); k, v: (B, T, Hkv, D) -> (o (B, S, Hq, D),
    lse (B, Hq, S) f32), causal.  The reference's XLA form, blockwise over
    query rows."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qh = _heads_first(q, Hkv)                       # (B, Hkv, G, S, D)
    kh = k.float().permute(0, 2, 1, 3)              # (B, Hkv, T, D)
    vh = v.float().permute(0, 2, 1, 3)
    o = torch.empty((B, Hkv, G, S, D), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, Hkv, G, S), dtype=torch.float32, device=q.device)
    n = _block_rows(B, Hq, S, T)
    for q0 in range(0, S, n):
        q1 = min(S, q0 + n)
        lo, hi = _kv_span(q0, q1, T, window)
        s = torch.matmul(qh[:, :, :, q0:q1], kh[:, :, None, lo:hi]
                         .transpose(-1, -2)) * scale
        s = torch.where(_mask(q0, q1, lo, hi, window, q.device), s, NEG_INF)
        lse[..., q0:q1] = torch.logsumexp(s, dim=-1)
        p = torch.softmax(s, dim=-1).to(v.dtype).float()
        o[:, :, :, q0:q1] = torch.matmul(p, vh[:, :, None, lo:hi])
    o = o.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)
    return o, lse.reshape(B, Hq, S)


def flash_attention_backward(q, k, v, o, lse, do, *, window: int = 0):
    """Gradients (dq, dk, dv) of ``o = attention(q, k, v)`` from the saved
    ``o`` and ``lse``, in f32 tensor ops, one block of query rows at a time:

        P  = exp(S - lse),  dV = P^T dO,  dP = dO V^T,
        dS = P * (dP - rowsum(dO * O)),  dQ = dS K / sqrt(D),
        dK = dS^T Q / sqrt(D),

    with dK and dV summed over each GQA group.  Returned in the input
    dtypes."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(D)
    qh = _heads_first(q, Hkv)                       # (B, Hkv, G, S, D)
    doh = _heads_first(do, Hkv)
    kh = k.float().permute(0, 2, 1, 3)[:, :, None]  # (B, Hkv, 1, T, D)
    vh = v.float().permute(0, 2, 1, 3)[:, :, None]
    lse_h = lse.reshape(B, Hkv, Hq // Hkv, S)
    delta = (doh * _heads_first(o, Hkv)).sum(-1)    # (B, Hkv, G, S)
    dq = torch.empty_like(qh)
    dk = torch.zeros((B, Hkv, T, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    n = _block_rows(B, Hq, S, T)
    for q0 in range(0, S, n):
        q1 = min(S, q0 + n)
        lo, hi = _kv_span(q0, q1, T, window)
        qb, dob = qh[:, :, :, q0:q1], doh[:, :, :, q0:q1]
        kb, vb = kh[..., lo:hi, :], vh[..., lo:hi, :]
        s = torch.matmul(qb, kb.transpose(-1, -2)) * scale
        p = torch.exp(s - lse_h[..., q0:q1, None])
        p = torch.where(_mask(q0, q1, lo, hi, window, q.device), p, 0.0)
        dv[:, :, lo:hi] += torch.matmul(p.transpose(-1, -2), dob).sum(2)
        ds = p * (torch.matmul(dob, vb.transpose(-1, -2))
                  - delta[..., q0:q1, None])
        dq[:, :, :, q0:q1] = torch.matmul(ds, kb) * scale
        dk[:, :, lo:hi] += (torch.matmul(ds.transpose(-1, -2), qb).sum(2)
                            * scale)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)
    return (dq, dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, window: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel on PyTorch's current stream; returns
    (o, lse).  Raises on any input it does not take; never falls back."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got "
                         f"{q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("need q (B,S,Hq,D) and equal k, v (B,T,Hkv,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, Hq, D = q.shape
    Bk, T, Hkv, Dk = k.shape
    if Bk != B or Dk != D or Hq % Hkv or S == 0 or T == 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} vs k/v "
                         f"{tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {HEAD_DIMS}, got D={D}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("kernel takes q, k, v of one dtype, bfloat16 or "
                         f"float32, got {q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    plan = flash_plan(B, S, Hq, D, q.dtype)
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
           lse.data_ptr(), B, S, T, Hkv, Hq // Hkv, D, _DTYPES[q.dtype],
           1.0 / math.sqrt(D), int(window), plan["block_q"],
           plan["block_k"], stream_handle(q.device))
    return o, lse
