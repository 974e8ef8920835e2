"""Single-query GQA decode attention: the plain PyTorch version and the
wrapper of the hand-written Hopper kernel ``csrc/decode_attention.cu``.

The kernel replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py:59`` (``decode_attention``).  Unlike
the Pallas kernel it takes a (B,) position vector, so the per-stream
server catch-up, where every row sits at its own depth, is one launch per
layer.  The plain version is the reference's XLA form
(``repro/nn/attention.py:136``), the function the reference's serving
path runs, with the same (B,) position vector; the kernel follows its
rounding points (see the note in the CUDA source).

The kernel splits the cache axis over the blocks of a thread-block
cluster and combines their partials in shared memory, in one launch;
``n_split`` plans the split from the shapes alone (the host cannot read
``pos`` without waiting for the card).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Union

import torch

from repro_torch.kernels.build import CudaKernel, stream_handle

NEG_INF = -1e30
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
HEAD_DIMS = (32, 64, 112, 128, 256)
GROUPS = (1, 2, 4, 8)
# the split of the cache axis: a cluster of at most 8 blocks (the portable
# cluster size), at least 2, enough blocks for about two per SM of the
# H100's 132 (256, the power of two below 264), and no split of fewer than
# 16 cache rows.  chip_smoke.py's split sweep times every split count at
# the granite server shape and at zamba2's shared block.
SPLITS = (1, 2, 4, 8)
TARGET_BLOCKS = 256
MIN_SPLIT_ROWS = 16

KERNEL = CudaKernel(
    "decode_attention.cu", "decode_attention",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                  ctypes.c_void_p])


def n_split(B: int, Hkv: int, C: int) -> int:
    """Blocks per cluster along the cache axis: the least power of two
    from 2 up that gives B * Hkv * n >= TARGET_BLOCKS, at most 8, and
    smaller while a split would get fewer than MIN_SPLIT_ROWS of the C
    cache rows."""
    n = 1
    while (n < SPLITS[-1] and (n < 2 or B * Hkv * n < TARGET_BLOCKS)
           and C // (2 * n) >= MIN_SPLIT_ROWS):
        n *= 2
    return n


def decode_plan(B: int, Hkv: int, C: int) -> dict:
    """The launch ``decode_attention_cuda`` makes: one cluster per (kv head,
    batch row), ``splits`` blocks each."""
    n = n_split(B, Hkv, C)
    return {"splits": n, "clusters": B * Hkv, "blocks": B * Hkv * n}


def pos_vector(pos: Union[int, torch.Tensor], batch: int,
               device) -> torch.Tensor:
    """A scalar or (B,) position as a (B,) int32 tensor on ``device``."""
    p = torch.as_tensor(pos, device=device)
    if p.dim() == 0:
        p = p.expand(batch)
    if p.shape != (batch,):
        raise ValueError(f"pos must be a scalar or ({batch},), got "
                         f"{tuple(p.shape)}")
    return p.to(torch.int32).contiguous()


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos) -> torch.Tensor:
    """q: (B, Hq, D); caches: (B, C, Hkv, D); pos: scalar or (B,).

    Row b attends to cache entries ``idx <= pos[b]``.  Cache-dtype operands
    with f32 sums, p rounded to the cache dtype before the PV product,
    output in q's dtype: the reference's XLA form.
    """
    B, Hq, D = q.shape
    C, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    posv = pos_vector(pos, B, q.device).long()
    qg = q.reshape(B, Hkv, G, D).to(k_cache.dtype)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), k_cache.float()) * scale
    # the reference's ring mask idx < min(pos+1, C) is this same prefix for
    # every idx in [0, C) and pos >= 0, so ring and linear caches share it
    idx = torch.arange(C, device=q.device)
    valid = idx[None, :] <= posv[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, Hq, D).to(q.dtype)


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, pos) -> torch.Tensor:
    """Launch the Hopper kernel on PyTorch's current stream, the cache
    split as ``n_split`` plans.  Raises on any input it does not take;
    never falls back."""
    return decode_attention_split(q, k_cache, v_cache, pos, None)


def decode_attention_split(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos,
                           splits: Optional[int]) -> torch.Tensor:
    """``decode_attention_cuda`` with the cache split over ``splits``
    blocks (1, 2, 4 or 8) whatever the shapes; None: as planned."""
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention kernel needs CUDA tensors, got "
                         f"{q.device}")
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError("need q (B,Hq,D) and equal caches (B,C,Hkv,D), got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, Hq, D = q.shape
    Bc, C, Hkv, Dc = k_cache.shape
    if Bc != B or Dc != D or Hq % Hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} vs cache "
                         f"{tuple(k_cache.shape)}")
    G = Hq // Hkv
    if D not in HEAD_DIMS or G not in GROUPS:
        raise ValueError(f"kernel takes head_dim in {HEAD_DIMS} and "
                         f"Hq/Hkv in {GROUPS}, got D={D}, G={G}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError("kernel takes q and caches of one dtype, bfloat16 "
                         f"or float32, got {q.dtype}/{k_cache.dtype}/"
                         f"{v_cache.dtype}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if splits is None:
        splits = n_split(B, Hkv, C)
    elif splits not in SPLITS:
        raise ValueError(f"splits must be one of {SPLITS}, got {splits}")
    posv = pos_vector(pos, B, q.device)
    out = torch.empty_like(q)
    KERNEL(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
           posv.data_ptr(), out.data_ptr(), B, C, Hkv, G, D,
           _DTYPES[q.dtype], splits, 1.0 / math.sqrt(D),
           stream_handle(q.device))
    return out


def max_active_clusters(D: int, G: int, dtype: torch.dtype,
                        splits: int) -> int:
    """How many clusters of ``splits`` blocks of the (dtype, D, G) kernel
    the card holds at once (``cudaOccupancyMaxActiveClusters``)."""
    count = ctypes.c_int(0)
    KERNEL.call("decode_attention_max_clusters",
                [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)],
                D, G, _DTYPES[dtype], splits, ctypes.byref(count))
    return count.value
