"""Dense transformer block, the layer loop, and decode-cache sizing
(``models/base.py``)."""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.nn.attention import GQA, KVCache, gqa_decode, gqa_prefill
from repro_torch.nn.mlp import SwiGLU, swiglu
from repro_torch.nn.module import resolve_device
from repro_torch.nn.norms import RMSNorm, rmsnorm

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def cdt(cfg: ArchConfig) -> torch.dtype:
    """Compute (activation) dtype."""
    return _DTYPES[cfg.dtype]


def pdt(cfg: ArchConfig) -> torch.dtype:
    """Parameter storage dtype of parameters read in their own dtype."""
    return _DTYPES[cfg.param_dtype]


class Block(nn.Module):
    """Attention + SwiGLU block.  The projection weights are stored in the
    compute dtype: the reference keeps them in ``param_dtype`` but casts
    them to the compute dtype on every use (``nn/module.py:59``), so the
    forward reads the same numbers, and a bf16 server takes half the
    memory (16 GB instead of 32 GB at Granite-8B width).  Training keeps
    an f32 master of each such weight in the optimizer
    (``training/optimizer.py``).  Norm scales are read in f32 and stay in
    ``param_dtype``."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        if cfg.use_mla or cfg.is_moe:
            raise NotImplementedError(
                "MLA and MoE blocks are not ported yet: see ROADMAP.md "
                "queue 1, item 7 (other families)")
        w = dict(dtype=cdt(cfg), device=device)
        self.ln_attn = RMSNorm(cfg.d_model, dtype=pdt(cfg), device=device)
        self.attn = GQA(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias, **w)
        self.ln_mlp = RMSNorm(cfg.d_model, dtype=pdt(cfg), device=device)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, **w)

    def init_(self, gen: torch.Generator):
        self.ln_attn.init_()
        self.attn.init_(gen)
        self.ln_mlp.init_()
        self.mlp.init_(gen)


def block_prefill(p: Block, h: torch.Tensor, rope, cfg: ArchConfig, *,
                  window: int = 0) -> torch.Tensor:
    """One block over a whole sequence (ref ``block_prefill`` :180 and
    ``_attn_prefill`` :155, dense branch).  h: (B, S, d_model)."""
    hn = rmsnorm(p.ln_attn, h, cfg.norm_eps)
    h = h + gqa_prefill(p.attn, hn, rope, n_heads=cfg.n_heads,
                        n_kv=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
                        window=window, compute_dtype=cdt(cfg))
    hn = rmsnorm(p.ln_mlp, h, cfg.norm_eps)
    return h + swiglu(p.mlp, hn, compute_dtype=cdt(cfg))


def scan_layers(body: Callable, h: torch.Tensor, blocks: nn.ModuleList, *,
                remat: bool) -> torch.Tensor:
    """``h = body(block, h)`` for each block in order (ref ``scan_layers``
    :37).  With ``remat`` and autograd on, each layer runs under
    ``torch.utils.checkpoint``: its activations are dropped after the
    forward and recomputed in the backward, as ``jax.checkpoint`` does."""
    remat = remat and torch.is_grad_enabled()
    for blk in blocks:
        h = (checkpoint(body, blk, h, use_reentrant=False) if remat
             else body(blk, h))
    return h


def block_decode(p: Block, h: torch.Tensor, cache_k: torch.Tensor,
                 cache_v: torch.Tensor, pos: torch.Tensor, rope,
                 cfg: ArchConfig, *, window: int = 0,
                 active=None) -> torch.Tensor:
    hn = rmsnorm(p.ln_attn, h, cfg.norm_eps)
    a = gqa_decode(p.attn, hn, cache_k, cache_v, pos, rope,
                   n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                   head_dim=cfg.resolved_head_dim, window=window,
                   compute_dtype=cdt(cfg), active=active)
    h = h + a
    hn = rmsnorm(p.ln_mlp, h, cfg.norm_eps)
    return h + swiglu(p.mlp, hn, compute_dtype=cdt(cfg))


def init_kv_cache(cfg: ArchConfig, batch: int, capacity: int, *,
                  n_layers: int, device=None) -> KVCache:
    """Zeroed caches of ``n_layers`` layers, (L, B, C, Hkv, D) each, on
    ``device`` (``None``: the card)."""
    device = resolve_device(device)
    shape = (n_layers, batch, capacity, cfg.n_kv_heads, cfg.resolved_head_dim)
    return KVCache(k=torch.zeros(shape, dtype=cdt(cfg), device=device),
                   v=torch.zeros(shape, dtype=cdt(cfg), device=device))


LONG_CONTEXT_THRESHOLD = 65_536  # beyond this, full-attention archs switch
                                 # to their sliding-window ring cache


def decode_capacity(cfg: ArchConfig, seq_len: int) -> int:
    if cfg.sliding_window:
        return min(seq_len, cfg.sliding_window)
    if cfg.long_context_window and seq_len > LONG_CONTEXT_THRESHOLD:
        return cfg.long_context_window
    return seq_len

