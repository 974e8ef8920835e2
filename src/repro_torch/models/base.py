"""The transformer block (GQA or MLA attention; SwiGLU or MoE feed-forward),
the layer loop, and decode-cache sizing (``models/base.py``)."""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.nn.attention import (GQA, MLA, KVCache, MLACache,
                                     gqa_decode, gqa_prefill, mla_decode,
                                     mla_prefill)
from repro_torch.nn.mlp import SwiGLU, swiglu
from repro_torch.nn.moe import MoE, moe_dispatch
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
    """Attention (GQA, or MLA with ``cfg.use_mla``) + SwiGLU block, or with
    ``moe`` an MoE feed-forward.  The projection and expert weights are
    stored in the compute dtype: the reference keeps them in
    ``param_dtype`` but casts them to the compute dtype on every use
    (``nn/module.py:59``), so the forward reads the same numbers, and a
    bf16 server takes half the memory (16 GB instead of 32 GB at
    Granite-8B width).  Training keeps an f32 master of each such weight
    in the optimizer where ``param_dtype`` is f32
    (``training/optimizer.py``).  Norm scales are read in f32 and stay in
    ``param_dtype``; the MoE router stays f32."""

    def __init__(self, cfg: ArchConfig, device=None, *, moe: bool = False):
        super().__init__()
        w = dict(dtype=cdt(cfg), device=device)
        self.ln_attn = RMSNorm(cfg.d_model, dtype=pdt(cfg), device=device)
        if cfg.use_mla:
            self.attn = MLA(cfg.d_model, cfg.n_heads, q_lora=cfg.q_lora_rank,
                            kv_lora=cfg.kv_lora_rank,
                            qk_nope=cfg.qk_nope_dim, qk_rope=cfg.qk_rope_dim,
                            v_dim=cfg.v_head_dim, **w)
        else:
            self.attn = GQA(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias,
                            **w)
        self.ln_mlp = RMSNorm(cfg.d_model, dtype=pdt(cfg), device=device)
        if moe:
            self.moe = MoE(cfg.d_model, cfg.moe_d_ff, cfg.n_experts,
                           n_shared=cfg.n_shared_experts, **w)
        else:
            self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, **w)

    def init_(self, gen: torch.Generator):
        self.ln_attn.init_()
        self.attn.init_(gen)
        self.ln_mlp.init_()
        (self.moe if hasattr(self, "moe") else self.mlp).init_(gen)


def rope_dim(cfg: ArchConfig) -> int:
    """The width the rotary embedding turns: MLA's decoupled rope key, else
    the head."""
    return cfg.qk_rope_dim if cfg.use_mla else cfg.resolved_head_dim


def _ffn(p: Block, hn: torch.Tensor, cfg: ArchConfig, groups: int = 1):
    """SwiGLU, or the MoE with its load-balance loss (0 for SwiGLU)."""
    if hasattr(p, "moe"):
        return moe_dispatch(p.moe, hn, n_experts=cfg.n_experts,
                            top_k=cfg.top_k,
                            capacity_factor=cfg.capacity_factor,
                            compute_dtype=cdt(cfg), groups=groups)
    return (swiglu(p.mlp, hn, compute_dtype=cdt(cfg)),
            torch.zeros((), dtype=torch.float32, device=hn.device))


def block_prefill(p: Block, h: torch.Tensor, rope, cfg: ArchConfig, *,
                  window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block over a whole sequence (ref ``block_prefill`` :180 and
    ``_attn_prefill`` :155).  h: (B, S, d_model); ``rope`` at
    ``rope_dim(cfg)``.  Returns (h, aux_loss); the MoE routes all B*S
    tokens together, as the reference's training forward does."""
    hn = rmsnorm(p.ln_attn, h, cfg.norm_eps)
    if cfg.use_mla:
        a = mla_prefill(p.attn, hn, rope, n_heads=cfg.n_heads,
                        qk_nope=cfg.qk_nope_dim, qk_rope=cfg.qk_rope_dim,
                        v_dim=cfg.v_head_dim, window=window,
                        compute_dtype=cdt(cfg))
    else:
        a = gqa_prefill(p.attn, hn, rope, n_heads=cfg.n_heads,
                        n_kv=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
                        window=window, compute_dtype=cdt(cfg))
    h = h + a
    m, aux = _ffn(p, rmsnorm(p.ln_mlp, h, cfg.norm_eps), cfg)
    return h + m, aux


def scan_layers(body: Callable, h: torch.Tensor, blocks: nn.ModuleList, *,
                remat: bool, aux: Optional[torch.Tensor] = None):
    """``h, a = body(block, h)`` for each block in order, summing the
    aux losses ``a`` onto ``aux`` (ref ``scan_layers`` :37); returns (h,
    aux).  With ``remat`` and autograd on, each layer runs under
    ``torch.utils.checkpoint``: its activations are dropped after the
    forward and recomputed in the backward, as ``jax.checkpoint`` does."""
    remat = remat and torch.is_grad_enabled()
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for blk in blocks:
        h, a = (checkpoint(body, blk, h, use_reentrant=False) if remat
                else body(blk, h))
        aux = aux + a
    return h, aux


def layer_cache(cache, li: int):
    """Layer ``li`` of a stacked ``KVCache``/``MLACache`` (views)."""
    return type(cache)(*(leaf[li] for leaf in cache))


def block_decode(p: Block, h: torch.Tensor, cache, pos: torch.Tensor, rope,
                 cfg: ArchConfig, *, window: int = 0, active=None,
                 route_each_row: bool = False) -> torch.Tensor:
    """One token per row through one block; ``cache`` is the layer's
    ``KVCache`` (B, C, Hkv, D) or ``MLACache``, written in place.  The
    MoE routes the B rows together, or with ``route_each_row`` each row
    as its own group (the reference's vmapped catch-up)."""
    hn = rmsnorm(p.ln_attn, h, cfg.norm_eps)
    if cfg.use_mla:
        a = mla_decode(p.attn, hn, cache.ckv, cache.krope, pos, rope,
                       n_heads=cfg.n_heads, qk_nope=cfg.qk_nope_dim,
                       qk_rope=cfg.qk_rope_dim, v_dim=cfg.v_head_dim,
                       kv_lora=cfg.kv_lora_rank, compute_dtype=cdt(cfg),
                       active=active)
    else:
        a = gqa_decode(p.attn, hn, cache.k, cache.v, pos, rope,
                       n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                       head_dim=cfg.resolved_head_dim, window=window,
                       compute_dtype=cdt(cfg), active=active)
    h = h + a
    hn = rmsnorm(p.ln_mlp, h, cfg.norm_eps)
    if not hasattr(p, "moe"):
        return h + swiglu(p.mlp, hn, compute_dtype=cdt(cfg))
    m, _ = _ffn(p, hn[:, None], cfg, h.shape[0] if route_each_row else 1)
    return h + m[:, 0]


def init_kv_cache(cfg: ArchConfig, batch: int, capacity: int, *,
                  n_layers: int, device=None):
    """Zeroed caches of ``n_layers`` layers on ``device`` (``None``: the
    card): ``KVCache`` (L, B, C, Hkv, D) each, or for MLA ``MLACache``
    (L, B, C, kv_lora_rank) and (L, B, C, qk_rope_dim)."""
    device = resolve_device(device)
    z = dict(dtype=cdt(cfg), device=device)
    if cfg.use_mla:
        return MLACache(
            ckv=torch.zeros((n_layers, batch, capacity, cfg.kv_lora_rank),
                            **z),
            krope=torch.zeros((n_layers, batch, capacity, cfg.qk_rope_dim),
                              **z))
    shape = (n_layers, batch, capacity, cfg.n_kv_heads, cfg.resolved_head_dim)
    return KVCache(k=torch.zeros(shape, **z), v=torch.zeros(shape, **z))


LONG_CONTEXT_THRESHOLD = 65_536  # beyond this, full-attention archs switch
                                 # to their sliding-window ring cache


def decode_capacity(cfg: ArchConfig, seq_len: int) -> int:
    if cfg.sliding_window:
        return min(seq_len, cfg.sliding_window)
    if cfg.long_context_window and seq_len > LONG_CONTEXT_THRESHOLD:
        return cfg.long_context_window
    return seq_len

