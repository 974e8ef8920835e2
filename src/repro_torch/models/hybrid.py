"""Zamba2-style hybrid backbone (``models/hybrid.py``, ``family ==
"hybrid"``, arXiv:2411.15242): a stack of Mamba2 blocks with ONE shared
attention + MLP block applied after every ``shared_attn_every`` of them.
The shared block's parameters are reused at every invocation, so its
gradient sums over them; each invocation keeps its own KV cache.

Layout: ``n_super = n_layers // k`` super-blocks of (k Mamba2 layers +
the shared block), then ``n_layers mod k`` tail Mamba2 layers.  The
reference stacks the super-blocks' layers on two leading axes and scans
them; here ``mamba_blocks`` is a ``ModuleList`` of ``ModuleList``s and a
Python loop walks them.  The reference's ``seq_shard``/``seq_unshard``
sharding constraints do nothing on one device and are left out.

The decode cache holds the SSM states of all Mamba2 layers as one stack in
forward order, (n_mamba, B, ...), where the reference nests them as
(n_super, k, B, ...) plus (tail, B, ...): one batch axis per cache type
(``serving/engine.py``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.decode_attention import pos_vector
from repro_torch.models.base import (Block, block_decode, block_prefill, cdt,
                                     decode_capacity, init_kv_cache, pdt)
from repro_torch.nn.embedding import Embedding, embed, unembed
from repro_torch.nn.module import resolve_device
from repro_torch.nn.norms import RMSNorm, rmsnorm
from repro_torch.nn.rotary import rope_angles
from repro_torch.nn.ssm import (Mamba2, SSMCache, init_ssm_cache,
                                mamba2_decode, mamba2_prefill)


def _layout(cfg: ArchConfig) -> Tuple[int, int, int]:
    k = cfg.shared_attn_every or cfg.n_layers
    n_super = cfg.n_layers // k
    tail = cfg.n_layers - n_super * k
    return n_super, k, tail


def _ssm_kw(cfg: ArchConfig) -> dict:
    return dict(expand=cfg.ssm_expand, state=cfg.ssm_state,
                conv_k=cfg.ssm_conv)


class MambaBlock(nn.Module):
    """Pre-norm residual Mamba2 layer: {ln, mamba}."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, dtype=pdt(cfg), device=device)
        self.mamba = Mamba2(cfg.d_model, **_ssm_kw(cfg), dtype=cdt(cfg),
                            param_dtype=pdt(cfg), device=device)

    def init_(self, gen: torch.Generator):
        self.ln.init_()
        self.mamba.init_(gen)


class HybridLM(nn.Module):
    """Parameters of one hybrid backbone, with the reference's leaf paths
    (``mamba_blocks.s.j`` for its stacked ``mamba_blocks[s, j]``).  The
    embedding table is stored in the compute dtype; ``device=None`` means
    the card."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        n_super, k, tail = _layout(cfg)
        device = resolve_device(device)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, dtype=cdt(cfg),
                               device=device)
        self.ln_f = RMSNorm(cfg.d_model, dtype=pdt(cfg), device=device)
        self.mamba_blocks = nn.ModuleList(
            nn.ModuleList(MambaBlock(cfg, device) for _ in range(k))
            for _ in range(n_super))
        self.shared = Block(cfg, device)  # one parameter set, reused
        self.unembed = None if cfg.tie_embeddings else Embedding(
            cfg.vocab_size, cfg.d_model, dtype=cdt(cfg), device=device)
        self.tail = nn.ModuleList(MambaBlock(cfg, device)
                                  for _ in range(tail)) if tail else None

    def init_(self, gen: torch.Generator):
        self.embed.init_(gen)
        self.ln_f.init_()
        for blocks in self.mamba_blocks:
            for blk in blocks:
                blk.init_(gen)
        self.shared.init_(gen)
        if self.unembed is not None:
            self.unembed.init_(gen)
        for blk in self.tail or ():
            blk.init_(gen)

    def mamba_layers(self):
        """Every Mamba2 layer in forward order (the cache's layer order)."""
        for blocks in self.mamba_blocks:
            yield from blocks
        yield from self.tail or ()


def init_lm(cfg: ArchConfig, gen: torch.Generator, device=None) -> HybridLM:
    lm = HybridLM(cfg, device)
    lm.init_(gen)
    return lm


def _mamba_fwd(blk: MambaBlock, h: torch.Tensor, cfg: ArchConfig):
    hn = rmsnorm(blk.ln, h, cfg.norm_eps)
    return h + mamba2_prefill(blk.mamba, hn, **_ssm_kw(cfg),
                              chunk=cfg.ssm_chunk, compute_dtype=cdt(cfg))


def forward(params: HybridLM, cfg: ArchConfig, batch, *,
            with_logits: bool = True) -> Dict[str, torch.Tensor]:
    """Training/prefill forward (ref :77).  batch["tokens"]: (B, S).
    Returns ``hidden`` (B, S, d) in the compute dtype, ``logits``
    (B, S, V) f32 (None with ``with_logits=False``) and ``aux_loss`` 0.

    Under ``remat`` with autograd on, each super-block (k Mamba2 layers
    and the shared block) and each tail layer runs under one
    ``torch.utils.checkpoint``, where the reference remats ``super_body``
    and the tail layers."""
    tokens = batch["tokens"]
    h = embed(params.embed, tokens, cdt(cfg))
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    rope = rope_angles(pos, cfg.resolved_head_dim, cfg.rope_theta)
    remat = cfg.remat and torch.is_grad_enabled()

    def super_body(blocks: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
        for blk in blocks:
            x = _mamba_fwd(blk, x, cfg)
        return block_prefill(params.shared, x, rope, cfg)

    def tail_body(blk: MambaBlock, x: torch.Tensor) -> torch.Tensor:
        return _mamba_fwd(blk, x, cfg)

    for body, layers in ((super_body, params.mamba_blocks),
                         (tail_body, params.tail or ())):
        for layer in layers:
            h = (checkpoint(body, layer, h, use_reentrant=False) if remat
                 else body(layer, h))
    h = rmsnorm(params.ln_f, h, cfg.norm_eps)
    logits = None
    if with_logits:
        tab = params.embed if params.unembed is None else params.unembed
        logits = unembed(tab, h, cdt(cfg))
    return {"hidden": h, "logits": logits,
            "aux_loss": torch.zeros((), dtype=torch.float32, device=h.device)}


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device=None):
    """{"ssm": SSMCache (n_mamba, B, ...), "attn": KVCache (n_super, B, C,
    Hkv, D)} on ``device`` (``None``: the card)."""
    n_super, k, tail = _layout(cfg)
    device = resolve_device(device)
    return {"ssm": init_ssm_cache(batch, cfg.d_model, **_ssm_kw(cfg),
                                  n_layers=n_super * k + tail,
                                  device=device),
            "attn": init_kv_cache(cfg, batch, decode_capacity(cfg, seq_len),
                                  n_layers=n_super, device=device)}


def decode_step(params: HybridLM, cfg: ArchConfig, cache, tokens_t, pos, *,
                with_logits: bool = True,
                active: Optional[torch.Tensor] = None
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """One decode step (ref :130).  tokens_t: (B,); pos: scalar or (B,);
    ``active``: (B,) bool, rows whose SSM states, conv tails and KV rows
    commit (all when None).  Updates ``cache`` in place and returns
    (logits | None, hidden (B, d))."""
    n_super, k, _ = _layout(cfg)
    B = tokens_t.shape[0]
    posv = pos_vector(pos, B, tokens_t.device)
    h = embed(params.embed, tokens_t, cdt(cfg))
    ssm, kv = cache["ssm"], cache["attn"]
    win = kv.k.shape[2] if cfg.long_context_window else 0
    rope = rope_angles(posv, cfg.resolved_head_dim, cfg.rope_theta)
    for li, blk in enumerate(params.mamba_layers()):
        layer = SSMCache(*(leaf[li] for leaf in ssm))
        h = h + mamba2_decode(blk.mamba, rmsnorm(blk.ln, h, cfg.norm_eps),
                              layer, **_ssm_kw(cfg), compute_dtype=cdt(cfg),
                              active=active)
        if li % k == k - 1 and li // k < n_super:  # end of a super-block
            s = li // k
            h = block_decode(params.shared, h, kv.k[s], kv.v[s], posv, rope,
                             cfg, window=win, active=active)
    h = rmsnorm(params.ln_f, h, cfg.norm_eps)
    if not with_logits:
        return None, h
    tab = params.embed if params.unembed is None else params.unembed
    return unembed(tab, h, cdt(cfg)), h
