"""xLSTM-350m backbone (``models/xlstm_model.py``, ``family == "ssm"``,
arXiv:2405.04517): mLSTM blocks with one sLSTM block every
``slstm_every`` layers (the paper's xLSTM[a:b]).  ``d_ff`` is 0: the
blocks carry their own projections.

Layout: ``n_super = n_layers // k`` super-blocks of (k - 1 mLSTM layers
+ 1 sLSTM layer), then ``n_layers mod k`` tail mLSTM layers.  The
reference stacks the super-blocks' mLSTM layers on two axes
(``super.mlstm``), their sLSTM layers on one (``super.slstm``) and the
tail on one; so do the ``LayerStack``s here.

The decode state holds every mLSTM layer's state as one stack in forward
order, (n_mlstm, B, ...), and every sLSTM layer's as another, (n_super,
B, d), where the reference nests the first as (n_super, k - 1, B, ...)
plus (tail, B, ...): one batch axis per state type
(``serving/engine.py``).  Decode ignores ``pos``: the state is O(1) in
the sequence.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.base import cdt, pdt, scan_layers
from repro_torch.nn.embedding import Embedding, embed, unembed
from repro_torch.nn.module import LayerStack, resolve_device
from repro_torch.nn.norms import RMSNorm, rmsnorm
from repro_torch.nn.xlstm import (MLSTM, SLSTM, MLSTMState, SLSTMState,
                                  init_mlstm_state, init_slstm_state,
                                  mlstm_decode, mlstm_parallel, slstm_scan,
                                  slstm_step)


def _layout(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(n_super, mLSTM layers a super-block, tail mLSTM layers)."""
    if not cfg.slstm_every:
        return 0, 0, cfg.n_layers
    k = cfg.slstm_every
    n_super = cfg.n_layers // k
    return n_super, k - 1, cfg.n_layers - n_super * k


class MBlock(nn.Module):
    """Pre-norm residual mLSTM layer: {ln, cell}."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, dtype=pdt(cfg), device=device)
        self.cell = MLSTM(cfg.d_model, cfg.n_heads, dtype=cdt(cfg),
                          param_dtype=pdt(cfg), device=device)

    def init_(self, gen: torch.Generator):
        self.ln.init_()
        self.cell.init_(gen)


class SBlock(nn.Module):
    """Pre-norm residual sLSTM layer: {ln, cell}."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, dtype=pdt(cfg), device=device)
        self.cell = SLSTM(cfg.d_model, cfg.n_heads, param_dtype=pdt(cfg),
                          device=device)

    def init_(self, gen: torch.Generator):
        self.ln.init_()
        self.cell.init_(gen)


class SuperBlocks(nn.Module):
    """The reference's ``super``: ``mlstm`` (n_super, k - 1) and
    ``slstm`` (n_super)."""

    def __init__(self, cfg: ArchConfig, n_super: int, per: int, device):
        super().__init__()
        self.mlstm = LayerStack(
            lambda d: LayerStack(lambda d2: MBlock(cfg, d2), per, d),
            n_super, device)
        self.slstm = LayerStack(lambda d: SBlock(cfg, d), n_super, device)


class XLSTMLM(nn.Module):
    """Parameters of one xLSTM backbone, with the reference's leaf paths.
    The embedding table is stored in the compute dtype; ``device=None``
    means the card."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        n_super, per, tail = _layout(cfg)
        device = resolve_device(device)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, dtype=cdt(cfg),
                               device=device)
        self.ln_f = RMSNorm(cfg.d_model, dtype=pdt(cfg), device=device)
        self.unembed = None if cfg.tie_embeddings else Embedding(
            cfg.vocab_size, cfg.d_model, dtype=cdt(cfg), device=device)
        if n_super:
            self.super = SuperBlocks(cfg, n_super, per, device)
        if tail:
            self.tail = LayerStack(lambda d: MBlock(cfg, d), tail, device)

    def init_(self, gen: torch.Generator):
        self.embed.init_(gen)
        self.ln_f.init_()
        if self.unembed is not None:
            self.unembed.init_(gen)
        for blk in self.mlstm_layers():
            blk.init_(gen)
        for blk in self.slstm_layers():
            blk.init_(gen)

    def mlstm_layers(self):
        """Every mLSTM layer in forward order (the state's layer order)."""
        if hasattr(self, "super"):
            for blocks in self.super.mlstm:
                yield from blocks
        yield from getattr(self, "tail", None) or ()

    def slstm_layers(self):
        yield from self.super.slstm if hasattr(self, "super") else ()


def init_lm(cfg: ArchConfig, gen: torch.Generator, device=None) -> XLSTMLM:
    lm = XLSTMLM(cfg, device)
    lm.init_(gen)
    return lm


def _logits(params: XLSTMLM, cfg: ArchConfig, h: torch.Tensor):
    tab = params.embed if params.unembed is None else params.unembed
    return unembed(tab, h, cdt(cfg))


def forward(params: XLSTMLM, cfg: ArchConfig, batch, *,
            with_logits: bool = True) -> Dict[str, torch.Tensor]:
    """Training/prefill forward (ref :61).  batch["tokens"]: (B, S).
    Returns ``hidden`` (B, S, d) in the compute dtype, ``logits`` (B, S,
    V) f32 (None with ``with_logits=False``) and ``aux_loss`` 0.  Under
    ``remat`` with autograd on, each super-block runs under one
    ``torch.utils.checkpoint`` and each tail layer under its own, as the
    reference remats them."""
    h = embed(params.embed, batch["tokens"], cdt(cfg))

    def m_body(blk: MBlock, x):
        y = mlstm_parallel(blk.cell, rmsnorm(blk.ln, x, cfg.norm_eps),
                           cfg.n_heads, compute_dtype=cdt(cfg))
        return x + y, torch.zeros((), dtype=torch.float32, device=x.device)

    def super_body(blocks, sblk: SBlock, x):
        x, _ = scan_layers(m_body, x, blocks, remat=False)
        return x + slstm_scan(sblk.cell, rmsnorm(sblk.ln, x, cfg.norm_eps),
                              cfg.n_heads, compute_dtype=cdt(cfg))

    remat = cfg.remat and torch.is_grad_enabled()
    if hasattr(params, "super"):
        for blocks, sblk in zip(params.super.mlstm, params.super.slstm):
            h = (checkpoint(super_body, blocks, sblk, h, use_reentrant=False)
                 if remat else super_body(blocks, sblk, h))
    h, aux = scan_layers(m_body, h, getattr(params, "tail", None) or (),
                         remat=cfg.remat)
    h = rmsnorm(params.ln_f, h, cfg.norm_eps)
    return {"hidden": h, "aux_loss": aux,
            "logits": _logits(params, cfg, h) if with_logits else None}


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device=None):
    """{"mlstm": MLSTMState (n_mlstm, B, ...) or None, "slstm":
    SLSTMState (n_super, B, d) or None} on ``device`` (``None``: the
    card); ``seq_len`` does not size it."""
    n_super, per, tail = _layout(cfg)
    device = resolve_device(device)
    n_m = n_super * per + tail
    return {"mlstm": init_mlstm_state(batch, cfg.d_model, cfg.n_heads,
                                      n_layers=n_m, device=device)
            if n_m else None,
            "slstm": init_slstm_state(batch, cfg.d_model, n_layers=n_super,
                                      device=device) if n_super else None}


def decode_step(params: XLSTMLM, cfg: ArchConfig, cache, tokens_t, pos, *,
                with_logits: bool = True,
                active: Optional[torch.Tensor] = None
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """One decode step (ref :108).  tokens_t: (B,); ``pos`` is unused;
    ``active``: (B,) bool, rows whose states commit (all when None).
    Updates ``cache`` in place and returns (logits | None, hidden (B, d))."""
    h = embed(params.embed, tokens_t, cdt(cfg))
    mst, sst = cache["mlstm"], cache["slstm"]
    mlayers = enumerate(params.mlstm_layers())

    def m_step(h, li, blk):
        return h + mlstm_decode(blk.cell, rmsnorm(blk.ln, h, cfg.norm_eps),
                                MLSTMState(*(leaf[li] for leaf in mst)),
                                cfg.n_heads, compute_dtype=cdt(cfg),
                                active=active)

    for s, sblk in enumerate(params.slstm_layers()):
        for _ in range(len(params.super.mlstm[s])):
            h = m_step(h, *next(mlayers))
        y = slstm_step(sblk.cell, rmsnorm(sblk.ln, h, cfg.norm_eps),
                       SLSTMState(*(leaf[s] for leaf in sst)), cfg.n_heads,
                       active=active)
        h = (h.float() + y * sblk.cell.norm_scale.float()).to(cdt(cfg))
    for li, blk in mlayers:  # the tail
        h = m_step(h, li, blk)
    h = rmsnorm(params.ln_f, h, cfg.norm_eps)
    if not with_logits:
        return None, h
    return _logits(params, cfg, h), h
