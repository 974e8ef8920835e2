"""Dense decoder-only backbone (``models/transformer.py``, ``family ==
"dense"``): embed -> L blocks -> norm -> tied or separate unembed, as a
training/prefill ``forward`` over whole sequences and a ``decode_step``.

The reference scans stacked layer parameters with ``lax.scan``; here a
Python loop walks an ``nn.ModuleList`` and indexes the layer axis of the
stacked cache.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.decode_attention import pos_vector
from repro_torch.models.base import (Block, block_decode, block_prefill, cdt,
                                     decode_capacity, init_kv_cache, pdt,
                                     scan_layers)
from repro_torch.nn.embedding import Embedding, embed, unembed
from repro_torch.nn.module import resolve_device
from repro_torch.nn.norms import RMSNorm, rmsnorm
from repro_torch.nn.rotary import rope_angles


def _layer_layout(cfg: ArchConfig) -> Dict[str, int]:
    if cfg.family != "dense" or cfg.is_moe or cfg.use_mla:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: the port runs "
            "dense backbones; see ROADMAP.md queue 1, item 7 (other "
            "families)")
    return {"kind": "dense", "dense": cfg.n_layers}


class TransformerLM(nn.Module):
    """Parameters of one dense backbone.  The embedding table is stored in
    the compute dtype (the reference casts it on every use); the final
    norm stays in ``param_dtype``.  ``device=None`` means the card."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        lay = _layer_layout(cfg)
        device = resolve_device(device)
        self.ln_f = RMSNorm(cfg.d_model, dtype=pdt(cfg), device=device)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, dtype=cdt(cfg),
                               device=device)
        self.unembed = None if cfg.tie_embeddings else Embedding(
            cfg.vocab_size, cfg.d_model, dtype=cdt(cfg), device=device)
        self.blocks = nn.ModuleList(Block(cfg, device)
                                    for _ in range(lay["dense"]))

    def init_(self, gen: torch.Generator):
        self.ln_f.init_()
        self.embed.init_(gen)
        if self.unembed is not None:
            self.unembed.init_(gen)
        for blk in self.blocks:
            blk.init_(gen)


def init_lm(cfg: ArchConfig, gen: torch.Generator, device=None) -> TransformerLM:
    lm = TransformerLM(cfg, device)
    lm.init_(gen)
    return lm


def forward(params: TransformerLM, cfg: ArchConfig, batch, *,
            with_logits: bool = True) -> Dict[str, torch.Tensor]:
    """Training/prefill forward (ref :101, dense branch :150-158).
    batch["tokens"]: (B, S) on the model's device.  Returns ``hidden``
    (B, S, d) in the compute dtype, ``logits`` (B, S, V) f32 (None with
    ``with_logits=False``: the edge tower's monitor path reads only the
    hidden states) and ``aux_loss`` 0 (no MoE)."""
    _layer_layout(cfg)
    tokens = batch["tokens"]
    h = embed(params.embed, tokens, cdt(cfg))
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    rope = rope_angles(pos, cfg.resolved_head_dim, cfg.rope_theta)
    window = cfg.sliding_window
    h = scan_layers(lambda blk, x: block_prefill(blk, x, rope, cfg,
                                                 window=window),
                    h, params.blocks, remat=cfg.remat)
    h = rmsnorm(params.ln_f, h, cfg.norm_eps)
    logits = None
    if with_logits:
        tab = params.embed if params.unembed is None else params.unembed
        logits = unembed(tab, h, cdt(cfg))
    return {"hidden": h, "logits": logits,
            "aux_loss": torch.zeros((), dtype=torch.float32, device=h.device)}


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device=None):
    lay = _layer_layout(cfg)
    return {"blocks": init_kv_cache(cfg, batch, decode_capacity(cfg, seq_len),
                                    n_layers=lay["dense"], device=device)}


def decode_step(params: TransformerLM, cfg: ArchConfig, cache, tokens_t,
                pos, *, with_logits: bool = True,
                active: Optional[torch.Tensor] = None
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """One decode step.  tokens_t: (B,); pos: scalar or (B,) positions;
    ``active``: (B,) bool, rows whose cache writes commit (all when None).
    Updates ``cache`` in place and returns (logits | None, hidden (B, d)).
    ``with_logits=False`` skips the unembed (monitoring-only decode)."""
    _layer_layout(cfg)
    B = tokens_t.shape[0]
    posv = pos_vector(pos, B, tokens_t.device)
    h = embed(params.embed, tokens_t, cdt(cfg))
    kv = cache["blocks"]
    cap = kv.k.shape[2]
    # a cache smaller than the logical context runs as a ring buffer
    win = cap if (cfg.sliding_window or cfg.long_context_window) else 0
    rope = rope_angles(posv, cfg.resolved_head_dim, cfg.rope_theta)
    for li, blk in enumerate(params.blocks):
        h = block_decode(blk, h, kv.k[li], kv.v[li], posv, rope, cfg,
                         window=win, active=active)
    h = rmsnorm(params.ln_f, h, cfg.norm_eps)
    if not with_logits:
        return None, h
    tab = params.embed if params.unembed is None else params.unembed
    return unembed(tab, h, cdt(cfg)), h
