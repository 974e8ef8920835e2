"""Decoder-only backbone of the dense and MoE families
(``models/transformer.py``): granite, the Qwen archs, mixtral and
deepseek-v3, as a training/prefill ``forward`` over whole sequences and a
``decode_step``.

  dense : embed -> L blocks -> norm -> tied or separate unembed
  moe   : embed -> first_dense_layers dense blocks (d_ff, or moe_d_ff when
          d_ff is 0) -> the rest as MoE blocks -> norm -> unembed
          [-> the depth-1 MTP head when cfg.mtp_depth (DeepSeek-V3)]

The reference scans stacked layer parameters with ``lax.scan``; here a
Python loop walks an ``nn.ModuleList`` and indexes the layer axis of the
stacked cache.  The vlm and audio families are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.decode_attention import pos_vector
from repro_torch.models.base import (Block, block_decode, block_prefill, cdt,
                                     decode_capacity, init_kv_cache,
                                     layer_cache, pdt, rope_dim, scan_layers)
from repro_torch.nn.embedding import Embedding, embed, unembed
from repro_torch.nn.module import Linear, linear, resolve_device
from repro_torch.nn.norms import RMSNorm, rmsnorm
from repro_torch.nn.rotary import rope_angles


def _layer_layout(cfg: ArchConfig) -> Dict[str, int]:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: the port runs "
            "dense and MoE backbones here; see ROADMAP.md queue 1, item 7 "
            "(other families)")
    if cfg.is_moe:
        return {"kind": "moe", "dense": cfg.first_dense_layers,
                "moe": cfg.n_layers - cfg.first_dense_layers}
    return {"kind": "dense", "dense": cfg.n_layers}


def dense_cfg(cfg: ArchConfig) -> ArchConfig:
    """The config of an MoE backbone's dense blocks (ref :66)."""
    return cfg.replace(d_ff=cfg.d_ff or cfg.moe_d_ff)


class MTPHead(nn.Module):
    """DeepSeek-V3's depth-1 multi-token-prediction head (ref :66-72)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.proj = Linear(2 * cfg.d_model, cfg.d_model, dtype=cdt(cfg),
                           device=device)
        self.ln_h = RMSNorm(cfg.d_model, dtype=pdt(cfg), device=device)
        self.ln_e = RMSNorm(cfg.d_model, dtype=pdt(cfg), device=device)
        self.block = Block(cfg, device, moe=True)
        self.ln_f = RMSNorm(cfg.d_model, dtype=pdt(cfg), device=device)

    def init_(self, gen: torch.Generator):
        self.proj.init_(gen)
        for ln in (self.ln_h, self.ln_e, self.ln_f):
            ln.init_()
        self.block.init_(gen)


class TransformerLM(nn.Module):
    """Parameters of one dense or MoE backbone, with the reference's leaf
    paths (``blocks``; or ``blocks_dense``, ``blocks_moe`` and ``mtp``).
    The embedding table is stored in the compute dtype (the reference
    casts it on every use); the final norm stays in ``param_dtype``.
    ``device=None`` means the card."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        lay = _layer_layout(cfg)
        device = resolve_device(device)
        self.ln_f = RMSNorm(cfg.d_model, dtype=pdt(cfg), device=device)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, dtype=cdt(cfg),
                               device=device)
        self.unembed = None if cfg.tie_embeddings else Embedding(
            cfg.vocab_size, cfg.d_model, dtype=cdt(cfg), device=device)
        if lay["kind"] == "moe":
            dcfg = dense_cfg(cfg)
            self.blocks_dense = nn.ModuleList(
                Block(dcfg, device) for _ in range(lay["dense"])
            ) if lay["dense"] else None
            self.blocks_moe = nn.ModuleList(
                Block(cfg, device, moe=True) for _ in range(lay["moe"]))
            self.mtp = MTPHead(cfg, device) if cfg.mtp_depth else None
        else:
            self.blocks = nn.ModuleList(Block(cfg, device)
                                        for _ in range(lay["dense"]))

    def init_(self, gen: torch.Generator):
        self.ln_f.init_()
        self.embed.init_(gen)
        if self.unembed is not None:
            self.unembed.init_(gen)
        for name in ("blocks", "blocks_dense", "blocks_moe"):
            for blk in getattr(self, name, None) or ():
                blk.init_(gen)
        if getattr(self, "mtp", None) is not None:
            self.mtp.init_(gen)

    def stacks(self, cfg: ArchConfig):
        """(cache key, config, blocks) of each layer stack in forward
        order; the cache key names the stack's entry of ``init_cache``."""
        if _layer_layout(cfg)["kind"] == "dense":
            return [("blocks", cfg, self.blocks)]
        return [("dense", dense_cfg(cfg), self.blocks_dense or ()),
                ("moe", cfg, self.blocks_moe)]


def init_lm(cfg: ArchConfig, gen: torch.Generator, device=None) -> TransformerLM:
    lm = TransformerLM(cfg, device)
    lm.init_(gen)
    return lm


def _unembed(params: TransformerLM, cfg: ArchConfig, h: torch.Tensor):
    tab = params.embed if params.unembed is None else params.unembed
    return unembed(tab, h, cdt(cfg))


def forward(params: TransformerLM, cfg: ArchConfig, batch, *,
            with_logits: bool = True) -> Dict[str, torch.Tensor]:
    """Training/prefill forward (ref :101).  batch["tokens"]: (B, S) on
    the model's device.  Returns ``hidden`` (B, S, d) in the compute
    dtype, ``logits`` (B, S, V) f32 (None with ``with_logits=False``: the
    edge tower's monitor path reads only the hidden states), ``aux_loss``
    (the MoE load-balance losses summed over layers, 0 for a dense
    backbone) and, with an MTP head, ``mtp_logits``."""
    tokens = batch["tokens"]
    h = embed(params.embed, tokens, cdt(cfg))
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    rope = rope_angles(pos, rope_dim(cfg), cfg.rope_theta)
    window = cfg.sliding_window
    aux = None
    for _, scfg, blocks in params.stacks(cfg):
        h, aux = scan_layers(
            lambda blk, x, c=scfg: block_prefill(blk, x, rope, c,
                                                 window=window),
            h, blocks, remat=cfg.remat, aux=aux)
    h = rmsnorm(params.ln_f, h, cfg.norm_eps)
    out = {"hidden": h, "aux_loss": aux,
           "logits": _unembed(params, cfg, h) if with_logits else None}
    mp = getattr(params, "mtp", None)
    if cfg.is_moe and cfg.mtp_depth and mp is not None and with_logits:
        # depth-1 MTP: h_t with emb(tok_{t+1}) predicts tok_{t+2} (ref :162)
        emb_next = torch.roll(embed(params.embed, tokens, cdt(cfg)), -1, 1)
        z = torch.cat([rmsnorm(mp.ln_h, h, cfg.norm_eps),
                       rmsnorm(mp.ln_e, emb_next, cfg.norm_eps)], dim=-1)
        z = linear(mp.proj, z, compute_dtype=cdt(cfg))
        z, _ = block_prefill(mp.block, z, rope, cfg, window=window)
        out["mtp_logits"] = _unembed(params, cfg,
                                     rmsnorm(mp.ln_f, z, cfg.norm_eps))
    return out


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device=None):
    """{"blocks": cache} for a dense backbone; {"dense": cache or None,
    "moe": cache} for an MoE one (ref :185); ``KVCache``s, or
    ``MLACache``s for MLA."""
    lay = _layer_layout(cfg)
    cap = decode_capacity(cfg, seq_len)

    def stack(n):
        return init_kv_cache(cfg, batch, cap, n_layers=n, device=device)

    if lay["kind"] == "moe":
        return {"dense": stack(lay["dense"]) if lay["dense"] else None,
                "moe": stack(lay["moe"])}
    return {"blocks": stack(lay["dense"])}


def decode_step(params: TransformerLM, cfg: ArchConfig, cache, tokens_t,
                pos, *, with_logits: bool = True,
                active: Optional[torch.Tensor] = None,
                route_each_row: bool = False
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """One decode step.  tokens_t: (B,); pos: scalar or (B,) positions;
    ``active``: (B,) bool, rows whose cache writes commit (all when None);
    ``route_each_row``: the MoE blocks route every row as its own group
    (the reference's vmapped per-element decode) instead of the B rows
    together.  Updates ``cache`` in place and returns (logits | None,
    hidden (B, d)).  ``with_logits=False`` skips the unembed
    (monitoring-only decode)."""
    lay = _layer_layout(cfg)
    B = tokens_t.shape[0]
    posv = pos_vector(pos, B, tokens_t.device)
    h = embed(params.embed, tokens_t, cdt(cfg))
    first = cache["blocks"] if lay["kind"] == "dense" else cache["moe"]
    cap = first[0].shape[2]
    # a cache smaller than the logical context runs as a ring buffer; the
    # MoE branch reads its window off long_context_window alone (ref :261)
    ring = cfg.long_context_window if lay["kind"] == "moe" else (
        cfg.sliding_window or cfg.long_context_window)
    win = cap if ring else 0
    rope = rope_angles(posv, rope_dim(cfg), cfg.rope_theta)
    for key, scfg, blocks in params.stacks(cfg):
        for li, blk in enumerate(blocks):
            h = block_decode(blk, h, layer_cache(cache[key], li), posv, rope,
                             scfg, window=win, active=active,
                             route_each_row=route_each_row)
    h = rmsnorm(params.ln_f, h, cfg.norm_eps)
    if not with_logits:
        return None, h
    return _unembed(params, cfg, h), h
