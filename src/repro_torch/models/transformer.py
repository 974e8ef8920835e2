"""Decoder-only backbone of the dense, MoE, VLM and audio families
(``models/transformer.py``): granite, the Qwen archs, mixtral,
deepseek-v3, llama-3.2-vision and musicgen, as a training/prefill
``forward`` over whole sequences and a ``decode_step``.

  dense : embed -> L blocks -> norm -> tied or separate unembed
  moe   : embed -> first_dense_layers dense blocks (d_ff, or moe_d_ff when
          d_ff is 0) -> the rest as MoE blocks -> norm -> unembed
          [-> the depth-1 MTP head when cfg.mtp_depth (DeepSeek-V3)]
  vlm   : embed -> n_super x [cross_attn_every self blocks + 1 cross block
          with a tanh gate over the image rows] -> tail self blocks -> ...
  audio : sum of the K codebook embeddings -> dense blocks -> K heads

The reference scans stacked layer parameters with ``lax.scan``; here a
Python loop walks ``LayerStack``s and indexes the layer axis of the
stacked cache.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import batch_local
from repro_torch.kernels.decode_attention import pos_vector
from repro_torch.models.base import (Block, block_decode, block_prefill, cdt,
                                     decode_capacity, init_kv_cache,
                                     layer_cache, pdt, rope_dim, scan_layers)
from repro_torch.nn.attention import (GQA, CrossKV, cross_attn,
                                      cross_attn_decode)
from repro_torch.nn.embedding import (CodebookEmbedding, Embedding,
                                      codebook_embed, codebook_unembed,
                                      embed, unembed)
from repro_torch.nn.module import (LayerStack, Linear, linear, param,
                                   resolve_device)
from repro_torch.nn.norms import RMSNorm, rmsnorm
from repro_torch.nn.rotary import rope_angles


def _layer_layout(cfg: ArchConfig) -> Dict[str, int]:
    if cfg.family == "vlm" and cfg.cross_attn_every:
        n_super = cfg.n_layers // cfg.cross_attn_every
        return {"kind": "vlm", "n_super": n_super,
                "per_super": cfg.cross_attn_every,
                "tail": cfg.n_layers - n_super * cfg.cross_attn_every}
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


class CrossBlock(nn.Module):
    """A llama-3.2-vision image layer (ref :55-66): ``ln``, a GQA ``attn``
    over the image rows and the tanh ``gate``, f32, zero at init (so a
    fresh model's image path adds nothing)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, dtype=pdt(cfg), device=device)
        self.attn = GQA(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.resolved_head_dim, dtype=cdt(cfg), device=device)
        self.gate = param((1,), torch.float32, device)

    def init_(self, gen: torch.Generator):
        self.ln.init_()
        self.attn.init_(gen)
        self.gate.zero_()


class TransformerLM(nn.Module):
    """Parameters of one backbone of these families, with the reference's
    leaf paths (``blocks``; or ``blocks_dense``, ``blocks_moe`` and
    ``mtp``; or the VLM's ``blocks`` stacked on two axes, ``cross`` and
    ``tail``).  The embedding tables are stored in the compute dtype (the
    reference casts them on every use); the final norm stays in
    ``param_dtype``.  ``device=None`` means the card."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        lay = _layer_layout(cfg)
        device = resolve_device(device)
        self.ln_f = RMSNorm(cfg.d_model, dtype=pdt(cfg), device=device)
        if cfg.family == "audio":
            # the K codebook tables are the input and the output heads
            self.embed = CodebookEmbedding(cfg.n_codebooks, cfg.vocab_size,
                                           cfg.d_model, dtype=cdt(cfg),
                                           device=device)
            self.unembed = None
        else:
            self.embed = Embedding(cfg.vocab_size, cfg.d_model,
                                   dtype=cdt(cfg), device=device)
            self.unembed = None if cfg.tie_embeddings else Embedding(
                cfg.vocab_size, cfg.d_model, dtype=cdt(cfg), device=device)

        def block(c, moe=False):
            return lambda d: Block(c, d, moe=moe)

        if lay["kind"] == "vlm":
            per = lay["per_super"]
            self.blocks = LayerStack(
                lambda d: LayerStack(block(cfg), per, d), lay["n_super"],
                device)
            self.cross = LayerStack(lambda d: CrossBlock(cfg, d),
                                    lay["n_super"], device)
            if lay["tail"]:
                self.tail = LayerStack(block(cfg), lay["tail"], device)
        elif lay["kind"] == "moe":
            if lay["dense"]:
                self.blocks_dense = LayerStack(block(dense_cfg(cfg)),
                                               lay["dense"], device)
            self.blocks_moe = LayerStack(block(cfg, moe=True), lay["moe"],
                                         device)
            self.mtp = MTPHead(cfg, device) if cfg.mtp_depth else None
        else:
            self.blocks = LayerStack(block(cfg), lay["dense"], device)

    def init_(self, gen: torch.Generator):
        self.ln_f.init_()
        self.embed.init_(gen)
        if self.unembed is not None:
            self.unembed.init_(gen)
        for layer in self.self_blocks():
            layer.init_(gen)
        for cb in getattr(self, "cross", None) or ():
            cb.init_(gen)
        if getattr(self, "mtp", None) is not None:
            self.mtp.init_(gen)

    def self_blocks(self):
        """Every attention + feed-forward block in forward order (the
        layer order of the self-attention cache), cross blocks aside."""
        if hasattr(self, "cross"):
            for blocks in self.blocks:
                yield from blocks
            yield from getattr(self, "tail", None) or ()
            return
        for name in ("blocks", "blocks_dense", "blocks_moe"):
            yield from getattr(self, name, None) or ()

    def stacks(self, cfg: ArchConfig):
        """(cache key, config, blocks) of each layer stack of a dense or
        MoE backbone in forward order; the cache key names the stack's
        entry of ``init_cache``."""
        if _layer_layout(cfg)["kind"] == "dense":
            return [("blocks", cfg, self.blocks)]
        return [("dense", dense_cfg(cfg),
                 getattr(self, "blocks_dense", None) or ()),
                ("moe", cfg, self.blocks_moe)]


def init_lm(cfg: ArchConfig, gen: torch.Generator, device=None) -> TransformerLM:
    lm = TransformerLM(cfg, device)
    lm.init_(gen)
    return lm


def _embed_in(params: TransformerLM, cfg: ArchConfig, tokens: torch.Tensor):
    """(B, S) token ids, or the audio family's (B, S, K)."""
    if cfg.family == "audio":
        return codebook_embed(params.embed, tokens, cdt(cfg))
    return embed(params.embed, tokens, cdt(cfg))


def _unembed(params: TransformerLM, cfg: ArchConfig, h: torch.Tensor):
    """Logits in f32: (..., V), or the audio family's (..., K, V)."""
    if cfg.family == "audio":
        return codebook_unembed(params.embed, h, cdt(cfg))
    tab = params.embed if params.unembed is None else params.unembed
    return unembed(tab, h, cdt(cfg))


def _gated(h: torch.Tensor, cb: CrossBlock, c: torch.Tensor,
           cfg: ArchConfig) -> torch.Tensor:
    """h + tanh(gate) * c, summed in f32 and rounded to the compute dtype."""
    return (h.float() + torch.tanh(cb.gate.float()) * c.float()).to(cdt(cfg))


def _vlm_forward(params: TransformerLM, cfg: ArchConfig, h, img, rope):
    """The VLM's layers over a whole sequence (ref :109-132): each
    super-block (its self blocks, then the gated cross block over the
    image rows ``img``) under one ``torch.utils.checkpoint`` with
    ``remat``, as the reference remats ``super_body``; then the tail."""
    window = cfg.sliding_window
    remat = cfg.remat and torch.is_grad_enabled()

    def self_body(blk, x):
        return block_prefill(blk, x, rope, cfg, window=window)

    def super_body(blocks, cb, x, aux):
        x, aux = scan_layers(self_body, x, blocks, remat=False, aux=aux)
        c = cross_attn(cb.attn, rmsnorm(cb.ln, x, cfg.norm_eps), img,
                       n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                       head_dim=cfg.resolved_head_dim, compute_dtype=cdt(cfg))
        return _gated(x, cb, c, cfg), aux

    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for blocks, cb in zip(params.blocks, params.cross):
        h, aux = (checkpoint(super_body, blocks, cb, h, aux,
                             use_reentrant=False) if remat
                  else super_body(blocks, cb, h, aux))
    return scan_layers(self_body, h, getattr(params, "tail", None) or (),
                       remat=cfg.remat, aux=aux)


def forward(params: TransformerLM, cfg: ArchConfig, batch, *,
            with_logits: bool = True) -> Dict[str, torch.Tensor]:
    """Training/prefill forward (ref :101).  batch["tokens"]: (B, S), or
    (B, S, K) for audio, on the model's device; a VLM's batch also holds
    ``image_embeds`` (B, n_image_tokens, d_model).  Returns ``hidden``
    (B, S, d) in the compute dtype, ``logits`` (B, S, V), or (B, S, K, V)
    for audio, f32 (None with ``with_logits=False``: the edge tower's
    monitor path reads only the hidden states), ``aux_loss`` (the MoE
    load-balance losses summed over layers, 0 otherwise) and, with an MTP
    head, ``mtp_logits``."""
    tokens = batch["tokens"]
    h = _embed_in(params, cfg, tokens)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    rope = rope_angles(pos, rope_dim(cfg), cfg.rope_theta)
    window = cfg.sliding_window
    if _layer_layout(cfg)["kind"] == "vlm":
        h, aux = _vlm_forward(params, cfg, h,
                              batch["image_embeds"].to(cdt(cfg)), rope)
    else:
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
        emb_next = batch_local(lambda e: torch.roll(e, -1, 1),
                               _embed_in(params, cfg, tokens))
        z = torch.cat([rmsnorm(mp.ln_h, h, cfg.norm_eps),
                       rmsnorm(mp.ln_e, emb_next, cfg.norm_eps)], dim=-1)
        z = linear(mp.proj, z, compute_dtype=cdt(cfg))
        z, _ = block_prefill(mp.block, z, rope, cfg, window=window)
        out["mtp_logits"] = _unembed(params, cfg,
                                     rmsnorm(mp.ln_f, z, cfg.norm_eps))
    return out


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device=None):
    """{"blocks": cache} for a dense or audio backbone; {"dense": cache or
    None, "moe": cache} for an MoE one (ref :185); ``KVCache``s, or
    ``MLACache``s for MLA.  A VLM's is {"self": KVCache of every self
    block, "cross": CrossKV (n_super, B, n_image_tokens, Hkv, D)}, the
    image rows zero until a caller fills them (the reference's serving
    never does)."""
    lay = _layer_layout(cfg)
    cap = decode_capacity(cfg, seq_len)

    def stack(n):
        return init_kv_cache(cfg, batch, cap, n_layers=n, device=device)

    if lay["kind"] == "vlm":
        shape = (lay["n_super"], batch, cfg.n_image_tokens, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        dev = resolve_device(device)
        return {"self": stack(lay["n_super"] * lay["per_super"]
                              + lay["tail"]),
                "cross": CrossKV(*(torch.zeros(shape, dtype=cdt(cfg),
                                               device=dev)
                                   for _ in range(2)))}
    if lay["kind"] == "moe":
        return {"dense": stack(lay["dense"]) if lay["dense"] else None,
                "moe": stack(lay["moe"])}
    return {"blocks": stack(lay["dense"])}


def decode_step(params: TransformerLM, cfg: ArchConfig, cache, tokens_t,
                pos, *, with_logits: bool = True,
                active: Optional[torch.Tensor] = None,
                route_each_row: bool = False
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """One decode step.  tokens_t: (B,), or (B, K) for audio; pos: scalar
    or (B,) positions; ``active``: (B,) bool, rows whose cache writes
    commit (all when None); ``route_each_row``: the MoE blocks route every
    row as its own group (the reference's vmapped per-element decode)
    instead of the B rows together.  Updates ``cache`` in place and
    returns (logits | None, hidden (B, d)).  ``with_logits=False`` skips
    the unembed (monitoring-only decode)."""
    lay = _layer_layout(cfg)
    B = tokens_t.shape[0]
    posv = pos_vector(pos, B, tokens_t.device)
    h = _embed_in(params, cfg, tokens_t)
    rope = rope_angles(posv, rope_dim(cfg), cfg.rope_theta)
    if lay["kind"] == "vlm":
        h = _vlm_decode(params, cfg, cache, h, posv, rope, active)
    else:
        first = cache["blocks"] if lay["kind"] == "dense" else cache["moe"]
        # a cache smaller than the logical context runs as a ring buffer;
        # the MoE branch reads its window off long_context_window alone
        # (ref :261)
        ring = cfg.long_context_window if lay["kind"] == "moe" else (
            cfg.sliding_window or cfg.long_context_window)
        win = first[0].shape[2] if ring else 0
        for key, scfg, blocks in params.stacks(cfg):
            for li, blk in enumerate(blocks):
                h = block_decode(blk, h, layer_cache(cache[key], li), posv,
                                 rope, scfg, window=win, active=active,
                                 route_each_row=route_each_row)
    h = rmsnorm(params.ln_f, h, cfg.norm_eps)
    if not with_logits:
        return None, h
    return _unembed(params, cfg, h), h


def _vlm_decode(params: TransformerLM, cfg: ArchConfig, cache, h, posv,
                rope, active):
    """The VLM's layers for one token (ref :219-259): each super-block's
    self blocks, then its cross block's single-query attention over the
    image K/V of ``cache["cross"]`` through the decode attention kernel,
    gated; then the tail.  Only the self-attention cache is written."""
    selfc, cross = cache["self"], cache["cross"]
    win = selfc.k.shape[2] if (cfg.sliding_window
                               or cfg.long_context_window) else 0
    layers = params.self_blocks()
    li = 0
    for s, cb in enumerate(params.cross):
        for _ in range(len(params.blocks[s])):
            h = block_decode(next(layers), h, layer_cache(selfc, li), posv,
                             rope, cfg, window=win, active=active)
            li += 1
        c = cross_attn_decode(cb.attn, rmsnorm(cb.ln, h, cfg.norm_eps),
                              cross.k[s], cross.v[s], n_heads=cfg.n_heads,
                              head_dim=cfg.resolved_head_dim,
                              compute_dtype=cdt(cfg))
        h = _gated(h, cb, c, cfg)
    for blk in layers:  # the tail
        h = block_decode(blk, h, layer_cache(selfc, li), posv, rope, cfg,
                         window=win, active=active)
        li += 1
    return h
