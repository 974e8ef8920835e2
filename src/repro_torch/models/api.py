"""Uniform backbone API (``models/api.py``): the rest of the port talks to
these functions only.  The dense and hybrid families are ported."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import hybrid, transformer

_FAMILY = {"dense": (transformer, transformer.TransformerLM),
           "hybrid": (hybrid, hybrid.HybridLM)}


def _family(cfg: ArchConfig):
    if cfg.family not in _FAMILY:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: see ROADMAP.md "
            "queue 1, item 7 (other families)")
    return _FAMILY[cfg.family]


def _impl(cfg: ArchConfig):
    return _family(cfg)[0]


def new_model(cfg: ArchConfig, device=None) -> nn.Module:
    """The backbone's parameter module, not yet initialised."""
    return _family(cfg)[1](cfg, device)


def init_model(cfg: ArchConfig, gen: torch.Generator, device=None):
    return _impl(cfg).init_lm(cfg, gen, device)


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device=None):
    return _impl(cfg).init_cache(cfg, batch, seq_len, device)


def decode_step(params, cfg: ArchConfig, cache, tokens_t, pos, *,
                with_logits: bool = True, active=None):
    return _impl(cfg).decode_step(params, cfg, cache, tokens_t, pos,
                                  with_logits=with_logits, active=active)


def forward(params, cfg: ArchConfig, batch, *, with_logits: bool = True):
    return _impl(cfg).forward(params, cfg, batch, with_logits=with_logits)
