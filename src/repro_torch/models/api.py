"""Uniform backbone API (``models/api.py``), dense part: the rest of the
port talks to these functions only."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


def _impl(cfg: ArchConfig):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: see ROADMAP.md "
            "queue 1, item 7 (other families)")
    return transformer


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
