"""Uniform backbone API (``models/api.py``): the rest of the port talks to
these functions only.  Every family of the reference is here: the
transformer backbone's dense, moe, vlm and audio, the hybrid, and the
xLSTM (``ssm``)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import hybrid, transformer, xlstm_model

_TRANSFORMER = (transformer, transformer.TransformerLM)
_FAMILY = {"dense": _TRANSFORMER, "moe": _TRANSFORMER, "vlm": _TRANSFORMER,
           "audio": _TRANSFORMER, "hybrid": (hybrid, hybrid.HybridLM),
           "ssm": (xlstm_model, xlstm_model.XLSTMLM)}


def _family(cfg: ArchConfig):
    return _FAMILY[cfg.family]


def _impl(cfg: ArchConfig):
    return _family(cfg)[0]


def new_model(cfg: ArchConfig, device=None) -> nn.Module:
    """The backbone's parameter module, not yet initialised."""
    return _family(cfg)[1](cfg, device)


def init_model(cfg: ArchConfig, gen: torch.Generator, device=None):
    return _impl(cfg).init_lm(cfg, gen, device)


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device=None, *,
               device_mesh=None, use_model: bool = True):
    """The decode cache of ``batch`` streams over ``seq_len`` tokens on
    ``device`` (``None``: the card).  With a ``device_mesh`` every leaf is
    a DTensor placed by ``cache_specs(mode=cfg.decode_cache_shard)`` (data
    axes only with ``use_model=False``: the edge cache), and ``device``
    holds only this rank's block (``distributed.sharding.placed_cache``)."""
    if device_mesh is None:
        return _impl(cfg).init_cache(cfg, batch, seq_len, device)
    from repro_torch.distributed.sharding import placed_cache
    from repro_torch.nn.module import resolve_device
    return placed_cache(
        lambda d: _impl(cfg).init_cache(cfg, batch, seq_len, d),
        resolve_device(device), device_mesh, batch,
        mode=cfg.decode_cache_shard, use_model=use_model)


def decode_step(params, cfg: ArchConfig, cache, tokens_t, pos, *,
                with_logits: bool = True, active=None,
                route_each_row: bool = False):
    """``route_each_row``: an MoE backbone routes each row as its own
    group (the per-element catch-up); no other family routes."""
    kw = {"route_each_row": route_each_row} if cfg.is_moe else {}
    return _impl(cfg).decode_step(params, cfg, cache, tokens_t, pos,
                                  with_logits=with_logits, active=active,
                                  **kw)


def forward(params, cfg: ArchConfig, batch, *, with_logits: bool = True):
    return _impl(cfg).forward(params, cfg, batch, with_logits=with_logits)
