"""The paper's decomposition ``f_hat = u - s * sigma(v)`` at LM scale
(``core/decomposition.py``): the server backbone with a scalar corrector
head, and a small edge tower with the truncated-basis monitor head
(paper Eq. 8)."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import api as model_api
from repro_torch.nn.module import (Linear, linear, normal_, param,
                                   resolve_device, softplus)


def sigma(x: torch.Tensor, kind: str = "sigmoid") -> torch.Tensor:
    """Fixed continuous invertible map into (0, 1)."""
    if kind == "sigmoid":
        return torch.sigmoid(x)
    if kind == "tanh01":
        return 0.5 * (torch.tanh(x) + 1.0)
    raise ValueError(kind)


def edge_arch(cfg: ArchConfig) -> ArchConfig:
    """The edge tower's config, derived from ``cfg.monitor``: a small dense
    decoder with a 1k-token ring cache (the edge memory budget), for a
    dense or a hybrid server, as in the reference."""
    m = cfg.monitor
    if cfg.family not in ("dense", "hybrid"):
        raise NotImplementedError(
            f"edge tower for family {cfg.family!r} is not ported yet: see "
            "ROADMAP.md queue 1, item 7 (other families)")
    return ArchConfig(
        name=f"{cfg.name}-edge", family="dense", citation="edge tower (paper U)",
        n_layers=m.n_layers, d_model=m.d_model, n_heads=m.n_heads,
        n_kv_heads=m.n_heads, d_ff=m.d_ff, vocab_size=cfg.vocab_size,
        n_codebooks=cfg.n_codebooks, tie_embeddings=True,
        sliding_window=1024,
        dtype=cfg.dtype, param_dtype=cfg.param_dtype, remat=False,
        monitor=m,
    )


def _inv_softplus(y: float) -> float:
    return float(np.log(np.expm1(y))) if y < 20 else float(y)


class UHead(nn.Module):
    """Truncated-basis monitor head: u = sum_i a_i tanh(w_feat h)_i + t."""

    def __init__(self, d_model: int, n_features: int, device=None):
        super().__init__()
        self.w_feat = Linear(d_model, n_features, device=device)
        self.a = param((n_features,), torch.float32, device)
        self.raw_t = param((), torch.float32, device)

    def init_(self, gen: torch.Generator, t_init: float):
        self.w_feat.init_(gen)
        normal_(self.a, gen, 0.1)
        self.raw_t.fill_(_inv_softplus(t_init))


class CollabLM(nn.Module):
    """``{server, v_head, edge, u_head}``: the deployed system
    (``init_collab_lm``'s layout) on ``device`` (``None``: the card; raises
    when there is none).  The heads stay f32."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        m = cfg.monitor
        device = resolve_device(device)
        self.server = model_api.new_model(cfg, device)
        self.v_head = Linear(cfg.d_model, 1, bias=True, device=device)
        self.edge = model_api.new_model(edge_arch(cfg), device)
        self.u_head = UHead(m.d_model, m.n_features, device)

    def init_(self, gen: torch.Generator, cfg: ArchConfig):
        self.server.init_(gen)
        self.v_head.init_(gen)
        self.edge.init_(gen)
        self.u_head.init_(gen, cfg.monitor.t_init)


def init_collab_lm(cfg: ArchConfig, gen: torch.Generator,
                   device=None) -> CollabLM:
    """Random weights drawn from ``gen`` directly on ``device`` (``None``:
    the card), with the
    reference's distributions (the reference's ``jax.random`` draws differ:
    to compare the two, carry the reference's weights across with
    ``repro_torch.bridge``)."""
    model = CollabLM(cfg, device)
    model.init_(gen, cfg)
    return model


def monitor_score(model: CollabLM, cfg: ArchConfig, batch) -> torch.Tensor:
    """Edge-only path (ref :174): u(x) per position, (B, S) f32, from the
    edge tower's hidden states and the Eq.-8 truncated-basis head."""
    m = cfg.monitor
    eout = model_api.forward(model.edge, edge_arch(cfg), batch,
                             with_logits=False)
    hd = model.u_head
    feats = torch.tanh(linear(hd.w_feat, eout["hidden"].float()))
    mask = (torch.arange(feats.shape[-1], device=feats.device)
            < m.n_features).float()
    return feats @ (hd.a * mask) + softplus(hd.raw_t)


def corrector_score(model: CollabLM, cfg: ArchConfig,
                    server_out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """v(x) per position from the server's hidden states (ref :189)."""
    return linear(model.v_head, server_out["hidden"].float())[..., 0]


def collab_forward(model: CollabLM, cfg: ArchConfig,
                   batch) -> Dict[str, torch.Tensor]:
    """Training-time forward of the whole collaborative system (ref :196):
    the server's logits and corrector v, the edge's monitor u, and
    ``fhat = u - s * sigma(v)`` with the monitor config's ``s``."""
    m = cfg.monitor
    s = m.s
    server_out = model_api.forward(model.server, cfg, batch)
    u = monitor_score(model, cfg, batch)
    v = corrector_score(model, cfg, server_out)
    corr = s * sigma(v, m.sigma)
    return {"u": u, "v": v, "fhat": u - corr, "corr": corr,
            "logits": server_out["logits"],
            "aux_loss": server_out["aux_loss"],
            "t": softplus(model.u_head.raw_t)}
