"""The paper's decomposition ``f_hat = u - s * sigma(v)``
(``core/decomposition.py``), in its two forms:

1. Paper scale (§4): V is a small FC net (``MLP``) and the monitor u is
   either the truncated basis of V's penultimate features (``truncated``,
   Eq. 8), the explicit cosine basis (``cosine``, §4.1) or a separate
   small FC net (``independent``, the appendix).  ``PaperDecomposition``
   holds the parameters, ``paper_forward`` computes.
2. LM scale: the server backbone with a scalar corrector head, and a
   small edge tower with the truncated-basis monitor head (``CollabLM``).

Safety is structural in both: the corrector -s*sigma(v) is negative, so
fhat <= u always.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

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


def sigma_inv(y: torch.Tensor, kind: str = "sigmoid") -> torch.Tensor:
    y = torch.clamp(y, 1e-7, 1 - 1e-7)
    if kind == "sigmoid":
        return torch.log(y) - torch.log1p(-y)
    if kind == "tanh01":
        return torch.atanh(2.0 * y - 1.0)
    raise ValueError(kind)


def _inv_softplus(y: float) -> float:
    return float(np.log(np.expm1(y))) if y < 20 else float(y)


# ---------------------------------------------------------------------------
# Paper scale
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """The reference's ``init_mlp`` tree: layers ``l0 .. l{k}``, each a
    ``Linear`` with ``w`` (d_in, d_out) and ``b``; tanh between them."""

    def __init__(self, dims: Sequence[int], device=None):
        super().__init__()
        self.dims = tuple(dims)
        for i in range(len(dims) - 1):
            self.add_module(f"l{i}", Linear(dims[i], dims[i + 1], bias=True,
                                            device=device))

    def layers(self):
        return [getattr(self, f"l{i}") for i in range(len(self.dims) - 1)]

    def init_(self, gen: torch.Generator):
        """normal(0, 1/sqrt(d_in)) weights, zero biases."""
        for layer in self.layers():
            layer.init_(gen, 1.0 / math.sqrt(layer.w.shape[0]))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return mlp_forward(self, x)


def mlp_forward(p: MLP, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scalar output (B,), penultimate features (B, n_basis))."""
    layers = p.layers()
    h = x
    for layer in layers[:-1]:
        h = torch.tanh(linear(layer, h))
    return linear(layers[-1], h)[..., 0], h


def cosine_basis(x: torch.Tensor, n_modes: int) -> torch.Tensor:
    """phi_i(x) = cos(i x), i = 1..n_modes; x: (B,) or (B, d) (its first
    column) -> (B, n_modes)."""
    xs = x if x.dim() == 1 else x[..., 0]
    i = torch.arange(1, n_modes + 1, dtype=torch.float32, device=x.device)
    return torch.cos(xs[:, None] * i[None, :])


U_MODES = ("truncated", "cosine", "independent")


class PaperDecomposition(nn.Module):
    """``init_paper_decomposition``'s tree: ``v`` (the server net
    FC(in_dim, *hidden, 1)) and either ``a`` (the monitor's basis
    coefficients: V's ``n_basis`` penultimate features, or ``n_modes``
    cosines) or ``u_net`` (an independent FC net, ``u_dims``), with
    ``raw_t`` (t = softplus(raw_t)).  f32 throughout."""

    def __init__(self, cfg, *, u_mode: str = "truncated", u_dims=None,
                 n_modes: int = 0, device=None):
        super().__init__()
        if u_mode not in U_MODES:
            raise ValueError(f"u_mode {u_mode!r} not in {U_MODES}")
        device = resolve_device(device)
        self.u_mode = u_mode
        self.v = MLP((cfg.in_dim,) + tuple(cfg.hidden) + (1,), device)
        if u_mode == "independent":
            self.u_net = MLP(tuple(u_dims or (cfg.in_dim, 10, 1)), device)
        else:
            n_basis = n_modes if u_mode == "cosine" else cfg.n_basis
            self.a = param((n_basis,), torch.float32, device)
        self.raw_t = param((), torch.float32, device)

    def init_(self, gen: torch.Generator, cfg):
        self.v.init_(gen)
        if self.u_mode == "independent":
            self.u_net.init_(gen)
        else:
            normal_(self.a, gen, 0.1)
        self.raw_t.fill_(_inv_softplus(cfg.t_init))


def init_paper_decomposition(cfg, gen: torch.Generator, *,
                             u_mode: str = "truncated", u_dims=None,
                             n_modes: int = 0,
                             device=None) -> PaperDecomposition:
    """cfg: ``PaperMLPConfig``.  Weights drawn from ``gen`` (a generator
    on ``device``; ``None``: the card) with the reference's distributions:
    std 1/sqrt(d_in), zero biases, ``a ~ 0.1 N(0, 1)``,
    ``raw_t = inv_softplus(t_init)``.  To compare with the reference, carry
    its weights across with ``bridge.paper_from_numpy``."""
    model = PaperDecomposition(cfg, u_mode=u_mode, u_dims=u_dims,
                               n_modes=n_modes, device=device)
    model.init_(gen, cfg)
    return model


def paper_forward(p: PaperDecomposition, x: torch.Tensor, cfg, *,
                  u_mode: str = "truncated", s: Optional[float] = None,
                  monitor_n: Optional[int] = None,
                  sigma_kind: str = "sigmoid") -> Dict[str, torch.Tensor]:
    """The collaborative forward at paper scale: u, v, corr = s sigma(v),
    fhat = u - corr and t.  Only the first ``monitor_n`` (default
    ``cfg.monitor_n``) basis functions reach the device."""
    s = cfg.s if s is None else s
    n = cfg.monitor_n if monitor_n is None else monitor_n
    v_out, phi = mlp_forward(p.v, x)
    t = softplus(p.raw_t)
    if u_mode == "independent":
        u = mlp_forward(p.u_net, x)[0] + t
    else:
        k = p.a.shape[0]
        basis = cosine_basis(x, k) if u_mode == "cosine" else phi
        mask = (torch.arange(k, device=x.device) < n).float()
        u = basis @ (p.a * mask) + t
    corr = s * sigma(v_out, sigma_kind)
    return {"u": u, "v": v_out, "corr": corr, "fhat": u - corr, "t": t}


# ---------------------------------------------------------------------------
# LM scale
# ---------------------------------------------------------------------------


def edge_arch(cfg: ArchConfig) -> ArchConfig:
    """The edge tower's config, derived from ``cfg.monitor``: a small dense
    decoder with a 1k-token ring cache (the edge memory budget), as in the
    reference; an audio server's edge keeps the codebook embeddings, so
    it reads the same (B, S, K) token stream."""
    m = cfg.monitor
    fam = "audio" if cfg.family == "audio" else "dense"
    return ArchConfig(
        name=f"{cfg.name}-edge", family=fam, citation="edge tower (paper U)",
        n_layers=m.n_layers, d_model=m.d_model, n_heads=m.n_heads,
        n_kv_heads=m.n_heads, d_ff=m.d_ff, vocab_size=cfg.vocab_size,
        n_codebooks=cfg.n_codebooks, tie_embeddings=True,
        sliding_window=1024,
        dtype=cfg.dtype, param_dtype=cfg.param_dtype, remat=False,
        monitor=m,
    )


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
                   device=None, device_mesh=None) -> CollabLM:
    """Random weights drawn from ``gen`` directly on ``device`` (``None``:
    the card), with the
    reference's distributions (the reference's ``jax.random`` draws differ:
    to compare the two, carry the reference's weights across with
    ``repro_torch.bridge``).  With a ``device_mesh`` every parameter is
    placed by the partition rules as it is drawn, and ``device`` holds
    this rank's blocks and one whole leaf at a time
    (``distributed.sharding.init_placed``): the weights are the unplaced
    init's."""
    if device_mesh is None:
        model = CollabLM(cfg, device)
        model.init_(gen, cfg)
        return model
    from repro_torch.distributed.sharding import init_placed
    model = CollabLM(cfg, "meta")
    init_placed(model, lambda: model.init_(gen, cfg), resolve_device(device),
                device_mesh)
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
    the server's logits (and MTP logits, where it has the head) and
    corrector v, the edge's monitor u, and ``fhat = u - s * sigma(v)``
    with the monitor config's ``s``."""
    m = cfg.monitor
    s = m.s
    server_out = model_api.forward(model.server, cfg, batch)
    u = monitor_score(model, cfg, batch)
    v = corrector_score(model, cfg, server_out)
    corr = s * sigma(v, m.sigma)
    return {"u": u, "v": v, "fhat": u - corr, "corr": corr,
            "logits": server_out["logits"],
            "aux_loss": server_out["aux_loss"],
            "mtp_logits": server_out.get("mtp_logits"),
            "t": softplus(model.u_head.raw_t)}
