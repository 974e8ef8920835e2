"""Step functions of the launchers (``launch/steps.py``).

Three steps per architecture, matching the reference's input-shape kinds:

  train_step    (train_4k)    : collaborative forward, loss, gradients,
                AdamW (in place: the model and the optimizer state)
  prefill_step  (prefill_32k) : collaborative forward (monitor and
                corrector scores)
  serve_step    (decode_32k)  : one new token against the caches: server
                decode and corrector, edge decode and monitor, the fused
                combine and the trigger mask

``monitor_step`` is the edge-only path (no server tower).  The reference
jit-compiles these and returns new caches; here they run eagerly and
update the caches in place (the returned dict still names them).  On the
card the serve step's decodes reach the ``decode_attention`` kernel
through ``decode_step``, its combine is one ``monitor_combine`` launch,
and train/prefill reach ``flash_attention`` (and ``ssd_scan`` on the
hybrid) through ``collab_forward``.  The reference's ``step_and_specs``
(shape-only inputs for its dry run) belongs with the dry run, which is not
ported (ROADMAP queue 1, item 9).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import decomposition as deco
from repro_torch.core.gating import masked_correction
from repro_torch.kernels import ops
from repro_torch.models import api as model_api
from repro_torch.nn.module import linear, softplus
from repro_torch.training.loop import make_train_step as _loop_train_step

EDGE_CACHE_LEN = 1024  # edge ring-buffer budget (device memory constraint)


def make_train_step(cfg: ArchConfig, opt) -> Callable:
    """(model, opt_state, batch) -> {"loss", "grad_norm"} (0-d tensors): one
    AdamW step in place on a ``trainable`` model."""
    step = _loop_train_step(cfg, opt)

    def train_step(model, opt_state, batch) -> Dict[str, torch.Tensor]:
        parts = step(model, opt_state, batch)
        return {"loss": parts["total"], "grad_norm": parts["grad_norm"]}

    return train_step


def make_prefill_step(cfg: ArchConfig) -> Callable:
    """(model, batch) -> logits, u, the gated fhat and the trigger rate."""
    m = cfg.monitor

    @torch.inference_mode()
    def prefill_step(model, batch) -> Dict[str, torch.Tensor]:
        out = deco.collab_forward(model, cfg, batch)
        fhat, mask = masked_correction(out["u"], out["corr"], m.threshold,
                                       m.trigger_margin)
        return {"logits": out["logits"], "u": out["u"], "fhat": fhat,
                "trigger_rate": mask.mean()}

    return prefill_step


def _edge_u(model, cfg: ArchConfig, hidden_t: torch.Tensor) -> torch.Tensor:
    hd = model.u_head
    feats = torch.tanh(linear(hd.w_feat, hidden_t.float()))
    return feats @ hd.a + softplus(hd.raw_t)


def make_serve_step(cfg: ArchConfig) -> Callable:
    """(model, server_cache, edge_cache, tokens (B,), pos) -> logits, u,
    fhat, mask and the two caches (updated in place).  The ungated step:
    the server decodes every token, and ``fhat = u - mask * s*sigmoid(v)``
    with ``mask = u > threshold - margin``, fused in one ``monitor_combine``
    call."""
    ecfg = deco.edge_arch(cfg)
    m = cfg.monitor

    @torch.inference_mode()
    def serve_step(model, server_cache, edge_cache, tokens,
                   pos) -> Dict[str, object]:
        logits, h = model_api.decode_step(model.server, cfg, server_cache,
                                          tokens, pos)
        v = linear(model.v_head, h.float())[..., 0]
        _, eh = model_api.decode_step(model.edge, ecfg, edge_cache, tokens,
                                      pos, with_logits=False)
        u = _edge_u(model, cfg, eh)
        fhat_all, mask, _ = ops.monitor_combine(
            u, v, u, s=m.s, threshold=m.threshold, margin=m.trigger_margin)
        return {"logits": logits, "u": u,
                "fhat": torch.where(mask > 0, fhat_all, u), "mask": mask,
                "server_cache": server_cache, "edge_cache": edge_cache}

    return serve_step


def make_monitor_step(cfg: ArchConfig) -> Callable:
    """Edge-only decode step (the device's always-on path): (model,
    edge_cache, tokens, pos) -> u and the edge cache (in place)."""
    ecfg = deco.edge_arch(cfg)

    @torch.inference_mode()
    def monitor_step(model, edge_cache, tokens, pos) -> Dict[str, object]:
        _, eh = model_api.decode_step(model.edge, ecfg, edge_cache, tokens,
                                      pos, with_logits=False)
        return {"u": _edge_u(model, cfg, eh), "edge_cache": edge_cache}

    return monitor_step
