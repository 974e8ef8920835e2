"""Training loop of the collaborative LM (``training/loop.py``).

``make_train_step`` builds the step the reference jit-compiles:
``collab_forward`` -> ``collab_lm_loss`` -> gradients -> optimizer update.
Here it runs eagerly and updates the model and the optimizer state in
place.  ``train_collab_lm`` runs it end to end; it takes a
``torch.Generator`` where the reference takes a key, and an explicit
device (``None``: the card).  The paper-scale ``train_paper`` comes with a
later slice (ROADMAP queue 1, item 3).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.decomposition import (CollabLM, collab_forward,
                                            init_collab_lm)
from repro_torch.core.losses import collab_lm_loss
from repro_torch.nn.module import resolve_device
from repro_torch.training.optimizer import AdamW, OptState


def trainable(model: torch.nn.Module) -> List[torch.nn.Parameter]:
    """Switch gradients on for every parameter of ``model`` (the port
    makes them gradient-free for serving) and return them in the fixed
    order that optimizer states follow."""
    model.requires_grad_(True)
    return list(model.parameters())


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(cfg: ArchConfig, opt, *, monitor_weight: float = 1.0,
                    safety_weight: float = 10.0) -> Callable:
    """(model, opt_state, batch) -> metrics: one step in place.  The model
    must be ``trainable`` and ``opt_state`` made by ``opt.init`` from its
    parameters; batch holds tensors on the model's device.  Metrics are
    0-d tensors: the loss parts and ``grad_norm``."""

    def step(model: CollabLM, opt_state: OptState,
             batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        params = list(model.parameters())
        for p in params:
            p.grad = None
        out = collab_forward(model, cfg, batch)
        parts = collab_lm_loss(out, batch, monitor_weight=monitor_weight,
                               safety_weight=safety_weight)
        parts["total"].backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        parts = {k: v.detach() for k, v in parts.items()}
        parts["grad_norm"] = opt.update(grads, opt_state, params)
        return parts

    return step


def train_collab_lm(gen: torch.Generator, cfg: ArchConfig,
                    batches: Iterator[Dict[str, np.ndarray]], *, steps: int,
                    lr: float = 3e-4, log_every: int = 10,
                    monitor_weight: float = 1.0, safety_weight: float = 10.0,
                    log_fn: Callable = print, device=None
                    ) -> Tuple[CollabLM, list]:
    """Initialise the collaborative LM from ``gen`` (a generator on
    ``device``) on ``device`` (``None``: the card; raises without one),
    train it ``steps`` AdamW steps on ``batches`` (numpy, e.g.
    ``data.tokens.lm_batches``), and return (model, history).  A history
    record, every ``log_every`` steps and at the last, holds the step's
    metrics as floats, ``step`` and ``wall_s`` since the start."""
    device = resolve_device(device)
    model = init_collab_lm(cfg, gen, device)
    params = trainable(model)
    opt = AdamW(lr=lr)
    opt_state = opt.init(params)
    step = make_train_step(cfg, opt, monitor_weight=monitor_weight,
                           safety_weight=safety_weight)
    history = []
    t0 = time.time()
    for i in range(steps):
        m = step(model, opt_state, to_device(next(batches), device))
        if i % log_every == 0 or i == steps - 1:
            rec = {k: float(v) for k, v in m.items()}
            rec["step"], rec["wall_s"] = i, time.time() - t0
            history.append(rec)
            log_fn(f"step {i:5d}  loss {rec['total']:.4f}  lm {rec['lm']:.4f}"
                   f"  monitor {rec['monitor']:.4f}  safety "
                   f"{rec['safety']:.5f}")
    return model, history
