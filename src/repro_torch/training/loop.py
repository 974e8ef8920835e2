"""Training loops (``training/loop.py``).

``make_train_step`` builds the step the reference jit-compiles:
``collab_forward`` -> ``collab_lm_loss`` -> gradients -> optimizer update.
Here it runs eagerly and updates the model and the optimizer state in
place.  ``train_collab_lm`` runs it end to end; it takes a
``torch.Generator`` where the reference takes a key, and an explicit
device (``None``: the card).  ``train_paper`` runs the paper-scale
experiments (small FC nets, Adam, the §4 recipe) through the step that
``make_paper_step`` builds.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.decomposition import (CollabLM, PaperDecomposition,
                                            _inv_softplus, collab_forward,
                                            init_collab_lm,
                                            init_paper_decomposition,
                                            paper_forward)
from repro_torch.core.losses import collab_lm_loss, paper_loss
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


# ---------------------------------------------------------------------------
# Paper-scale training (§4)
# ---------------------------------------------------------------------------

# a host sync (the loss as a float) every LOG_EVERY steps when logging
LOG_EVERY = 200


def make_paper_step(cfg, opt, *, u_mode: str, s: Optional[float] = None,
                    monitor_n: Optional[int] = None,
                    safety_weight: float = 0.0,
                    freeze_t: bool = False) -> Callable:
    """(model, opt_state, xb, fb) -> loss: one step of ``train_paper`` in
    place, with no host sync (the loss is a 0-d tensor on the model's
    device).  With ``freeze_t`` the gradient of ``raw_t`` is zeroed before
    the update, so t stays where it was pinned."""

    def step(model: PaperDecomposition, opt_state: OptState,
             xb: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
        params = list(model.parameters())
        for p in params:
            p.grad = None
        out = paper_forward(model, xb, cfg, u_mode=u_mode, s=s,
                            monitor_n=monitor_n)
        loss = paper_loss(out, fb, safety_weight=safety_weight)
        loss.backward()
        if freeze_t:
            model.raw_t.grad.zero_()
        opt.update([p.grad for p in params], opt_state, params)
        return loss.detach()

    return step


def paper_batches(n: int, *, steps: int, batch: int,
                  seed: int) -> np.ndarray:
    """(steps, batch) row indices, drawn from ``np.random.default_rng(seed)``
    one step at a time, exactly as the reference's loop draws them."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n, size=batch) for _ in range(steps)])


def train_paper(gen: torch.Generator, cfg, x: np.ndarray, f: np.ndarray, *,
                u_mode: str, s: Optional[float] = None,
                monitor_n: Optional[int] = None, n_modes: int = 0,
                u_dims=None, steps: int = 2000, lr: float = 1e-2,
                batch: int = 256, safety_weight: float = 0.0,
                freeze_t: Optional[float] = None, seed: int = 0,
                log_fn: Optional[Callable] = None, device=None
                ) -> Tuple[PaperDecomposition, Dict]:
    """Train fhat = u - s*sigma(v) end to end with Adam (paper §4.1) on
    ``device`` (``None``: the card; raises without one), from weights drawn
    from ``gen`` (a generator on ``device``).  ``freeze_t``: if given, t is
    pinned to this value (the Prop-2 calibration) instead of learned.

    x, f and every step's batch indices go to the device once, up front;
    a step makes no host sync, except one every ``LOG_EVERY`` steps when
    ``log_fn`` is given.  Returns (model, {"final_loss": float, "out":
    paper_forward over all of x})."""
    device = resolve_device(device)
    model = init_paper_decomposition(cfg, gen, u_mode=u_mode,
                                     n_modes=n_modes, u_dims=u_dims,
                                     device=device)
    if freeze_t is not None:
        model.raw_t.fill_(_inv_softplus(max(freeze_t, 1e-6)))
    params = trainable(model)
    opt = AdamW(lr=lr, clip_norm=0.0)
    opt_state = opt.init(params)
    step = make_paper_step(cfg, opt, u_mode=u_mode, s=s, monitor_n=monitor_n,
                           safety_weight=safety_weight,
                           freeze_t=freeze_t is not None)
    xd = torch.as_tensor(x, device=device)
    fd = torch.as_tensor(f, device=device)
    idx = torch.as_tensor(paper_batches(x.shape[0], steps=steps, batch=batch,
                                        seed=seed), device=device)
    loss = None
    for i in range(steps):
        loss = step(model, opt_state, xd[idx[i]], fd[idx[i]])
        if log_fn and i % LOG_EVERY == 0:
            log_fn(f"  paper-train step {i} loss {float(loss):.6f}")
    with torch.no_grad():
        out = paper_forward(model, xd, cfg, u_mode=u_mode, s=s,
                            monitor_n=monitor_n)
    return model, {"final_loss": float(loss), "out": out}
