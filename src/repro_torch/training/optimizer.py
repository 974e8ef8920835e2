"""AdamW and SGD with global-norm clipping (``training/optimizer.py``),
over ``torch._foreach_*`` kernels.

The reference's optimizers return new parameter trees; these update the
parameters and their state in place, which saves a copy of every
parameter and moment per step.  State lists line up with the parameter
list given to ``init``.

Where the config's ``param_dtype`` is f32 (``keeps_masters``), a
parameter stored narrower than f32 (the port keeps the projection and
embedding weights in the compute dtype, ``models/base.py``) gets an f32
master copy in the state: the update runs on the master exactly as the
reference runs it on its f32 parameter, and the stored weight becomes
``master.to(storage dtype)``, the value the reference's per-use cast
gives.  Where ``param_dtype`` is bf16 the reference's parameter is bf16
itself, and so is the port's: the update runs as the reference's
``(p.astype(f32) - lr * step).astype(p.dtype)``, with no master (12
bytes a trained parameter instead of 16).  Gradients are cast to f32
before the clip norm, as the reference's ``gf`` is.  The update walks
the parameters in chunks of at most ``CHUNK_ELEMS`` elements, which
bounds its f32 temporaries.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Union

import torch
from torch.profiler import record_function

CHUNK_ELEMS = 1 << 28  # 1 GiB of f32 per temporary list

Lr = Union[float, Callable[[torch.Tensor], torch.Tensor]]


@dataclass
class OptState:
    count: int                             # steps taken
    m: List[torch.Tensor]                  # f32 first moments / momenta
    v: Optional[List[torch.Tensor]]        # f32 second moments (AdamW)
    master: List[Optional[torch.Tensor]]   # f32 master, or None if f32


def keeps_masters(cfg) -> bool:
    """Whether a model of ``cfg`` trains with f32 masters: where its
    ``param_dtype`` is f32, as the reference's parameters then are."""
    return cfg.param_dtype == "float32"


def _masters(params: Sequence[torch.Tensor],
             masters: bool) -> List[Optional[torch.Tensor]]:
    return [p.detach().float().clone()
            if masters and p.dtype != torch.float32 else None
            for p in params]


def _zeros(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [torch.zeros_like(p, dtype=torch.float32) for p in params]


def _lr(lr: Lr, count: int) -> float:
    return float(lr(torch.tensor(count)) if callable(lr) else lr)


def _chunks(params: Sequence[torch.Tensor]):
    """Index lists of consecutive parameters, each under CHUNK_ELEMS
    elements (a larger parameter gets a chunk of its own)."""
    out, cur, n = [], [], 0
    for i, p in enumerate(params):
        if cur and n + p.numel() > CHUNK_ELEMS:
            out.append(cur)
            cur, n = [], 0
        cur.append(i)
        n += p.numel()
    if cur:
        out.append(cur)
    return out


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares of every gradient, in f32, + 1e-12)."""
    norms = torch._foreach_norm(list(grads), 2, dtype=torch.float32)
    return torch.sqrt(torch.stack(norms).square().sum() + 1e-12)


def _targets(params, state: OptState, idx) -> List[torch.Tensor]:
    """The f32 tensors the update runs on: the master, the parameter
    itself where it is f32, else a temporary f32 copy of it."""
    return [state.master[i] if state.master[i] is not None
            else params[i].data if params[i].dtype == torch.float32
            else params[i].data.float() for i in idx]


def _write_back(params, idx, targets) -> None:
    """Stored weights of the parameters narrower than f32: the updated f32
    value cast to the storage dtype."""
    pairs = [(params[i].data, w) for i, w in zip(idx, targets)
             if params[i].dtype != torch.float32]
    if pairs:
        torch._foreach_copy_([p for p, _ in pairs], [w for _, w in pairs])


@dataclass(frozen=True)
class AdamW:
    lr: Lr = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 1.0

    def init(self, params: Sequence[torch.Tensor], *,
             masters: bool = True) -> OptState:
        """``masters``: keep f32 masters of the narrower parameters
        (``keeps_masters(cfg)``)."""
        return OptState(count=0, m=_zeros(params), v=_zeros(params),
                        master=_masters(params, masters))

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: OptState,
               params: Sequence[torch.Tensor]) -> torch.Tensor:
        """One step in place; returns the gradients' global norm (before
        clipping), an f32 scalar on the parameters' device.  A profiler
        sees it as the range ``adamw_update``."""
        with record_function("adamw_update"):
            gnorm = global_norm(grads)
            scale = (torch.clamp(self.clip_norm / gnorm, max=1.0)
                     if self.clip_norm else None)
            state.count += 1
            lr = _lr(self.lr, state.count)
            f32 = torch.float32
            bc1 = float(1.0 - torch.tensor(self.b1, dtype=f32) ** state.count)
            bc2 = float(1.0 - torch.tensor(self.b2, dtype=f32) ** state.count)
            for idx in _chunks(params):
                g = [grads[i].float() for i in idx]
                if scale is not None:
                    g = torch._foreach_mul(g, scale)
                m = [state.m[i] for i in idx]
                v = [state.v[i] for i in idx]
                torch._foreach_mul_(m, self.b1)
                torch._foreach_add_(m, g, alpha=1 - self.b1)
                torch._foreach_mul_(v, self.b2)
                torch._foreach_addcmul_(v, g, g, value=1 - self.b2)
                del g
                step = torch._foreach_div(m, bc1)
                den = torch._foreach_div(v, bc2)
                torch._foreach_sqrt_(den)
                torch._foreach_add_(den, self.eps)
                torch._foreach_div_(step, den)
                del den
                w = _targets(params, state, idx)
                if self.weight_decay:
                    torch._foreach_add_(step, w, alpha=self.weight_decay)
                torch._foreach_add_(w, step, alpha=-lr)
                del step
                _write_back(params, idx, w)
            return gnorm


@dataclass(frozen=True)
class SGD:
    lr: Lr = 1e-2
    momentum: float = 0.9

    def init(self, params: Sequence[torch.Tensor], *,
             masters: bool = True) -> OptState:
        return OptState(count=0, m=_zeros(params), v=None,
                        master=_masters(params, masters))

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: OptState,
               params: Sequence[torch.Tensor]) -> torch.Tensor:
        """m = momentum * m + g; p -= lr * m.  Returns the global norm of
        the (unclipped) gradients."""
        gnorm = global_norm(grads)
        state.count += 1
        lr = _lr(self.lr, state.count)
        for idx in _chunks(params):
            m = [state.m[i] for i in idx]
            torch._foreach_mul_(m, self.momentum)
            torch._foreach_add_(m, [grads[i].float() for i in idx])
            w = _targets(params, state, idx)
            torch._foreach_add_(w, m, alpha=-lr)
            _write_back(params, idx, w)
        return gnorm
