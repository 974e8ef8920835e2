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

On a DeviceMesh (DTensor parameters, ``distributed.sharding
.distribute_collab``) each moment and master lives in its
``opt_specs(zero1=...)`` placement, given to ``init``.  ``update``
redistributes each gradient to that placement (an all-reduce of a
replicated leaf's partial sums over the data ranks, or under ZeRO-1 a
reduce-scatter), runs the same arithmetic on the local blocks, and where
a parameter's placement differs from its moments' (ZeRO-1) all-gathers
the new value back.  ``global_norm`` is the norm over every block, a
block held whole on several ranks counted once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Union

import torch

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.observability.trace import span

CHUNK_ELEMS = 1 << 28  # 1 GiB of f32 per temporary list

Lr = Union[float, Callable[[torch.Tensor], torch.Tensor]]


@dataclass
class OptState:
    count: int                             # steps taken
    m: List[torch.Tensor]                  # f32 first moments / momenta
    v: Optional[List[torch.Tensor]]        # f32 second moments (AdamW)
    master: List[Optional[torch.Tensor]]   # f32 master, or None if f32
    # DTensor placements of the moments and masters (None: unplaced)
    placements: Optional[List[Any]] = None


def keeps_masters(cfg) -> bool:
    """Whether a model of ``cfg`` trains with f32 masters: where its
    ``param_dtype`` is f32, as the reference's parameters then are."""
    return cfg.param_dtype == "float32"


def _opt_view(p: torch.Tensor, pl) -> torch.Tensor:
    """``p`` in the moments' placement ``pl`` (itself when unplaced)."""
    if pl is None or tuple(pl) == tuple(p.placements):
        return p.detach()
    return p.detach().redistribute(p.device_mesh, pl)


def _masters(params: Sequence[torch.Tensor], masters: bool,
             pls) -> List[Optional[torch.Tensor]]:
    return [_opt_view(p, pl).float().clone()
            if masters and p.dtype != torch.float32 else None
            for p, pl in zip(params, pls)]


def _zeros(params: Sequence[torch.Tensor], pls) -> List[torch.Tensor]:
    out = []
    for p, pl in zip(params, pls):
        if pl is None:
            out.append(torch.zeros_like(p, dtype=torch.float32))
        else:
            from torch.distributed.tensor import zeros
            out.append(zeros(p.shape, dtype=torch.float32,
                             device_mesh=p.device_mesh, placements=pl))
    return out


def _placements(params, placements) -> List[Any]:
    """Per parameter: the moments' placement (a DTensor parameter's own by
    default), or None for a plain tensor."""
    if placements is None:
        return [tuple(p.placements) if is_dtensor(p) else None
                for p in params]
    return list(placements)


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
    """sqrt(sum of squares of every gradient, in f32, + 1e-12).  DTensor
    gradients (none partial: ``_Locals`` redistributes them first): the
    sum over every block, each summed over the mesh dims its leaf is
    split on, so a block held whole on several ranks counts once."""
    grads = list(grads)
    if not any(is_dtensor(g) for g in grads):
        norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
        return torch.sqrt(torch.stack(norms).square().sum() + 1e-12)
    mesh = grads[0].device_mesh
    norms = torch._foreach_norm([g.to_local() for g in grads], 2,
                                dtype=torch.float32)
    sq = torch.stack(norms).square()
    groups = {}
    for i, g in enumerate(grads):
        dims = tuple(d for d, pl in enumerate(g.placements)
                     if pl.is_shard() and mesh.size(d) > 1)
        groups.setdefault(dims, []).append(i)
    if list(groups) == [()]:
        return torch.sqrt(sq.sum() + 1e-12)
    import torch.distributed as dist
    total = None
    for dims, idx in sorted(groups.items()):
        part = sq[torch.tensor(idx, device=sq.device)].sum()
        for d in dims:
            dist.all_reduce(part, group=mesh.get_group(d))
        total = part if total is None else total + part
    return torch.sqrt(total + 1e-12)


class _Locals:
    """The tensors an update's arithmetic runs on: the parameters, their
    gradients and the state's moments and masters themselves, or, for
    DTensor parameters, the local blocks in the moments' placement (the
    gradients redistributed there first)."""

    def __init__(self, grads, state: OptState, params):
        self.params = list(params)
        self.placed = state.placements is not None
        if not self.placed:
            self.grads, self.m, self.v = list(grads), state.m, state.v
            self.master = state.master
            self.w = [p.data for p in self.params]
            self.norm = global_norm(self.grads)
            return
        pls = state.placements
        g = [gr.redistribute(gr.device_mesh, pl)
             for gr, pl in zip(grads, pls)]
        self.norm = global_norm(g)
        self.grads = [t.to_local() for t in g]
        self.m = [t.to_local() for t in state.m]
        self.v = None if state.v is None else [t.to_local()
                                                for t in state.v]
        self.master = [None if t is None else t.to_local()
                       for t in state.master]
        # a parameter placed as its moments updates its own block; else
        # (ZeRO-1) a copy of the block the moments' placement gives
        self.same = [tuple(p.placements) == tuple(pl)
                     for p, pl in zip(self.params, pls)]
        self.pls = pls
        self.w = [p.data.to_local() if same
                  else _opt_view(p.data, pl).to_local().clone()
                  for p, pl, same in zip(self.params, pls, self.same)]

    def targets(self, idx) -> List[torch.Tensor]:
        """The f32 tensors the update runs on: the master, the parameter
        itself where it is f32, else a temporary f32 copy of it."""
        return [self.master[i] if self.master[i] is not None
                else self.w[i] if self.w[i].dtype == torch.float32
                else self.w[i].float() for i in idx]

    def write_back(self, idx, targets) -> None:
        """Stored weights of the parameters narrower than f32: the updated
        f32 value cast to the storage dtype; under ZeRO-1 each parameter's
        new value all-gathered into its own placement."""
        pairs = [(self.w[i], w) for i, w in zip(idx, targets)
                 if self.w[i].dtype != torch.float32]
        if pairs:
            torch._foreach_copy_([p for p, _ in pairs], [w for _, w in pairs])
        if not self.placed:
            return
        from torch.distributed.tensor import DTensor
        for i in idx:
            if self.same[i]:
                continue
            p = self.params[i]
            new = DTensor.from_local(self.w[i], p.device_mesh, self.pls[i],
                                     run_check=False, shape=p.shape,
                                     stride=p.stride())
            p.data.to_local().copy_(
                new.redistribute(p.device_mesh, p.placements).to_local())


@dataclass(frozen=True)
class AdamW:
    lr: Lr = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 1.0

    def init(self, params: Sequence[torch.Tensor], *,
             masters: bool = True, placements=None) -> OptState:
        """``masters``: keep f32 masters of the narrower parameters
        (``keeps_masters(cfg)``).  ``placements``: per DTensor parameter,
        its moments' placement (``distribute_collab``'s result in
        parameter order; default: the parameter's own)."""
        pls = _placements(params, placements)
        placed = any(pl is not None for pl in pls)
        return OptState(count=0, m=_zeros(params, pls), v=_zeros(params, pls),
                        master=_masters(params, masters, pls),
                        placements=pls if placed else None)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: OptState,
               params: Sequence[torch.Tensor]) -> torch.Tensor:
        """One step in place; returns the gradients' global norm (before
        clipping), an f32 scalar on the parameters' device.  A profiler
        sees it as the range ``adamw_update``."""
        with span("adamw_update"):
            loc = _Locals(grads, state, params)
            gnorm = loc.norm
            scale = (torch.clamp(self.clip_norm / gnorm, max=1.0)
                     if self.clip_norm else None)
            state.count += 1
            lr = _lr(self.lr, state.count)
            f32 = torch.float32
            bc1 = float(1.0 - torch.tensor(self.b1, dtype=f32) ** state.count)
            bc2 = float(1.0 - torch.tensor(self.b2, dtype=f32) ** state.count)
            for idx in _chunks(loc.w):
                g = [loc.grads[i].float() for i in idx]
                if scale is not None:
                    g = torch._foreach_mul(g, scale)
                m = [loc.m[i] for i in idx]
                v = [loc.v[i] for i in idx]
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
                w = loc.targets(idx)
                if self.weight_decay:
                    torch._foreach_add_(step, w, alpha=self.weight_decay)
                torch._foreach_add_(w, step, alpha=-lr)
                del step
                loc.write_back(idx, w)
            return gnorm


@dataclass(frozen=True)
class SGD:
    lr: Lr = 1e-2
    momentum: float = 0.9

    def init(self, params: Sequence[torch.Tensor], *,
             masters: bool = True) -> OptState:
        pls = [None] * len(params)
        return OptState(count=0, m=_zeros(params, pls), v=None,
                        master=_masters(params, masters, pls))

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: OptState,
               params: Sequence[torch.Tensor]) -> torch.Tensor:
        """m = momentum * m + g; p -= lr * m.  Returns the global norm of
        the (unclipped) gradients."""
        loc = _Locals(grads, state, params)
        state.count += 1
        lr = _lr(self.lr, state.count)
        for idx in _chunks(loc.w):
            m = [loc.m[i] for i in idx]
            torch._foreach_mul_(m, self.momentum)
            torch._foreach_add_(m, [loc.grads[i].float() for i in idx])
            w = loc.targets(idx)
            torch._foreach_add_(w, m, alpha=-lr)
            loc.write_back(idx, w)
        return loc.norm
