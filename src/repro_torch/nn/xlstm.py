"""xLSTM cells (``nn/xlstm.py``, arXiv:2405.04517): the mLSTM (matrix
memory) in its parallel form for training and prefill and its recurrent
form for decode, and the sLSTM (scalar memory with a hidden-to-hidden
recurrence), one time step at a time.  Gate and state math in f32 with
the paper's max-stabiliser, as the reference.

The reference has no Pallas kernel here, so neither has the port: tensor
ops, and the sLSTM scan a Python loop over time (eager on the card,
launch-bound; ``slstm_scan`` folds the four recurrent products of a step
into one).  Decode writes the states in place; rows with ``active[b] ==
False`` keep theirs bit-unchanged.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import (batch_local, heads_local,
                                              is_dtensor, merge_heads,
                                              model_region, split_heads)
from repro_torch.nn.module import Linear, linear, normal_, param

STATE_NEG = -1e30  # the stabiliser's start, as the reference's


class MLSTMState(NamedTuple):
    C: torch.Tensor  # (L, B, H, P, P) matrix memory in a model cache
    n: torch.Tensor  # (L, B, H, P) normaliser
    m: torch.Tensor  # (L, B, H) stabiliser


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (L, B, d) in a model cache
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor


class MLSTM(nn.Module):
    """``wq``, ``wk``, ``wv`` and ``w_out`` are stored in the compute
    dtype (the reference casts them on every use); the gate projections
    ``w_i``, ``w_f`` (to one value a head) are f32, ``w_o`` and
    ``norm_scale`` stay in ``param_dtype``: the reference reads those
    three in f32."""

    def __init__(self, d_model: int, n_heads: int, *, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        d = d_model
        self.wq = Linear(d, d, dtype=dtype, device=device)
        self.wk = Linear(d, d, dtype=dtype, device=device)
        self.wv = Linear(d, d, dtype=dtype, device=device)
        self.w_i = Linear(d, n_heads, bias=True, device=device)
        self.w_f = Linear(d, n_heads, bias=True, device=device)
        self.w_o = Linear(d, d, bias=True, dtype=param_dtype, device=device)
        self.w_out = Linear(d, d, dtype=dtype, device=device)
        self.norm_scale = param((d,), param_dtype, device)

    def init_(self, gen: torch.Generator):
        for lin in (self.wq, self.wk, self.wv, self.w_i, self.w_f, self.w_o,
                    self.w_out):
            lin.init_(gen)
        self.norm_scale.fill_(1.0)


def _f32(p: Linear, x: torch.Tensor) -> torch.Tensor:
    return linear(p, x, compute_dtype=torch.float32)


def mlstm_parallel(p: MLSTM, x: torch.Tensor, n_heads: int,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d): the parallel (quadratic) form (ref :53),
    a decay matrix D[t, s] = F_t - F_s + i_s over s <= t, stabilised by
    its row maximum."""
    B, S, d = x.shape
    H, P = n_heads, d // n_heads

    def proj(w):
        return split_heads(linear(w, x, compute_dtype=compute_dtype), H,
                           P).float()

    q, k, v = proj(p.wq), proj(p.wk), proj(p.wv)
    xf = x.float()
    it = _f32(p.w_i, xf)                                   # (B, S, H)
    # on a DeviceMesh, a region of each rank's rows: DTensor has no rule
    # for log_sigmoid's backward, nor on some versions for the flip in
    # cumsum's
    cum = batch_local(lambda f: torch.cumsum(F.logsigmoid(f), dim=1),
                      _f32(p.w_f, xf))

    def heads(q, k, v, it, cum):
        dt = cum[:, :, None, :] - cum[:, None, :, :] + it[:, None, :, :]
        tril = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        dt = torch.where(tril[None, :, :, None], dt, float("-inf"))
        m = torch.amax(dt, dim=2)                          # (B, S, H)
        dm = torch.exp(dt - m[:, :, None, :])
        a = torch.einsum("bthp,bshp->btsh", q, k) / math.sqrt(P)
        sm = a * dm
        num = torch.einsum("btsh,bshp->bthp", sm, v)
        den = torch.maximum(torch.abs(sm.sum(dim=2)), torch.exp(-m))
        return num / den[..., None]

    # on a DeviceMesh, a region of each rank's rows and heads
    h = heads_local(heads, q, k, v, it, cum)
    o = torch.sigmoid(_f32(p.w_o, xf))
    y = merge_heads(h) * o * p.norm_scale.float()
    return linear(p.w_out, y.to(compute_dtype), compute_dtype=compute_dtype)


def _commit(state, new, active: Optional[torch.Tensor]) -> None:
    """state[i] <- new[i] leaf by leaf, in place, on the rows where
    ``active`` (every row when None); other rows keep theirs bit-for-bit."""
    for old, val in zip(state, new):
        if active is not None:
            keep = active.reshape((-1,) + (1,) * (val.dim() - 1))
            val = torch.where(keep, val, old)
        old.copy_(val)


def mlstm_decode(p: MLSTM, x: torch.Tensor, st: MLSTMState, n_heads: int,
                 compute_dtype=torch.bfloat16,
                 active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, d), one token a row; ``st``: the layer's state (B, ...),
    updated in place on the ``active`` rows (ref :86).  Returns (B, d)."""
    H, P = n_heads, x.shape[-1] // n_heads

    def proj(w):
        return split_heads(linear(w, x, compute_dtype=compute_dtype), H,
                           P).float()

    q, k, v = proj(p.wq), proj(p.wk), proj(p.wv)
    xf = x.float()
    it = _f32(p.w_i, xf)                                   # (B, H)
    ft = _f32(p.w_f, xf)
    # on a DeviceMesh, a region of each rank's rows and heads
    h, C, n, m_new = heads_local(_mlstm_cell, q, k, v, it, ft, st.C, st.n,
                                 st.m, dim=1, outs=4)
    o = torch.sigmoid(_f32(p.w_o, xf))
    y = merge_heads(h) * o * p.norm_scale.float()
    _commit(st, (C, n, m_new), active)
    return linear(p.w_out, y.to(compute_dtype), compute_dtype=compute_dtype)


def _mlstm_cell(q, k, v, it, ft, C, n, m):
    """One mLSTM update per (row, head), f32: (h, C, n, m) from the
    previous (C, n, m) and the step's q, k, v (B, H, P) and gate
    pre-activations it, ft (B, H)."""
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    fp = torch.exp(logf + m - m_new)
    ip = torch.exp(it - m_new)
    C = fp[..., None, None] * C + ip[..., None, None] * (
        v[..., :, None] * k[..., None, :])                 # v k^T
    n = fp[..., None] * n + ip[..., None] * k
    qs = q / math.sqrt(q.shape[-1])
    num = torch.einsum("bhvp,bhp->bhv", C, qs)
    den = torch.maximum(torch.abs(torch.einsum("bhp,bhp->bh", n, qs)),
                        torch.exp(-m_new))
    return num / den[..., None], C, n, m_new


def init_mlstm_state(batch: int, d_model: int, n_heads: int, *,
                     n_layers: int, device) -> MLSTMState:
    P = d_model // n_heads
    z = dict(dtype=torch.float32, device=device)
    return MLSTMState(
        C=torch.zeros((n_layers, batch, n_heads, P, P), **z),
        n=torch.zeros((n_layers, batch, n_heads, P), **z),
        m=torch.full((n_layers, batch, n_heads), STATE_NEG, **z))


class SLSTM(nn.Module):
    """Input projections ``w_{z,i,f,o}`` (d -> d, with bias) and the
    block-diagonal recurrent weights ``r_{z,i,f,o}`` (H, P, P), all f32;
    ``norm_scale`` in ``param_dtype``."""

    def __init__(self, d_model: int, n_heads: int, *,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        d, P = d_model, d_model // n_heads
        for g in "zifo":
            setattr(self, f"w_{g}", Linear(d, d, bias=True, device=device))
        for g in "zifo":
            setattr(self, f"r_{g}",
                    param((n_heads, P, P), torch.float32, device))
        self.norm_scale = param((d,), param_dtype, device)

    def init_(self, gen: torch.Generator):
        for g in "zifo":
            getattr(self, f"w_{g}").init_(gen)
        P = self.r_z.shape[-1]
        for g in "zifo":
            normal_(getattr(self, f"r_{g}"), gen, 1.0 / math.sqrt(P))
        self.norm_scale.fill_(1.0)

    def recurrent(self) -> torch.Tensor:
        """(4, H, P, P): r_z, r_i, r_f, r_o stacked."""
        return torch.stack([self.r_z, self.r_i, self.r_f, self.r_o])


def _cell(gates_x: torch.Tensor, r: torch.Tensor, c, n, h, m):
    """One sLSTM update in f32 from the input pre-activations ``gates_x``
    (4, B, d: z, i, f, o) and the previous (c, n, h, m); the four
    recurrent products R h_{t-1} in one batched product.  Returns (c, n,
    h, m)."""
    B, d = h.shape
    H, P = r.shape[1], r.shape[2]
    pre = gates_x + torch.einsum("bhp,ghpq->gbhq", h.reshape(B, H, P),
                                 r).reshape(4, B, d)
    zt, it, ft = torch.tanh(pre[0]), pre[1], pre[2]
    ot = torch.sigmoid(pre[3])
    lfm = F.logsigmoid(ft) + m
    m_new = torch.maximum(lfm, it)
    ip = torch.exp(it - m_new)
    fp = torch.exp(lfm - m_new)
    c = fp * c + ip * zt
    n = torch.clamp(fp * n + ip, min=1e-6)
    return c, n, ot * (c / n), m_new


def slstm_step(p: SLSTM, x_t: torch.Tensor, st: SLSTMState, n_heads: int,
               active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One sLSTM step in f32 (ref :151).  x_t: (B, d); ``st``: the layer's
    state (B, d) each, updated in place on the ``active`` rows.  Returns
    h (B, d) f32, before ``norm_scale``."""
    xf = x_t.float()
    gates = torch.stack([_f32(getattr(p, f"w_{g}"), xf) for g in "zifo"])
    if is_dtensor(st.c):
        c, n, h, m = _cell_region(gates, p.recurrent(), st, n_heads)
    else:
        c, n, h, m = _cell(gates, p.recurrent(), st.c, st.n, st.h, st.m)
    _commit(st, (c, n, h, m), active)
    return h


def _cell_region(gates, r, st, n_heads: int):
    """``_cell`` on a DeviceMesh: batch rows over the data axes, each
    rank's heads over ``model`` where they divide it (its slice of d in
    the states and gates, its blocks of the recurrent weights), else
    every head on every rank."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.kernels.ops import model_size
    split = n_heads % model_size(st.c.device_mesh) == 0
    S1, S2 = (Shard(1), Shard(2)) if split else (Replicate(), Replicate())
    state = (True, S1)

    def body(g, rl, c, n, h, m):
        return _cell(g.transpose(0, 1), rl, c, n, h, m)

    return model_region(body, (gates.transpose(0, 1), r, *st),
                        ((True, S2), (False, S1)) + (state,) * 4,
                        (state,) * 4, st.c)


def slstm_scan(p: SLSTM, x: torch.Tensor, n_heads: int,
               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x: (B, S, d) -> y (B, S, d) in the compute dtype, from a zero state
    (ref ``slstm_scan`` :170): the input projections hoisted out of the
    loop as (B, S, d) products, then a Python loop over time carries the
    recurrence."""
    xf = x.float()
    gx = torch.stack([_f32(getattr(p, f"w_{g}"), xf) for g in "zifo"], 1)
    # on a DeviceMesh the loop runs on each rank's own rows
    y = batch_local(_slstm_loop, gx, p.recurrent()) * p.norm_scale.float()
    return y.to(compute_dtype)


def _slstm_loop(gx: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The recurrence over time from a zero state: gx (B, 4, S, d) input
    pre-activations, r (4, H, P, P) -> h (B, S, d) f32."""
    B, _, S, d = gx.shape
    gx = gx.transpose(0, 1)
    z = torch.zeros((B, d), dtype=torch.float32, device=gx.device)
    c, n, h = z, z, z
    m = torch.full((B, d), STATE_NEG, dtype=torch.float32, device=gx.device)
    hs = []
    for t in range(S):
        c, n, h, m = _cell(gx[:, :, t], r, c, n, h, m)
        hs.append(h)
    return torch.stack(hs, dim=1)


def init_slstm_state(batch: int, d_model: int, *, n_layers: int,
                     device) -> SLSTMState:
    z = dict(dtype=torch.float32, device=device)
    shape = (n_layers, batch, d_model)
    return SLSTMState(c=torch.zeros(shape, **z), n=torch.zeros(shape, **z),
                      h=torch.zeros(shape, **z),
                      m=torch.full(shape, STATE_NEG, **z))
