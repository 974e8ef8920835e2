"""Mamba2 (SSD) block (``nn/ssm.py``): the chunked-scan prefill/training
forward and the recurrent decode step.

The projections are separate (w_z, w_x, w_B, w_C, w_dt, one depthwise
causal conv per stream), as in the reference.  They are stored in the
compute dtype, as the port stores every projection (``models/base.py``:
the reference casts them on each use, and training keeps f32 masters in
the optimizer); the conv weights, the norm scale and ``A_log``, ``D`` and
``dt_bias`` stay f32.  All recurrence math is f32.  The scan is
``kernels.ops.ssd_scan``: the plain chunked form for CPU tensors, the
Hopper kernel for CUDA ones.

Decode writes the layer's ``SSMCache`` in place, where the reference
returns a new one; rows with ``active[b] == False`` keep their state and
conv tails bit-unchanged.  On a DeviceMesh the recurrence runs in a
region of each rank's heads (``_step_region``): the state split on its
heads over ``model`` (``cache_specs(mode="time")`` splits the axis after
the batch), the conv tails whole there.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.distributed.sharding import (data_axes, is_dtensor,
                                              merge_heads, model_region,
                                              split_heads)
from repro_torch.kernels import ops
from repro_torch.nn.module import (Linear, linear, normal_, param,
                                   resolve_device, softplus)


class SSMCache(NamedTuple):
    h: torch.Tensor       # (..., B, H, P, N) recurrent state
    conv_x: torch.Tensor  # (..., B, conv_k - 1, d_in) conv tails per stream
    conv_B: torch.Tensor  # (..., B, conv_k - 1, N)
    conv_C: torch.Tensor  # (..., B, conv_k - 1, N)


def ssm_dims(d_model: int, expand: int, state: int, head_p: int = 64):
    d_in = expand * d_model
    n_heads = d_in // head_p
    return d_in, n_heads, head_p, state


class CausalConv(nn.Module):
    """Depthwise causal conv over the sequence: ``w`` (K, C), ``b`` (C,)."""

    def __init__(self, k: int, channels: int, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.w = param((k, channels), dtype, device)
        self.b = param((channels,), dtype, device)

    def init_(self, gen: torch.Generator):
        normal_(self.w, gen, 1.0 / math.sqrt(self.w.shape[0]))
        self.b.zero_()


class Mamba2(nn.Module):
    """The parameters of one Mamba2 block, under the leaf names of the
    reference's ``init_mamba2``; ``init_`` draws them with its
    distributions: normal(0, 1/sqrt(fan_in)) projections, normal(0,
    1/sqrt(K)) conv weights, zero conv biases, A_log = log(linspace(1, 16,
    H)), D = 1, dt_bias = 0, norm_scale = 1.  ``dtype``: the projections'
    storage (compute) dtype; ``param_dtype``: the convs' and the norm
    scale's."""

    def __init__(self, d_model: int, *, expand: int = 2, state: int = 64,
                 conv_k: int = 4, head_p: int = 64, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        d_in, H, P, N = ssm_dims(d_model, expand, state, head_p)
        w = dict(dtype=dtype, device=device)
        self.w_z = Linear(d_model, d_in, **w)
        self.w_x = Linear(d_model, d_in, **w)
        self.w_B = Linear(d_model, N, **w)
        self.w_C = Linear(d_model, N, **w)
        self.w_dt = Linear(d_model, H, **w)
        c = dict(dtype=param_dtype, device=device)
        self.conv_x = CausalConv(conv_k, d_in, **c)
        self.conv_B = CausalConv(conv_k, N, **c)
        self.conv_C = CausalConv(conv_k, N, **c)
        self.A_log = param((H,), torch.float32, device)
        self.D = param((H,), torch.float32, device)
        self.dt_bias = param((H,), torch.float32, device)
        self.norm_scale = param((d_in,), param_dtype, device)
        self.out_proj = Linear(d_in, d_model, **w)

    def init_(self, gen: torch.Generator):
        for lin in (self.w_z, self.w_x, self.w_B, self.w_C, self.w_dt):
            lin.init_(gen)
        for conv in (self.conv_x, self.conv_B, self.conv_C):
            conv.init_(gen)
        H = self.A_log.shape[0]
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, H)))
        self.D.fill_(1.0)
        self.dt_bias.zero_()
        self.norm_scale.fill_(1.0)
        self.out_proj.init_(gen)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, S, C), w: (K, C).  DTensors:
    ``_conv_region``."""
    if is_dtensor(x):
        return _conv_region(x, w, b)
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = sum(xp[:, i: i + S, :] * w[i][None, None, :] for i in range(K))
    return y + b[None, None, :]


def _conv_region(x, w, b):
    """The conv on a DeviceMesh, in a ``local_map`` region: each rank's
    rows, its channels where they are split over ``model`` (the weight
    and bias split alike), the weights' gradients partial over the data
    axes.  DTensor's own rule for the padding loses the mesh's dims on
    some PyTorch versions."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    names = list(mesh.mesh_dim_names)
    daxes = set(data_axes(mesh))
    xp, wp, bp, wg, bg = [], [], [], [], []
    for n, pl in zip(names, x.placements):
        rows = n in daxes and pl == Shard(0)
        chans = n == "model" and pl == Shard(2)
        xp.append(Shard(0) if rows else Shard(2) if chans else Replicate())
        wp.append(Shard(1) if chans else Replicate())
        bp.append(Shard(0) if chans else Replicate())
        wg.append(Partial() if rows else wp[-1])
        bg.append(Partial() if rows else bp[-1])
    return local_map(_causal_conv, out_placements=xp,
                     in_placements=(xp, wp, bp),
                     in_grad_placements=(xp, wg, bg), device_mesh=mesh,
                     redistribute_inputs=True)(x, w, b)


def _conv_silu(v: torch.Tensor, c: CausalConv) -> torch.Tensor:
    return F.silu(_causal_conv(v.float(), c.w.float(), c.b.float()))


def mamba2_prefill(p: Mamba2, x: torch.Tensor, *, expand: int, state: int,
                   conv_k: int, chunk: int = 128, head_p: int = 64,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x: (B, S, d_model) -> (B, S, d_model) in the compute dtype."""
    B, S, d = x.shape
    d_in, H, P, N = ssm_dims(d, expand, state, head_p)
    z = linear(p.w_z, x, compute_dtype=compute_dtype)
    xs = linear(p.w_x, x, compute_dtype=compute_dtype)
    Bs = linear(p.w_B, x, compute_dtype=compute_dtype)
    Cs = linear(p.w_C, x, compute_dtype=compute_dtype)
    dt = linear(p.w_dt, x, compute_dtype=compute_dtype)

    xi = split_heads(_conv_silu(xs, p.conv_x), H, P)
    Bm = _conv_silu(Bs, p.conv_B)
    Cm = _conv_silu(Cs, p.conv_C)
    dt = softplus(dt.float() + p.dt_bias[None, None, :])
    A = -torch.exp(p.A_log)
    y, _ = ops.ssd_scan(xi, dt, A, Bm, Cm, chunk=chunk)
    y = y + p.D[None, None, :, None] * xi
    y = merge_heads(y) * F.silu(z.float())
    y = y * p.norm_scale.float()[None, None, :]
    return linear(p.out_proj, y.to(compute_dtype),
                  compute_dtype=compute_dtype)


def _keep_inactive(new: torch.Tensor, old: torch.Tensor,
                   active: Optional[torch.Tensor]) -> torch.Tensor:
    if active is None:
        return new
    return torch.where(active.reshape((-1,) + (1,) * (new.dim() - 1)), new,
                       old)


def mamba2_decode(p: Mamba2, x: torch.Tensor, cache: SSMCache, *,
                  expand: int, state: int, conv_k: int, head_p: int = 64,
                  compute_dtype=torch.bfloat16,
                  active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, d_model), one token per row; ``cache``: this layer's state
    (B, H, P, N) and conv tails, updated in place; ``active``: (B,) bool,
    rows whose state commits (all when None).  Returns y (B, d_model)."""
    H = ssm_dims(x.shape[-1], expand, state, head_p)[1]
    z = linear(p.w_z, x, compute_dtype=compute_dtype)
    xs = linear(p.w_x, x, compute_dtype=compute_dtype)
    Bs = linear(p.w_B, x, compute_dtype=compute_dtype)
    Cs = linear(p.w_C, x, compute_dtype=compute_dtype)
    dt = linear(p.w_dt, x, compute_dtype=compute_dtype)
    args = (xs, Bs, Cs, dt, z, cache.conv_x, cache.conv_B, cache.conv_C,
            cache.h, p.conv_x.w, p.conv_x.b, p.conv_B.w, p.conv_B.b,
            p.conv_C.w, p.conv_C.b, p.dt_bias, p.A_log, p.D, p.norm_scale)
    if is_dtensor(cache.h):
        y, *new = _step_region(args, H)
    else:
        y, *new = _ssm_step(*args)
    for old, val in zip((cache.conv_x, cache.conv_B, cache.conv_C, cache.h),
                        new):
        old.copy_(_keep_inactive(val, old, active))
    return linear(p.out_proj, y.to(compute_dtype),
                  compute_dtype=compute_dtype)


def _ssm_step(xs, Bs, Cs, dt, z, tail_x, tail_B, tail_C, h, wx, bx, wB, bB,
              wC, bC, dt_bias, A_log, Dp, norm_scale, *, lo: int = 0):
    """One recurrent step from the projections: the three conv tails
    (whole over their channels), the heads of ``h`` (B, H, P, N) and the
    per-head parameters the x stream's conv weights ``wx`` (K, H * P)
    cover, its channels from ``lo`` of the whole tail.  Returns (y (B, H
    * P) f32, the new tails, the new state)."""

    def conv(tail, v_t, w, b, lo=0):
        seq = torch.cat([tail, v_t[:, None].float()], dim=1)
        y = torch.einsum("bkc,kc->bc", seq[..., lo:lo + w.shape[1]],
                         w.float())
        return F.silu(y + b.float()), seq[:, 1:]

    xi, tx = conv(tail_x, xs, wx, bx, lo)
    Bm, tB = conv(tail_B, Bs, wB, bB)
    Cm, tC = conv(tail_C, Cs, wC, bC)
    B, H = dt.shape
    xi = xi.reshape(B, H, -1)
    dt = softplus(dt.float() + dt_bias[None, :])
    A = -torch.exp(A_log)
    a = torch.exp(dt * A[None, :])  # (B, H)
    h = (h * a[:, :, None, None]
         + torch.einsum("bn,bhp->bhpn", Bm, xi * dt[..., None]))
    y = torch.einsum("bn,bhpn->bhp", Cm, h) + Dp[None, :, None] * xi
    y = y.reshape(B, -1) * F.silu(z.float())
    y = y * norm_scale.float()[None, :]
    return y, tx, tB, tC, h


def _step_region(args, H: int):
    """``_ssm_step`` on a DeviceMesh: batch rows over the data axes, each
    rank's heads over ``model`` where they divide it (its state, dt, z
    and per-head parameters, the x conv's weights on its channels), the
    x stream gathered (one all-gather of a (B, d_in) row) so every rank
    keeps the whole conv tails.  Heads that do not divide ``model`` run
    whole on every rank.  The new state comes back on the rank's heads,
    the tails whole."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = args[8].device_mesh
    M = ops.model_size(mesh)
    split = H % M == 0
    R = Replicate()
    S0, S1 = (Shard(0), Shard(1)) if split else (R, R)
    rowed = [(True, R), (True, R), (True, R), (True, S1), (True, S1),
             (True, R), (True, R), (True, R), (True, S1)]
    params = [(False, S1), (False, S0), (False, R), (False, R), (False, R),
              (False, R), (False, S0), (False, S0), (False, S0), (False, S0)]
    outs = [(True, S1), (True, R), (True, R), (True, R), (True, S1)]

    def body(*local):
        wx = local[9]
        lo = mesh.get_local_rank("model") * wx.shape[1] \
            if split and M > 1 else 0
        return _ssm_step(*local, lo=lo)

    return model_region(body, args, rowed + params, outs, args[8])


def init_ssm_cache(batch: int, d_model: int, *, expand: int, state: int,
                   conv_k: int, n_layers: int, head_p: int = 64,
                   device=None) -> SSMCache:
    """Zeroed f32 state and conv tails of ``n_layers`` layers stacked on a
    leading axis, (n_layers, B, ...) each, on ``device`` (``None``: the
    card)."""
    d_in, H, P, N = ssm_dims(d_model, expand, state, head_p)
    device = resolve_device(device)

    def zeros(*shape):
        return torch.zeros((n_layers,) + shape, dtype=torch.float32,
                           device=device)

    return SSMCache(h=zeros(batch, H, P, N),
                    conv_x=zeros(batch, conv_k - 1, d_in),
                    conv_B=zeros(batch, conv_k - 1, N),
                    conv_C=zeros(batch, conv_k - 1, N))
