"""GQA attention: prefill over a whole sequence (``nn/attention.py:184``)
and single-token decode (``nn/attention.py:136-226``); llama-3.2-vision's
cross attention over image rows (``nn/attention.py:229``); and DeepSeek's
multi-head latent attention, MLA (``nn/attention.py:249-342``).

Prefill is ``kernels.ops.flash_attention``: the plain version of the
reference's ``chunked_attention`` for CPU tensors, the Hopper flash kernel
for CUDA ones, with the gradient of ``kernels/flash_attention.py``.

KV caches are fixed-capacity buffers (B, C, Hkv, D).  Decode writes the
new key/value of row b at slot ``pos[b]`` (``pos[b] % C`` for a ring
buffer, ``window > 0``) and attends over the valid prefix.  Positions are a
(B,) vector, so rows at different depths decode in one call; the
reference reaches the same with a ``vmap`` over singleton decodes
(``serving/engine.py::make_step_at``).

The port writes the cache in place, where the reference returns a new
one: that saves a copy of the whole cache per step.  The attention itself
is ``kernels.ops.decode_attention``: the reference's XLA form
(``nn/attention.py:136``) as a plain PyTorch version for CPU tensors
(``kernels/decode_attention.py``), the Hopper kernel for CUDA ones.  Rows with
``active[b] == False`` keep their old slot contents, so their cache rows
come back bit-unchanged, as the reference's masked decode guarantees.

On a DeviceMesh the caches are DTensors placed by ``cache_specs``.  A
cache split on its time axis over ``model`` (``decode_cache_shard =
"time"``) is written by the one rank whose slice holds the slot
(``write_rows``), and attended to by flash-decode: each rank scores its
slice and the ranks combine their softmax partials
(``kernels/ops.py::_decode_region``; MLA's absorbed products in
``_mla_region``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.distributed.sharding import (heads_local, is_dtensor,
                                              merge_heads, row_placements,
                                              split_heads)
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import NEG_INF, slice_softmax
from repro_torch.nn.module import Linear, linear
from repro_torch.nn.rotary import rotate


class KVCache(NamedTuple):
    k: torch.Tensor  # (L, B, C, Hkv, D) in a model cache
    v: torch.Tensor


class CrossKV(NamedTuple):
    """The image rows' keys and values of llama-3.2-vision's cross blocks,
    computed once per image; the engine finds their batch axis by type."""
    k: torch.Tensor  # (n_super, B, n_image_tokens, Hkv, D)
    v: torch.Tensor


class GQA(nn.Module):
    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                 *, qkv_bias: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.wq = Linear(d_model, n_heads * head_dim, bias=qkv_bias, **kw)
        self.wk = Linear(d_model, n_kv * head_dim, bias=qkv_bias, **kw)
        self.wv = Linear(d_model, n_kv * head_dim, bias=qkv_bias, **kw)
        self.wo = Linear(n_heads * head_dim, d_model, **kw)

    def init_(self, gen: torch.Generator):
        for lin in (self.wq, self.wk, self.wv, self.wo):
            lin.init_(gen)


def gqa_prefill(p: GQA, x: torch.Tensor, rope, *, n_heads: int, n_kv: int,
                head_dim: int, window: int = 0,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x: (B, S, d_model); ``rope``: (cos, sin) of positions 0..S-1 from
    ``nn.rotary.rope_angles``.  Causal attention (sliding when
    ``window > 0``); returns y (B, S, d_model)."""
    B, S, _ = x.shape
    q = split_heads(linear(p.wq, x, compute_dtype=compute_dtype), n_heads,
                    head_dim)
    k = split_heads(linear(p.wk, x, compute_dtype=compute_dtype), n_kv,
                    head_dim)
    v = split_heads(linear(p.wv, x, compute_dtype=compute_dtype), n_kv,
                    head_dim)
    q = rotate(q, *rope)
    k = rotate(k, *rope)
    o = ops.flash_attention(q, k, v, window=window)
    return linear(p.wo, merge_heads(o), compute_dtype=compute_dtype)


def write_rows(cache: torch.Tensor, slot: torch.Tensor, new: torch.Tensor,
               active: Optional[torch.Tensor]) -> None:
    """cache[b, slot[b]] = new[b] for every row b where ``active`` (all rows
    when None); other rows keep their slot contents bit-for-bit."""
    if is_dtensor(cache):
        return _write_placed(cache, slot, new, active)
    rows = torch.arange(cache.shape[0], device=cache.device)
    if active is not None:
        keep = active.reshape((-1,) + (1,) * (new.dim() - 1))
        new = torch.where(keep, new, cache[rows, slot])
    cache[rows, slot] = new


def _write_placed(cache, slot, new, active) -> None:
    """``write_rows`` on a DTensor cache (B, C, ...), in place on each
    rank's block: the new rows (B, ...) placed as the cache's rows (whole
    on a mesh dim that splits the cache's time axis), the slots and the
    mask as its batch rows.  A time split over ``model``: the slot is
    global, and only the rank whose slice holds it writes, at its local
    index; the other ranks write their old contents back."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache.device_mesh
    pls = cache.placements
    row_pls = [Shard(pl.dim - 1) if pl.is_shard() and pl.dim >= 2 else
               pl if pl.is_shard() and pl.dim == 0 else Replicate()
               for pl in pls]
    rows = row_placements(cache)

    def local(t, placements):
        t = ops.as_dtensor(t, mesh)
        return t.redistribute(mesh, placements).to_local()

    block = cache.to_local()
    new_l, slot_l = local(new, row_pls), local(slot, rows)
    act = None if active is None else local(active, rows)
    if ops.time_split(cache):
        Cl = block.shape[1]
        base = mesh.get_local_rank("model") * Cl
        mine = (slot_l >= base) & (slot_l < base + Cl)
        act = mine if act is None else act & mine
        slot_l = torch.clamp(slot_l - base, 0, Cl - 1)
    write_rows(block, slot_l, new_l, act)


def gqa_decode(p: GQA, x: torch.Tensor, cache_k: torch.Tensor,
               cache_v: torch.Tensor, pos: torch.Tensor, rope, *,
               n_heads: int, n_kv: int, head_dim: int, window: int = 0,
               compute_dtype=torch.bfloat16,
               active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, d_model), one token per row; pos: (B,) int32; ``rope``: the
    step's (cos, sin) from ``nn.rotary.rope_angles(pos, ...)``; caches:
    (B, C, Hkv, D), updated in place.  Returns y (B, d_model)."""
    C = cache_k.shape[1]
    q = split_heads(linear(p.wq, x, compute_dtype=compute_dtype), n_heads,
                    head_dim)
    k = split_heads(linear(p.wk, x, compute_dtype=compute_dtype), n_kv,
                    head_dim)
    v = split_heads(linear(p.wv, x, compute_dtype=compute_dtype), n_kv,
                    head_dim)
    q = rotate(q, *rope)
    k = rotate(k, *rope)
    # the reference's dynamic_update_slice clamps an out-of-range start
    slot = (pos % C) if window else torch.clamp(pos, 0, C - 1)
    slot = slot.long()
    write_rows(cache_k, slot, k.to(cache_k.dtype), active)
    write_rows(cache_v, slot, v.to(cache_v.dtype), active)
    o = ops.decode_attention(q, cache_k, cache_v, pos)
    return linear(p.wo, merge_heads(o), compute_dtype=compute_dtype)


# ---------------------------------------------------------------------------
# Cross attention (llama-3.2-vision's image layers): no causal mask, no rope
# ---------------------------------------------------------------------------

CROSS_Q_BLOCK = 1024  # query rows a score block holds (the reference's)


def cross_attn(p: GQA, x: torch.Tensor, kv_feats: torch.Tensor, *,
               n_heads: int, n_kv: int, head_dim: int,
               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x: (B, S, d_model) queries over kv_feats: (B, T, d_model) image
    rows, every query row over every image row (ref :229).  The reference
    runs this through ``chunked_attention(causal=False)``, outside any
    Pallas kernel, so here too it is tensor ops, a block of query rows at
    a time: scores of compute-dtype operands summed in f32, an f32
    softmax, probabilities rounded to v's dtype before the PV product,
    output in q's dtype.  Autograd differentiates it."""
    B, S, _ = x.shape
    G = n_heads // n_kv
    q = split_heads(linear(p.wq, x, compute_dtype=compute_dtype), n_kv,
                    G * head_dim).reshape(B, S, n_kv, G, head_dim)
    k = split_heads(linear(p.wk, kv_feats, compute_dtype=compute_dtype),
                    n_kv, head_dim)
    v = split_heads(linear(p.wv, kv_feats, compute_dtype=compute_dtype),
                    n_kv, head_dim)
    scale = 1.0 / math.sqrt(head_dim)

    def heads(q, k, v):
        kh = k.float().permute(0, 2, 3, 1)[:, :, None]  # (B, Hkv, 1, D, T)
        vh = v.float().permute(0, 2, 1, 3)[:, :, None]  # (B, Hkv, 1, T, D)
        blocks = []
        for q0 in range(0, S, CROSS_Q_BLOCK):
            qb = q[:, q0:q0 + CROSS_Q_BLOCK].float().permute(0, 2, 3, 1, 4)
            s = torch.matmul(qb, kh) * scale            # (B, Hkv, G, s, T)
            prob = torch.softmax(s, dim=-1).to(v.dtype).float()
            blocks.append(torch.matmul(prob, vh).to(q.dtype))
        return torch.cat(blocks, dim=3).permute(0, 3, 1, 2, 4)

    # on a DeviceMesh, a region of each rank's rows and kv heads
    o = heads_local(heads, q, k, v)                     # (B, S, Hkv, G, D)
    o = merge_heads(o.reshape(B, S, n_kv, G * head_dim))
    return linear(p.wo, o, compute_dtype=compute_dtype)


def cross_attn_decode(p: GQA, x: torch.Tensor, k_img: torch.Tensor,
                      v_img: torch.Tensor, *, n_heads: int, head_dim: int,
                      compute_dtype=torch.bfloat16) -> torch.Tensor:
    """One token per row against precomputed image K/V (B, T, Hkv, D):
    the decode attention kernel at position T - 1, so every image row is
    valid (ref ``models/transformer.py:298``).  Returns (B, d_model)."""
    q = split_heads(linear(p.wq, x, compute_dtype=compute_dtype), n_heads,
                    head_dim)
    o = ops.decode_attention(q, k_img, v_img, k_img.shape[1] - 1)
    return linear(p.wo, merge_heads(o), compute_dtype=compute_dtype)


# ---------------------------------------------------------------------------
# MLA: the cache holds the compressed latent c_kv (kv_lora_rank) and the
# decoupled rope key (qk_rope_dim) per token, 576 values at DeepSeek-V3's
# widths where GQA would keep 2 * 128 heads * 128.
# ---------------------------------------------------------------------------


class MLACache(NamedTuple):
    ckv: torch.Tensor    # (L, B, C, kv_lora_rank) in a model cache
    krope: torch.Tensor  # (L, B, C, qk_rope_dim)


class MLA(nn.Module):
    def __init__(self, d_model: int, n_heads: int, *, q_lora: int,
                 kv_lora: int, qk_nope: int, qk_rope: int, v_dim: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.wq_a = Linear(d_model, q_lora, **kw)
        self.wq_b = Linear(q_lora, n_heads * (qk_nope + qk_rope), **kw)
        self.wkv_a = Linear(d_model, kv_lora + qk_rope, **kw)
        self.wkv_b = Linear(kv_lora, n_heads * (qk_nope + v_dim), **kw)
        self.wo = Linear(n_heads * v_dim, d_model, **kw)

    def init_(self, gen: torch.Generator):
        for lin in (self.wq_a, self.wq_b, self.wkv_a, self.wkv_b, self.wo):
            lin.init_(gen)


def _mla_q(p: MLA, x, *, n_heads, qk_nope, qk_rope, rope, compute_dtype):
    """(q_nope, roped q_rope), heads on axis -2."""
    q = linear(p.wq_b, linear(p.wq_a, x, compute_dtype=compute_dtype),
               compute_dtype=compute_dtype)
    q = split_heads(q, n_heads, qk_nope + qk_rope)
    return q[..., :qk_nope], rotate(q[..., qk_nope:], *rope)


def mla_prefill(p: MLA, x: torch.Tensor, rope, *, n_heads: int,
                qk_nope: int, qk_rope: int, v_dim: int, window: int = 0,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x: (B, S, d_model); ``rope``: (cos, sin) of positions 0..S-1 at the
    rope width.  Keys and queries are qk_nope + qk_rope wide (the rope
    key shared by every head), values v_dim wide: the flash attention
    takes Dqk != Dv, scaled by 1/sqrt(Dqk) (ref ``_mla_qkv`` :284 and
    ``mla_prefill`` :307)."""
    B, S, _ = x.shape
    q_nope, q_rope = _mla_q(p, x, n_heads=n_heads, qk_nope=qk_nope,
                            qk_rope=qk_rope, rope=rope,
                            compute_dtype=compute_dtype)
    kv_a = linear(p.wkv_a, x, compute_dtype=compute_dtype)
    ckv, k_rope = kv_a[..., :-qk_rope], kv_a[..., -qk_rope:]
    k_rope = rotate(k_rope[:, :, None], *rope)              # (B, S, 1, r)
    kv = split_heads(linear(p.wkv_b, ckv, compute_dtype=compute_dtype),
                     n_heads, qk_nope + v_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([kv[..., :qk_nope],
                   k_rope.expand(B, S, n_heads, qk_rope)], dim=-1)
    v = kv[..., qk_nope:].contiguous()
    o = ops.flash_attention(q, k, v, window=window)
    return linear(p.wo, merge_heads(o), compute_dtype=compute_dtype)


def mla_decode(p: MLA, x: torch.Tensor, ckv: torch.Tensor,
               krope: torch.Tensor, pos: torch.Tensor, rope, *, n_heads: int,
               qk_nope: int, qk_rope: int, v_dim: int, kv_lora: int,
               compute_dtype=torch.bfloat16,
               active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Latent-cache decode with the absorbed products (ref :313-342).
    x: (B, d_model); pos: (B,) int32; ``rope``: the step's (cos, sin) at
    the rope width; caches (B, C, kv_lora) and (B, C, qk_rope), written in
    place at ``pos`` (clamped, as ``dynamic_update_slice`` clamps) for the
    ``active`` rows.  q_nope goes through the key half of W^kv_b so the
    scores read the cached latents directly.  Rounding points are the
    reference's: the latents and the rope keys are read in the cache
    dtype, every product sums in f32.  Tensor ops: the reference runs
    these einsums outside any Pallas kernel."""
    C = ckv.shape[1]
    q_nope, q_rope = _mla_q(p, x, n_heads=n_heads, qk_nope=qk_nope,
                            qk_rope=qk_rope, rope=rope,
                            compute_dtype=compute_dtype)
    kv_a = linear(p.wkv_a, x, compute_dtype=compute_dtype)
    ckv_t = kv_a[..., :-qk_rope]
    krope_t = rotate(kv_a[:, None, -qk_rope:], *rope)[:, 0]
    slot = torch.clamp(pos, 0, C - 1).long()
    write_rows(ckv, slot, ckv_t.to(ckv.dtype), active)
    write_rows(krope, slot, krope_t.to(krope.dtype), active)
    wkv = split_heads(p.wkv_b.w.to(compute_dtype), n_heads, qk_nope + v_dim)
    wk, wv = wkv[..., :qk_nope].float(), wkv[..., qk_nope:].float()
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope.float(), wk)   # (B, H, r)
    scale = 1.0 / math.sqrt(qk_nope + qk_rope)
    q_lat, q_rope = q_lat.to(ckv.dtype), q_rope.to(krope.dtype)
    if is_dtensor(ckv):
        o_lat = _mla_region(q_lat, q_rope, ckv, krope, pos, scale)
    else:
        o_lat = _mla_attend(q_lat, q_rope, ckv, krope, pos, scale)
    o = torch.einsum("bhr,rhv->bhv", o_lat, wv)
    return linear(p.wo, merge_heads(o.to(compute_dtype)),
                  compute_dtype=compute_dtype)


def _mla_scores(q_lat, q_rope, ckv, krope, scale):
    return (torch.einsum("bhr,btr->bht", q_lat.float(), ckv.float())
            + torch.einsum("bhr,btr->bht", q_rope.float(),
                           krope.float())) * scale


def _mla_attend(q_lat, q_rope, ckv, krope, pos, scale) -> torch.Tensor:
    """The absorbed attention over the whole latent cache (B, C, r): f32
    scores of cache-dtype operands, the softmax, p rounded to the cache
    dtype, o_lat (B, H, r) f32 (ref :330-338)."""
    C = ckv.shape[1]
    s = _mla_scores(q_lat, q_rope, ckv, krope, scale)
    valid = torch.arange(C, device=s.device)[None, :] <= pos[:, None].long()
    s = torch.where(valid[:, None, :], s, NEG_INF)
    prob = torch.softmax(s, dim=-1)
    return torch.einsum("bht,btr->bhr", prob.to(ckv.dtype).float(),
                        ckv.float())


def _mla_partial(q_lat, q_rope, ckv, krope, pos, scale, base: int):
    """``_mla_attend`` over one time slice (global rows ``base ..``):
    (o_lat f32 normalised by the slice's own sum, lse), the slice's
    partial as ``decode_attention_partial_plain`` forms it."""
    s = _mla_scores(q_lat, q_rope, ckv, krope, scale)
    prob, lse = slice_softmax(s, pos.long(), base, ckv.dtype)
    return torch.einsum("bht,btr->bhr", prob, ckv.float()), lse


def _mla_region(q_lat, q_rope, ckv, krope, pos, scale) -> torch.Tensor:
    """The absorbed attention on a DeviceMesh, rows over the data axes as
    the cache's.  Latent and rope caches split on their time axis over
    ``model``: q whole on ``model``, each rank's partial over its slice,
    joined by ``combine_partials`` (two all-reduces); o_lat whole on
    ``model``.  Otherwise the caches come whole (gathered where the
    ``"heads"`` rule split their last dim) and each rank attends with its
    q heads."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = ckv.device_mesh
    rows = row_placements(ckv)
    q_lat = ops.as_dtensor(q_lat, mesh)
    pos = ops.as_dtensor(pos, mesh)
    if ops.time_split(ckv):
        qp = list(ops.on_model(rows, mesh, Replicate()))
        cp = list(ops.on_model(rows, mesh, Shard(1)))
        group = mesh.get_group("model")

        def body(ql, qr, cl, kl, pl):
            base = mesh.get_local_rank("model") * cl.shape[1]
            o, lse = _mla_partial(ql, qr, cl, kl, pl, scale, base)
            return ops.combine_partials(o, lse, group)
    else:
        M = ops.model_size(mesh)
        keep = M == 1 or ops.model_placement(q_lat) == Shard(1)
        qp = list(ops.on_model(rows, mesh, ops.model_placement(q_lat)
                               if keep else Replicate()))
        cp = list(ops.on_model(rows, mesh, ops.model_placement(ckv)
                               if M == 1 else Replicate()))

        def body(ql, qr, cl, kl, pl):
            return _mla_attend(ql, qr, cl, kl, pl, scale)
    return local_map(body, out_placements=qp,
                     in_placements=(qp, qp, cp, cp, list(rows)),
                     device_mesh=mesh, redistribute_inputs=True)(
        q_lat, q_rope, ckv, krope, pos)
