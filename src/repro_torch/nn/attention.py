"""GQA attention: prefill over a whole sequence (``nn/attention.py:184``)
and single-token decode (``nn/attention.py:136-226``).

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
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.nn.module import Linear, linear
from repro_torch.nn.rotary import rotate


class KVCache(NamedTuple):
    k: torch.Tensor  # (L, B, C, Hkv, D) in a model cache
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
    q = linear(p.wq, x, compute_dtype=compute_dtype).reshape(B, S, n_heads,
                                                              head_dim)
    k = linear(p.wk, x, compute_dtype=compute_dtype).reshape(B, S, n_kv,
                                                              head_dim)
    v = linear(p.wv, x, compute_dtype=compute_dtype).reshape(B, S, n_kv,
                                                              head_dim)
    q = rotate(q, *rope)
    k = rotate(k, *rope)
    o = ops.flash_attention(q, k, v, window=window)
    return linear(p.wo, o.reshape(B, S, n_heads * head_dim),
                  compute_dtype=compute_dtype)


def write_rows(cache: torch.Tensor, slot: torch.Tensor, new: torch.Tensor,
               active: Optional[torch.Tensor]) -> None:
    """cache[b, slot[b]] = new[b] for every row b where ``active`` (all rows
    when None); other rows keep their slot contents bit-for-bit."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    if active is not None:
        new = torch.where(active[:, None, None], new, cache[rows, slot])
    cache[rows, slot] = new


def gqa_decode(p: GQA, x: torch.Tensor, cache_k: torch.Tensor,
               cache_v: torch.Tensor, pos: torch.Tensor, rope, *,
               n_heads: int, n_kv: int, head_dim: int, window: int = 0,
               compute_dtype=torch.bfloat16,
               active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, d_model), one token per row; pos: (B,) int32; ``rope``: the
    step's (cos, sin) from ``nn.rotary.rope_angles(pos, ...)``; caches:
    (B, C, Hkv, D), updated in place.  Returns y (B, d_model)."""
    B = x.shape[0]
    C = cache_k.shape[1]
    q = linear(p.wq, x, compute_dtype=compute_dtype).reshape(B, n_heads, head_dim)
    k = linear(p.wk, x, compute_dtype=compute_dtype).reshape(B, n_kv, head_dim)
    v = linear(p.wv, x, compute_dtype=compute_dtype).reshape(B, n_kv, head_dim)
    q = rotate(q, *rope)
    k = rotate(k, *rope)
    # the reference's dynamic_update_slice clamps an out-of-range start
    slot = (pos % C) if window else torch.clamp(pos, 0, C - 1)
    slot = slot.long()
    write_rows(cache_k, slot, k.to(cache_k.dtype), active)
    write_rows(cache_v, slot, v.to(cache_v.dtype), active)
    o = ops.decode_attention(q, cache_k, cache_v, pos)
    return linear(p.wo, o.reshape(B, n_heads * head_dim),
                  compute_dtype=compute_dtype)
