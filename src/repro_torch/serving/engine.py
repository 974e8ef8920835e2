"""Serving engine: batched decode over the uniform backbone API
(``serving/engine.py``).

Besides the uniform-position ``decode``, the engine exposes a per-element
decode (``decode_at`` / ``step_at``): every row carries its own cache
position and an active flag, so independent streams at different depths
advance in one call, and inactive rows' cache rows are left bit-unchanged.
The reference gets there with a ``vmap`` over singleton decodes and a
select; here the (B,) position vector goes straight through the model and
the decode attention kernel, and the cache write of an inactive row keeps
the old slot contents.  Every row is decoded; the hidden state of an
inactive row is garbage and callers gate on ``active``.

``prefill`` / ``sample`` / ``generate`` are the reference's text
generation: the prompt is fed by walking ``decode_step`` over it (as the
reference's scan does, so no prefill attention kernel is needed), and
each new token is the argmax at temperature 0 or a categorical draw from
the engine's own seeded ``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import api as model_api
from repro_torch.nn.attention import KVCache
from repro_torch.nn.module import resolve_device
from repro_torch.nn.ssm import SSMCache

# batch axis of every cache type, written out where the reference finds
# it with an eval_shape probe (cache_batch_axes): KVCache leaves are
# (layers, B, C, Hkv, D); SSMCache leaves (mamba layers, B, ...)
CACHE_BATCH_AXIS = {KVCache: 1, SSMCache: 1}


def zero_cache_rows(cache, rows: torch.Tensor) -> None:
    """Zero the selected batch rows (``rows``: (B,) bool) of every cache
    leaf, in place.  A re-leased slot starts exactly as a fresh cache."""
    for entry in cache.values():
        axis = CACHE_BATCH_AXIS[type(entry)]
        for leaf in entry:
            shape = [1] * leaf.dim()
            shape[axis] = rows.shape[0]
            leaf.masked_fill_(rows.reshape(shape), 0)


def permute_cache_rows(cache, perm: torch.Tensor) -> None:
    """Row ``i`` of every cache leaf takes old row ``perm[i]`` (``perm``:
    a (B,) permutation), in place: the reference's ``jnp.take`` over the
    batch axes, which the correction server's lease defrag uses.  In
    place because the server's cache is the dict that ``step_at``
    writes."""
    for entry in cache.values():
        axis = CACHE_BATCH_AXIS[type(entry)]
        for leaf in entry:
            leaf.copy_(leaf.index_select(axis, perm))


def step_at(params, cfg: ArchConfig, cache, tokens_t: torch.Tensor,
            pos: torch.Tensor, active: torch.Tensor, *,
            with_logits: bool = True):
    """Per-element decode: row i reads/writes its cache at ``pos[i]``;
    rows with ``active[i] == False`` keep their cache bit-unchanged.
    Returns (logits | None, hidden)."""
    return model_api.decode_step(params, cfg, cache, tokens_t, pos,
                                 with_logits=with_logits, active=active)


class ServeEngine:
    """Parameters + cache for one batched decode session on ``device``;
    ``seed`` seeds the generator that ``sample`` draws from above
    temperature 0."""

    def __init__(self, params, cfg: ArchConfig, batch: int, max_len: int,
                 device, seed: int = 0):
        self.params, self.cfg = params, cfg
        self.batch, self.max_len = batch, max_len
        self.device = resolve_device(device)
        self.cache = model_api.init_cache(cfg, batch, max_len, self.device)
        self.pos = 0
        self.gen = torch.Generator(self.device).manual_seed(seed)

    def decode(self, tokens_t: torch.Tensor
               ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """One step at the engine's scalar position; returns (logits,
        hidden) and advances it."""
        out = model_api.decode_step(self.params, self.cfg, self.cache,
                                    tokens_t, self.pos)
        self.pos += 1
        return out

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor) -> torch.Tensor:
        """Feed the prompt ``tokens`` (B, S0) one decode step a position
        from ``self.pos`` on, advancing it; returns the last position's
        logits (B, V)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        logits = None
        for t in range(tokens.shape[1]):
            logits, _ = self.decode(tokens[:, t])
        return logits

    def sample(self, logits: torch.Tensor,
               temperature: float = 0.0) -> torch.Tensor:
        """(B, V) logits -> (B,) int32 tokens: the argmax at temperature
        <= 0, else a categorical draw from softmax(logits / temperature)
        by the Gumbel-max rule, with noise from ``self.gen``."""
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        e = torch.empty_like(logits, dtype=torch.float32).exponential_(
            generator=self.gen)
        return torch.argmax(logits.float() / temperature - torch.log(e),
                            dim=-1).to(torch.int32)

    @torch.no_grad()
    def generate(self, prompt: torch.Tensor, n_new: int,
                 temperature: float = 0.0, *, return_logits: bool = False):
        """prompt (B, S0) -> generated tokens (B, n_new): the prefill, then
        exactly ``n_new`` decode steps (the last one's logits go unused,
        as in the reference).  With ``return_logits`` also the (B, n_new,
        V) logits each token was drawn from."""
        logits = self.prefill(prompt)
        toks, seen = [], []
        tok = self.sample(logits, temperature)
        for _ in range(n_new):
            toks.append(tok)
            seen.append(logits)
            logits, _ = self.decode(tok)
            tok = self.sample(logits, temperature)
        out = torch.stack(toks, dim=1)
        return (out, torch.stack(seen, dim=1)) if return_logits else out

    def decode_masked(self, tokens_t: torch.Tensor, pos: int,
                      mask: torch.Tensor, *, with_logits: bool = True):
        """One dense decode at scalar ``pos`` where only ``mask`` rows
        commit their cache writes.  ``self.pos`` is not advanced."""
        return self.decode_at(tokens_t, pos, mask, with_logits=with_logits)

    def decode_at(self, tokens_t: torch.Tensor, pos, active: torch.Tensor,
                  *, with_logits: bool = True):
        """Per-element decode step on the engine's cache (see ``step_at``).
        ``pos``: scalar or (B,).  ``self.pos`` is not advanced."""
        return step_at(self.params, self.cfg, self.cache, tokens_t, pos,
                       active, with_logits=with_logits)

    def zero_rows(self, rows, cache=None) -> None:
        """Reset the selected rows (``rows``: (B,) bool) of ``cache`` (the
        engine's own when None) to bit-cold zeros.  An async session's
        worker owns the server cache, and the engine passes it here."""
        zero_cache_rows(self.cache if cache is None else cache,
                        torch.as_tensor(rows, device=self.device))
