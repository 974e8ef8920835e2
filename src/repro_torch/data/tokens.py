"""Synthetic LM token pipeline (``data/tokens.py``), a numpy copy: a
Zipf-distributed token stream with a Markov bigram successor, so that a
real LM loss signal exists.  The same seed gives the same batches as the
reference's ``lm_batches``."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.data.synthetic import monitoring_target


def zipf_tokens(rng: np.random.Generator, shape, vocab: int,
                a: float = 1.2) -> np.ndarray:
    """Zipf-ish token ids in [0, vocab) via inverse-CDF on a power law."""
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** (-a)
    probs /= probs.sum()
    return rng.choice(vocab, size=shape, p=probs).astype(np.int32)


def markov_stream(rng: np.random.Generator, batch: int, seq: int, vocab: int,
                  order_mix: float = 0.5) -> np.ndarray:
    """Mix of Zipf draws and a deterministic bigram successor
    (t+1 = 7t+3 mod V), so next-token prediction is partly learnable."""
    base = zipf_tokens(rng, (batch, seq), vocab)
    succ = (7 * base[:, :-1] + 3) % vocab
    use_succ = rng.uniform(size=(batch, seq - 1)) < order_mix
    out = base.copy()
    out[:, 1:] = np.where(use_succ, succ, base[:, 1:])
    return out


def lm_batches(seed: int, cfg: ArchConfig, batch: int,
               seq: int) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite iterator of {tokens, labels, monitor_target} (B, S) numpy
    arrays, for the token families the port runs."""
    if cfg.family in ("audio", "vlm"):
        raise NotImplementedError(
            f"family {cfg.family!r} batches are not ported yet: see "
            "ROADMAP.md queue 1, item 7 (other families)")
    rng = np.random.default_rng(seed)
    while True:
        toks = markov_stream(rng, batch, seq + 1, cfg.vocab_size)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:],
               "monitor_target": monitoring_target(toks[:, :-1],
                                                   cfg.vocab_size)}
