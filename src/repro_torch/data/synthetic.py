"""The LM-scale monitoring target (``data/synthetic.py:71``), a numpy copy
so that both packages draw the same targets from one seed."""
from __future__ import annotations

import numpy as np


def monitoring_target(tokens: np.ndarray, vocab: int, *,
                      hazard_frac: float = 0.03, ewma: float = 0.95,
                      drift_period: int = 512, seed: int = 7) -> np.ndarray:
    """Deterministic per-position health index f in ~[-1, 1.5]: an EWMA of
    occurrences of a fixed pseudo-random 'hazardous' subset of the
    vocabulary, plus a slow sinusoidal drift.  tokens: (B, S) int ->
    (B, S) float32."""
    rng = np.random.default_rng(seed)
    hazard = (rng.uniform(size=vocab) < hazard_frac).astype(np.float32)
    h = hazard[tokens.reshape(-1)].reshape(tokens.shape)  # (B,S)
    B, S = tokens.shape
    f = np.zeros((B, S), np.float32)
    acc = np.zeros((B,), np.float32)
    for t in range(S):
        acc = ewma * acc + (1 - ewma) * h[:, t]
        f[:, t] = acc
    f = f / (hazard_frac + 1e-9)  # EWMA of Bernoulli(p) has mean p -> ~O(1)
    drift = 0.3 * np.sin(2 * np.pi * np.arange(S) / drift_period)
    return (f + drift[None, :] - 0.5).astype(np.float32)
