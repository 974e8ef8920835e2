"""Data generators (``data/synthetic.py``), numpy copies so that both
packages draw the same data from one seed.

1. ``paper_synthetic`` -- the paper's §4.1 dataset: x ~ U[-3,3],
   f(x) = sum_{i=1}^{n_modes} rho^{i-1} cos(ix), and ``synthetic_residual``,
   the tail sum_{i>n} that sizes t(n) (Prop 2).
2. ``financial_series`` / ``financial_xy`` -- the §4.2 stand-in: a
   30-ticker correlated geometric-Brownian-motion panel with DJIA-like
   statistics, normalised to [0,1] as the paper does, re-synthesised from
   the seed (nothing is downloaded).  Ticker 0 is the target.
3. ``monitoring_target`` -- the LM-scale per-position health index.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def paper_synthetic(seed: int, n: int, *, rho: float = 0.9,
                    n_modes: int = 100,
                    x_range: Tuple[float, float] = (-3.0, 3.0)
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """x: (n, 1) float32 uniform on ``x_range``; f: (n,) float32."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(x_range[0], x_range[1], size=(n, 1)).astype(np.float32)
    i = np.arange(1, n_modes + 1, dtype=np.float64)
    a = rho ** (i - 1)
    f = (np.cos(x.astype(np.float64) * i[None, :]) @ a).astype(np.float32)
    return x, f


def synthetic_residual(x: np.ndarray, n: int, *, rho: float = 0.9,
                       n_modes: int = 100) -> np.ndarray:
    """sum_{i>n} a_i cos(ix), for the exact t(n) calibration (Prop 2)."""
    i = np.arange(n + 1, n_modes + 1, dtype=np.float64)
    a = rho ** (i - 1)
    xs = x[..., 0] if x.ndim > 1 else x
    return (np.cos(xs.astype(np.float64)[:, None] * i[None, :]) @ a
            ).astype(np.float32)


def financial_series(seed: int, n_days: int = 2520, n_tickers: int = 30,
                     *, daily_vol: float = 0.015, corr: float = 0.4,
                     drift: float = 0.0003) -> np.ndarray:
    """(n_days, n_tickers) normalised-to-[0,1] price panel (correlated GBM)."""
    rng = np.random.default_rng(seed)
    cov = np.full((n_tickers, n_tickers), corr)
    np.fill_diagonal(cov, 1.0)
    chol = np.linalg.cholesky(cov)
    shocks = rng.standard_normal((n_days, n_tickers)) @ chol.T
    logret = drift + daily_vol * shocks
    prices = 100.0 * np.exp(np.cumsum(logret, axis=0))
    lo, hi = prices.min(axis=0, keepdims=True), prices.max(axis=0,
                                                           keepdims=True)
    return ((prices - lo) / (hi - lo + 1e-9)).astype(np.float32)


def financial_xy(panel: np.ndarray, target_col: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """x = the other 29 tickers, f = the target ticker (paper: AAPL from
    the rest)."""
    f = panel[:, target_col]
    x = np.delete(panel, target_col, axis=1)
    return x.astype(np.float32), f.astype(np.float32)


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
