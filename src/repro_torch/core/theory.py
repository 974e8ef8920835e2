"""Numeric forms of the paper's theory (Props 1-4 and §3.4 selection
rules), a numpy copy of the JAX package's ``core/theory.py``.

These are the design rules applied when constructing a monitor: given the
coefficient decay of the target's basis expansion (Assumption 1, Eq. 7),
choose the truncation n, the safety offset t(n) (Prop 2), and the
corrector scale s (Props 2+3: s = 2 t(n) is the smallest scale that
preserves safety, and FP grows with s).
"""
from __future__ import annotations

import numpy as np


# -- Prop 2: t(n) = || sum_{i>n} a_i phi_i ||_inf ---------------------------

def t_of_n(coeffs: np.ndarray, n: int, phi_sup: float = 1.0) -> float:
    """Practical estimate t(n) ~= sum_{i>n} |a_i| * sup|phi| (paper §4.1
    uses sum |a_i| as the inf-norm surrogate for the cosine basis)."""
    c = np.asarray(coeffs, dtype=np.float64)
    return float(np.sum(np.abs(c[n:])) * phi_sup)


def t_of_n_sampled(residual_fn, xs: np.ndarray) -> float:
    """Exact-on-sample t(n) = max_x |sum_{i>n} a_i phi_i(x)| (the tight
    variant: it closes the paper's noted gap between theoretical and
    practical optima)."""
    return float(np.max(np.abs(residual_fn(xs))))


def s_rule(t: float) -> float:
    """Props 2+3: s = 2 t(n), the smallest s that keeps FN = 0, minimising
    FP."""
    return 2.0 * t


# -- §3.4 closed forms -------------------------------------------------------

def exp_decay_s(rho: float, n: int) -> float:
    """a_i = rho^{i-1}: t(n) = rho^n/(1-rho); the paper picks
    s ~ rho^n/(1-rho)."""
    return rho ** n / (1.0 - rho)


def power_law_s(alpha: float, n: int) -> float:
    """a_i = i^{-alpha}, orthonormal phi: ||residual||_2^2 <~ 1/n^{2a-1}."""
    return float(n ** (1.0 - 2.0 * alpha))


# -- Prop 3: FP upper bound --------------------------------------------------

def prop3_fp_bound(delta: float, s: float, eps: float,
                   vol: float = 1.0) -> float:
    """mu_FP,eps <= (delta + s) * vol(Omega) / (2 eps)."""
    return (delta + s) * vol / (2.0 * eps)


# -- Prop 4: FN mass bound (Chebyshev) when t is under-sized -----------------

def prop4_fn_bound(residual_l2_sq: float, eps: float, t: float) -> float:
    """mu(Omega_FN,eps) <= ||sum_{i>n} a_i phi_i||_2^2 / (2 eps + t)^2."""
    return residual_l2_sq / (2.0 * eps + t) ** 2


def prop4_region_bound(residual_l2_sq: float, t: float, s: float) -> float:
    """mu(Omega^c_{-t,s-t}) <= (1/t^2 + 1/(s-t)^2) ||residual||_2^2."""
    return (1.0 / t ** 2 + 1.0 / (s - t) ** 2) * residual_l2_sq


# -- coefficient generators for the two §3.4 regimes -------------------------

def exp_coeffs(rho: float, n_modes: int) -> np.ndarray:
    return rho ** np.arange(n_modes, dtype=np.float64)


def power_coeffs(alpha: float, n_modes: int) -> np.ndarray:
    return (1.0 / np.arange(1, n_modes + 1, dtype=np.float64)) ** alpha
