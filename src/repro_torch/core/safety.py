"""Performance metrics of paper §2.3 on tensors (``core/safety.py``):
approximation error (Eq. 2), false positive rate (Eq. 3), false negative
rate (Eq. 4), and the corrected (post-server) variants of Fig 2(d).

Every metric takes the ground truth f, the on-device monitor u and, where
it applies, the combined prediction fhat = u - s*sigma(v), as tensors of
one shape, and returns 0-d f32 tensors on their device (no host sync).
The threshold gamma defaults to 0 as in the paper, overridable for the
financial experiment's 0.8.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def approx_error(f: torch.Tensor, fhat: torch.Tensor,
                 p: float = 2.0) -> torch.Tensor:
    """||f - fhat||_p, Monte-Carlo normalised (vol(Omega) = 1)."""
    d = torch.abs(f.float() - fhat.float())
    if p == float("inf"):
        return torch.max(d)
    return torch.mean(d ** p) ** (1.0 / p)


def fp_rate(f: torch.Tensor, u: torch.Tensor, eps: float = 0.0,
            threshold: float = 0.0) -> torch.Tensor:
    """mu_FP,eps (Eq. 3): u raises the alarm while f is safely below."""
    return ((f < threshold - eps) & (u > threshold + eps)).float().mean()


def fn_rate(f: torch.Tensor, u: torch.Tensor, eps: float = 0.0,
            threshold: float = 0.0) -> torch.Tensor:
    """mu_FN,eps (Eq. 4): the safety-critical miss, f adverse and u
    silent."""
    return ((f > threshold + eps) & (u < threshold - eps)).float().mean()


def safety_violation(f: torch.Tensor, u: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mass and magnitude of u < f violations (u must upper-bound f)."""
    gap = f.float() - u.float()
    return (gap > 0).float().mean(), torch.clamp(gap, min=0.0).max()


def metrics_report(f, u, fhat, *, eps: float = 0.05,
                   threshold: float = 0.0) -> Dict[str, torch.Tensor]:
    """The full §2.3 metric set; ``corrected_*`` are Fig 2(d)'s (the
    server's view)."""
    viol_rate, viol_max = safety_violation(f, u)
    return {
        "l1": approx_error(f, fhat, 1.0),
        "l2": approx_error(f, fhat, 2.0),
        "linf": approx_error(f, fhat, float("inf")),
        "fp": fp_rate(f, u, eps, threshold),
        "fn": fn_rate(f, u, eps, threshold),
        "corrected_fp": fp_rate(f, fhat, eps, threshold),
        "corrected_fn": fn_rate(f, fhat, eps, threshold),
        "safety_violation_rate": viol_rate,
        "safety_violation_max": viol_max,
    }
