"""The comparisons that decide ``correct``: each number the program's
outputs give against the reference, beside its limit from the cell's
``limits/<cell>.json`` (where each limit's readings are written too).
A number passes when it is at most its limit."""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

# leaves whose reference gradient is under this share of the median
# leaf's move under AdamW by round-off alone: left out of the leaf numbers
ROUND_OFF_LEAF = 1e-3


def fleet_numbers(rec: dict, u_ref: np.ndarray, v_ref: np.ndarray,
                  s: float) -> Dict[str, float]:
    """``rec``: the program's u, fhat, triggered and the schedule's due
    alarms at the checked streams' served positions (NaN elsewhere),
    float64 (n, T).
    u_err     max |u - u_ref| over every served position
    trig_flips   served positions whose alarm differs from the schedule's
    v_err     max |v - v_ref| over the alarms, v read from the verdict:
              logit((u - fhat) / s)
    fhat_err  max |fhat - fhat_ref|, fhat_ref = u_ref - s sigmoid(v_ref)
              at the program's alarms and u_ref elsewhere
    unsafe    verdicts with fhat > u (the paper's safety property)
    no_alarms    1 when no alarm was compared (a check with none compares
              no v)"""
    served = ~np.isnan(rec["u"])
    u, fhat, trig = rec["u"], rec["fhat"], rec["triggered"] > 0.5
    u_err = float(np.max(np.abs(u - u_ref)[served]))
    flips = int(np.sum(served & (trig != (rec["due"] > 0.5))))
    alarm = served & trig
    y = np.clip((u - fhat) / s, 1e-300, 1.0 - 1e-16)
    v = np.log(y) - np.log1p(-y)
    v_err = (float(np.max(np.abs(v - v_ref)[alarm])) if alarm.any()
             else math.inf)
    ref = np.where(trig, u_ref - s / (1.0 + np.exp(-v_ref)), u_ref)
    return {"u_err": u_err, "trig_flips": float(flips), "v_err": v_err,
            "fhat_err": float(np.max(np.abs(fhat - ref)[served])),
            "unsafe": float(np.sum(served & (fhat > u))),
            "no_alarms": float(not alarm.any())}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: List[str]) -> Dict[str, float]:
    """Each leaf's |norm - ref norm| / max(ref norm, median ref)."""
    med = float(np.median([ref[k] for k in keep]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep}


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """Each checked step's loss, each leaf's first gradient and each
    leaf's change after the checked steps, against the reference:
    loss_gap         max over the steps of |L - L_ref| / |L_ref|
    loss1_gap        the same at the first step
    grad_gap         the worst leaf's gap of first-gradient norms as the
                     optimizer gets them (clipped by the global norm)
    gnorm_gap        |global norm - ref| / ref of the first gradient
    grad_median_gap  the median leaf's gap of first-gradient norms before
                     the clip
    update_gap       the worst leaf's gap of the norms of the change
    update_median_gap  the median leaf's
    A leaf's gap is |norm - ref| / max(ref, the median leaf's ref).
    Leaves whose reference gradient is under ROUND_OFF_LEAF of the
    median leaf's are left out of the leaf numbers."""
    raw = ref["first_grad_raw"]
    med = float(np.median(list(raw.values())))
    keep = [k for k, g in raw.items() if g >= ROUND_OFF_LEAF * med]
    loss = [abs(p["total"] - r["total"]) / abs(r["total"])
            for p, r in zip(prog["losses"], ref["losses"])]
    g_raw = leaf_gaps(prog["first_grad_raw"], raw, keep)
    upd = leaf_gaps(prog["delta"], ref["delta"], keep)

    def gnorm(d):
        return float(np.sqrt(sum(v * v for v in d.values())))

    return {"loss_gap": float(max(loss)), "loss1_gap": float(loss[0]),
            "grad_gap": max(leaf_gaps(prog["first_grad"], ref["first_grad"],
                                      keep).values()),
            "gnorm_gap": abs(gnorm(prog["first_grad_raw"]) - gnorm(raw))
            / gnorm(raw),
            "grad_median_gap": float(np.median(list(g_raw.values()))),
            "update_gap": max(upd.values()),
            "update_median_gap": float(np.median(list(upd.values()))),
            "leaves_left_out": float(len(raw) - len(keep))}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}) over the numbers the cell's
    limits name; the others are readings, not compared."""
    checks, ok = {}, bool(limits)
    for name, lim in limits.items():
        value = numbers.get(name, math.inf)
        checks[name] = {"value": value, "limit": lim}
        if not value <= lim:
            ok = False
    return ok, checks
