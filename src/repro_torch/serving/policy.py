"""Adaptive triggering (``serving/policy.py``, numpy only, ported whole):
the threshold as an online, per-stream policy, plus the three-rung
cascade built by composing two ``MonitorSession``s.

The paper fixes the trigger threshold at one calibrated operating point
(Fig. 4).  The hierarchical-inference line (arXiv 2304.00891,
2304.11763) treats edge offload as an *online decision problem*: each
stream's margin distribution drifts, so the threshold should too.  This
module makes that a first-class serving concern:

  * ``TriggerPolicy``  — the controller interface.  A policy owns the
    per-stream effective trigger points ``tau[i]`` (the engine triggers
    stream i when ``u_i > tau[i]``); the session reads
    ``step_thresholds()`` before every step and feeds the step's
    ``u``/``fhat``/trigger outcome back through ``update``.  Thresholds
    are data, a (B,) host vector the trigger compare reads, never part
    of the device work.
  * ``FixedPolicy``    — today's behavior, bitwise-identical to a
    policy-free session (the regression anchor: ``tau[i]`` is exactly
    the float32 the scalar comparison used to produce).
  * ``QuantilePolicy`` — per-stream running-quantile tracker: ``tau[i]``
    rides the ``1 - target_rate`` quantile of stream i's recent u
    window, holding each stream near a trigger-rate budget.
  * ``BudgetPolicy``   — AIMD controller that holds a false-negative
    proxy budget at minimum comms, consuming the per-stream
    ``CommsMeter`` windowed trigger-rate gauge as its comms feedback.
  * ``CascadeSession`` — edge -> regional corrector -> central
    corrector: two ``MonitorSession``s composed into a three-rung
    topology where the regional tier's RESIDUAL margin drives its own
    escalation policy to the central tier, each hop metered in a
    distinct comms bucket (``report()["tier1"]`` / ``["tier2"]``).

SAFETY ARGUMENT (why threshold motion cannot create false negatives).
The reference's sign certificates (its ``analysis/signs.py``) prove
``corr >= 0`` and ``fhat <= u`` for the catch-up REGARDLESS of when
corrections are requested — the trigger threshold only selects *when* the server is
consulted, never the corrector's sign.  Because ``u`` is an upper bound
on the monitored score, an alarm candidate (``u`` above the alarm level)
that a raised threshold leaves unconsulted STANDS as a raw alarm — a
possible false positive, never a suppressed warning.  Controllers
therefore treat raising ``tau`` (fewer consults, more comms saved) as
the move that needs evidence, and keep two hard rules:

  * the calibrated operating point ``tau0 = threshold - margin`` is a
    FLOOR — policies only ever raise above it;
  * when recent-margin evidence is thin (cold stream, stale window) or a
    controller's risk budget is blown, ``tau`` may only move in the
    fhat-conservative direction: multiplicative decay back toward the
    floor.

Controller state is CLIENT-HELD (it lives in the policy object next to
the session, like the token history), while ``attach`` of a fresh
stream cold-starts the slot's controller (no threshold leakage across
tenants).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np

__all__ = ["TriggerPolicy", "FixedPolicy", "QuantilePolicy", "BudgetPolicy",
           "CascadeSession"]


def _tau0_of(threshold: float, margin: float) -> np.float32:
    """The engine's calibrated point is ``f32(threshold - margin)`` (the
    Python-float difference rounded once to f32) -- reproduce that exact
    float so a FixedPolicy vector compares bitwise."""
    return np.float32(threshold - margin)


class TriggerPolicy:
    """Base class / interface for per-stream threshold controllers.

    Lifecycle: the session ``bind``s the policy to the engine's
    calibrated operating point (threshold, margin, batch) at open, then
    per step::

        tau = policy.step_thresholds()     # (B,) f32, engine triggers u > tau
        ...engine steps...
        policy.update(u, fhat, triggered, active, meter)

    ``reset_stream(slot)`` cold-starts one slot's controller (called on
    ``attach``).  Subclasses override ``_reset_slot_state`` and
    ``_update``; the base class owns the tau buffer and the floor.
    """

    name = "policy"

    def bind(self, *, threshold: float, margin: float,
             batch: int) -> "TriggerPolicy":
        self._gamma = np.float32(threshold)     # the alarm level (paper gamma)
        self._tau0 = _tau0_of(threshold, margin)  # calibrated floor
        self._batch = int(batch)
        self._tau = np.full(batch, self._tau0, np.float32)
        self.reset()
        return self

    @property
    def is_bound(self) -> bool:
        return hasattr(self, "_tau")

    @property
    def tau0(self) -> float:
        return float(self._tau0)

    def reset(self) -> None:
        for slot in range(self._batch):
            self.reset_stream(slot)

    def reset_stream(self, slot: int) -> None:
        """Cold controller for ``slot``: threshold back at the calibrated
        floor, all per-stream evidence dropped."""
        self._tau[slot] = self._tau0
        self._reset_slot_state(slot)

    def step_thresholds(self) -> np.ndarray:
        """(B,) float32 effective trigger points for the NEXT step."""
        return self._tau

    def update(self, u, fhat, triggered, active, meter=None) -> None:
        """Feed one step's outcome back.  ``u``/``fhat``: (B,) scores;
        ``triggered``/``active``: (B,) bool; ``meter``: the engine's
        ``CommsMeter`` (windowed per-stream trigger-rate feedback)."""
        self._update(np.asarray(u, np.float32), np.asarray(fhat, np.float32),
                     np.asarray(triggered, bool), np.asarray(active, bool),
                     meter)
        # the floor is an invariant, not a convention subclasses must keep
        np.maximum(self._tau, self._tau0, out=self._tau)

    def state(self) -> Dict[str, Any]:
        """Introspection snapshot (tests, benches, docs)."""
        return {"name": self.name, "tau": self._tau.copy(),
                "tau0": float(self._tau0)}

    # -- subclass hooks ------------------------------------------------------
    def _reset_slot_state(self, slot: int) -> None:
        pass

    def _update(self, u, fhat, triggered, active, meter) -> None:
        pass


class FixedPolicy(TriggerPolicy):
    """The paper's fixed operating point as a (degenerate) policy: every
    stream's tau stays pinned at the calibrated floor.  Bitwise-identical
    to a policy-free session on all four session paths (the regression
    anchor, asserted in tests/test_policy.py)."""

    name = "fixed"


class QuantilePolicy(TriggerPolicy):
    """Per-stream running margin-quantile tracker.

    Holds each stream near a trigger-rate budget: ``tau[i]`` tracks the
    ``1 - target_rate`` quantile of stream i's last ``window`` u values,
    floored at the calibrated ``tau0``.  Cold streams (fewer than
    ``min_samples`` observations — thin evidence) sit AT the floor: the
    conservative direction.

    target_rate — per-stream trigger-rate budget (fraction of steps).
    window      — u observations retained per stream.
    min_samples — observations before tau may leave the floor.
    """

    name = "quantile"

    def __init__(self, target_rate: float = 0.1, *, window: int = 64,
                 min_samples: int = 16):
        if not 0.0 < target_rate <= 1.0:
            raise ValueError("target_rate must be in (0, 1]")
        if window < 1 or min_samples < 1:
            raise ValueError("window and min_samples must be >= 1")
        self.target_rate = float(target_rate)
        self.window = int(window)
        self.min_samples = int(min_samples)

    def bind(self, **kw) -> "QuantilePolicy":
        b = kw["batch"]
        self._uwin = np.zeros((b, self.window), np.float32)
        self._n = np.zeros(b, np.int64)
        return super().bind(**kw)

    def _reset_slot_state(self, slot: int) -> None:
        self._uwin[slot] = 0.0
        self._n[slot] = 0

    def _update(self, u, fhat, triggered, active, meter) -> None:
        q = 1.0 - self.target_rate
        for i in np.flatnonzero(active):
            self._uwin[i, self._n[i] % self.window] = u[i]
            self._n[i] += 1
            k = min(int(self._n[i]), self.window)
            if k >= self.min_samples:
                self._tau[i] = np.quantile(self._uwin[i, :k], q)

    def state(self) -> Dict[str, Any]:
        return {**super().state(), "n_observed": self._n.copy(),
                "target_rate": self.target_rate}


class BudgetPolicy(TriggerPolicy):
    """AIMD controller: hold a false-negative proxy budget at minimum
    comms, consuming the ``CommsMeter``'s windowed per-stream
    trigger-rate gauge as comms feedback.

    The FN proxy is the windowed rate of UNCORRECTED ALARM CANDIDATES:
    steps where ``u`` crossed the alarm level gamma but the raised tau
    skipped the consult.  (Sign-safety means such a skip can only leave a
    false positive standing, never suppress a warning — see the module
    docstring — but each one is a correction the calibrated policy would
    have bought, so it is the honest risk proxy to budget.)

    Update rule, per active stream i (AIMD, floor ``tau0``):

      1. CONSERVATIVE-ONLY under thin evidence or a blown budget — if
         fewer than ``min_evidence`` consult margins (``gamma - fhat``
         on recent consulted steps) are in the window (cold stream: the
         controller has never seen what corrections buy here), or the
         FN proxy exceeds ``fn_budget``: multiplicative decay
         ``tau <- tau0 + (tau - tau0) * decay``.
      2. ADDITIVE INCREASE — else, while the meter's recent trigger rate
         sits above ``target_rate`` (the comms budget ceiling): raise
         ``tau`` by ``step`` (default: a quarter of the stream's recent
         u spread above the floor, so the raise is scale-free).
      3. otherwise hold.

    (A raised tau converts would-be consults into skips, never alarms
    into silence: ``fhat = u`` on a skipped candidate keeps the alarm
    raised — see the module safety argument.  The skip-rate budget is
    therefore a COST budget on foregone corrections, and the controller
    needs no separate alarm-proximity brake.)

    target_rate  — comms budget: windowed per-stream trigger-rate
                   ceiling the controller works down toward.
    fn_budget    — windowed uncorrected-alarm-candidate budget.
    window       — evidence window (u values, skip indicators, margins).
    min_evidence — consult margins required before tau may rise.
    decay        — multiplicative return factor toward the floor.
    step         — additive raise; None = adaptive from the u window.
    """

    name = "budget"

    def __init__(self, target_rate: float = 0.1, *, fn_budget: float = 0.1,
                 window: int = 32, min_evidence: int = 4, decay: float = 0.5,
                 step: Optional[float] = None):
        if not 0.0 < target_rate <= 1.0:
            raise ValueError("target_rate must be in (0, 1]")
        if not 0.0 <= fn_budget <= 1.0:
            raise ValueError("fn_budget must be in [0, 1]")
        if not 0.0 <= decay < 1.0:
            raise ValueError("decay must be in [0, 1)")
        self.target_rate = float(target_rate)
        self.fn_budget = float(fn_budget)
        self.window = int(window)
        self.min_evidence = int(min_evidence)
        self.decay = float(decay)
        self.step = None if step is None else float(step)

    def bind(self, **kw) -> "BudgetPolicy":
        b, w = kw["batch"], self.window
        self._uwin = np.zeros((b, w), np.float32)
        self._skip = np.zeros((b, w), bool)   # uncorrected alarm candidates
        self._trig = np.zeros((b, w), bool)   # meterless rate fallback
        self._marg = np.full((b, w), np.inf, np.float32)  # consult margins
        self._n = np.zeros(b, np.int64)       # steps observed
        self._nm = np.zeros(b, np.int64)      # margins observed
        return super().bind(**kw)

    def _reset_slot_state(self, slot: int) -> None:
        self._uwin[slot] = 0.0
        self._skip[slot] = False
        self._trig[slot] = False
        self._marg[slot] = np.inf
        self._n[slot] = 0
        self._nm[slot] = 0

    def _update(self, u, fhat, triggered, active, meter) -> None:
        rates = None
        if meter is not None:
            rates = meter.recent_trigger_rate()
        for i in np.flatnonzero(active):
            w = int(self._n[i] % self.window)
            self._uwin[i, w] = u[i]
            self._skip[i, w] = bool(u[i] > self._gamma) and not triggered[i]
            self._trig[i, w] = bool(triggered[i])
            if triggered[i]:
                self._marg[i, self._nm[i] % self.window] = self._gamma - fhat[i]
                self._nm[i] += 1
            self._n[i] += 1
            k = min(int(self._n[i]), self.window)
            km = min(int(self._nm[i]), self.window)
            fn_proxy = float(self._skip[i, :self.window].sum()) / k if k else 0.0
            thin = km < self.min_evidence
            if thin or fn_proxy > self.fn_budget:
                # conservative-only motion under thin evidence / blown
                # skip budget
                self._tau[i] = self._tau0 + (self._tau[i] - self._tau0) * self.decay
            else:
                if rates is not None:
                    rate = float(rates[i])
                else:
                    # no meter: fall back to the policy's own window
                    rate = float(self._trig[i, :k].mean())
                if rate > self.target_rate:
                    if self.step is not None:
                        raise_by = self.step
                    else:
                        spread = float(self._uwin[i, :k].max()) - float(self._tau0)
                        raise_by = max(1e-4, 0.25 * max(spread, 0.0))
                    self._tau[i] = self._tau[i] + np.float32(raise_by)

    def state(self) -> Dict[str, Any]:
        k = np.minimum(np.maximum(self._n, 1), self.window)
        return {**super().state(), "n_observed": self._n.copy(),
                "n_margins": self._nm.copy(),
                "fn_proxy": self._skip.sum(axis=1) / k,
                "target_rate": self.target_rate,
                "fn_budget": self.fn_budget}


# ---------------------------------------------------------------------------
# Three-rung cascade: edge -> regional corrector -> central corrector
# ---------------------------------------------------------------------------

_FORCE = np.float32(-np.inf)     # u > -inf: consult unconditionally
_SUPPRESS = np.float32(np.inf)   # u > +inf: never consult


class CascadeSession:
    """Edge -> regional corrector -> central corrector: two
    ``MonitorSession``s composed into the paper's two-tier decomposition
    plus a third rung.

    Topology.  Both sessions share the SAME edge tower (same ``u``,
    asserted bitwise every step).  The tier-1 session runs the ordinary
    protocol against the REGIONAL corrector (its transport is hop 1).
    The regional tier's RESIDUAL margin — its corrected ``fhat1`` —
    drives an escalation policy: rows whose residual still crowds the
    escalation threshold are escalated to the CENTRAL corrector by
    forcing the tier-2 session's per-stream thresholds (``-inf`` =
    consult, ``+inf`` = stay local), reusing the same vector-threshold
    mechanism every policy uses.  The final report takes the TIGHTER of
    the two corrected scores on escalated rows (both are sign-safe upper
    bounds, so ``fhat <= u`` holds at every rung — asserted each step).

    Comms.  Each hop is metered in its own session's ``CommsMeter``;
    ``report()`` returns them as distinct ``tier1`` / ``tier2`` buckets.
    Escalation re-ships from the client-held history, so tier-2 bytes
    are real shipped-token charges, not estimates.

    Membership is FIXED for the cascade's lifetime (attach/detach of the
    composed sessions would desynchronize the tiers — refused loudly).

    tier1 / tier2 — two open-able ``MonitorSession``s over engines built
                    from the same params (any non-scan mode; tier2 must
                    not carry its own policy — the cascade drives it).
    escalation    — a ``TriggerPolicy`` evaluated on the tier-1 residual
                    ``fhat1`` (default ``FixedPolicy``), bound at
                    ``escalate_above``.
    escalate_above — the escalation threshold on ``fhat1``.
    """

    def __init__(self, tier1, tier2, *, escalate_above: float,
                 escalation: Optional[TriggerPolicy] = None):
        if tier1.config.mode == "scan" or tier2.config.mode == "scan":
            raise ValueError("cascade tiers must be online sessions "
                             "(sync/async), not scan")
        if tier2.config.policy is not None:
            raise ValueError(
                "tier2 carries SessionConfig.policy: the cascade drives the "
                "central tier's thresholds itself (escalation=...)")
        if tier1.engine.batch != tier2.engine.batch:
            raise ValueError(
                f"tier batch mismatch: {tier1.engine.batch} != "
                f"{tier2.engine.batch}")
        self.tier1, self.tier2 = tier1, tier2
        self.escalation = (escalation if escalation is not None
                           else FixedPolicy())
        self.escalation.bind(threshold=float(escalate_above), margin=0.0,
                             batch=tier1.engine.batch)
        self._n_escalated = 0

    # -- lifecycle -----------------------------------------------------------
    def __enter__(self) -> "CascadeSession":
        self.tier1.__enter__()
        self.tier2.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        try:
            self.tier1.close()
        finally:
            self.tier2.close()

    def attach(self, *a, **kw):
        raise RuntimeError("cascade membership is fixed: attach/detach "
                           "would desynchronize the tiers")

    detach = attach

    @property
    def streams(self):
        return self.tier1.streams

    # -- serving -------------------------------------------------------------
    def step(self, tokens) -> Dict[str, Any]:
        """One cascade step: tier-1 protocol step, escalation decision on
        the residual, forced tier-2 consult on escalated rows.  Returns
        the merged ``fhat`` plus both tiers' traces and the escalation
        mask.  ``fhat <= u`` is asserted at every rung."""
        r1 = self.tier1.step(tokens)
        u1, fhat1 = r1["u"], r1["fhat"]
        active = self.tier1.engine.active
        if not (fhat1 <= u1).all():
            raise AssertionError("tier1 violated fhat <= u")
        # escalation: the regional tier's residual margin vs its policy
        tau_esc = self.escalation.step_thresholds()
        esc = (fhat1 > tau_esc) & active
        # drive tier2 through the same per-stream vector-threshold
        # mechanism: escalated rows consult unconditionally, the rest
        # never do (thresholds are data)
        self.tier2.engine._thr_eff = np.where(esc, _FORCE, _SUPPRESS)
        r2 = self.tier2.step(tokens)
        u2, fhat2 = r2["u"], r2["fhat"]
        if not np.array_equal(u2, u1):
            raise AssertionError(
                "cascade tiers disagree on u: both tiers must share the "
                "same edge tower (build both engines from the same params)")
        if not (fhat2 <= u2).all():
            raise AssertionError("tier2 violated fhat <= u")
        self.escalation.update(fhat1, fhat1, esc, active,
                               self.tier2.engine.comms)
        self._n_escalated += int(esc.sum())
        # both corrected scores are sign-safe upper bounds: take the
        # tighter one where the central tier was consulted
        fhat = np.where(esc, np.minimum(fhat1, fhat2), fhat1)
        if not (fhat <= u1).all():
            raise AssertionError("cascade violated fhat <= u")
        return {"u": u1, "fhat": fhat, "fhat_tier1": fhat1,
                "fhat_tier2": fhat2, "triggered": r1["triggered"],
                "escalated": esc, "streams": r1["streams"]}

    def run(self, token_stream) -> Dict[str, Any]:
        """Serve a full fixed stream through the cascade; returns stacked
        traces plus the per-tier comms report."""
        S = token_stream.shape[1]
        outs = []
        try:
            for t in range(S):
                outs.append(self.step(np.asarray(token_stream[:, t])))
        finally:
            self.close()
        stacked = {k: np.stack([o[k] for o in outs], 1)
                   for k in ("u", "fhat", "fhat_tier1", "fhat_tier2",
                             "triggered", "escalated")}
        stacked["streams"] = self.streams
        stacked["comms"] = self.report()
        return stacked

    def report(self) -> Dict[str, Any]:
        """Per-hop comms: ``tier1`` = edge->regional, ``tier2`` =
        regional->central (shipped from the client-held history)."""
        return {"tier1": self.tier1.report(), "tier2": self.tier2.report(),
                "escalated_steps": self._n_escalated}
