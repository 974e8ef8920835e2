"""The port's threshold policies and cascade (repro_torch.serving.policy)
on the CPU.

Against the JAX package: every policy, fed the same u/fhat/trigger
sequence (and the same comms meter updates), gives the reference policy's
threshold trajectory bitwise.  Inside the port, mirroring
tests/test_policy.py and tests/test_churn.py::TestPolicyChurn:
``FixedPolicy`` is bitwise a policy-free session on the sync, scan,
async-thread and sync-over-thread paths, and those paths agree with each
other; ``fhat <= u`` under any threshold trajectory; the floor holds; the
controllers' rules; the three-rung cascade; and a re-attached slot gets a
cold controller.  The cascade over the wire transport is tested in
tests/test_torch_server.py.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.gating import CommsMeter as JCommsMeter
from repro.serving import policy as jpolicy
from repro_torch.core.gating import CommsMeter
from repro_torch.serving import (BudgetPolicy, CascadeSession, FixedPolicy,
                                 QuantilePolicy, SessionConfig, TriggerPolicy)
from repro_torch.serving.collaborative import CollaborativeEngine

from _torch_parity import collab_pair, token_stream, with_threshold

_PAIR = {}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(threshold=0.1, batch=3, length=16):
    """granite SMOKE weights from the reference's init (through the
    bridge), a threshold and a stream."""
    if "p" not in _PAIR:
        _PAIR["p"] = collab_pair("granite-8b")
    _, tcfg, _, model = _PAIR["p"]
    cfg = with_threshold(tcfg, threshold)
    return cfg, model, token_stream(cfg, batch, length, seed=0)


def _engine(cfg, model, batch, max_len):
    return CollaborativeEngine(model, cfg, batch, max_len, device="cpu")


def _comms_key(rep):
    return (rep["trigger_rate"], rep["bytes_sent"], rep["bytes_baseline"])


# -- against the reference's policies ----------------------------------------

def _policies(kind, lib):
    return {"fixed": lambda: lib.FixedPolicy(),
            "quantile": lambda: lib.QuantilePolicy(0.3, window=8,
                                                   min_samples=3),
            "budget": lambda: lib.BudgetPolicy(0.2, fn_budget=0.3, window=8,
                                               min_evidence=2),
            "budget-step": lambda: lib.BudgetPolicy(0.1, fn_budget=0.5,
                                                    window=6, min_evidence=1,
                                                    decay=0.25, step=0.05),
            }[kind]()


@pytest.mark.parametrize("kind", ["fixed", "quantile", "budget",
                                  "budget-step"])
@pytest.mark.parametrize("with_meter", [True, False])
def test_threshold_trajectory_matches_reference(kind, with_meter):
    """Closed loop on a synthetic margin stream: each step triggers where
    u > tau, and both packages' policies (and meters) see the same
    outcome; their (B,) thresholds stay bitwise equal at every step, also
    across a cold restart of one slot."""
    from repro_torch.serving import policy as tpolicy
    B, S = 4, 60
    rng = np.random.default_rng(11)
    drift = np.linspace(-0.5, 1.5, S)[:, None]
    u = (rng.normal(0.0, 0.6, (S, B)) + drift).astype(np.float32)
    corr = rng.uniform(0.0, 1.0, (S, B)).astype(np.float32)
    active = rng.random((S, B)) > 0.1
    tp, jp = _policies(kind, tpolicy), _policies(kind, jpolicy)
    for p in (tp, jp):
        p.bind(threshold=0.3, margin=0.05, batch=B)
    tm = CommsMeter(8, n_streams=B, rate_window=16) if with_meter else None
    jm = JCommsMeter(8, n_streams=B, rate_window=16) if with_meter else None
    moved = False
    for t in range(S):
        tau = tp.step_thresholds().copy()
        np.testing.assert_array_equal(tau, jp.step_thresholds())
        moved |= bool((tau != np.float32(0.3 - 0.05)).any())
        trig = (u[t] > tau) & active[t]
        fhat = np.where(trig, u[t] - corr[t], u[t]).astype(np.float32)
        if with_meter:
            for m in (tm, jm):
                m.update_per_stream(trig.astype(np.int64),
                                    active[t].astype(np.int64))
        tp.update(u[t], fhat, trig, active[t], tm)
        jp.update(u[t], fhat, trig, active[t], jm)
        if t == S // 2:
            tp.reset_stream(1)
            jp.reset_stream(1)
    np.testing.assert_array_equal(tp.step_thresholds(), jp.step_thresholds())
    assert moved == (kind != "fixed")


# -- config validation --------------------------------------------------------

def test_threshold_plus_policy_refused():
    with pytest.raises(ValueError) as ei:
        SessionConfig(policy=FixedPolicy(), threshold=0.25)
    assert "SessionConfig.threshold" in str(ei.value)
    assert "SessionConfig.policy" in str(ei.value)


def test_margin_override_alone_still_works_with_policy():
    SessionConfig(policy=FixedPolicy(), trigger_margin=None)


def test_non_policy_object_refused():
    with pytest.raises(ValueError, match="TriggerPolicy"):
        SessionConfig(policy=object())


# -- FixedPolicy: the bitwise anchor ------------------------------------------

def test_sync_scan_async_thread_identical():
    """Each session path: a FixedPolicy session is bitwise (u, fhat,
    triggers, comms) a policy-free one (on async-thread, where a reply
    merges at age 1 or 2 as the worker keeps up, u and triggers bitwise
    and fhat <= u); across paths u and triggers are identical, fhat
    exactly between sync and sync-over-thread (the strict boundary) and
    within 1e-6 of scan."""
    cfg, model, stream = _setup()
    B, S = stream.shape

    def run(config):
        eng = _engine(cfg, model, B, S)
        r = eng.session(config).run(stream)
        return ({k: np.asarray(r[k]) for k in ("u", "fhat", "triggered")},
                _comms_key(eng.comms.report()))

    paths = [
        ("sync", lambda p: SessionConfig(mode="sync", policy=p)),
        ("scan", lambda p: SessionConfig(mode="scan", policy=p)),
        ("async", lambda p: SessionConfig(mode="async", transport="inproc",
                                          max_staleness=2, policy=p)),
        ("async_thread", lambda p: SessionConfig(
            mode="async", transport="thread", max_staleness=2, policy=p)),
        ("sync_thread", lambda p: SessionConfig(mode="sync",
                                                transport="thread",
                                                policy=p)),
    ]
    results = {}
    for name, mk in paths:
        base, comms_base = run(mk(None))
        fixed, comms_fixed = run(mk(FixedPolicy()))
        for k in ("u", "fhat", "triggered"):
            if name == "async_thread" and k == "fhat":
                assert (fixed["fhat"] <= fixed["u"]).all()
                continue
            assert np.array_equal(base[k], fixed[k]), (name, k)
        if name != "scan":  # scan derives comms from the trace
            assert comms_base == comms_fixed, name
        results[name] = fixed
    assert 0 < results["sync"]["triggered"].mean() < 1
    for name in ("scan", "async", "async_thread", "sync_thread"):
        assert np.array_equal(results["sync"]["u"], results[name]["u"])
        assert np.array_equal(results["sync"]["triggered"],
                              results[name]["triggered"])
    np.testing.assert_allclose(results["sync"]["fhat"],
                               results["scan"]["fhat"], atol=1e-6, rtol=0)
    assert np.array_equal(results["sync"]["fhat"],
                          results["sync_thread"]["fhat"])


def test_moving_policy_same_u_sync_and_async():
    """Under a QuantilePolicy that moves every stream's threshold, the
    async (thread, k=2) session sees the sync session's u and triggers
    bitwise: thresholds read only u, which never waits on the server."""
    cfg, model, stream = _setup()
    B, S = stream.shape
    outs = {}
    for name, conf in (("sync", {}), ("async", dict(
            mode="async", transport="thread", max_staleness=2))):
        pol = QuantilePolicy(0.3, window=4, min_samples=2)
        r = _engine(cfg, model, B, S).session(
            SessionConfig(policy=pol, **conf)).run(stream)
        outs[name] = (r, pol.state()["tau"])
        assert (r["fhat"] <= r["u"]).all()
    (rs, tau_s), (ra, tau_a) = outs["sync"], outs["async"]
    np.testing.assert_array_equal(rs["u"], ra["u"])
    np.testing.assert_array_equal(rs["triggered"], ra["triggered"])
    np.testing.assert_array_equal(tau_s, tau_a)
    assert (tau_s != np.float32(0.1)).any(), "the policy moved"


# -- safety: fhat <= u under any trajectory -----------------------------------

class _AdversarialPolicy(TriggerPolicy):
    """Arbitrary per-stream thresholds each step from a seeded RNG (the
    base class clamps them to the floor)."""

    name = "adversarial"

    def __init__(self, seed, lo=-2.0, hi=2.0):
        self._rng = np.random.default_rng(seed)
        self._lo, self._hi = lo, hi

    def _update(self, u, fhat, triggered, active, meter):
        self._tau[:] = self._rng.uniform(
            self._lo, self._hi, self._batch).astype(np.float32)


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(0, 2**31 - 1),
       kind=st.sampled_from(["adversarial", "quantile", "budget"]))
def test_fhat_bounded_by_u_any_trajectory(seed, kind):
    cfg, model, _ = _setup()
    rng = np.random.default_rng(seed)
    B, S = 3, 10
    stream = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pol = {"adversarial": lambda: _AdversarialPolicy(seed),
           "quantile": lambda: QuantilePolicy(0.5, window=3, min_samples=1),
           "budget": lambda: BudgetPolicy(0.2, fn_budget=0.3, window=4,
                                          min_evidence=1)}[kind]()
    eng = _engine(cfg, model, B, S)
    with eng.session(SessionConfig(mode="sync", policy=pol)) as sess:
        for t in range(S):
            r = sess.step(stream[:, t])
            assert (r["fhat"] <= r["u"]).all(), (kind, t)


def test_floor_is_enforced():
    pol = _AdversarialPolicy(0, lo=-100.0, hi=-50.0)
    pol.bind(threshold=0.1, margin=0.0, batch=4)
    pol.update(np.zeros(4), np.zeros(4), np.zeros(4, bool), np.ones(4, bool))
    assert (pol.step_thresholds() >= np.float32(0.1)).all()


# -- controllers --------------------------------------------------------------

def test_quantile_tracks_per_stream_quantile():
    pol = QuantilePolicy(0.25, window=8, min_samples=4)
    pol.bind(threshold=0.0, margin=0.0, batch=2)
    rng = np.random.default_rng(0)
    u0 = rng.normal(2.0, 0.1, 16)
    u1 = rng.normal(-1.0, 0.1, 16)
    for a, b in zip(u0, u1):
        x = np.asarray([a, b], np.float32)
        pol.update(x, x, np.zeros(2, bool), np.ones(2, bool))
    tau = pol.step_thresholds()
    assert abs(tau[0] - np.quantile(u0[-8:].astype(np.float32), 0.75)) < 0.2
    assert tau[1] == np.float32(0.0)


def test_quantile_cold_stream_sits_at_floor():
    pol = QuantilePolicy(0.25, window=8, min_samples=6)
    pol.bind(threshold=0.5, margin=0.1, batch=1)
    for _ in range(5):
        pol.update(np.asarray([3.0]), np.asarray([3.0]), np.zeros(1, bool),
                   np.ones(1, bool))
    assert pol.step_thresholds()[0] == np.float32(0.5 - 0.1)


def _drive(pol, n, *, u=2.0, trig=True, fhat=None):
    """n identical steps on a 1-stream policy with a live meter."""
    meter = CommsMeter(bytes_per_request=8, n_streams=1, rate_window=8)
    for _ in range(n):
        t = np.asarray([trig])
        meter.update_per_stream(t.astype(np.int64), np.ones(1, np.int64))
        pol.update(np.asarray([u], np.float32),
                   np.asarray([fhat if fhat is not None else u - 1.0],
                              np.float32), t, np.ones(1, bool), meter)
    return pol.step_thresholds()[0]


def test_budget_raises_when_over_rate_with_healthy_margins():
    pol = BudgetPolicy(0.1, fn_budget=0.9, window=8, min_evidence=2)
    pol.bind(threshold=0.0, margin=0.0, batch=1)
    assert _drive(pol, 12, u=2.0, trig=True, fhat=-1.0) > np.float32(0.0)


def test_budget_thin_evidence_decays_to_floor():
    pol = BudgetPolicy(0.1, fn_budget=0.9, window=8, min_evidence=4)
    pol.bind(threshold=0.0, margin=0.0, batch=1)
    _drive(pol, 12, u=2.0, trig=True, fhat=-1.0)
    pol.reset_stream(0)
    assert _drive(pol, 12, u=2.0, trig=False) == np.float32(0.0)


def test_budget_blown_skip_budget_decays():
    pol = BudgetPolicy(0.1, fn_budget=0.2, window=8, min_evidence=2,
                       step=1.0)
    pol.bind(threshold=0.0, margin=0.0, batch=1)
    _drive(pol, 8, u=2.0, trig=True, fhat=-1.0)
    raised = pol.step_thresholds()[0]
    assert raised > np.float32(0.0)
    assert _drive(pol, 8, u=2.0, trig=False) < raised


def test_budget_conservative_motion_is_monotone_decay():
    pol = BudgetPolicy(0.1, fn_budget=0.2, window=8, min_evidence=2,
                       decay=0.5, step=1.0)
    pol.bind(threshold=0.0, margin=0.0, batch=1)
    _drive(pol, 8, u=2.0, trig=True, fhat=-1.0)
    taus = [pol.step_thresholds()[0]]
    for _ in range(6):
        _drive(pol, 1, u=2.0, trig=False)
        taus.append(pol.step_thresholds()[0])
    assert (np.diff(np.asarray(taus, np.float64)) <= 0).all()
    assert (np.asarray(taus) >= 0).all()


# -- cascade ------------------------------------------------------------------

def _cascade(cfg, model, stream, *, esc=0.05, escalation=None,
             tier1=None):
    B, S = stream.shape

    def tier(config):
        return _engine(cfg, model, B, S).session(config or SessionConfig())
    return CascadeSession(tier(tier1), tier(None), escalate_above=esc,
                          escalation=escalation)


@pytest.mark.parametrize("tier1", [None, SessionConfig(
    mode="async", transport="inproc", max_staleness=2)],
    ids=["sync", "async-tier1"])
def test_cascade_three_rungs(tier1):
    """Edge -> regional -> central: escalated rows take the tighter
    corrected score, per-tier buckets account separately, fhat <= u at
    every rung."""
    cfg, model, stream = _setup()
    out = _cascade(cfg, model, stream, tier1=tier1).run(stream)
    assert (out["fhat"] <= out["u"]).all()
    assert (out["fhat_tier1"] <= out["u"]).all()
    assert (out["fhat_tier2"] <= out["u"]).all()
    esc = out["escalated"]
    assert esc.any()
    merged = np.where(esc, np.minimum(out["fhat_tier1"], out["fhat_tier2"]),
                      out["fhat_tier1"])
    assert np.array_equal(out["fhat"], merged)
    rep = out["comms"]
    assert rep["tier1"]["bytes_sent"] > 0
    assert rep["tier2"]["bytes_sent"] > 0
    assert rep["escalated_steps"] == int(esc.sum())


def test_cascade_no_escalation_when_residual_clears():
    cfg, model, stream = _setup()
    out = _cascade(cfg, model, stream, esc=1e9).run(stream)
    assert not out["escalated"].any()
    assert out["comms"]["tier2"]["bytes_sent"] == 0
    assert np.array_equal(out["fhat"], out["fhat_tier1"])


def test_cascade_membership_is_fixed():
    cfg, model, stream = _setup()
    casc = _cascade(cfg, model, stream)
    with pytest.raises(RuntimeError, match="fixed"):
        casc.attach("x")
    with pytest.raises(RuntimeError, match="fixed"):
        casc.detach(0)
    casc.close()


def test_cascade_tier2_policy_refused():
    cfg, model, stream = _setup()
    B, S = stream.shape
    t1 = _engine(cfg, model, B, S).session(SessionConfig(mode="sync"))
    t2 = _engine(cfg, model, B, S).session(
        SessionConfig(mode="sync", policy=FixedPolicy()))
    with pytest.raises(ValueError, match="cascade drives"):
        CascadeSession(t1, t2, escalate_above=0.0)


# -- churn --------------------------------------------------------------------

def test_reattached_slot_gets_cold_controller():
    """A re-attached slot's controller is cold (tau at the floor, no
    evidence) while co-resident streams keep their warmed thresholds, and
    the engine's threshold for the slot is back at the floor."""
    S = 16
    cfg, model, stream = _setup(threshold=-0.5, length=S)
    fresh = token_stream(cfg, 1, S, seed=7)[0]
    eng = _engine(cfg, model, 3, 32)
    pol = QuantilePolicy(0.3, window=6, min_samples=3)
    with eng.session(SessionConfig(mode="sync", policy=pol),
                     streams=["a", "b", "c"]) as session:
        for t in range(8):
            session.step({sid: stream[i, t] for i, sid in enumerate("abc")})
        warmed = pol.state()
        assert (warmed["n_observed"] >= 8).all()
        assert warmed["tau"][1] > np.float32(warmed["tau0"])
        session.detach("b")
        session.step({"a": stream[0, 8], "c": stream[2, 8]})
        tau_a_before = pol.state()["tau"][0]
        assert session.attach("d") == 1
        cold = pol.state()
        assert cold["tau"][1] == np.float32(cold["tau0"])
        assert cold["n_observed"][1] == 0
        assert eng._thr_eff[1] == np.float32(cold["tau0"])
        assert cold["tau"][0] == tau_a_before
        assert cold["n_observed"][0] >= 9
        for t2 in range(6):
            session.step({"a": stream[0, 9 + t2], "c": stream[2, 9 + t2],
                          "d": fresh[t2]})
        assert pol.state()["n_observed"][1] == 6
