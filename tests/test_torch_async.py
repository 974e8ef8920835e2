"""The port's async pipelined serving (repro_torch.serving.async_rpc and
the engine's async path) on the CPU.

Mirrors tests/test_serving.py::TestAsyncPipelinedEngine and the async half
of tests/test_churn.py::TestLocalChurn inside the port: the strict
boundary (max_staleness=0) is bit-identical to the port's sync step
(traces, comms, server_pos, server cache); u and the triggers never depend
on the staleness window; corrections merge one step late, within ages
1..k; the thread and mock_remote workers agree with sync bitwise; churn
survivors match a fixed-batch run.  Against the JAX package on the same
weights: the reference's ``run_async(transport="inproc",
max_staleness=2)`` and the port's agree on u and fhat within the dtype's
tolerance (f32 1e-4, bf16 2e-2), on triggers outside the tie band (its
count printed), and on per-stream bytes and the async counts.

The ``stream`` transport needs a CUDA engine and is tested on the card
(tests/test_torch_cuda.py); here it must raise.
"""
import sys
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.serving.collaborative import CollaborativeEngine as JEngine
from repro_torch.kernels.build import CudaKernel
from repro_torch.serving import MonitorSession, SessionConfig, TransportSpec
from repro_torch.serving import async_rpc
from repro_torch.serving.collaborative import CollaborativeEngine

from _torch_parity import (ARCHS, TOL_E2E, collab_pair, gap_threshold,
                           tie_band, token_stream, with_threshold)

_PAIRS = {}


@pytest.fixture(autouse=True)
def _one_thread():
    """Many tiny ops: one intra-op thread is as fast alone and does not
    thrash when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pair(arch):
    """(JAX cfg, port cfg, reference params, port model), once a process."""
    if arch not in _PAIRS:
        _PAIRS[arch] = collab_pair(arch)
    return _PAIRS[arch]


def _granite(threshold=0.1):
    _, tcfg, _, model = pair("granite-8b")
    return with_threshold(tcfg, threshold), model


def _engine(model, cfg, batch, max_len=32):
    return CollaborativeEngine(model, cfg, batch, max_len, device="cpu")


def run_async(eng, stream, *, transport="inproc", max_staleness=1,
              latency_s=None):
    spec = TransportSpec(transport, latency_s=latency_s)
    with eng.session(SessionConfig(mode="async", transport=spec,
                                   max_staleness=max_staleness)) as s:
        return s.run(stream)


def _assert_cache_equal(a, b):
    for name in a:
        for x, y in zip(a[name], b[name]):
            assert torch.equal(x, y), name


def _mixed_threshold(model, cfg, stream, batch):
    probe = _engine(model, cfg, batch).session(
        SessionConfig(mode="scan")).run(stream)
    return gap_threshold(probe["u"])[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_sync_fallback_bit_identical_to_sync(arch):
    """max_staleness=0 is the strict synchronous engine: same traces,
    comms, server positions and server cache, bit for bit; and against the
    scan path u and triggers bitwise, fhat within 1e-6."""
    _, tcfg, _, model = pair(arch)
    stream = token_stream(tcfg, 3, 16, seed=1)
    cfg = with_threshold(tcfg, _mixed_threshold(model, tcfg, stream, 3))
    sync = _engine(model, cfg, 3)
    r1 = sync.session().run(stream)
    a = _engine(model, cfg, 3)
    r0 = run_async(a, stream, max_staleness=0)
    rs = _engine(model, cfg, 3).session(SessionConfig(mode="scan")).run(stream)
    assert 0.0 < r1["triggered"].mean() < 1.0, "need mixed triggers"
    for key in ("u", "fhat", "triggered"):
        np.testing.assert_array_equal(r0[key], r1[key])
    for key in ("bytes_sent", "trigger_rate", "bytes_baseline"):
        assert r0["comms"][key] == r1["comms"][key]
    np.testing.assert_array_equal(r0["comms"]["per_stream"]["bytes_sent"],
                                  r1["comms"]["per_stream"]["bytes_sent"])
    assert r0["comms"]["async"]["merged_late"] == 0
    np.testing.assert_array_equal(a.server_pos, sync.server_pos)
    assert a.server.pos == sync.server.pos
    _assert_cache_equal(a.server.cache, sync.server.cache)
    np.testing.assert_array_equal(r0["u"], rs["u"])
    np.testing.assert_array_equal(r0["triggered"], rs["triggered"])
    np.testing.assert_allclose(r0["fhat"], rs["fhat"], atol=1e-6, rtol=0)


@settings(max_examples=5, deadline=None)
@given(staleness=st.integers(min_value=0, max_value=3),
       threshold=st.floats(min_value=-0.3, max_value=0.3))
def test_monitor_path_staleness_independent(staleness, threshold):
    """u and the trigger trace never depend on the staleness window (the
    monitor path does not wait on the server), and corrections only ever
    lower fhat below u."""
    cfg, model = _granite(threshold)
    stream = token_stream(cfg, 2, 8, seed=2)
    rs = _engine(model, cfg, 2, 16).session(
        SessionConfig(mode="scan")).run(stream)
    ra = run_async(_engine(model, cfg, 2, 16), stream,
                   max_staleness=staleness)
    np.testing.assert_array_equal(ra["u"], rs["u"])
    np.testing.assert_array_equal(ra["triggered"], rs["triggered"])
    assert (ra["fhat"] <= ra["u"]).all()


def _stub_u(eng, value=1.0):
    """A monitor that always scores ``value``: every stream triggers."""
    eng._u_head = lambda p, h: torch.full((h.shape[0],), value,
                                          dtype=torch.float32)


def test_corrections_merge_one_step_late():
    """With an always-triggering monitor the correction computed for step
    t lands in fhat at step t+1 (applied to step t+1's u); step 0 reports
    the uncorrected u."""
    cfg, model = _granite(threshold=0.5)
    stream = token_stream(cfg, 2, 10, seed=3)
    sync = _engine(model, cfg, 2, 16)
    _stub_u(sync)
    r1 = sync.session().run(stream)
    assert r1["triggered"].all()
    corr_sync = r1["u"] - r1["fhat"]  # s*sigma(v_t) per step
    assert (corr_sync > 0).any(), "the corrector must fire"
    a = _engine(model, cfg, 2, 16)
    _stub_u(a)
    ra = run_async(a, stream, max_staleness=2)
    assert ra["triggered"].all()
    np.testing.assert_array_equal(ra["fhat"][:, 0], ra["u"][:, 0])
    np.testing.assert_allclose(ra["fhat"][:, 1:],
                               ra["u"][:, 1:] - corr_sync[:, :-1], atol=1e-6)


@pytest.mark.parametrize("transport,staleness", [
    ("thread", 0), ("thread", 4), ("mock_remote", 4)])
def test_worker_transports_agree_with_sync(transport, staleness):
    """thread and mock_remote workers under a simulated latency: the sync
    run's u, triggers and shipped bytes (charged at dispatch, so
    staleness-independent), the bytes invariant, no request left in flight,
    and the final server cache and positions of the sync engine, bitwise;
    at the strict boundary fhat too."""
    cfg, model = _granite()
    stream = token_stream(cfg, 3, 16, seed=4)
    sync = _engine(model, cfg, 3)
    r1 = sync.session().run(stream)
    a = _engine(model, cfg, 3)
    ra = run_async(a, stream, transport=transport, latency_s=0.003,
                   max_staleness=staleness)
    assert 0.0 < r1["triggered"].mean() < 1.0
    np.testing.assert_array_equal(ra["u"], r1["u"])
    np.testing.assert_array_equal(ra["triggered"], r1["triggered"])
    if staleness == 0:
        np.testing.assert_array_equal(ra["fhat"], r1["fhat"])
    assert (ra["fhat"] <= ra["u"]).all()
    rep = ra["comms"]
    assert rep["bytes_sent"] == r1["comms"]["bytes_sent"]
    np.testing.assert_array_equal(rep["per_stream"]["bytes_sent"],
                                  r1["comms"]["per_stream"]["bytes_sent"])
    assert rep["bytes_sent"] <= rep["bytes_baseline"]
    assert (rep["per_stream"]["bytes_sent"]
            <= rep["per_stream"]["bytes_baseline"]).all()
    assert rep["async"]["requests"] > 0
    assert rep["async"]["inflight_now"] == 0
    assert 0.0 <= rep["async"]["overlap_ratio"] <= 1.0
    np.testing.assert_array_equal(a.server_pos, sync.server_pos)
    _assert_cache_equal(a.server.cache, sync.server.cache)


def test_staleness_bound_is_enforced():
    """No reply merges later than max_staleness steps after its trigger,
    and in pipelined mode none merges in-step (ages 1..k)."""
    cfg, model = _granite()
    stream = token_stream(cfg, 2, 12, seed=5)
    for k in (1, 3):
        a = _engine(model, cfg, 2, 16)
        ages = []
        orig = a.comms.record_merge
        a.comms.record_merge = lambda m, age: (ages.append(age), orig(m, age))
        run_async(a, stream, max_staleness=k)
        assert ages, "must have merged something"
        assert all(1 <= g <= k for g in ages)


def test_no_trigger_means_no_async_traffic():
    cfg, model = _granite(threshold=1e9)
    stream = token_stream(cfg, 3, 16)
    a = _engine(model, cfg, 3)
    ra = run_async(a, stream, transport="thread", max_staleness=4)
    assert ra["triggered"].sum() == 0
    assert ra["comms"]["bytes_sent"] == 0
    assert "async" not in ra["comms"], "no requests -> no async section"
    assert a.server.pos == 0, "the server cache must stay cold"
    np.testing.assert_array_equal(ra["fhat"], ra["u"])


def test_stream_transport_needs_a_cuda_engine():
    """No side stream to overlap on: a CPU engine refuses ``stream``
    rather than compute in place."""
    cfg, model = _granite()
    sess = _engine(model, cfg, 2, 8).session(
        SessionConfig(mode="async", transport="stream"))
    with pytest.raises(ValueError, match="CUDA"):
        sess.step([1, 2])


@pytest.mark.parametrize("transport", ["wire", "shm"])
def test_socket_workers_are_not_ported(transport):
    """``wire`` and ``shm`` are ported: each refuses a missing address and a
    simulated latency with the reference's ValueErrors (their sessions are
    tested in tests/test_torch_server.py and tests/test_torch_shm.py)."""
    cfg, model = _granite()
    eng = _engine(model, cfg, 2, 8)
    args = (eng._catchup_apply, eng.params, eng.server.cache)
    with pytest.raises(ValueError, match=f"{transport} transport needs"):
        async_rpc.make_worker(transport, *args)
    with pytest.raises(ValueError, match="measured"):
        async_rpc.make_worker(transport, *args, latency_s=0.01,
                              wire_opts={"address": "/nowhere"})


def test_thread_worker_reraises_a_failed_catchup():
    """A catch-up that raises on the worker thread surfaces at the edge
    loop's next wait, with the cause attached, instead of hanging it."""
    cfg, model = _granite()
    eng = _engine(model, cfg, 2, 16)

    def boom(*a):
        raise ValueError("catch-up failed")
    worker = async_rpc.ThreadWorker(boom, eng.params, eng.server.cache)
    sess = eng.session(SessionConfig(mode="async", transport="thread",
                                     max_staleness=1), worker=worker)
    _stub_u(eng)
    with pytest.raises(RuntimeError, match="worker thread died") as ei:
        sess.run(token_stream(cfg, 2, 4))
    assert isinstance(ei.value.__cause__, ValueError)
    worker._thread.join(timeout=10)
    assert not worker._thread.is_alive()


def test_launch_count_exact_across_threads():
    """An async session launches from the edge thread and the worker's
    thread at once: the kernels' counts stay exact (a lost ``+= 1`` would
    break chip_smoke's launch checks)."""
    k = CudaKernel("monitor_combine.cu", "monitor_combine", [])
    k._fn = lambda *a: 0          # a launch that always succeeds
    n_threads, calls = 8, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [k() for _ in range(calls)])
                   for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert k.launches == n_threads * calls


def _trace(outs, sid, k):
    return np.asarray([o[k] for o in outs[sid]])


@pytest.mark.parametrize("transport", ["inproc", "thread"])
def test_churn_survivors_exact_async(transport):
    """Async churn at max_staleness=2 (tests/test_churn.py::TestLocalChurn):
    streams present the whole run have the fixed-batch run's u and
    triggers bitwise and fhat <= u; the departed stream matched while
    attached; a detached slot accrues nothing; the joiner is bit-cold (its
    traces match a fresh engine's, its server catch-up starts at 0)."""
    cfg, model = _granite()
    S, detach_at, attach_at = 16, 6, 9
    stream = token_stream(cfg, 3, S, seed=6)
    fresh = token_stream(cfg, 1, S, seed=7)[0]
    ref = _engine(model, cfg, 3).session().run(stream)
    ref_d = _engine(model, cfg, 3).session().run(
        np.stack([stream[0], fresh, stream[2]]))
    eng = _engine(model, cfg, 3)
    config = SessionConfig(mode="async", transport=transport,
                           max_staleness=2)
    outs = {sid: [] for sid in "abcd"}
    with eng.session(config, streams=["a", "b", "c"]) as s:
        for t in range(S):
            if t == detach_at:
                s.detach("b")
                seen_at_detach = int(eng.comms.tokens_seen[1])
            if t == attach_at:
                assert s.attach("d") == 1
                assert eng.server_pos[1] == 0 and eng._dispatch_pos[1] == 0
                for c in (eng.edge.cache, eng._worker.cache):
                    assert not c["blocks"].k[:, 1].any()
            toks = {sid: stream["abc".index(sid), t]
                    for sid in s.streams if sid != "d"}
            if "d" in s.streams:
                toks["d"] = fresh[t - attach_at]
            r = s.step(toks)
            for i, sid in enumerate(r["streams"]):
                outs[sid].append((r["u"][i], r["fhat"][i], r["triggered"][i]))
        seen_final = int(eng.comms.tokens_seen[1])
    for sid, row in (("a", 0), ("c", 2)):
        np.testing.assert_array_equal(_trace(outs, sid, 0), ref["u"][row])
        np.testing.assert_array_equal(_trace(outs, sid, 2),
                                      ref["triggered"][row])
        assert (_trace(outs, sid, 1) <= _trace(outs, sid, 0)).all()
    np.testing.assert_array_equal(_trace(outs, "b", 0),
                                  ref["u"][1][:detach_at])
    assert seen_at_detach == detach_at
    assert seen_final == seen_at_detach + (S - attach_at)
    np.testing.assert_array_equal(_trace(outs, "d", 0),
                                  ref_d["u"][1][:S - attach_at])
    np.testing.assert_array_equal(_trace(outs, "d", 2),
                                  ref_d["triggered"][1][:S - attach_at])
    assert eng.comms.report()["async"]["inflight_now"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_matches_reference_run_async(arch):
    """The reference's ``run_async(transport="inproc", max_staleness=2)``
    and the port's on the same weights and stream: u and fhat within the
    dtype's tolerance, triggers exact outside the tie band, per-stream
    bytes and the async counts equal."""
    jcfg, tcfg, params, model = pair(arch)
    B, S = 3, 16
    stream = token_stream(tcfg, B, S, seed=8)
    thr = _mixed_threshold(model, tcfg, stream, B)
    tol = TOL_E2E[tcfg.dtype]
    with pytest.warns(DeprecationWarning):
        want = JEngine(params, with_threshold(jcfg, thr), batch=B,
                       max_len=32).run_async(stream, transport="inproc",
                                             max_staleness=2)
    with pytest.warns(DeprecationWarning):
        got = _engine(model, with_threshold(tcfg, thr), B).run_async(
            stream, transport="inproc", max_staleness=2)
    ties = tie_band(want["u"], thr, tol)
    print(f"\n{arch} async k=2: tie band |u-thr| <= {tol}: "
          f"{int(ties.sum())} of {ties.size} entries; trigger rate "
          f"{want['triggered'].mean():.3f}")
    assert 0 < want["triggered"].mean() < 1, "need mixed triggers"
    np.testing.assert_allclose(got["u"], want["u"], atol=tol, rtol=tol)
    np.testing.assert_allclose(got["fhat"], want["fhat"], atol=tol, rtol=tol)
    np.testing.assert_array_equal(got["triggered"][~ties],
                                  want["triggered"][~ties])
    for key in ("bytes_sent", "bytes_baseline"):
        np.testing.assert_array_equal(got["comms"]["per_stream"][key],
                                      want["comms"]["per_stream"][key])
    for key in ("requests", "merged_late", "inflight_now", "inflight_peak"):
        assert got["comms"]["async"][key] == want["comms"]["async"][key], key
