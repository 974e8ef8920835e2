"""The port's observability layer (repro_torch.observability, the
serving/tracker.py histogram and trackers) on the CPU.

Mirrors tests/test_observability.py: the tracer's ring, export and schema
gate, the metrics registry, histogram edge cases, the tracker ring; traced
sessions are bitwise identical to untraced ones on the sync, scan and
async paths; the disabled path never touches a tracer.  Against the JAX
package: a trace exported by either package validates under the other's
``validate_chrome_trace``, and a traced session of each package on the
same weights records the same span names and the same metrics keys.
Traced wire sessions and the wire timing payload are tested in
tests/test_torch_server.py.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.observability import load_trace as j_load_trace
from repro.observability import validate_chrome_trace as j_validate
from repro.serving import SessionConfig as JSessionConfig
from repro.serving.collaborative import CollaborativeEngine as JEngine
from repro.serving.tracker import Histogram as JHistogram
from repro_torch.observability import (MetricsRegistry, Tracer, breakdown,
                                       breakdown_table, flatten, load_trace,
                                       validate_chrome_trace)
from repro_torch.serving import SessionConfig
from repro_torch.serving.collaborative import CollaborativeEngine
from repro_torch.serving.tracker import (Histogram, InMemoryTracker,
                                         JsonFileTracker, read_stats)

from _torch_parity import collab_pair, token_stream, with_threshold

_PROTO = {}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- tracer -------------------------------------------------------------------

def test_spans_record_and_clamp():
    tr = Tracer()
    t0 = tr.clock()
    tr.done("edge.decode", "edge", t0, track="edge", step=3)
    tr.add("server.queue", "server", 10.0, -0.5, track="server")
    spans = tr.spans()
    assert [s.name for s in spans] == ["edge.decode", "server.queue"]
    assert spans[0].dur >= 0 and spans[0].args["step"] == 3
    assert spans[1].dur == 0.0, "negative durations clamp to zero"


def test_ring_bound_and_dropped():
    tr = Tracer(capacity=4)
    for i in range(10):
        tr.add(f"s{i}", "edge", float(i), 0.1, track="edge")
    assert len(tr) == 4 and tr.dropped == 6
    assert [s.name for s in tr.spans()] == ["s6", "s7", "s8", "s9"]
    st = tr.stats()
    assert st["spans"] == 4 and st["dropped"] == 6


def test_export_validate_round_trip(tmp_path):
    tr = Tracer()
    tr.add("wire.request", "wire", 1.0, 0.25, track="wire", req_id=7)
    tr.add("edge.decode", "edge", 1.0, 0.01, track="edge")
    path = str(tmp_path / "trace.json")
    assert tr.export(path) == 2
    obj = load_trace(path)
    xs = [e for e in obj["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == 2
    req = next(e for e in xs if e["name"] == "wire.request")
    assert req["dur"] == pytest.approx(0.25e6)
    assert req["args"]["req_id"] == 7
    names = {e["args"]["name"] for e in obj["traceEvents"] if e["ph"] == "M"}
    assert {"edge", "wire", "server"} <= names


def test_validate_rejects_malformed(tmp_path):
    with pytest.raises(ValueError):
        validate_chrome_trace({"no": "events"})
    with pytest.raises(ValueError):
        validate_chrome_trace({"traceEvents": []})
    with pytest.raises(ValueError):
        validate_chrome_trace({"traceEvents": [
            {"ph": "X", "pid": 1, "tid": 0, "name": "a", "ts": -1.0,
             "dur": 0.0}]})
    p = str(tmp_path / "garbage.json")
    with open(p, "w") as fh:
        json.dump({"traceEvents": [{"ph": "X"}]}, fh)
    with pytest.raises(ValueError):
        load_trace(p)


def test_breakdown_over_spans_and_events(tmp_path):
    tr = Tracer()
    tr.add("wire.request", "wire", 0.0, 0.010, track="wire")
    tr.add("wire.encode", "wire", 0.0, 0.001, track="wire")
    tr.add("server.queue", "server", 0.0, 0.002, track="server")
    tr.add("server.catchup", "server", 0.0, 0.004, track="server")
    tr.add("wire.socket", "wire", 0.0, 0.003, track="wire")
    stats = breakdown(tr.spans())
    assert stats["rtt"]["p50_s"] == pytest.approx(0.010)
    assert stats["serialize"]["n"] == 1
    assert stats["compute"]["mean_s"] == pytest.approx(0.004)
    path = str(tmp_path / "t.json")
    tr.export(path)
    assert breakdown(load_trace(path)["traceEvents"])["rtt"]["p50_s"] == \
        pytest.approx(0.010)
    assert breakdown_table(tr.spans())[1].split()[0] == "rtt"


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_traces_validate_across_packages(tmp_path, writer):
    """The two packages emit one format: each one's export passes the
    other's schema gate and loader, with the same event count."""
    from repro.observability import Tracer as JTracer
    tr = (Tracer if writer == "port" else JTracer)(capacity=16)
    for i, name in enumerate(("edge.decode", "edge.trigger", "edge.dispatch",
                              "edge.merge", "edge.stall")):
        tr.add(name, "edge", float(i), 0.001 * (i + 1), track="edge",
               req_id=i)
    path = str(tmp_path / f"{writer}.json")
    tr.export(path)
    assert j_validate(j_load_trace(path)) == 5
    assert validate_chrome_trace(load_trace(path)) == 5


def _profiled(fn, tmp_path):
    """Run ``fn`` under a CPU ``torch.profiler``; its Chrome trace."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = str(tmp_path / "profile.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        return json.load(fh)


def _ranges(trace, name):
    return [e for e in trace["traceEvents"] if e.get("ph") == "X"
            and e.get("cat") == "user_annotation" and e["name"] == name]


def test_tracer_and_profiler_share_a_clock(tmp_path):
    """A Tracer span and a ``record_function`` range opened at the same
    point land within 50 us of each other once each file's
    ``baseTimeNanoseconds`` is applied (the closest of five pairs: a
    preemption between the two reads delays one of them)."""
    from torch.profiler import record_function
    tr = Tracer()

    def both():
        for _ in range(3):   # a session's first ranges pay for set-up
            with record_function("warm"):
                pass
        for i in range(5):
            t0 = tr.clock()
            with record_function(f"mark{i}"):
                pass
            tr.done(f"edge.decode{i}", "edge", t0)
    prof = _profiled(both, tmp_path)
    path = str(tmp_path / "spans.json")
    tr.export(path)
    spans = load_trace(path)
    gaps = []
    for i in range(5):
        (mark,) = _ranges(prof, f"mark{i}")
        (dec,) = [e for e in spans["traceEvents"]
                  if e["name"] == f"edge.decode{i}"]
        gaps.append(mark["ts"] + prof["baseTimeNanoseconds"] / 1e3
                    - dec["ts"] - spans["baseTimeNanoseconds"] / 1e3)
    assert min(abs(g) for g in gaps) < 50.0, gaps


def test_span_is_one_check_without_a_profiler(monkeypatch):
    """With no profiler recording, ``span`` and ``span_backward`` never
    enter ``record_function`` nor add the backward's range node, and the
    gradient is the plain backward's."""
    from repro_torch.observability import trace

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(trace, "record_function", refuse)
    monkeypatch.setattr(trace._BackwardRange, "apply", refuse)
    with trace.span("train.forward"):
        w = torch.arange(3.0, requires_grad=True)
        loss = (w * w).sum()
    trace.span_backward(loss, "train.backward")
    assert torch.equal(w.grad, 2 * torch.arange(3.0))


def test_backward_range_on_another_thread_closes_with_the_pass(
        monkeypatch, tmp_path):
    """Where the backward pass runs on a thread other than the caller's
    (autograd's device thread on CUDA), its first node opens the range
    there and the pass's end closes it: the range holds the pass's nodes
    and ends before the caller's.  The thread is faked here: the CPU runs
    the pass on the caller's thread."""
    from repro_torch.observability import trace
    idents = iter(range(100))
    monkeypatch.setattr(trace.threading, "get_ident", lambda: next(idents))
    w = torch.arange(3.0, requires_grad=True)

    def step():
        trace.span_backward((w * w).sum(), "train.backward")
    prof = _profiled(step, tmp_path)
    outer, inner = sorted(_ranges(prof, "train.backward"),
                          key=lambda e: (e["ts"], -e["dur"]))
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    nodes = [e for e in prof["traceEvents"] if e.get("ph") == "X"
             and "MulBackward0" in e["name"]]
    assert nodes
    for e in nodes:
        assert inner["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= inner["ts"] + inner["dur"]
    assert torch.equal(w.grad, 2 * torch.arange(3.0))


# -- metrics registry, histogram, trackers ------------------------------------

def test_registry_get_or_create_and_snapshot():
    reg = MetricsRegistry()
    assert reg.counter("requests") is reg.counter("requests")
    reg.inc("requests", 3)
    reg.gauge("load", fn=lambda: 0.5)
    reg.observe("lat_s", 0.2, lo=1e-4, hi=10.0)
    snap = reg.snapshot()
    assert snap["requests"] == 3 and snap["load"] == 0.5
    assert snap["lat_s_n"] == 1
    assert snap["lat_s_p50"] == snap["lat_s_p99"] == 0.2
    empty = MetricsRegistry()
    empty.histogram("h")
    s = empty.snapshot()
    assert s["h_n"] == 0 and s["h_p50"] is None and s["h_p99"] is None


def test_flatten_nested():
    nested = {"a": 1, "wire": {"rtt_mean_s": 0.5, "deep": {"x": 2}},
              "per_stream": [1, 2]}
    assert flatten(nested, "comms") == {
        "comms/a": 1, "comms/wire/rtt_mean_s": 0.5, "comms/wire/deep/x": 2,
        "comms/per_stream": [1, 2]}


def test_histogram_empty_percentiles_are_none():
    assert Histogram(1e-4, 10.0).summary() == {
        "n": 0, "mean": 0.0, "max": 0.0, "p50": None, "p99": None}


def test_histogram_single_observation_is_its_own_percentile():
    h = Histogram(1e-4, 10.0)
    h.observe(0.037)
    s = h.summary()
    assert s["p50"] == s["p99"] == 0.037 and s["n"] == 1


def test_histogram_quantiles_clamped_and_equal_to_reference():
    """Within [vmin, vmax], and the same bucket estimates as the
    reference's histogram on the same observations."""
    rng = np.random.default_rng(0)
    xs = rng.lognormal(-4.0, 1.5, 500)
    h, jh = Histogram(1e-4, 10.0), JHistogram(1e-4, 10.0)
    for x in xs:
        h.observe(float(x))
        jh.observe(float(x))
    assert h.summary() == jh.summary()
    h3 = Histogram(1e-4, 10.0)
    for x in (0.02, 0.021, 0.022):
        h3.observe(x)
    assert 0.02 <= h3.summary()["p50"] <= 0.022
    assert 0.02 <= h3.summary()["p99"] <= 0.022


def test_in_memory_tracker_ring_evicts_oldest():
    t = InMemoryTracker(max_records=4)
    for i in range(10):
        t.log({"i": i})
    assert [r["i"] for r in t.records] == [6, 7, 8, 9]
    assert t.latest == {"i": 9}
    unbounded = InMemoryTracker(max_records=None)
    for i in range(10):
        unbounded.log({"i": i})
    assert len(unbounded.records) == 10


def test_json_file_tracker_round_trip(tmp_path):
    path = str(tmp_path / "hb" / "stats.json")
    tr = JsonFileTracker(path)
    tr.log({"leased_rows": np.int64(3), "p": np.float32(0.5)}, step=2)
    got = read_stats(path)
    assert got["leased_rows"] == 3 and got["step"] == 2 and "ts" in got
    tr.finish()
    assert read_stats(path) is None
    assert not os.path.exists(path)


# -- traced sessions ------------------------------------------------------------

def _proto():
    """paper_synthetic.SERVING weights from the reference's init, a stream
    and a mixed-trigger threshold (0.1), as the reference's fixture."""
    if "p" not in _PROTO:
        jcfg, tcfg, params, model = collab_pair("paper-synthetic")
        stream = token_stream(tcfg, 3, 14, seed=0)
        _PROTO["p"] = (with_threshold(jcfg, 0.1), with_threshold(tcfg, 0.1),
                       params, model, stream)
    return _PROTO["p"]


def _run(session_cfg):
    _, cfg, _, model, stream = _proto()
    eng = CollaborativeEngine(model, cfg, 3, 32, device="cpu")
    sess = eng.session(session_cfg)
    return sess.run(stream), sess


def _assert_bitwise(r_plain, r_traced):
    for key in ("u", "triggered", "fhat"):
        np.testing.assert_array_equal(r_plain[key], r_traced[key])


def test_traced_sync_bitwise(tmp_path):
    r0, _ = _run(SessionConfig())
    r1, sess = _run(SessionConfig(trace=True))
    _assert_bitwise(r0, r1)
    assert 0.0 < r1["triggered"].mean() < 1.0, "need mixed triggers"
    spans = sess.tracer.spans()
    assert {"edge.decode", "edge.trigger", "edge.catchup"} <= {
        s.name for s in spans}
    path = str(tmp_path / "sync.json")
    assert sess.export_trace(path) == len(spans)
    load_trace(path)
    j_validate(j_load_trace(path))


def test_traced_scan_bitwise():
    r0, _ = _run(SessionConfig(mode="scan"))
    r1, sess = _run(SessionConfig(mode="scan", trace=True))
    _assert_bitwise(r0, r1)
    assert {s.name for s in sess.tracer.spans()} == {"scan.run"}


@pytest.mark.parametrize("transport,staleness",
                         [("inproc", 2), ("thread", 0)])
def test_traced_async_bitwise(transport, staleness):
    """Deterministic merges (inproc at k=2 merges at age 1; any worker at
    the strict boundary): traced == untraced including fhat."""
    conf = dict(mode="async", transport=transport, max_staleness=staleness)
    r0, _ = _run(SessionConfig(**conf))
    r1, sess = _run(SessionConfig(**conf, trace=True))
    _assert_bitwise(r0, r1)
    names = {s.name for s in sess.tracer.spans()}
    assert {"edge.dispatch", "edge.merge"} <= names
    if transport == "thread":
        assert "edge.stall" in names, "the strict boundary waits"


def test_metrics_snapshot_shape():
    _, sess = _run(SessionConfig(trace=True))
    snap = sess.metrics()
    assert snap["comms/trigger_rate"] > 0
    assert snap["trace/spans"] == len(sess.tracer.spans())
    _, plain = _run(SessionConfig())
    snap2 = plain.metrics()
    assert "comms/trigger_rate" in snap2
    assert not any(k.startswith("trace/") for k in snap2)


def test_trace_ring_bound_respected_in_session():
    r1, sess = _run(SessionConfig(trace=True, trace_capacity=8))
    assert len(sess.tracer) == 8 and sess.tracer.dropped > 0
    r0, _ = _run(SessionConfig())
    _assert_bitwise(r0, r1)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_span_names_and_metrics_keys_match_reference(mode):
    """A traced session of each package on the same weights and stream
    records the same span names and exposes the same metrics keys."""
    jcfg, _, params, _, stream = _proto()
    conf = dict(mode=mode, trace=True)
    if mode == "async":
        conf.update(transport="inproc", max_staleness=2)
    jsess = JEngine(params, jcfg, batch=3, max_len=32).session(
        JSessionConfig(**conf))
    jsess.run(stream)
    _, sess = _run(SessionConfig(**conf))
    assert {s.name for s in sess.tracer.spans()} == {
        s.name for s in jsess.tracer.spans()}
    assert set(sess.metrics()) == set(jsess.metrics())


# -- the disabled path ----------------------------------------------------------

def test_untraced_session_never_touches_tracer(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("tracer touched on the disabled path")
    monkeypatch.setattr(Tracer, "__init__", boom)
    monkeypatch.setattr(Tracer, "done", boom)
    monkeypatch.setattr(Tracer, "add", boom)
    for conf in (SessionConfig(), SessionConfig(mode="async",
                                                transport="thread")):
        r, sess = _run(conf)
        assert sess.tracer is None
        assert r["triggered"].any()


def test_export_trace_refuses_when_off(tmp_path):
    _, sess = _run(SessionConfig())
    with pytest.raises(RuntimeError, match="trace=True"):
        sess.export_trace(str(tmp_path / "never.json"))


def test_reused_engine_drops_stale_tracer():
    _, cfg, _, model, stream = _proto()
    eng = CollaborativeEngine(model, cfg, 3, 32, device="cpu")
    eng.session(SessionConfig(trace=True)).run(stream)
    assert eng._tracer is not None
    s2 = eng.session(SessionConfig())
    s2._ensure_open()
    assert eng._tracer is None
