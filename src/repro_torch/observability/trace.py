"""Span tracer for the serving stack (``observability/trace.py``):
monotonic-clock spans, a bounded ring buffer, Chrome trace-event /
Perfetto JSON export.

One ``Tracer`` rides a serving session (``SessionConfig(trace=True)``)
and collects spans on the reference's tracks and names, so the two
packages' traces read alike:

    edge track    edge.decode, edge.trigger, edge.dispatch, edge.merge,
                  edge.catchup (sync), edge.stall, scan.run
    wire, server  the reference's socket transport fills these; the port
                  has no wire transport yet (ROADMAP queue 1, item 5)

Spans are read on the HOST clock.  On a CUDA engine a span that ends
before the host waits for the card measures the enqueue, not the device
work: ``edge.decode`` is the edge tower's launches, ``edge.trigger``
holds the step's one readback of u (so the device time of the edge
decode lands there), ``edge.catchup`` ends with the readback of fhat, and
``edge.dispatch`` is the host time of handing the catch-up to a worker.

Every request-scoped span carries ``req_id`` in its args (the
Dispatcher's increasing id).

Cost discipline: sessions default to ``trace=False`` and every
instrumentation site is guarded by one ``if tracer is not None`` check --
the disabled path never allocates a span and never reads the clock for
tracing.  Enabled, a span is one ``time.monotonic()`` pair plus an append
into a bounded deque; nothing here touches torch, so tracing adds no
device work and no host sync.
"""
from __future__ import annotations

import itertools
import json
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional

# stable track -> Chrome tid mapping (one "process" per tracer)
TRACKS = ("edge", "wire", "server")
_TRACK_TID = {name: i for i, name in enumerate(TRACKS)}

_trace_seq = itertools.count(1)


class Span:
    """One completed span: name, category, start (monotonic seconds),
    duration, track, and a small args dict (req_id etc.)."""

    __slots__ = ("name", "cat", "ts", "dur", "track", "args")

    def __init__(self, name: str, cat: str, ts: float, dur: float,
                 track: str, args: Dict[str, Any]):
        self.name = name
        self.cat = cat
        self.ts = ts
        self.dur = dur
        self.track = track
        self.args = args

    def __repr__(self) -> str:  # debugging/test ergonomics
        return (f"Span({self.name!r}, ts={self.ts:.6f}, "
                f"dur={self.dur * 1e3:.3f}ms, track={self.track!r})")


class Tracer:
    """Bounded ring buffer of spans with trace-event export.

    ``capacity`` bounds memory: when full, the OLDEST spans are dropped
    (a long session keeps its tail, which is what a breakdown wants) and
    ``dropped`` counts them.  All methods are cheap enough for the
    reactor tick / per-step hot path when tracing is ON; when tracing is
    OFF the convention is that callers hold ``None`` instead of a
    disabled tracer — one flag check, zero calls into this class.
    """

    def __init__(self, capacity: int = 65536, *,
                 trace_id: Optional[str] = None):
        if capacity <= 0:
            raise ValueError("trace capacity must be >= 1")
        self.capacity = int(capacity)
        self.trace_id = (trace_id if trace_id is not None
                         else f"{os.getpid():x}-{next(_trace_seq):x}")
        self._spans: "deque[Span]" = deque(maxlen=self.capacity)
        self._appended = 0

    # -- recording -----------------------------------------------------------
    @staticmethod
    def clock() -> float:
        """The span clock (monotonic seconds) — callers stamp t0 with
        this so the disabled path can skip the read entirely."""
        return time.monotonic()

    def done(self, name: str, cat: str, t0: float, *, track: str = "edge",
             **args: Any) -> None:
        """Record a span that started at ``t0`` and ends NOW."""
        self.add(name, cat, t0, time.monotonic() - t0, track=track, **args)

    def add(self, name: str, cat: str, ts: float, dur: float, *,
            track: str = "edge", **args: Any) -> None:
        """Record a pre-measured span (synthesized server spans use this
        with durations carried by the REPLY timing payload)."""
        self._appended += 1
        self._spans.append(Span(name, cat, ts, max(float(dur), 0.0),
                                track, args))

    def instant(self, name: str, cat: str = "mark", *,
                track: str = "edge", **args: Any) -> None:
        self.add(name, cat, time.monotonic(), 0.0, track=track, **args)

    # -- inspection ----------------------------------------------------------
    def spans(self) -> List[Span]:
        return list(self._spans)

    def __len__(self) -> int:
        return len(self._spans)

    @property
    def dropped(self) -> int:
        """Spans evicted by the ring bound (0 unless the session outgrew
        ``capacity``)."""
        return max(0, self._appended - self.capacity)

    def stats(self) -> Dict[str, Any]:
        return {"trace_id": self.trace_id, "spans": len(self._spans),
                "dropped": self.dropped, "capacity": self.capacity}

    # -- export --------------------------------------------------------------
    def to_chrome(self) -> Dict[str, Any]:
        """The Chrome trace-event JSON object (Perfetto loads it as-is):
        ``{"traceEvents": [...], "displayTimeUnit": "ms"}`` with one
        complete ("X") event per span, ts/dur in microseconds, plus
        thread_name metadata naming the tracks."""
        pid = 1
        events: List[Dict[str, Any]] = [
            {"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
             "args": {"name": track}}
            for track, tid in _TRACK_TID.items()]
        for s in self._spans:
            events.append({
                "name": s.name, "cat": s.cat, "ph": "X",
                "ts": s.ts * 1e6, "dur": s.dur * 1e6,
                "pid": pid, "tid": _TRACK_TID.get(s.track, 0),
                "args": dict(s.args, trace_id=self.trace_id),
            })
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"trace_id": self.trace_id,
                              "dropped": self.dropped}}

    def export(self, path: str) -> int:
        """Write the Perfetto-loadable JSON; returns the span count."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(self.to_chrome(), fh)
        return len(self._spans)


def validate_chrome_trace(obj: Any) -> int:
    """Validate a loaded trace object against the trace-event schema we
    emit (the CI trace-smoke gate).  Returns the number of duration
    events; raises ``ValueError`` naming the first violation."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("not a trace-event object: missing 'traceEvents'")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' is not a list")
    n_x = 0
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        for k in ("ph", "pid", "tid", "name"):
            if k not in ev:
                raise ValueError(f"event {i} missing required key {k!r}")
        if ev["ph"] == "X":
            n_x += 1
            for k in ("ts", "dur"):
                if not isinstance(ev.get(k), (int, float)):
                    raise ValueError(f"event {i}: {k!r} is not a number")
                if ev[k] < 0:
                    raise ValueError(f"event {i}: negative {k}")
    if n_x == 0:
        raise ValueError("trace has no duration ('X') events")
    return n_x


def load_trace(path: str) -> Dict[str, Any]:
    """Read + validate a trace file (``tools/trace_report.py``)."""
    with open(path, "r") as fh:
        obj = json.load(fh)
    validate_chrome_trace(obj)
    return obj
