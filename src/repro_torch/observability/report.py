"""Critical-path breakdown over a span trace
(``observability/report.py``): group spans by stage and summarize.

The stage mapping is the reference's: ``wire.encode`` is client
serialization, ``wire.socket`` the socket time, ``server.queue`` the
server's queue wait and ``server.catchup`` its replay compute; every
other span (``edge.decode`` etc.) is its own group.  Works on live
``Span`` objects (``MonitorSession.tracer.spans()``) and on loaded Chrome
trace events (``load_trace(path)["traceEvents"]``) alike.

Percentiles here are exact (numpy over the raw durations), unlike the
bucketed ``tracker.Histogram`` estimates.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List

import numpy as np

# span name -> breakdown stage, in critical-path order
STAGES = ("serialize", "socket", "queue", "compute")
SPAN_STAGE = {
    "wire.encode": "serialize",
    "wire.socket": "socket",
    "shm.ring": "socket",     # same stage, different plane (shm transport)
    "server.queue": "queue",
    "server.catchup": "compute",
}


def _name_dur_s(item: Any):
    """(name, duration seconds) from a Span or a Chrome trace event."""
    if isinstance(item, dict):
        if item.get("ph") != "X":
            return None
        return item["name"], float(item["dur"]) * 1e-6
    return item.name, float(item.dur)


def durations_by_stage(items: Iterable[Any]) -> Dict[str, List[float]]:
    """Stage -> raw durations (seconds), plus the measured ``rtt`` and
    every other span name verbatim (``edge.decode`` etc.)."""
    out: Dict[str, List[float]] = {}
    for item in items:
        nd = _name_dur_s(item)
        if nd is None:
            continue
        name, dur = nd
        key = SPAN_STAGE.get(name, "rtt" if name == "wire.request" else name)
        out.setdefault(key, []).append(dur)
    return out


def summarize(durs: List[float]) -> Dict[str, float]:
    a = np.asarray(durs, np.float64)
    return {"n": int(a.size), "total_s": float(a.sum()),
            "mean_s": float(a.mean()), "p50_s": float(np.percentile(a, 50)),
            "p99_s": float(np.percentile(a, 99)), "max_s": float(a.max())}


def breakdown(items: Iterable[Any]) -> Dict[str, Dict[str, float]]:
    """Stage/name -> summary stats, for every span group in the trace."""
    return {k: summarize(v) for k, v in durations_by_stage(items).items()}


def breakdown_table(items: Iterable[Any]) -> List[str]:
    """The human-readable critical-path table (one string per line):
    RTT first, then its four stages in path order, then every other span
    group alphabetically.  Milliseconds throughout."""
    stats = breakdown(items)
    order = [k for k in ("rtt",) + STAGES if k in stats]
    order += sorted(k for k in stats if k not in order)
    lines = [f"{'span':<14} {'n':>6} {'mean ms':>9} {'p50 ms':>9} "
             f"{'p99 ms':>9} {'total ms':>10}"]
    for k in order:
        s = stats[k]
        lines.append(f"{k:<14} {s['n']:>6} {s['mean_s'] * 1e3:>9.3f} "
                     f"{s['p50_s'] * 1e3:>9.3f} {s['p99_s'] * 1e3:>9.3f} "
                     f"{s['total_s'] * 1e3:>10.1f}")
    return lines
