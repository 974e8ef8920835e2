"""Unified metrics registry (``observability/metrics.py``): counters,
gauges and histograms behind one flat snapshot.

The engine carries one ``MetricsRegistry`` (always on), and
``MonitorSession.metrics()`` returns its snapshot merged with the
flattened ``CommsMeter`` report (``comms/...`` keys) and, when tracing,
the tracer's ring stats (``trace/...``), the reference's keys.

Naming: flat snapshot keys.  Counters and gauges appear under their own
names; a histogram ``h`` contributes ``{h}_n/_mean/_max/_p50/_p99``
(percentiles are ``None`` while empty -- see ``tracker.Histogram``).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable, Dict, Optional, Union

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.serving.tracker import Histogram

# Histogram lives in serving/tracker.py; serving imports this module for
# the registry, so pulling it in at module scope would be circular.
# Resolved lazily at the first histogram() call and cached here.
_Histogram = None


def _histogram_cls():
    global _Histogram
    if _Histogram is None:
        from repro_torch.serving.tracker import Histogram
        _Histogram = Histogram
    return _Histogram


class Counter:
    """Monotonic counter (int or float increments)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Union[int, float] = 0

    def inc(self, n: Union[int, float] = 1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value: ``set()`` it, or construct with ``fn`` for a
    pull gauge evaluated at snapshot time (lease load, fragmentation)."""

    __slots__ = ("name", "_value", "_fn")

    def __init__(self, name: str, fn: Optional[Callable[[], Any]] = None):
        self.name = name
        self._value: Any = 0
        self._fn = fn

    def set(self, v: Any) -> None:
        self._value = v

    @property
    def value(self) -> Any:
        return self._fn() if self._fn is not None else self._value


class MetricsRegistry:
    """Name -> metric, with get-or-create accessors and one flat
    ``snapshot()``.  Not thread-safe by design: each owner (engine,
    server reactor) mutates its own registry from one thread, exactly
    like the structures it replaces."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, "Histogram"] = {}

    # -- get-or-create -------------------------------------------------------
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str,
              fn: Optional[Callable[[], Any]] = None) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name, fn)
        return g

    def histogram(self, name: str, lo: float = 1e-6, hi: float = 60.0,
                  n_buckets: int = 24) -> "Histogram":
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = _histogram_cls()(lo, hi, n_buckets)
        return h

    # -- convenience mutators (hot-path friendly) ----------------------------
    def inc(self, name: str, n: Union[int, float] = 1) -> None:
        self.counter(name).inc(n)

    def observe(self, name: str, x: float, *, lo: float = 1e-6,
                hi: float = 60.0, n_buckets: int = 24) -> None:
        self.histogram(name, lo, hi, n_buckets).observe(x)

    # -- views ---------------------------------------------------------------
    def counters(self) -> Dict[str, Union[int, float]]:
        return {name: c.value for name, c in self._counters.items()}

    @property
    def hists(self) -> Dict[str, "Histogram"]:
        return self._hists

    def snapshot(self) -> Dict[str, Any]:
        """One flat dict: counters + gauges by name, histograms as
        ``{name}_{n,mean,max,p50,p99}`` — JSON-safe (the heartbeat
        format)."""
        snap: Dict[str, Any] = {}
        for name, c in self._counters.items():
            snap[name] = c.value
        for name, g in self._gauges.items():
            snap[name] = g.value
        for name, h in self._hists.items():
            for k, val in h.summary().items():
                snap[f"{name}_{k}"] = val
        return snap


def flatten(nested: Dict[str, Any], prefix: str = "",
            sep: str = "/") -> Dict[str, Any]:
    """Flatten a nested report dict (``CommsMeter.report()``) into
    ``prefix/key`` scalars; non-dict leaves (including per-stream lists)
    pass through unchanged."""
    out: Dict[str, Any] = {}
    for k, v in nested.items():
        key = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key, sep))
        else:
            out[key] = v
    return out
