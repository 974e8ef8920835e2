"""Metrics trackers (``serving/tracker.py``, ported whole).

  * ``Tracker`` -- the interface: ``log(metrics)`` for periodic
    snapshots, ``log_summary(metrics)`` for end-of-life totals.
  * ``NoopTracker``, ``LogTracker`` (one ``key=value`` line to a
    stream), ``InMemoryTracker`` (a bounded ring of snapshots).
  * ``JsonFileTracker`` -- atomically rewrites one JSON file per call
    (tmp + ``os.replace``), so a reader never sees a torn write: the
    heartbeat channel of the correction server (ROADMAP queue 1, item 5).
  * ``CompositeTracker`` -- fan-out to N trackers.
  * ``Histogram`` -- fixed log-spaced buckets, cheap enough to
    ``observe()`` on a hot path; ``observability.metrics`` builds its
    histograms from it.

``read_stats(path)`` is the scrape side: tolerant of a missing or
half-written file (returns ``None`` rather than raising).
"""
from __future__ import annotations

import json
import math
import os
import sys
import tempfile
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence


def _jsonable(obj: Any) -> Any:
    """Best-effort conversion for numpy scalars/arrays inside metrics."""
    if hasattr(obj, "item") and not isinstance(obj, (str, bytes)):
        try:
            return obj.item()
        except (TypeError, ValueError):
            pass
    if hasattr(obj, "tolist"):
        return obj.tolist()
    return str(obj)


class Tracker:
    """Interface: periodic ``log`` snapshots plus a final ``log_summary``."""

    def log(self, metrics: Dict[str, Any], *, step: Optional[int] = None
            ) -> None:
        raise NotImplementedError

    def log_summary(self, metrics: Dict[str, Any]) -> None:
        # By default a summary is just a final log.
        self.log(metrics)

    def finish(self) -> None:
        pass


class NoopTracker(Tracker):
    def log(self, metrics: Dict[str, Any], *, step: Optional[int] = None
            ) -> None:
        pass


class LogTracker(Tracker):
    """Writes one ``key=value`` line per call to a stream (stderr)."""

    def __init__(self, stream=None, prefix: str = "tracker"):
        self._stream = stream if stream is not None else sys.stderr
        self._prefix = prefix

    def log(self, metrics: Dict[str, Any], *, step: Optional[int] = None
            ) -> None:
        parts = [f"{k}={metrics[k]}" for k in sorted(metrics)]
        head = self._prefix if step is None else f"{self._prefix}[{step}]"
        print(f"{head} " + " ".join(parts), file=self._stream, flush=True)


class InMemoryTracker(Tracker):
    """Keeps recent snapshots; ``latest``/``summary`` for tests and the
    supervisor's in-process (thread-backend) scrape path.

    ``max_records`` bounds the ring (oldest snapshots evicted): a
    long-running server heartbeats every ``stats_interval_s``, so an
    unbounded list was a slow leak.  ``None`` keeps everything (short
    test runs that assert on the full record stream)."""

    def __init__(self, max_records: Optional[int] = 4096):
        self._records: "deque[Dict[str, Any]]" = deque(maxlen=max_records)
        self.max_records = max_records
        self.summary: Dict[str, Any] = {}

    def log(self, metrics: Dict[str, Any], *, step: Optional[int] = None
            ) -> None:
        rec = dict(metrics)
        if step is not None:
            rec["step"] = step
        self._records.append(rec)

    def log_summary(self, metrics: Dict[str, Any]) -> None:
        self.summary = dict(metrics)

    @property
    def records(self) -> List[Dict[str, Any]]:
        """The retained snapshots, oldest first (a list copy — the ring
        itself is private so eviction can't surprise an iterator)."""
        return list(self._records)

    @property
    def latest(self) -> Optional[Dict[str, Any]]:
        return self._records[-1] if self._records else None


class JsonFileTracker(Tracker):
    """Atomic whole-file JSON heartbeat: each ``log`` replaces the file.

    The write goes to a tempfile in the same directory and lands with
    ``os.replace`` so a concurrent ``read_stats`` sees either the old
    snapshot or the new one, never a prefix of the new one.
    """

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path) or "."
        os.makedirs(d, exist_ok=True)

    def log(self, metrics: Dict[str, Any], *, step: Optional[int] = None
            ) -> None:
        rec = dict(metrics)
        if step is not None:
            rec["step"] = step
        rec.setdefault("ts", time.time())
        d = os.path.dirname(self.path) or "."
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".stats-", suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump(rec, fh, default=_jsonable)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def finish(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass


class CompositeTracker(Tracker):
    """Fan-out: every call goes to every child, in order."""

    def __init__(self, trackers: Sequence[Tracker] = ()):
        self.trackers = list(trackers)

    def add(self, tracker: Tracker) -> None:
        self.trackers.append(tracker)

    def log(self, metrics: Dict[str, Any], *, step: Optional[int] = None
            ) -> None:
        for t in self.trackers:
            t.log(metrics, step=step)

    def log_summary(self, metrics: Dict[str, Any]) -> None:
        for t in self.trackers:
            t.log_summary(metrics)

    def finish(self) -> None:
        for t in self.trackers:
            t.finish()


class Histogram:
    """Fixed log-spaced buckets over ``[lo, hi]``; O(log n) observe.

    Summaries expose count/mean/max plus approximate p50/p99 from the
    bucket midpoints — enough resolution for replay-latency and
    coalesce-width dashboards without keeping raw samples.

    Edge-case contract (unit-tested): a quantile of an EMPTY histogram
    is ``None`` (there is no defined percentile — 0.0 would read as "we
    measured and it was instant"), and with exactly ONE observation
    every quantile is that observation (a bucket midpoint could sit a
    factor away from the sample).  With >= 2 observations quantiles are
    bucket-geomean estimates clamped into ``[vmin, vmax]``.
    """

    def __init__(self, lo: float, hi: float, n_buckets: int = 24):
        assert 0 < lo < hi and n_buckets >= 2
        step = (math.log(hi) - math.log(lo)) / (n_buckets - 1)
        self.edges = [math.exp(math.log(lo) + i * step)
                      for i in range(n_buckets)]
        self.counts = [0] * (n_buckets + 1)
        self.total = 0.0
        self.n = 0
        self.vmax = 0.0
        self.vmin = math.inf

    def observe(self, x: float) -> None:
        self.n += 1
        self.total += x
        if x > self.vmax:
            self.vmax = x
        if x < self.vmin:
            self.vmin = x
        import bisect
        self.counts[bisect.bisect_left(self.edges, x)] += 1

    def _quantile(self, q: float) -> Optional[float]:
        if self.n == 0:
            return None
        if self.n == 1:
            return self.vmax  # the single observation, exactly
        target = q * self.n
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                if i == 0:
                    est = self.edges[0]
                elif i >= len(self.edges):
                    est = self.vmax
                else:
                    est = math.sqrt(self.edges[i - 1] * self.edges[i])
                return min(max(est, self.vmin), self.vmax)
        return self.vmax

    def summary(self) -> Dict[str, Optional[float]]:
        mean = self.total / self.n if self.n else 0.0
        return {"n": self.n, "mean": mean, "max": self.vmax,
                "p50": self._quantile(0.5), "p99": self._quantile(0.99)}


def read_stats(path: str) -> Optional[Dict[str, Any]]:
    """Scrape one ``JsonFileTracker`` heartbeat; ``None`` if unreadable.

    Missing file, torn content, or a decode error all mean "no fresh
    heartbeat" to the caller — the supervisor's deadline logic handles
    staleness, this function only has to never raise.
    """
    try:
        with open(path, "r") as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None
