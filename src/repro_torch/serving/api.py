"""The public serving API (``serving/api.py``): ``TransportSpec`` says
where the server half runs, ``SessionConfig`` how a session serves, and
``MonitorSession`` serves.

A session owns the slot pool of its engine: ``attach(stream_id)`` admits
a stream into a free slot (bit-cold state, its own position 0),
``detach(stream_id)`` retires one, and results carry the attached
streams' rows in slot order with their ids under ``"streams"``.  In async
mode a membership change first drains the pipeline (a reply must never
land on a re-leased slot).

Typical use::

    sess = MonitorSession.open(model, cfg, batch=8, max_len=512,
                               config=SessionConfig(mode="async",
                                                    transport="stream",
                                                    max_staleness=2))
    out = sess.run(tokens)          # (8, S) token ids -> traces + comms

Over the ``wire`` transport (``"wire:/tmp/corr.sock"``) the server half
runs in a correction server of its own (``python -m
repro_torch.launch.server``, or the JAX package's): sync mode is the
strict ``max_staleness=0`` boundary, async mode pipelines, and ATTACH /
DETACH frames mirror membership changes to the server.  The ``shm``
transport (``"shm:/tmp/corr.sock"``) moves the data frames into a
same-host shared-memory ring pair, and a ``fleet:<router>`` address
(``python -m repro_torch.launch.fleet``) routes the session to the
least-loaded server of a fleet and fails it over to a sibling when that
server dies or drains.  Mesh sharding and the recompile guard are later
slices of the port; asking for them raises ``NotImplementedError`` naming
their ROADMAP item.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Hashable, Iterable, Iterator, Optional, Tuple, Union

import numpy as np

from repro_torch.serving.async_rpc import TRANSPORTS

MODES = ("sync", "scan", "async")


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: see ROADMAP.md queue 1, item {item}")


@dataclass(frozen=True)
class TransportSpec:
    """Where the server half of the protocol runs.

    kind      -- ``inproc`` (compute at dispatch, deterministic),
                 ``stream`` (a CUDA side stream; CUDA engines only),
                 ``thread`` (a worker thread), ``mock_remote`` (thread +
                 simulated round trip), ``wire`` (a real socket to a
                 correction server) or ``shm`` (the wire protocol over a
                 same-host shared-memory ring pair; plain wire, with a
                 logged reason, when the server is remote or offers no
                 arena).
    address   -- ``wire``/``shm``: the server's UDS path or ``host:port``,
                 or ``fleet:<router>`` to connect through a
                 ``FleetSupervisor`` router (``python -m
                 repro_torch.launch.fleet``): the session HELLOs the
                 router, follows its REDIRECT to the least-loaded live
                 server, and fails over (re-HELLO and replay) when that
                 server dies or drains.  ``parse("fleet:...")`` is
                 shorthand for ``wire`` with a fleet address.
    latency_s -- simulated round trip (stream/thread/mock_remote only; the
                 wire has whatever latency it has).
    coalesce  -- ``wire`` only: False opts out of the server's request
                 coalescing (per-request replays).
    """

    kind: str = "inproc"
    address: Optional[str] = None
    latency_s: Optional[float] = None
    coalesce: bool = True

    def __post_init__(self):
        if self.kind not in TRANSPORTS:
            raise ValueError(
                f"unknown transport {self.kind!r}: valid transports are "
                + ", ".join(repr(t) for t in TRANSPORTS))
        if self.address is not None and self.kind not in ("wire", "shm"):
            raise ValueError(f"transport {self.kind!r} takes no address "
                             "(only 'wire' and 'shm')")
        if self.kind in ("wire", "shm") and self.address is None:
            raise ValueError(
                f"{self.kind} transport needs an address (the correction "
                "server's UDS path or host:port: python -m "
                "repro_torch.launch.server)")
        if self.latency_s is not None and self.kind in ("inproc", "wire",
                                                        "shm"):
            raise ValueError(
                f"transport {self.kind!r} has no latency model"
                + (": RTT is measured on the real socket"
                   if self.kind in ("wire", "shm") else ""))

    @classmethod
    def parse(cls, spec: Union[str, "TransportSpec"]) -> "TransportSpec":
        """``"stream"`` -> TransportSpec("stream");
        ``"wire:/tmp/corr.sock"`` / ``"wire:host:port"`` -> wire + address;
        ``"shm:/tmp/corr.sock"`` -> same-host shared-memory rings;
        ``"fleet:/tmp/router.sock"`` -> wire through a fleet router.
        A TransportSpec passes through unchanged."""
        if isinstance(spec, cls):
            return spec
        s = str(spec)
        if s.startswith("fleet:"):
            return cls("wire", address=s)
        kind, sep, rest = s.partition(":")
        return cls(kind, address=rest if sep else None)


@dataclass(frozen=True)
class SessionConfig:
    """How a ``MonitorSession`` serves.  Frozen and validated.

    mode           -- ``sync`` (each trigger blocks on the server catch-up;
                      over a transport other than inproc this is the strict
                      ``max_staleness=0`` boundary), ``scan`` (offline trace
                      evaluation, fixed membership) or ``async`` (pipelined:
                      corrections merge 1..``max_staleness`` steps late, the
                      monitor path never waits).
    transport      -- a ``TransportSpec`` or a string ``parse`` reads.
    max_staleness  -- the async merge window (ignored for sync/scan).
    policy         -- a ``serving.policy.TriggerPolicy``: per-stream online
                      threshold control, bound to the engine's calibrated
                      operating point at open; it sets the (B,) thresholds
                      before every step and reads the step's outcome after.
                      Refused together with ``threshold`` (a policy owns the
                      trigger point).  None: the fixed calibrated threshold.
    threshold / trigger_margin -- monitor operating-point overrides,
                      applied at engine construction by
                      ``MonitorSession.open``.
    capacity       -- scan mode's static correction capacity.
    monitor_n      -- Eq.-8 truncation override for the serving u head.
    mesh           -- mesh-sharded serving; not ported (raises).
    trace          -- span tracing: the session installs an
                      ``observability.Tracer`` on the engine for its
                      lifetime (``MonitorSession.tracer``/``export_trace``).
                      Off by default; traced sessions are bitwise identical
                      to untraced ones.
    trace_capacity -- the span ring's bound (oldest dropped).
    """

    mode: str = "sync"
    transport: TransportSpec = field(default_factory=TransportSpec)
    max_staleness: int = 1
    policy: Optional[Any] = None
    threshold: Optional[float] = None
    trigger_margin: Optional[float] = None
    capacity: Optional[int] = None
    monitor_n: Optional[int] = None
    mesh: Optional[Any] = None
    trace: bool = False
    trace_capacity: int = 65536

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}: valid modes are "
                             + ", ".join(repr(m) for m in MODES))
        if not isinstance(self.transport, TransportSpec):
            object.__setattr__(self, "transport",
                               TransportSpec.parse(self.transport))
        if self.mesh is not None:
            raise _later("mesh-sharded serving", "8 (mesh + analysis)")
        if self.max_staleness < 0:
            raise ValueError("max_staleness must be >= 0")
        if self.trace_capacity <= 0:
            raise ValueError("trace_capacity must be >= 1")
        if self.mode == "scan" and self.transport != TransportSpec():
            raise ValueError("scan mode is offline: it takes no transport")
        if self.policy is not None:
            if self.threshold is not None:
                raise ValueError(
                    f"SessionConfig.threshold={self.threshold} and "
                    f"SessionConfig.policy={type(self.policy).__name__} "
                    "are mutually exclusive: a policy owns the trigger "
                    "point (bound to the engine's calibrated operating "
                    "point at open) -- set the operating point via "
                    "threshold= alone, or let the policy drive it")
            from repro_torch.serving.policy import TriggerPolicy
            if not isinstance(self.policy, TriggerPolicy):
                raise ValueError(
                    f"SessionConfig.policy must be a TriggerPolicy, got "
                    f"{type(self.policy).__name__}")

    @property
    def needs_worker(self) -> bool:
        """Whether this session runs through the dispatch/merge layer
        (async mode, or sync over a transport other than inproc)."""
        return (self.mode == "async"
                or (self.mode == "sync" and self.transport.kind != "inproc"))

    @property
    def effective_staleness(self) -> int:
        """sync mode over a transport is the strict boundary."""
        return self.max_staleness if self.mode == "async" else 0


class MonitorSession:
    """A context-managed serving session over one ``CollaborativeEngine``.

    Lifecycle: ``new`` -> ``open`` (first step/run/enter) -> ``closed``.
    ``run`` on a worker-backed session (async, or sync over a transport)
    drains the pipeline's tail and closes the session when the stream
    ends; ``step``-driven sessions close at ``__exit__``/``close()``.  The
    session owns the engine's protocol state for its lifetime.
    """

    def __init__(self, engine, config: Optional[SessionConfig] = None, *,
                 streams: Optional[Iterable[Hashable]] = None, worker=None):
        self._engine = engine
        self.config = config if config is not None else SessionConfig()
        self._check_engine_matches(engine, self.config)
        self._worker = worker
        self._state = "new"
        # controller state lives here, beside the session (client side)
        self._policy = self.config.policy
        if self._policy is not None:
            self._policy.bind(threshold=engine.m.threshold,
                              margin=engine.m.trigger_margin,
                              batch=engine.batch)
        B = engine.batch
        ids = list(range(B)) if streams is None else list(streams)
        if len(ids) > B:
            raise ValueError(f"{len(ids)} initial streams > {B} slots")
        if len(set(ids)) != len(ids):
            raise ValueError("duplicate stream ids")
        self._slots: list = [None] * B
        for slot, sid in enumerate(ids):
            self._slots[slot] = sid
        engine.active = np.asarray([s is not None for s in self._slots])
        # explicit ids on a used engine: every initial slot starts bit-cold
        if streams is not None and engine.t > 0:
            for slot, sid in enumerate(self._slots):
                if sid is not None:
                    engine._attach_slot(slot)

    @staticmethod
    def _check_engine_matches(engine, config: SessionConfig) -> None:
        m = engine.m
        for name, want, have in (
                ("threshold", config.threshold, m.threshold),
                ("trigger_margin", config.trigger_margin, m.trigger_margin),
                ("capacity", config.capacity, engine.capacity),
                ("monitor_n", config.monitor_n, engine.monitor_n)):
            if want is not None and want != have:
                raise ValueError(
                    f"SessionConfig.{name}={want} != the engine's {have}: "
                    "operating-point overrides apply at engine construction "
                    "-- build the session with MonitorSession.open(...)")

    @classmethod
    def open(cls, params, arch_cfg, *, batch: int, max_len: int,
             config: Optional[SessionConfig] = None,
             streams: Optional[Iterable[Hashable]] = None,
             device=None) -> "MonitorSession":
        """Build engine + session in one call on ``device`` (``None``: the
        card; raises when there is none), applying the config's
        operating-point overrides at engine construction.  ``params``: a
        ``CollabLM`` on that device."""
        from repro_torch.serving.collaborative import CollaborativeEngine
        config = config if config is not None else SessionConfig()
        if config.threshold is not None or config.trigger_margin is not None:
            mon = arch_cfg.monitor
            kw = {**mon.__dict__}
            if config.threshold is not None:
                kw["threshold"] = config.threshold
            if config.trigger_margin is not None:
                kw["trigger_margin"] = config.trigger_margin
            arch_cfg = arch_cfg.replace(monitor=mon.__class__(**kw))
        eng = CollaborativeEngine(params, arch_cfg, batch=batch,
                                  max_len=max_len, device=device,
                                  capacity=config.capacity,
                                  monitor_n=config.monitor_n)
        return cls(eng, config, streams=streams)

    # -- lifecycle -----------------------------------------------------------
    @property
    def state(self) -> str:
        return self._state

    @property
    def engine(self):
        return self._engine

    def __enter__(self) -> "MonitorSession":
        self._ensure_open()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _ensure_open(self) -> None:
        if self._state == "open":
            return
        if self._state == "closed":
            raise RuntimeError("session is closed")
        if self.config.trace:
            # installed before any worker is built, so the dispatcher
            # captures it
            from repro_torch.observability import Tracer
            self._engine._tracer = Tracer(self.config.trace_capacity)
        else:
            # a reused engine must not keep a previous session's tracer
            self._engine._tracer = None
        if self.config.needs_worker:
            spec = self.config.transport
            self._engine._start_async(
                transport=spec.kind,
                max_staleness=self.config.effective_staleness,
                latency_s=spec.latency_s, address=spec.address,
                wire_coalesce=spec.coalesce, worker=self._worker)
        self._state = "open"

    def close(self) -> None:
        """Drain the pipeline and close.  Idempotent."""
        if self._state == "open" and self.config.needs_worker:
            self._engine._finish_async()
        self._state = "closed"

    # -- membership (the slot pool) ------------------------------------------
    @property
    def streams(self) -> Tuple[Hashable, ...]:
        """Attached stream ids in slot order (the row order of results)."""
        return tuple(s for s in self._slots if s is not None)

    def slot_of(self, stream_id: Hashable) -> int:
        for slot, sid in enumerate(self._slots):
            if sid == stream_id:
                return slot
        raise KeyError(f"stream {stream_id!r} is not attached")

    def _check_membership_change(self) -> None:
        if self.config.mode == "scan":
            raise RuntimeError("scan sessions have fixed membership")
        if self._state == "closed":
            raise RuntimeError("session is closed")

    def attach(self, stream_id: Hashable) -> int:
        """Admit ``stream_id`` into a free slot (bit-cold; its position
        starts at 0).  Returns the slot index."""
        self._check_membership_change()
        if any(sid == stream_id for sid in self._slots if sid is not None):
            raise ValueError(f"stream {stream_id!r} is already attached")
        for slot, sid in enumerate(self._slots):
            if sid is None:
                break
        else:
            raise RuntimeError(
                f"slot pool full ({self._engine.batch} slots): detach a "
                "stream first or build a larger engine")
        self._engine._attach_slot(slot)
        if self._policy is not None:
            # a fresh tenant gets a cold controller
            self._policy.reset_stream(slot)
        self._slots[slot] = stream_id
        return slot

    def detach(self, stream_id: Hashable) -> None:
        """Retire ``stream_id``: its slot stops decoding, triggering and
        accruing comms charges, and becomes reusable by ``attach``."""
        self._check_membership_change()
        slot = self.slot_of(stream_id)
        self._engine._detach_slot(slot)
        self._slots[slot] = None

    # -- serving -------------------------------------------------------------
    def _attached_slot_idx(self) -> np.ndarray:
        return np.asarray([i for i, s in enumerate(self._slots)
                           if s is not None], np.int64)

    def _full_pool(self) -> bool:
        return all(s is not None for s in self._slots)

    def _expand(self, tokens) -> np.ndarray:
        """Caller tokens (dict by stream id, or an array over the attached
        streams in slot order) -> full-batch array."""
        ids = self.streams
        if isinstance(tokens, dict):
            missing = set(ids) - set(tokens)
            extra = set(tokens) - set(ids)
            if missing or extra:
                raise ValueError(
                    f"token dict mismatch: missing {sorted(missing, key=str)}, "
                    f"unknown {sorted(extra, key=str)}")
            tokens = np.stack([np.asarray(tokens[sid]) for sid in ids])
        arr = np.asarray(tokens)
        if self._full_pool():
            return arr
        if arr.shape[0] != len(ids):
            raise ValueError(f"tokens first axis {arr.shape[0]} != "
                             f"{len(ids)} attached streams")
        full = np.zeros((self._engine.batch,) + arr.shape[1:], arr.dtype)
        full[self._attached_slot_idx()] = arr
        return full

    def _narrow(self, r: Dict[str, np.ndarray]) -> Dict[str, Any]:
        if self._full_pool():
            out = dict(r)
        else:
            sl = self._attached_slot_idx()
            out = {k: v[sl] for k, v in r.items()}
        out["streams"] = self.streams
        return out

    def step(self, tokens) -> Dict[str, Any]:
        """One monitoring step over the attached streams.  ``tokens``: a
        dict ``{stream_id: token}`` or an array (n_attached,) in slot
        order.  Returns u/fhat/triggered rows and the ``streams`` ids."""
        if self.config.mode == "scan":
            raise RuntimeError("scan sessions are offline: use run(token_stream)")
        self._ensure_open()
        full = self._expand(tokens)
        eng = self._engine
        if self._policy is not None:
            eng._thr_eff = np.asarray(self._policy.step_thresholds(),
                                      np.float32)
        if self.config.needs_worker:
            r = eng._step_async(full)
        else:
            r = eng._step(full)
        if self._policy is not None:
            self._policy.update(r["u"], r["fhat"], r["triggered"],
                                eng.active.copy(), eng.comms)
        return self._narrow(r)

    def stream(self, token_iter: Iterable) -> Iterator[Dict[str, Any]]:
        """One result dict per step of ``token_iter``; membership may
        change between steps."""
        for tokens in token_iter:
            yield self.step(tokens)

    def run(self, token_stream) -> Dict[str, Any]:
        """Serve a whole stream (n_attached, S) and return stacked traces
        (n_attached, S) and the comms report.  A worker-backed session
        drains its pipeline's tail and closes when the stream ends, so the
        report covers the whole session."""
        self._ensure_open()
        if self.config.mode == "scan":
            if not self._full_pool():
                raise RuntimeError("scan mode requires the full slot pool")
            if self._policy is not None:
                # one offline pass: the policy's current thresholds apply
                # statically (no per-step feedback)
                self._engine._thr_eff = np.asarray(
                    self._policy.step_thresholds(), np.float32)
            return self._engine._run_scan(token_stream)
        token_stream = np.asarray(token_stream)
        us, fhats, trigs = [], [], []
        try:
            for t in range(token_stream.shape[1]):
                r = self.step(token_stream[:, t])
                us.append(r["u"])
                fhats.append(r["fhat"])
                trigs.append(r["triggered"])
        finally:
            if self.config.needs_worker:
                self.close()
        return {"u": np.stack(us, 1), "fhat": np.stack(fhats, 1),
                "triggered": np.stack(trigs, 1), "streams": self.streams,
                "comms": self.report()}

    def report(self) -> Dict[str, Any]:
        """The engine's communication and overlap report (see
        ``CommsMeter``)."""
        return self._engine.comms.report()

    # -- observability --------------------------------------------------------
    @property
    def tracer(self):
        """The session's span tracer (``SessionConfig(trace=True)``), or
        ``None`` when tracing is off."""
        return self._engine._tracer

    def export_trace(self, path: str) -> int:
        """Write the session's spans as Chrome trace-event / Perfetto
        JSON; returns the span count.  Requires ``trace=True``."""
        tr = self._engine._tracer
        if tr is None:
            raise RuntimeError("tracing is off: open the session with "
                               "SessionConfig(trace=True)")
        return tr.export(path)

    def metrics(self) -> Dict[str, Any]:
        """One flat snapshot: the engine's registry, the flattened
        ``CommsMeter`` report under ``comms/...`` and, when tracing, the
        tracer's ring stats under ``trace/...``."""
        from repro_torch.observability import flatten
        snap = self._engine.metrics.snapshot()
        snap.update(flatten(self._engine.comms.report(), "comms"))
        tr = self._engine._tracer
        if tr is not None:
            snap.update(flatten(tr.stats(), "trace"))
        return snap

    def arm_recompile_guard(self, *, track_global: bool = True,
                            warm_only: bool = False):
        """The reference's guard over its jitted paths.  The port runs
        eagerly; its counterpart is a graph-capture guard once the serve
        step is captured in CUDA graphs (ROADMAP queue 2)."""
        raise _later("the recompile guard", "8 (mesh + analysis)")
