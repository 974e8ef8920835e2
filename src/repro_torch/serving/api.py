"""The public serving API (``serving/api.py``), sync and scan modes:
``SessionConfig`` says how a session serves, ``MonitorSession`` serves.

A session owns the slot pool of its engine: ``attach(stream_id)`` admits
a stream into a free slot (bit-cold state, its own position 0),
``detach(stream_id)`` retires one, and results carry the attached
streams' rows in slot order with their ids under ``"streams"``.

Typical use::

    sess = MonitorSession.open(model, cfg, batch=8, max_len=512,
                               config=SessionConfig(mode="sync"))
    out = sess.run(tokens)          # (8, S) token ids -> traces + comms

The async mode, the transports, mesh sharding, threshold policies and
tracing are later slices of the port; asking for them raises an error
that names their ROADMAP item.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Hashable, Iterable, Iterator, Optional, Tuple

import numpy as np

MODES = ("sync", "scan")


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: see ROADMAP.md queue 1, item {item}")


@dataclass(frozen=True)
class SessionConfig:
    """How a ``MonitorSession`` serves.  Frozen and validated.

    mode           -- ``sync`` (each trigger blocks on the server catch-up)
                      or ``scan`` (offline trace evaluation, fixed
                      membership).
    threshold / trigger_margin -- monitor operating-point overrides,
                      applied at engine construction by
                      ``MonitorSession.open``.
    capacity       -- scan mode's static correction capacity.
    monitor_n      -- Eq.-8 truncation override for the serving u head.
    transport, mesh, policy, trace -- the reference's options of paths not
                      ported yet; anything but their defaults raises.
    """

    mode: str = "sync"
    threshold: Optional[float] = None
    trigger_margin: Optional[float] = None
    capacity: Optional[int] = None
    monitor_n: Optional[int] = None
    transport: Optional[Any] = None
    mesh: Optional[Any] = None
    policy: Optional[Any] = None
    trace: bool = False

    def __post_init__(self):
        if self.mode == "async":
            raise _later("async mode", "4 (policy + async + tracing)")
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}: valid modes are "
                             + ", ".join(repr(m) for m in MODES))
        if self.transport not in (None, "inproc"):
            raise _later(f"transport {self.transport!r}",
                         "4-6 (async workers, wire, shm and fleet)")
        if self.mesh is not None:
            raise _later("mesh-sharded serving", "8 (mesh + analysis)")
        if self.policy is not None:
            raise _later("threshold policies", "4 (policy + async + tracing)")
        if self.trace:
            raise _later("span tracing", "4 (policy + async + tracing)")


class MonitorSession:
    """A context-managed serving session over one ``CollaborativeEngine``.

    Lifecycle: ``new`` -> ``open`` (first step/run/enter) -> ``closed``.
    The session owns the engine's protocol state for its lifetime.
    """

    def __init__(self, engine, config: Optional[SessionConfig] = None, *,
                 streams: Optional[Iterable[Hashable]] = None):
        self._engine = engine
        self.config = config if config is not None else SessionConfig()
        self._check_engine_matches(engine, self.config)
        self._state = "new"
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
        if self._state == "closed":
            raise RuntimeError("session is closed")
        self._state = "open"

    def close(self) -> None:
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
        return self._narrow(self._engine._step(self._expand(tokens)))

    def stream(self, token_iter: Iterable) -> Iterator[Dict[str, Any]]:
        """One result dict per step of ``token_iter``; membership may
        change between steps."""
        for tokens in token_iter:
            yield self.step(tokens)

    def run(self, token_stream) -> Dict[str, Any]:
        """Serve a whole stream (n_attached, S) and return stacked traces
        (n_attached, S) and the comms report."""
        self._ensure_open()
        if self.config.mode == "scan":
            if not self._full_pool():
                raise RuntimeError("scan mode requires the full slot pool")
            return self._engine._run_scan(token_stream)
        token_stream = np.asarray(token_stream)
        us, fhats, trigs = [], [], []
        for t in range(token_stream.shape[1]):
            r = self.step(token_stream[:, t])
            us.append(r["u"])
            fhats.append(r["fhat"])
            trigs.append(r["triggered"])
        return {"u": np.stack(us, 1), "fhat": np.stack(fhats, 1),
                "triggered": np.stack(trigs, 1), "streams": self.streams,
                "comms": self.report()}

    def report(self) -> Dict[str, Any]:
        """The engine's communication report (see ``CommsMeter``)."""
        return self._engine.comms.report()
