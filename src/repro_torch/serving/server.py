"""Standalone correction server (``serving/server.py``): the server half of
the paper's ``f = u + v`` decomposition as a process of its own, behind a
real socket, replaying on this package's engine.

One ``CorrectionServer`` owns a super-batch of ``slots`` server-cache rows
and leases contiguous row ranges to edge-client sessions: each connected
client (a ``wire`` session of either package) gets ``batch`` rows of the
shared server cache and the same rows of a token-history mirror kept on
the host.  The per-stream catch-up cache and the replayed history live
here, across a serialization boundary from the edge; the client's own
server cache stays cold for the whole session.

Request coalescing: the catch-up requests queued in one event-loop tick,
from many clients and from one async client's pipeline, merge into one
masked replay through the engine's ``_catchup_v`` on the server's cache:

  * ``triggered``  = the union of the requests' trigger masks (per slot);
  * ``server_pos`` = per slot, the least of the requests' catch-up bases;
  * ``t``          = per slot, the latest trigger step (a (slots,) vector:
    the masked replay takes per-stream end positions).

Rows of different sessions never interact (the replay is per-element
masked).  Each reply's fhat is fused from that request's own u and trigger
mask, in one ``monitor_combine`` call over every reply of the replay (the
call ``_catchup_apply`` makes), before the replay's one copy to the host.
A coalesced reply can carry a fresher v than its request asked for; any
corrector still only lowers fhat, so the monitor's upper bound stands.

Replies are FIFO per session: a session coalesces (its queued requests
merge, replies go out in arrival order) or opted out at HELLO
(``coalesce=False``), and then its requests replay one by one.

The event loop is a single-threaded ``selectors`` reactor: drain every
readable socket, run at most one coalesced replay, flush writes (one
gathered ``sendmsg`` per session a tick).  The replay runs on the loop's
thread, on ``device``.  Run it with ``python -m repro_torch.launch.server``
or in a thread via ``serve_forever(stop=threading.Event())``.  The
reference's shared-memory sessions (``shm=True``) and mesh-sharded
super-batch (``mesh=``) are not ported and raise.
"""
from __future__ import annotations

import os
import selectors
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.nn.module import resolve_device
from repro_torch.observability import MetricsRegistry, Tracer
from repro_torch.serving import wire
from repro_torch.serving.api import _later
from repro_torch.serving.collaborative import CollaborativeEngine
from repro_torch.serving.engine import permute_cache_rows, zero_cache_rows
from repro_torch.serving.tracker import Histogram, Tracker

# sendmsg gather limit per flush: under any IOV_MAX (Linux has 1024); a
# tick that queues more frames loops
_IOV_MAX = 64


@dataclass
class Session:
    """One connected edge client: a leased range of super-batch rows."""

    sid: int
    conn: socket.socket
    lo: int = -1            # first super-batch row (-1 until HELLO)
    batch: int = 0
    max_len: int = 0
    coalesce: bool = True
    client: str = "?"
    reader: wire.FrameReader = field(default_factory=wire.FrameReader)
    # per-frame output buffers, gathered into one sendmsg per flush
    out: List[bytes] = field(default_factory=list)

    @property
    def hi(self) -> int:
        return self.lo + self.batch


class CorrectionServer:
    """Socket front end + coalescing replay core over one super-batch, on
    ``device`` (``None``: the card; raises when there is none)."""

    def __init__(self, cfg: ArchConfig, params, *, slots: int = 16,
                 max_len: int = 128, uds: Optional[str] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 coalesce: bool = True, mesh: Optional[str] = None,
                 tracker: Optional[Tracker] = None,
                 tracer: Optional[Tracer] = None,
                 stats_interval_s: float = 0.5,
                 shm: bool = False, device=None):
        if shm:
            raise _later("the shm transport's server side",
                         "6 (shm, fleet, launchers)")
        if mesh is not None:
            raise _later("a mesh-sharded super-batch", "8 (mesh + analysis)")
        self.cfg, self.m = cfg, cfg.monitor
        self.slots, self.max_len = int(slots), int(max_len)
        self.coalesce = bool(coalesce)   # server-wide kill switch
        self.device = resolve_device(device)
        # the replay core is the engine's masked catch-up: one engine at
        # batch=slots gives it and the super-batch server cache (its edge
        # tower and comms meter go unused: the edge lives in the clients)
        self._eng = CollaborativeEngine(params, cfg, self.slots, self.max_len,
                                        device=self.device)
        self._cache = self._eng.server.cache
        self.tok_tail: Tuple[int, ...] = ()  # no audio family in the port
        # the token-history mirror, on the host: requests carry only
        # backlog slices, and the replay needs them at absolute positions
        self._history = np.zeros((self.slots, self.max_len), np.int32)
        # the replay thread's intra-op thread count is the constructing
        # thread's (a reduction's rounding may depend on its split)
        self._n_threads = torch.get_num_threads()

        # -- sessions / slots --------------------------------------------------
        self._sessions: Dict[socket.socket, Session] = {}
        self._free: List[Tuple[int, int]] = [(0, self.slots)]  # [lo, hi)
        self._next_sid = 1
        self._pending: List[Tuple[Session, wire.WireRequest, float]] = []

        # -- observability: the reference's counter and histogram names --------
        self.metrics = MetricsRegistry()
        for name in ("requests", "replays", "coalesced", "sessions",
                     "bytes_rx", "bytes_tx", "attaches", "detaches",
                     "defrags", "refused_draining",
                     # sendmsg calls: one tick's frames gather into one
                     "tx_flushes",
                     # the reference's ring-plane counters, zero here (no
                     # shm sessions), kept so the heartbeat's keys match
                     "shm_bytes_rx", "shm_bytes_tx", "shm_sessions"):
            self.metrics.counter(name)   # pre-create: zeros still report
        self.metrics.histogram("replay_s", 1e-5, 60.0)
        self.metrics.histogram("coalesce_width", 1.0, 4096.0)
        self.metrics.histogram("turnaround_s", 1e-5, 60.0)
        self.metrics.histogram("queue_wait_s", 1e-6, 60.0)
        # ``tracker``: serve_forever logs a snapshot every
        # ``stats_interval_s`` (a JsonFileTracker makes it a heartbeat)
        self.tracker = tracker
        self.stats_interval_s = float(stats_interval_s)
        self._last_stats_log = 0.0
        # optional server-local span tracer (server.queue/server.replay)
        self.tracer = tracer

        # -- drain -------------------------------------------------------------
        # request_drain() is signal-safe; the reactor applies it at its
        # next tick: GOAWAY to every leased session, ERROR to new HELLOs
        self.draining = False
        self._drain_req = threading.Event()

        # -- listener ----------------------------------------------------------
        self.uds = uds
        if uds is not None:
            self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._listener.bind(uds)
            self.address = uds
        else:
            self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._listener.bind((host, port))
            h, p = self._listener.getsockname()
            self.address = f"{h}:{p}"
        self._listener.listen(64)
        self._listener.setblocking(False)
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._listener, selectors.EVENT_READ, "accept")
        self._closed = False

    # -- observability ---------------------------------------------------------
    @property
    def stats(self) -> Dict[str, object]:
        """Counter snapshot (name -> value), a view of the registry."""
        return self.metrics.counters()

    @property
    def hist(self) -> Dict[str, Histogram]:
        """The registry's histograms, by name (``replay_s`` etc.)."""
        return self.metrics.hists

    def leased_rows(self) -> int:
        """Super-batch rows currently leased: the routing load signal."""
        return self.slots - sum(h - l for l, h in self._free)

    def sessions_live(self) -> int:
        return sum(1 for s in self._sessions.values() if s.lo >= 0)

    def stats_snapshot(self) -> Dict[str, object]:
        """One heartbeat record: identity, load, health and the counter and
        histogram state (what a JsonFileTracker writes)."""
        snap: Dict[str, object] = {
            "ts": time.time(),
            "address": self.address,
            "slots": self.slots,
            "leased_rows": self.leased_rows(),
            "sessions_live": self.sessions_live(),
            "fragmentation": self.fragmentation(),
            "draining": self.draining,
        }
        snap.update(self.metrics.snapshot())
        return snap

    # -- drain -----------------------------------------------------------------
    def request_drain(self) -> None:
        """Ask the reactor to start draining (safe from signal handlers and
        other threads; applied at the next ``serve_tick``)."""
        self._drain_req.set()

    def start_drain(self) -> None:
        """Stop taking work: GOAWAY every leased session, refuse new
        HELLOs.  In-flight requests still complete."""
        if self.draining:
            return
        self.draining = True
        for sess in list(self._sessions.values()):
            if sess.lo >= 0:
                self._send(sess, wire.encode_goaway("draining"))

    # -- slot allocation -------------------------------------------------------
    def _alloc(self, n: int) -> int:
        for i, (lo, hi) in enumerate(self._free):
            if hi - lo >= n:
                self._free[i] = (lo + n, hi)
                if self._free[i][0] == self._free[i][1]:
                    del self._free[i]
                return lo
        return -1

    def _release(self, lo: int, n: int) -> None:
        self._free.append((lo, lo + n))
        self._free.sort()
        merged: List[Tuple[int, int]] = []
        for a, b in self._free:
            if merged and merged[-1][1] == a:
                merged[-1] = (merged[-1][0], b)
            else:
                merged.append((a, b))
        self._free = merged

    def _reset_rows(self, lo: int, hi: int) -> None:
        """Zero a leased range, in place: a new session (or a re-leased
        slot, the ATTACH frame) sees cold rows whatever a previous tenant
        left."""
        rows = torch.zeros(self.slots, dtype=torch.bool)
        rows[lo:hi] = True
        zero_cache_rows(self._cache, rows.to(self.device))
        self._history[lo:hi] = 0

    # -- lease defrag ----------------------------------------------------------
    def fragmentation(self) -> float:
        """The fraction of free super-batch rows not in the largest free
        extent, in [0, 1): 0 when the free space is one block or none."""
        free = sum(h - l for l, h in self._free)
        if free == 0:
            return 0.0
        return 1.0 - max(h - l for l, h in self._free) / free

    def _defrag(self) -> None:
        """Compact live leases to the low end of the super-batch so the free
        rows form one tail.  Cache rows and the history mirror move with
        their sessions, bit for bit; clients address slots relative to
        ``sess.lo``, so nothing crosses the wire, and queued requests stay
        valid (the replay reads ``sess.lo`` when it runs)."""
        live = sorted((s for s in self._sessions.values() if s.lo >= 0),
                      key=lambda s: s.lo)
        if not any(s.lo != lo for s, lo in
                   zip(live, np.cumsum([0] + [s.batch for s in live]))):
            return  # already compact
        order: List[int] = []
        for s in live:
            order.extend(range(s.lo, s.lo + s.batch))
        taken = set(order)
        perm = np.asarray(order + [r for r in range(self.slots)
                                   if r not in taken])
        permute_cache_rows(self._cache,
                           torch.as_tensor(perm, device=self.device))
        self._history = self._history[perm]
        lo = 0
        for s in live:
            s.lo = lo
            lo += s.batch
        self._free = [(lo, self.slots)] if lo < self.slots else []
        self.metrics.inc("defrags")

    # -- socket plumbing -------------------------------------------------------
    def _send(self, sess: Session, data: bytes, *,
              flush: bool = True) -> None:
        """Queue a frame; ``flush=False`` defers the syscall so a tick's
        frames for one session (a replay's replies) gather into one
        ``sendmsg``."""
        sess.out.append(data)
        if flush:
            self._flush(sess)

    def _flush(self, sess: Session) -> None:
        while sess.out:
            try:
                n = sess.conn.sendmsg(sess.out[:_IOV_MAX])
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._drop(sess)
                return
            self.metrics.inc("bytes_tx", n)
            self.metrics.inc("tx_flushes")
            # retire fully sent buffers; re-head a partly sent one
            while n > 0:
                head = sess.out[0]
                if n >= len(head):
                    n -= len(head)
                    sess.out.pop(0)
                else:
                    sess.out[0] = head[n:]
                    n = 0
        events = selectors.EVENT_READ | (selectors.EVENT_WRITE if sess.out
                                         else 0)
        try:
            self._sel.modify(sess.conn, events, "conn")
        except KeyError:
            pass

    def _drop(self, sess: Session) -> None:
        try:
            self._sel.unregister(sess.conn)
        except (KeyError, ValueError):
            pass
        try:
            sess.conn.close()
        except OSError:
            pass
        released = sess.lo >= 0
        if released:
            self._release(sess.lo, sess.batch)
            # _drop can re-enter for one session (BYE flushes then drops,
            # and the flush drops on a broken pipe): mark the lease gone so
            # it is never released twice
            sess.lo = -1
        self._sessions.pop(sess.conn, None)
        self._pending = [p for p in self._pending if p[0] is not sess]
        # keep the freed rows one tail; deferred while requests are queued
        # (the compaction permutes the whole cache on the reactor thread),
        # and a fragmented map is compacted at the next HELLO that needs it
        if released and len(self._free) > 1 and not self._pending:
            self._defrag()

    def _accept(self) -> None:
        while True:
            try:
                conn, _ = self._listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            conn.setblocking(False)
            if conn.family == socket.AF_INET:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sess = Session(self._next_sid, conn)
            self._next_sid += 1
            self._sessions[conn] = sess
            self._sel.register(conn, selectors.EVENT_READ, "conn")

    def _read(self, sess: Session) -> None:
        while True:
            try:
                data = sess.conn.recv(1 << 16)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self._drop(sess)
                return
            if not data:
                self._drop(sess)
                return
            self.metrics.inc("bytes_rx", len(data))
            try:
                for p in sess.reader.feed(data):
                    if sess.conn not in self._sessions:
                        return  # dropped mid-batch (BYE, protocol error)
                    self._handle(sess, wire.decode(p))
            except wire.WireError as e:
                try:
                    self._send(sess, wire.encode_error(str(e)))
                finally:
                    self._drop(sess)
                return

    # -- protocol --------------------------------------------------------------
    def _handle(self, sess: Session, msg: wire.Message) -> None:
        if isinstance(msg, wire.Hello):
            if self.draining:
                # a refusal, not a death: the client sees HandshakeRefused
                self.metrics.inc("refused_draining")
                self._send(sess, wire.encode_error(
                    "draining: no new sessions"))
                return
            if sess.lo >= 0:
                self._send(sess, wire.encode_error("duplicate HELLO"))
                return
            if msg.max_len > self.max_len:
                self._send(sess, wire.encode_error(
                    f"client max_len {msg.max_len} > server {self.max_len}"))
                return
            if msg.tok_tail != self.tok_tail:
                self._send(sess, wire.encode_error(
                    f"token tail {msg.tok_tail} != server {self.tok_tail}"))
                return
            lo = self._alloc(msg.batch)
            if lo < 0 and len(self._free) > 1 \
                    and sum(h - l for l, h in self._free) >= msg.batch:
                # enough rows free in all, only fragmented: compact and
                # retry, so a HELLO that fits is never refused for holes
                self._defrag()
                lo = self._alloc(msg.batch)
            if lo < 0:
                self._send(sess, wire.encode_error(
                    f"server full: {msg.batch} slots requested, "
                    f"{sum(h - l for l, h in self._free)} free of {self.slots}"))
                return
            sess.lo, sess.batch = lo, msg.batch
            sess.max_len = msg.max_len
            sess.coalesce = bool(msg.coalesce) and self.coalesce
            sess.client = msg.client
            self._reset_rows(lo, lo + msg.batch)
            self.metrics.inc("sessions")
            # a v5 client's shm request gets the plain ack: the session
            # stays on the wire, as with the reference's wire-only server
            self._send(sess, wire.encode_hello_ack(
                wire.HelloAck(sess.sid, lo, self.max_len)))
        elif isinstance(msg, wire.WireRequest):
            if sess.lo < 0:
                self._send(sess, wire.encode_error("request before HELLO"))
                return
            bad = self._validate_request(sess, msg)
            if bad is not None:
                # a geometry violation: reject and drop, so a buggy client
                # never reaches rows outside its lease
                self._send(sess, wire.encode_error(bad))
                self._drop(sess)
                return
            self._pending.append((sess, msg, time.monotonic()))
        elif isinstance(msg, (wire.Attach, wire.Detach)):
            # slot-pool churn: one row of this session's lease turns over
            # (the client drained its pipeline first; other sessions cannot
            # name the row)
            if sess.lo < 0:
                self._send(sess, wire.encode_error("churn before HELLO"))
                self._drop(sess)
                return
            if not 0 <= msg.slot < sess.batch:
                self._send(sess, wire.encode_error(
                    f"churn slot {msg.slot} outside lease batch "
                    f"({sess.batch},)"))
                self._drop(sess)
                return
            row = sess.lo + msg.slot
            self._reset_rows(row, row + 1)
            self.metrics.inc("attaches" if isinstance(msg, wire.Attach)
                             else "detaches")
        elif isinstance(msg, wire.ShmOpen):
            # no arena was offered: as the reference's wire-only server
            self._send(sess, wire.encode_error("SHM_OPEN without offer"))
            self._drop(sess)
        elif isinstance(msg, wire.Bye):
            self._flush(sess)
            self._drop(sess)
        else:
            # ERROR from the client, or a frame only a server sends
            self._drop(sess)

    def _validate_request(self, sess: Session,
                          req: wire.WireRequest) -> Optional[str]:
        """Geometry check against the session's lease: every index the
        replay touches must lie inside it.  An error string, or None."""
        B = sess.batch
        if (req.triggered.shape != (B,) or req.server_pos.shape != (B,)
                or req.u.shape != (B,)):
            return (f"request vectors {req.triggered.shape}/"
                    f"{req.server_pos.shape}/{req.u.shape} != session "
                    f"batch ({B},)")
        if not 0 <= req.t < sess.max_len:
            return f"trigger step {req.t} outside [0, {sess.max_len})"
        if req.triggered.any():
            pos = req.server_pos[req.triggered]
            if (pos < 0).any() or (pos > req.t).any():
                return "server_pos outside [0, t] on a triggered stream"
        want = (int(req.backlog_lengths().sum()),) + self.tok_tail
        if req.tokens.shape != want:
            return f"token payload shape {req.tokens.shape} != {want}"
        return None

    # -- the replay core -------------------------------------------------------
    def _replay(self, group: List[Tuple[Session, wire.WireRequest, float]]
                ) -> None:
        """One masked catch-up over the union of the group's requests, then
        one reply per request (arrival order)."""
        S, eng, dev = self.slots, self._eng, self.device
        trig = np.zeros(S, bool)
        pos = np.zeros(S, np.int32)
        tvec = np.zeros(S, np.int32)
        for sess, req, _ in group:
            lengths = req.backlog_lengths()
            off = 0
            for i in np.flatnonzero(req.triggered):
                L = int(lengths[i])
                gi = sess.lo + int(i)
                p = int(req.server_pos[i])
                self._history[gi, p:req.t + 1] = req.tokens[off:off + L]
                off += L
                pos[gi] = min(pos[gi], p) if trig[gi] else p
                trig[gi] = True
                tvec[gi] = max(tvec[gi], req.t)
        t0 = time.monotonic()
        with torch.inference_mode():
            # every input uploads before the first launch: the replay's one
            # sync is the copy of its results below
            backlog = eng._backlog(pos, tvec, trig, history=self._history)
            rows = torch.as_tensor(np.concatenate(
                [np.arange(s.lo, s.hi) for s, _, _ in group]), device=dev)
            u_req = torch.as_tensor(np.concatenate(
                [req.u for _, req, _ in group]), device=dev)
            trig_req = torch.as_tensor(np.concatenate(
                [req.triggered for _, req, _ in group]), device=dev)
            v = eng._catchup_v(eng.params, self._cache, backlog)
            # every reply's fhat from its own request's u and mask, one call
            fhat = eng._fuse(u_req, v[rows], trig_req)
            out = torch.cat((v, fhat)).cpu().numpy()
        dt = time.monotonic() - t0
        v_np, fhat_np = out[:S], out[S:]
        self.metrics.inc("replays")
        self.metrics.inc("requests", len(group))
        if len(group) > 1:
            self.metrics.inc("coalesced", len(group) - 1)
        hist = self.metrics.hists
        hist["replay_s"].observe(max(dt, 1e-9))
        hist["coalesce_width"].observe(len(group))
        if self.tracer is not None:
            self.tracer.add("server.replay", "server", t0, dt,
                            track="server", coalesced=len(group))
        now = time.monotonic()
        touched: Dict[int, Session] = {}
        off = 0
        for sess, req, arrived in group:
            # queue wait = arrival -> replay start: the v4 timing payload
            # that lets the client split its RTT into socket/queue/compute
            queue_s = max(t0 - arrived, 0.0)
            hist["queue_wait_s"].observe(max(queue_s, 1e-9))
            hist["turnaround_s"].observe(max(now - arrived, 1e-9))
            if self.tracer is not None:
                self.tracer.add("server.queue", "server", arrived, queue_s,
                                track="server", req_id=req.req_id)
            self._send(sess, wire.encode_reply(wire.WireReply(
                req.req_id, req.t, req.triggered, v_np[sess.lo:sess.hi],
                fhat_np[off:off + sess.batch],
                server_time_s=dt / len(group), coalesced=len(group),
                queue_s=queue_s)), flush=False)
            off += sess.batch
            touched[sess.sid] = sess
        # one gathered flush per session for every reply of the tick
        for sess in touched.values():
            if sess.conn in self._sessions:
                self._flush(sess)

    def _process_pending(self) -> None:
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        group = [p for p in pending if p[0].coalesce]
        if group:
            self._replay(group)
        for p in pending:
            if not p[0].coalesce:
                self._replay([p])

    # -- loop ------------------------------------------------------------------
    def serve_tick(self, timeout: float = 0.001) -> None:
        if self._drain_req.is_set() and not self.draining:
            self.start_drain()
        for key, mask in self._sel.select(timeout):
            if key.data == "accept":
                self._accept()
                continue
            sess = self._sessions.get(key.fileobj)
            if sess is None:
                continue
            if mask & selectors.EVENT_READ:
                self._read(sess)
            if mask & selectors.EVENT_WRITE and sess.conn in self._sessions:
                self._flush(sess)
        self._process_pending()

    def serve_forever(self, *, poll_s: float = 0.001,
                      stop: Optional[threading.Event] = None,
                      idle_exit_s: Optional[float] = None) -> None:
        """Run until ``stop`` is set (or forever).  ``idle_exit_s``: return
        once a session has existed and none has remained for that long.
        The calling thread takes the server's device and the constructing
        thread's intra-op thread count."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        if torch.get_num_threads() != self._n_threads:
            torch.set_num_threads(self._n_threads)
        idle_since: Optional[float] = None
        while stop is None or not stop.is_set():
            self.serve_tick(poll_s)
            if self.tracker is not None:
                now = time.monotonic()
                if now - self._last_stats_log >= self.stats_interval_s:
                    self._last_stats_log = now
                    self.tracker.log(self.stats_snapshot())
            # a drained server with no sessions left has nothing to do
            if self.draining and not self._sessions:
                return
            if idle_exit_s is not None:
                if self._sessions or self.stats["sessions"] == 0:
                    idle_since = None
                elif idle_since is None:
                    idle_since = time.monotonic()
                elif time.monotonic() - idle_since > idle_exit_s:
                    return

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for sess in list(self._sessions.values()):
            self._drop(sess)
        try:
            self._sel.unregister(self._listener)
        except (KeyError, ValueError):
            pass
        self._listener.close()
        self._sel.close()
        if self.tracker is not None:
            try:
                self.tracker.finish()
            except OSError:
                pass
        if self.uds is not None:
            try:
                os.unlink(self.uds)
            except OSError:
                pass
