"""Async pipelined server catch-up (``serving/async_rpc.py``, its local
half): the dispatch/merge layer between the edge decode loop and the
server corrector.

The edge monitor ``u`` runs on every token while the server corrector
``v`` is consulted only on a trigger, so the server's latency (catch-up
compute plus the round trip) should hide behind edge decode.  Two halves:

  * ``ServerWorker`` -- owns the server cache for an async session and
    applies ``CatchupRequest``s strictly in FIFO order, so the cache
    replay is the synchronous engine's.  Transports:

      - ``inproc``      -- computes at dispatch, on the caller's thread and
        stream.  Deterministic; exercises the merge policy without
        concurrency.
      - ``stream``      -- the side-stream transport (CUDA only).  The
        catch-up is enqueued from the caller's thread on a CUDA stream of
        the worker's own; ``dispatch`` returns once the launches are
        queued and the card runs them beside the edge loop's next
        launches.  Requests chain through the worker's cache on one
        stream, so the replay is FIFO.  Readiness is an event query.
      - ``thread``      -- a worker thread runs the catch-up (on a CUDA
        engine on a stream of its own); PyTorch releases the GIL inside
        its kernels and launches.
      - ``mock_remote`` -- ``thread`` plus a simulated round trip: a reply
        becomes visible ``latency_s`` after its compute finishes.
      - ``wire``        -- the real boundary: a ``SocketWorker`` speaks the
        binary protocol of ``serving/wire.py`` to a correction server in
        another process (``serving/server.py``, started with ``python -m
        repro_torch.launch.server``) over a Unix-domain or TCP socket.
        The server owns the cache; only backlog tokens and scores cross
        the wire, and round trips and bytes are measured
        (``CommsMeter.record_wire_*``), not modelled.  The server may be
        the JAX package's: the frames are the same bytes.
      - ``shm``         -- the reference's shared-memory rings, and the
        ``fleet:`` router addresses; not ported (ROADMAP queue 1, item 6).

  * ``Dispatcher`` -- the edge side: tracks in-flight requests, polls or
    blocks for replies, and enforces the staleness window.

STALENESS (``max_staleness``): 0 is the strict synchronous boundary (the
reply for a trigger at step t merges at step t: bit-identical to the
engine's sync step); k >= 1 merges a reply at the first step after its
trigger once it has arrived, and no later than t + k -- the dispatcher
blocks the edge loop only when the oldest request reaches age k.  The
monitor path (u, the trigger decision) never waits on the server.

ORDER ACROSS STREAMS on the card.  The engine builds each request's
tensors (``Backlog``: the backlog's tokens gathered from the token history,
positions, masks) on the dispatching stream at dispatch, so no worker
reads the live history, which later steps overwrite in place.  A worker
on a stream of its own makes that stream wait on an event recorded on the
dispatching stream at dispatch (after u and the backlog exist) and marks
every request tensor with ``record_stream``, so the caching allocator
cannot hand their memory out while the side stream reads it.  It copies v
and fhat into pinned host memory on its stream and records an event
after them: readiness is ``Event.query()``, blocking is
``Event.synchronize()``, never a device-wide synchronize, and nothing on
the worker's stream uploads from pageable memory (such a copy would
synchronise the stream it runs on).  Before the engine touches the server
cache again (a slot reset, the end of the session) ``settle`` makes the
engine's stream wait on the worker's.

Replies do not carry the server cache: the worker owns it (in place) for
the session and the engine re-adopts it when the session closes, after a
full drain.
"""
from __future__ import annotations

import contextlib
import queue
import socket
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

TRANSPORTS = ("inproc", "stream", "thread", "mock_remote", "wire", "shm")
# the reference's transports that later slices port: kind -> ROADMAP item
NOT_PORTED = {"shm": "6 (shm, fleet, launchers)",
              "fleet": "6 (shm, fleet, launchers)"}
# dispatches whose timing a StreamWorker keeps (the newest)
TIMINGS_KEPT = 4096


def not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"the {kind} transport is not ported yet: see ROADMAP.md queue 1, "
        f"item {NOT_PORTED[kind]}")


class Backlog(NamedTuple):
    """One request's catch-up inputs on the engine's device, built on the
    dispatching stream at dispatch.  R rounds (the longest backlog), B
    rows: ``tokens`` (R, B) int64, ``pos`` (R, B) int32, ``active`` (R, B)
    bool (row b replays round r), ``triggered`` (B,) bool."""

    tokens: torch.Tensor
    pos: torch.Tensor
    active: torch.Tensor
    triggered: torch.Tensor


@dataclass
class CatchupRequest:
    """One trigger step's worth of server work for one same-position
    cohort.  ``server_pos`` is the dispatch-time catch-up base: stream i's
    backlog is its tokens ``server_pos[i]..t``, snapshotted in
    ``backlog``."""

    req_id: int
    t: int                      # trigger position (inclusive end of backlog)
    triggered: np.ndarray       # (B,) bool: the streams this request serves
    server_pos: np.ndarray      # (B,) int: catch-up base per stream
    backlog: Backlog            # the backlog's device tensors
    u: torch.Tensor             # (B,) monitor scores at the trigger step
    u_host: np.ndarray          # the same u on the host (what ``wire`` ships)
    wall_dispatch: float = 0.0  # time.monotonic() at dispatch
    # the session step at dispatch: the staleness clock.  Under slot-pool
    # churn streams carry their own positions, so t (a position) and the
    # session clock diverge: ages are measured on step_t, backlogs on t
    step_t: int = -1


@dataclass
class CatchupReply:
    req_id: int
    t: int                      # the request's trigger position
    triggered: np.ndarray
    v: np.ndarray               # (B,) server scores (valid where triggered)
    fhat: np.ndarray            # (B,) fused fhat from the dispatch-time u
    server_time_s: float        # compute time of the catch-up
    wall_ready: float = 0.0     # when the reply became visible (incl. latency)
    step_t: int = -1            # filled by the Dispatcher from the request


@dataclass
class DispatchTiming:
    """One ``StreamWorker.dispatch``: its host time, the CUDA events
    around its catch-up on the side stream, and whether the catch-up was
    still running on the card when ``dispatch`` returned."""

    host_s: float
    start: Any                  # torch.cuda.Event after the stream's wait
    done: Any                   # torch.cuda.Event after the host copies
    pending_at_return: bool
    returned_at: float          # time.perf_counter() at return

    def device_ms(self) -> float:
        """The catch-up's span on the card (both events must be done)."""
        return self.start.elapsed_time(self.done)


class ServerWorker:
    """Base transport, ``inproc``: owns the server cache, applies requests
    in FIFO order, on the caller's thread and current stream.

    ``catchup_fn(params, cache, backlog, u) -> (v, fhat)`` -- the engine's
    masked per-element catch-up, which writes ``cache`` in place.
    """

    kind = "inproc"

    def __init__(self, catchup_fn: Callable, params: Any, cache: Any):
        self._fn = catchup_fn
        self._params = params
        self.cache = cache
        self.device = next(params.parameters()).device
        self.stream = None            # a CUDA stream of the worker's own
        self._ready: deque = deque()  # replies visible to poll(), FIFO
        self._closed = False

    # -- server side ---------------------------------------------------------
    def _enqueue(self, req: CatchupRequest, ready=None):
        """Queue one catch-up on the current stream.  Returns (out, start,
        done), ``out`` (2, B) holding v and fhat: on a CUDA device a
        pinned host copy, valid once the event ``done`` has completed
        (``start``: an event after the wait on ``ready``, the dispatching
        stream's event that orders this work after the request's inputs);
        on the CPU final, and the events are None."""
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in (*req.backlog, req.u):
                t.record_stream(stream)
        start = None
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        v, fhat = self._fn(self._params, self.cache, req.backlog, req.u)
        out = torch.stack((v, fhat))
        if start is None:
            return out, None, None
        out = out.to("cpu", non_blocking=True)  # into pinned memory
        done = torch.cuda.Event(enable_timing=True)
        done.record()
        return out, start, done

    def _reply(self, req: CatchupRequest, out: torch.Tensor, server_s: float,
               ready_at: float) -> CatchupReply:
        """The reply from a finished catch-up's ``out`` (copied: a pinned
        block goes back to the host allocator's cache)."""
        v, fhat = out.numpy().copy()
        return CatchupReply(req.req_id, req.t, req.triggered, v, fhat,
                            server_s, wall_ready=ready_at)

    def _compute(self, req: CatchupRequest, ready=None) -> CatchupReply:
        """The catch-up to its end, on this thread's current stream."""
        t0 = time.monotonic()
        out, _, done = self._enqueue(req, ready)
        if done is not None:
            done.synchronize()
        t1 = time.monotonic()
        return self._reply(req, out, t1 - t0, t1)

    def settle(self) -> None:
        """Order the engine's stream after every catch-up this worker has
        queued: on a side stream, the engine's current stream waits on it
        (a device-side wait; the host does not block)."""
        if self.stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)

    # -- edge side -----------------------------------------------------------
    def dispatch(self, req: CatchupRequest) -> None:
        """inproc: compute now, on the caller's thread."""
        self._ready.append(self._compute(req))

    def poll(self) -> List[CatchupReply]:
        """All replies that are ready, in FIFO order.  Non-blocking."""
        out = list(self._ready)
        self._ready.clear()
        return out

    def wait(self, req_id: int) -> List[CatchupReply]:
        """Block until ``req_id`` is done; returns every reply up to and
        including it, in FIFO order.  inproc computes at dispatch, so the
        reply is already here."""
        taken: List[CatchupReply] = []
        while self._ready:
            r = self._ready.popleft()
            taken.append(r)
            if r.req_id == req_id:
                break
        return taken

    def close(self) -> None:
        """Idempotent on every transport."""
        if not self._closed:
            self._closed = True
            self.settle()


class StreamWorker(ServerWorker):
    """Side-stream transport: overlap on a CUDA stream, no threads.

    ``dispatch`` records an event on the caller's stream, makes the
    worker's stream wait on it, enqueues the catch-up there and returns;
    the card runs it beside whatever the edge loop launches next.  ``poll``
    observes readiness with ``Event.query()`` and ``wait`` blocks with
    ``Event.synchronize()``.  ``timings`` keeps the newest dispatches'
    host times and the CUDA events around their catch-ups (the witness
    that ``dispatch`` does not wait for the card).

    ``latency_s`` simulates the network: a reply becomes visible
    ``latency_s`` after its compute is first observed done (the edge loop
    polls every step, so the observation error is at most one step).

    Nothing in ``dispatch`` synchronises (``chip_smoke.py`` lists the
    runtime calls inside each ``stream_dispatch`` profiler range), but a
    stream holds a bounded queue of pending launches: when the card lags
    the host by more than that queue, ``cudaLaunchKernel`` itself blocks
    until an entry frees.  A dispatch runs ahead of the card by at most
    that many launches (``chip_smoke.py`` measures the depth; a
    full-width granite catch-up round is more).
    """

    kind = "stream"

    def __init__(self, catchup_fn, params, cache, *, latency_s: float = 0.0):
        super().__init__(catchup_fn, params, cache)
        if self.device.type != "cuda":
            raise ValueError(
                "the stream transport overlaps on a CUDA side stream and "
                f"needs an engine on a CUDA device, not {self.device}: on "
                "the CPU use inproc, thread or mock_remote")
        self.latency_s = float(latency_s)
        self.stream = torch.cuda.Stream(self.device)
        self._pending: deque = deque()  # [req, out, start, done, seen_at]
        self.timings: deque = deque(maxlen=TIMINGS_KEPT)

    def dispatch(self, req: CatchupRequest) -> None:
        t0 = time.perf_counter()
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        # a profiler range, so a trace shows each dispatch's runtime calls
        with record_function("stream_dispatch"), \
                torch.cuda.stream(self.stream):
            out, start, done = self._enqueue(req, ready)
        self._pending.append([req, out, start, done, None])
        pending = not done.query()
        t1 = time.perf_counter()
        self.timings.append(DispatchTiming(t1 - t0, start, done, pending, t1))

    def _release(self, item) -> CatchupReply:
        req, out, start, done, seen_at = item
        # the catch-up's span on the card: events, not the host clock
        return self._reply(req, out, start.elapsed_time(done) / 1e3,
                           seen_at + self.latency_s)

    def _stamp_ready(self) -> None:
        # stamp every finished request, not just the head: the simulated
        # wire delays of distinct requests overlap; compute is FIFO on one
        # stream, so stop at the first one still running
        now = time.monotonic()
        for item in self._pending:
            if item[4] is None:
                if not item[3].query():
                    break
                item[4] = now

    def poll(self) -> List[CatchupReply]:
        self._stamp_ready()
        out: List[CatchupReply] = []
        while self._pending:
            item = self._pending[0]
            if item[4] is None or item[4] + self.latency_s > time.monotonic():
                break
            self._pending.popleft()
            out.append(self._release(item))
        return out

    def wait(self, req_id: int) -> List[CatchupReply]:
        out: List[CatchupReply] = []
        while not out or out[-1].req_id < req_id:
            item = self._pending.popleft()
            if item[4] is None:
                item[3].synchronize()
                item[4] = time.monotonic()
                # later requests may have finished meanwhile: start their
                # simulated wire clocks now, so the delays overlap
                self._stamp_ready()
            dt = item[4] + self.latency_s - time.monotonic()
            if dt > 0:              # still on the simulated wire
                time.sleep(dt)
            out.append(self._release(item))
        return out


class ThreadWorker(ServerWorker):
    """One worker thread runs the catch-ups; the edge loop overlaps them.

    In PyTorch the current stream, the current device, inference mode and
    the intra-op thread count are each per thread, so the worker thread
    sets all four itself: the engine's device, a CUDA stream of its own
    (not the default stream, which would serialise it with the edge),
    ``torch.inference_mode`` and the creating thread's thread count (a
    reduction's rounding may depend on how it is split).

    ``latency_s`` models the network round trip: a reply becomes visible
    ``latency_s`` after its compute finishes.  The delays overlap (many
    replies can be on the wire at once) while compute stays serialised.
    """

    kind = "thread"

    def __init__(self, catchup_fn, params, cache, *, latency_s: float = 0.0):
        super().__init__(catchup_fn, params, cache)
        self.latency_s = float(latency_s)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self._n_threads = torch.get_num_threads()
        self._q: "queue.Queue" = queue.Queue()
        self._cv = threading.Condition()
        self._done: deque = deque()  # (reply, visible_at) in FIFO order
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"{self.kind}-worker")
        self._thread.start()

    def _run(self) -> None:
        if self.stream is not None:
            torch.cuda.set_device(self.device)
        if torch.get_num_threads() != self._n_threads:
            torch.set_num_threads(self._n_threads)
        on_stream = (torch.cuda.stream(self.stream) if self.stream is not None
                     else contextlib.nullcontext())
        try:
            with torch.inference_mode(), on_stream:
                while True:
                    item = self._q.get()
                    if item is None:
                        return
                    reply = self._compute(*item)
                    visible_at = reply.wall_ready + self.latency_s
                    reply.wall_ready = visible_at
                    with self._cv:
                        self._done.append((reply, visible_at))
                        self._cv.notify_all()
        except Exception as e:  # the thread's boundary: wait() re-raises
            with self._cv:
                self._error = e
                self._cv.notify_all()

    def dispatch(self, req: CatchupRequest) -> None:
        ready = None
        if self.stream is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        self._q.put((req, ready))

    def poll(self) -> List[CatchupReply]:
        now = time.monotonic()
        out: List[CatchupReply] = []
        with self._cv:
            while self._done and self._done[0][1] <= now:
                out.append(self._done.popleft()[0])
        return out

    def wait(self, req_id: int) -> List[CatchupReply]:
        out: List[CatchupReply] = []
        while not out or out[-1].req_id < req_id:
            with self._cv:
                while not self._done:
                    if self._error is not None:
                        raise RuntimeError(
                            "server worker thread died: the catch-up "
                            "raised") from self._error
                    self._cv.wait(timeout=0.05)
                reply, visible_at = self._done.popleft()
            dt = visible_at - time.monotonic()
            if dt > 0:              # still on the simulated wire
                time.sleep(dt)
            out.append(reply)
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._thread.is_alive():
            self._q.put(None)
            self._thread.join()
        self.settle()


class MockRemoteWorker(ThreadWorker):
    """``thread`` plus a nonzero simulated network round trip."""

    kind = "mock_remote"

    def __init__(self, catchup_fn, params, cache, *, latency_s: float = 0.02):
        super().__init__(catchup_fn, params, cache, latency_s=latency_s)


class SocketWorker(ServerWorker):
    """The ``wire`` transport: catch-up requests cross a real socket to a
    correction server in another process (``serving/server.py``, this
    package's or the JAX package's).

    The server owns the session's server cache (leased rows of its
    super-batch) and its token-history mirror; locally ``self.cache`` is
    the engine's cold cache, and what comes home is ``server_pos``
    (carried by every reply).  Each dispatch copies its request's backlog
    tokens (R, B) to the host once and ships, as int32, each triggered
    stream's first ``t + 1 - server_pos[i]`` tokens in stream order, with
    the trigger mask, the bases and u (float32, the engine's own host copy
    of the step's u): the payload the reference's ``encode_request`` slices
    out of a host history.  Each
    reply carries v, fhat and the server's timings.  Round trips and the
    bytes on the socket (the handshake included) are measured into the
    ``CommsMeter``; ``metrics`` (the engine's registry) receives the RTT
    breakdown (serialize / socket / queue / compute) and ``tracer`` its
    spans.

    ``coalesce=False`` opts the session out of the server's request
    coalescing (per-request replays).  Replies are matched against the
    head of the flight queue: a duplicate or stale reply is dropped, so
    the Dispatcher's FIFO contract holds.  A server that dies or answers
    with an ERROR frame fails the session with ``WireError`` (``PeerGone``
    at the handshake); nothing falls back to a local replay.  ``fleet:``
    router addresses and their failover are not ported (ROADMAP queue 1,
    item 6).
    """

    kind = "wire"
    # a blocking wait that sees no reply for this long fails the session
    # (a hung server must not hang the edge loop forever)
    _REPLY_TIMEOUT_S = 300.0

    # the handshake's own timeout (connect, HELLO, HELLO_ACK)
    _CONNECT_TIMEOUT_S = 60.0

    def __init__(self, cache, *, address: str, batch: int, max_len: int,
                 coalesce: bool = True, comms=None, metrics=None,
                 tracer=None):
        from repro_torch.serving import wire

        if address.startswith("fleet:"):
            raise not_ported("fleet")
        self._wire = wire
        self.cache = cache               # stays cold (see the docstring)
        self.stream = None
        self._closed = False
        self._comms = comms
        self._metrics = metrics
        self._tracer = tracer
        self._replies: deque = deque()
        # req_id -> (dispatch wall time, serialize duration): the client
        # half of the per-request RTT breakdown
        self._dispatch_wall: Dict[int, Tuple[float, float]] = {}
        # the req_ids of unanswered requests, in dispatch order: the head
        # is the only reply the FIFO contract accepts
        self._flights: "deque[int]" = deque()
        self._must_move = False      # GOAWAY received: leave when empty
        # while corked, outgoing frames gather into one buffer that leaves
        # in a single transmit at uncork (the engine corks around a step's
        # cohort fan-out)
        self._corked: Optional[List[bytes]] = None
        # no token tail: the port has no audio family
        hello = wire.Hello(batch, max_len, (), coalesce, "edge")
        sock, ack, reader, tx, rx = wire.connect_hello(
            address, hello, timeout=self._CONNECT_TIMEOUT_S)
        self._sock, self._reader = sock, reader
        self._tx(tx)
        self._rx(rx)
        self.session_id = ack.session_id
        self.slot_lo = ack.slot_lo
        peer = sock.getpeername()
        self.server_address = (peer if isinstance(peer, str)
                               else f"{peer[0]}:{peer[1]}")

    # -- metering ------------------------------------------------------------
    def _tx(self, n: int) -> None:
        if self._comms is not None:
            self._comms.record_wire_tx(n)

    def _rx(self, n: int) -> None:
        if self._comms is not None:
            self._comms.record_wire_rx(n)

    def _fail(self, why: str) -> None:
        """A direct address has no sibling to move to: the session fails.
        (The reference's fleet client fails over instead: it re-HELLOs
        through its router and replays; ROADMAP queue 1, item 6.)"""
        raise self._wire.WireError(why)

    def _move_now(self) -> None:
        """A GOAWAY honoured once the pipeline is empty: leave politely;
        with no router to find a sibling, the session ends there."""
        try:
            self._sock.settimeout(1.0)
            bye = self._wire.encode_bye()
            self._sock.sendall(bye)
            self._tx(len(bye))
        except OSError:
            pass
        self._fail("server draining")

    # -- replies ---------------------------------------------------------------
    def _to_reply(self, msg) -> CatchupReply:
        now = time.monotonic()
        disp, ser = self._dispatch_wall.pop(msg.req_id, (now, 0.0))
        rtt = now - disp
        if self._comms is not None:
            self._comms.record_wire_rtt(rtt)
        if self._metrics is not None or self._tracer is not None:
            self._breakdown(msg, now, disp, ser, rtt)
        return CatchupReply(msg.req_id, msg.t, np.asarray(msg.triggered),
                            np.asarray(msg.v), np.asarray(msg.fhat),
                            msg.server_time_s, wall_ready=now)

    def _breakdown(self, msg, now: float, disp: float, ser: float,
                   rtt: float) -> None:
        """Split one measured RTT into serialize / socket / queue / compute
        from the REPLY's duration-only timings, observe the pieces into the
        registry and, when tracing, add the server-side spans, anchored
        backwards from the reply's arrival (no clock sync)."""
        compute = max(msg.server_time_s, 0.0)
        queue_s = msg.queue_s if msg.queue_s >= 0 else None  # None: a v3 peer
        if self._metrics is not None:
            m = self._metrics
            m.observe("rtt_s", max(rtt, 1e-9))
            m.observe("rtt_serialize_s", max(ser, 1e-9))
            m.observe("rtt_compute_s", max(compute, 1e-9))
            if queue_s is not None:
                m.observe("rtt_queue_s", max(queue_s, 1e-9))
                m.observe("rtt_socket_s",
                          max(rtt - queue_s - compute, 1e-9))
        if self._tracer is not None:
            tr = self._tracer
            tr.add("wire.request", "wire", disp, rtt, track="wire",
                   req_id=msg.req_id, coalesced=msg.coalesced)
            # compute ends at arrival, the queue wait precedes it, and the
            # rest of the gap after dispatch is both socket directions
            tr.add("server.catchup", "server", now - compute, compute,
                   track="server", req_id=msg.req_id,
                   coalesced=msg.coalesced)
            if queue_s is not None:
                tr.add("server.queue", "server", now - compute - queue_s,
                       queue_s, track="server", req_id=msg.req_id)
                tr.add("wire.socket", "wire", disp,
                       max(rtt - queue_s - compute, 0.0), track="wire",
                       req_id=msg.req_id)

    def _accept_reply(self, msg) -> bool:
        """Match a REPLY against the head of the flight queue; anything
        else (a duplicate, a stale frame) is dropped.  Returns True when a
        reply landed."""
        if not self._flights or self._flights[0] != msg.req_id:
            return False
        self._flights.popleft()
        self._replies.append(self._to_reply(msg))
        return True

    def _on_payloads(self, payloads: List[bytes]) -> bool:
        wire = self._wire
        got = False
        for p in payloads:
            msg = wire.decode(p)
            if isinstance(msg, wire.Error):
                raise wire.WireError(f"server: {msg.message}")
            if isinstance(msg, wire.GoAway):
                self._must_move = True
            elif isinstance(msg, wire.WireReply):
                got |= self._accept_reply(msg)
        return got

    def _pump(self, block: bool) -> None:
        """Drain the socket into ``self._replies``: non-blocking takes what
        the kernel has; blocking returns once a reply landed, and raises
        ``WireError`` after ``_REPLY_TIMEOUT_S`` without one."""
        got = False
        while True:
            if self._must_move and not self._flights:
                self._move_now()
            self._sock.settimeout(self._REPLY_TIMEOUT_S
                                  if (block and not got) else 0.0)
            try:
                data = self._sock.recv(1 << 16)
            except BlockingIOError:
                return
            except socket.timeout:
                if block and not got:
                    self._fail("no reply within "
                                   f"{self._REPLY_TIMEOUT_S} s")
                return
            except InterruptedError:
                continue
            except OSError as e:
                self._fail(f"connection lost: {e}")
            if not data:
                self._fail("server closed connection")
            self._rx(len(data))
            got |= self._on_payloads(self._reader.feed(data))

    # -- ServerWorker API ------------------------------------------------------
    def dispatch(self, req: CatchupRequest) -> None:
        if self._must_move and not self._flights:
            self._move_now()
        t = int(req.t)
        trig = np.asarray(req.triggered, bool)
        pos = np.asarray(req.server_pos, np.int32)
        lengths = np.where(trig, t + 1 - pos, 0)
        t_enc = time.monotonic()
        # the backlog's (R, B) tokens to the host once; each triggered
        # stream's backlog, concatenated in stream order
        toks = req.backlog.tokens.cpu().numpy()
        rows = np.flatnonzero(trig)
        tokens = (np.concatenate([toks[:lengths[i], i] for i in rows])
                  if len(rows) else np.zeros(0, np.int32))
        buf = self._wire.encode_request_arrays(self._wire.WireRequest(
            req.req_id, t, trig, pos, req.u_host, tokens))
        t_send = time.monotonic()
        self._dispatch_wall[req.req_id] = (t_send, t_send - t_enc)
        if self._tracer is not None:
            self._tracer.add("wire.encode", "wire", t_enc, t_send - t_enc,
                             track="wire", req_id=req.req_id,
                             bytes=len(buf), tokens=int(lengths.sum()))
        self._flights.append(req.req_id)
        self._send_frame(buf)

    def poll(self) -> List[CatchupReply]:
        self._pump(block=False)
        out = list(self._replies)
        self._replies.clear()
        return out

    def wait(self, req_id: int) -> List[CatchupReply]:
        out: List[CatchupReply] = []
        while True:
            while self._replies:
                r = self._replies.popleft()
                out.append(r)
                if r.req_id == req_id:
                    return out
            self._pump(block=True)

    # -- frame egress ----------------------------------------------------------
    def _send_frame(self, buf: bytes) -> None:
        if self._corked is not None:
            self._corked.append(buf)
            return
        self._transmit(buf)

    def _transmit(self, buf: bytes) -> None:
        """The only place client bytes leave."""
        self._sock.settimeout(None)
        try:
            self._sock.sendall(buf)
        except OSError as e:
            self._fail(f"send failed: {e}")
        self._tx(len(buf))

    def cork(self) -> None:
        """Start gathering outgoing frames (idempotent); ``uncork`` sends
        them as one transmit.  Callers wrap a dispatch fan-out, never a
        wait."""
        if self._corked is None:
            self._corked = []

    def uncork(self) -> None:
        bufs, self._corked = self._corked, None
        if bufs:
            self._transmit(b"".join(bufs))

    # -- slot-pool churn (MonitorSession.attach/detach over the wire) ----------
    def attach_slot(self, slot: int) -> None:
        """Tell the server to zero and re-lease row ``slot`` of this
        session's lease (a new stream moved in).  The socket is FIFO, so
        the reset lands before any later request; the engine drains its
        pipeline first."""
        if self._must_move and not self._flights:
            self._move_now()
        self._send_frame(self._wire.encode_attach(slot))

    def detach_slot(self, slot: int) -> None:
        """Tell the server the stream in row ``slot`` left (it zeroes the
        row; ATTACH zeroes it again on reuse)."""
        self._send_frame(self._wire.encode_detach(slot))

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._sock.settimeout(1.0)
            bye = self._wire.encode_bye()
            self._sock.sendall(bye)
            self._tx(len(bye))
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


def make_worker(transport: str, catchup_fn, params, cache, *,
                latency_s: Optional[float] = None,
                wire_opts: Optional[Dict[str, Any]] = None) -> ServerWorker:
    """``latency_s=None`` keeps each transport's own default (0 for
    stream/thread, 20 ms for mock_remote).  ``wire_opts`` configures the
    ``wire`` transport (at least ``address``; see ``SocketWorker``).
    ``shm`` raises ``NotImplementedError`` naming its ROADMAP item."""
    if transport not in TRANSPORTS:
        raise ValueError(
            f"unknown transport {transport!r}: valid transports are "
            + ", ".join(repr(t) for t in TRANSPORTS))
    if transport in NOT_PORTED:
        raise not_ported(transport)
    if transport == "inproc":
        if latency_s:
            raise ValueError("inproc transport has no latency model")
        return ServerWorker(catchup_fn, params, cache)
    if transport == "wire":
        if latency_s:
            raise ValueError(
                "wire transport has no simulated latency: RTT is measured "
                "on the real socket (drop latency_s)")
        if not wire_opts or "address" not in wire_opts:
            raise ValueError(
                "wire transport needs wire_opts={'address': ...} pointing "
                "at a running correction server (python -m "
                "repro_torch.launch.server)")
        return SocketWorker(cache, **wire_opts)
    kw = {} if latency_s is None else {"latency_s": latency_s}
    cls = {"stream": StreamWorker, "thread": ThreadWorker,
           "mock_remote": MockRemoteWorker}[transport]
    return cls(catchup_fn, params, cache, **kw)


class Dispatcher:
    """Edge-side request tracking and the staleness merge policy.

    ``collect(now_t)`` is called once per edge step and returns the replies
    to merge at this step, in FIFO (request) order:

      1. poll the worker (non-blocking) into a held buffer;
      2. while the oldest in-flight request has age >= max_staleness,
         block on it (the only place the edge loop ever waits, after u and
         the trigger decision of the step);
      3. release held replies that satisfy the merge window: age >= 1 in
         pipelined mode (max_staleness >= 1), age >= 0 at the strict
         boundary.

    Stall time (step 2) and per-request wall and compute times feed the
    ``CommsMeter``'s async accounting.
    """

    def __init__(self, worker: ServerWorker, *, max_staleness: int = 1,
                 comms=None, tracer=None):
        if max_staleness < 0:
            raise ValueError("max_staleness must be >= 0")
        self.worker = worker
        self.max_staleness = int(max_staleness)
        self.comms = comms
        self.tracer = tracer   # optional span tracer (edge.stall spans)
        self._inflight: deque = deque()   # CatchupRequest, FIFO
        self._held: deque = deque()       # arrived, not yet merge-eligible
        self._next_id = 0

    @property
    def n_inflight(self) -> int:
        return len(self._inflight) + len(self._held)

    def dispatch(self, *, t: int, triggered: np.ndarray,
                 server_pos: np.ndarray, backlog: Backlog, u,
                 u_host: np.ndarray,
                 step_t: Optional[int] = None) -> CatchupRequest:
        req = CatchupRequest(self._next_id, int(t), np.array(triggered),
                             np.array(server_pos), backlog, u, u_host,
                             wall_dispatch=time.monotonic(),
                             step_t=int(t) if step_t is None else int(step_t))
        self._next_id += 1
        self._inflight.append(req)
        if self.comms is not None:
            self.comms.record_dispatch(req.triggered)
        self.worker.dispatch(req)
        return req

    def _arrived(self, replies: List[CatchupReply]) -> None:
        for r in replies:
            req = self._inflight.popleft()
            if req.req_id != r.req_id:
                raise RuntimeError(f"worker replied to request {r.req_id} "
                                   f"before {req.req_id}: replies must be FIFO")
            r.step_t = req.step_t  # the staleness clock rides the request
            if self.comms is not None:
                self.comms.record_server_busy(
                    r.server_time_s, r.wall_ready - req.wall_dispatch)
            self._held.append(r)

    def collect(self, now_t: int) -> List[CatchupReply]:
        # ages are measured on the session step clock (step_t), not on the
        # request's trigger position t
        self._arrived(self.worker.poll())
        while (self._inflight
               and now_t - self._inflight[0].step_t >= self.max_staleness):
            t0 = time.monotonic()
            head = self._inflight[0].req_id
            replies = self.worker.wait(head)
            if self.comms is not None:
                self.comms.record_stall(time.monotonic() - t0)
            if self.tracer is not None:
                self.tracer.done("edge.stall", "edge", t0,
                                 req_id=head, step=now_t)
            self._arrived(replies)
        min_age = 1 if self.max_staleness > 0 else 0
        out: List[CatchupReply] = []
        while self._held and now_t - self._held[0].step_t >= min_age:
            r = self._held.popleft()
            if self.comms is not None:
                self.comms.record_merge(r.triggered, now_t - r.step_t)
            out.append(r)
        return out

    def drain(self) -> List[CatchupReply]:
        """Block for every outstanding reply (end of stream, or before a
        membership change).  Tail replies have no edge step left to report
        into; the engine folds them into protocol state (server_pos) only.
        Re-entrant: once drained, a further ``drain`` touches no worker
        state and returns ``[]``."""
        if self._inflight:
            t0 = time.monotonic()
            self._arrived(self.worker.wait(self._inflight[-1].req_id))
            if self.comms is not None:
                self.comms.record_stall(time.monotonic() - t0)
            if self.tracer is not None:
                self.tracer.done("edge.stall", "edge", t0, drain=True)
        out = list(self._held)
        self._held.clear()
        if self.comms is not None:
            for r in out:
                self.comms.record_merge(r.triggered, self.max_staleness)
        return out
