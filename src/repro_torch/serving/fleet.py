"""Correction-server fleet (``serving/fleet.py``): supervisor, least-loaded
routing, failover.

One ``CorrectionServer`` reactor (serving/server.py) is both a machine
ceiling and a single point of failure.  ``FleetSupervisor`` runs N of
them and fronts them with a ROUTER — a tiny endpoint speaking only the
HELLO half of the wire protocol: a client HELLOs the router, the router
answers ``REDIRECT <address>`` naming the least-loaded LIVE server, and
the client re-HELLOs there (``SocketWorker`` does this automatically for
``fleet:<router>`` addresses; one extra round trip per session, zero
per-token overhead — requests never proxy through the router).

Lifecycle (the xinference ``WorkerActor`` launch/terminate/recover
shape, adapted to processes):

  * **launch** — each server is spawned via
    ``launch.server.spawn_subprocess`` (a fresh interpreter, ``python -m
    repro_torch.launch.server``, never a fork: a forked CUDA context is
    unusable) or run on a thread in this process, with a
    ``JsonFileTracker`` heartbeat: an
    atomically-rewritten JSON stats file (serving/tracker.py) carrying
    ``leased_rows`` (the routing load signal), ``sessions_live``,
    ``draining``, counters and latency histograms.
  * **health** — a server is LIVE while its process is running and its
    heartbeat is fresher than ``heartbeat_timeout_s``.  A dead process
    or a stale heartbeat marks it dead; ``respawn=True`` launches a
    replacement (recover_sub_pool).
  * **drain** — ``drain(name)`` sends SIGUSR1: the server GOAWAYs its
    sessions, refuses new HELLOs, and exits once empty.  Clients finish
    in-flight work, then migrate through the router.  Zero streams drop.
  * **failover is a replay, not a state transfer** — the wire protocol
    makes each client the source of truth for its own token history, so
    the supervisor never copies caches between servers: the client
    re-HELLOs and replays (see ``SocketWorker`` in async_rpc.py for the
    bitwise argument).

The supervisor is single-threaded and non-blocking: ``tick()`` services
router I/O, scrapes heartbeats, reaps/respawns — call it from your own
loop or use ``run_forever``.  The servers run on ``device`` (``None``:
the card; ``"cpu"`` on the host).  A SIGKILLed server that holds a CUDA
context takes a while to exit: process liveness, not the heartbeat,
marks it dead, so ``heartbeat_timeout_s`` must outlast the longest replay
(the reactor beats between replays), not the teardown.
"""
from __future__ import annotations

import os
import selectors
import signal
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.serving import wire
from repro_torch.serving.tracker import Tracker, read_stats

# redirects handed out against a heartbeat that predates them still count
# as load for this long (the optimistic-pending window — prevents a
# thundering herd onto one server between two heartbeats)
PENDING_TTL_S = 2.0


def resolve_route(router_address: str, hello: wire.Hello, *,
                  timeout: float = 10.0) -> str:
    """Ask a fleet router where a session shaped like ``hello`` should
    go; returns the server address from the REDIRECT.  Raises
    ``HandshakeRefused`` when the router answers ERROR (no live server
    fits) and ``PeerGone`` when the router itself is unreachable."""
    deadline = time.monotonic() + timeout
    try:
        sock = wire.connect(router_address, timeout=timeout)
    except OSError as e:
        raise wire.PeerGone(f"router {router_address!r}: {e}") from e
    reader = wire.FrameReader()
    try:
        sock.settimeout(max(0.1, deadline - time.monotonic()))
        sock.sendall(wire.encode_hello(hello))
        while True:
            data = sock.recv(1 << 16)
            if not data:
                raise wire.PeerGone("router closed during resolve")
            for p in reader.feed(data):
                msg = wire.decode(p)
                if isinstance(msg, wire.Redirect):
                    return msg.address
                if isinstance(msg, wire.Error):
                    raise wire.HandshakeRefused(msg.message)
                raise wire.WireError(f"unexpected router reply: {msg}")
    finally:
        sock.close()


class ServerHandle:
    """One managed correction server: identity, health, load, control."""

    def __init__(self, name: str):
        self.name = name
        self.address: Optional[str] = None
        self.state = "starting"   # starting | live | draining | dead | stopped
        self.reaped = False       # supervisor already acted on death/retire
        self.stats: Dict[str, Any] = {}
        self.last_seen = 0.0      # wall-clock ts of the freshest heartbeat
        # (issue_ts, rows) of redirects not yet visible in a heartbeat
        self.pending: List[Tuple[float, int]] = []

    # -- backend contract ----------------------------------------------------
    def alive(self) -> bool:
        raise NotImplementedError

    def scrape(self) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def drain(self) -> None:
        raise NotImplementedError

    def kill(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    # -- shared logic --------------------------------------------------------
    def refresh(self, heartbeat_timeout_s: float) -> None:
        """Scrape + update state.  ``starting -> live`` on first
        heartbeat; ``live/draining -> dead`` on process death or a stale
        heartbeat; a draining server that exits cleanly is ``stopped``."""
        rec = self.scrape()
        now = time.time()
        if rec is not None:
            self.stats = rec
            self.last_seen = float(rec.get("ts", now))
            if self.address is None:
                self.address = rec.get("address")
            if bool(rec.get("draining")) and self.state == "live":
                self.state = "draining"
            elif self.state == "starting":
                self.state = "live"
            self.pending = [(ts, n) for ts, n in self.pending
                            if ts > self.last_seen]
        if self.state in ("dead", "stopped"):
            return
        if not self.alive():
            # a draining server exiting on its own is a clean retire
            self.state = "stopped" if self.state == "draining" else "dead"
            return
        if (self.state in ("live", "draining")
                and now - self.last_seen > heartbeat_timeout_s):
            self.state = "dead"

    def load(self) -> int:
        """Leased rows per the last heartbeat plus redirects issued since
        (optimistically counted for PENDING_TTL_S)."""
        now = time.time()
        self.pending = [(ts, n) for ts, n in self.pending
                        if now - ts < PENDING_TTL_S]
        return int(self.stats.get("leased_rows", 0)) \
            + sum(n for _, n in self.pending)

    def free_rows(self) -> int:
        slots = int(self.stats.get("slots", 0))
        return max(0, slots - self.load())


class SubprocessServer(ServerHandle):
    """A ``launch.server`` subprocess on a UDS, heartbeating via a
    ``JsonFileTracker`` stats file the supervisor scrapes."""

    def __init__(self, name: str, *, arch: str, slots: int, max_len: int,
                 root: str, ckpt_dir: Optional[str] = None,
                 stats_interval_s: float = 0.25,
                 extra_args: Tuple[str, ...] = (), device=None):
        super().__init__(name)
        from repro_torch.launch.server import spawn_subprocess
        self.uds = os.path.join(root, f"{name}.sock")
        self.ready_file = os.path.join(root, f"{name}.ready")
        self.stats_file = os.path.join(root, f"{name}.stats.json")
        self.address = self.uds
        self.proc = spawn_subprocess(
            arch, uds=self.uds, slots=slots, max_len=max_len,
            ready_file=self.ready_file, ckpt_dir=ckpt_dir, wait=False,
            extra_args=("--stats-file", self.stats_file,
                        "--stats-interval-s", str(stats_interval_s))
            + (() if device is None else ("--device", str(device)))
            + tuple(extra_args))

    def wait_ready(self, timeout_s: float) -> None:
        from repro_torch.launch.server import wait_ready
        wait_ready(self.proc, self.ready_file, timeout_s)

    def alive(self) -> bool:
        return self.proc.poll() is None

    def scrape(self) -> Optional[Dict[str, Any]]:
        return read_stats(self.stats_file)

    def drain(self) -> None:
        if self.alive():
            self.proc.send_signal(signal.SIGUSR1)
        if self.state == "live":
            self.state = "draining"

    def kill(self) -> None:
        """SIGKILL — the fault-injection primitive: no GOAWAY, no BYE,
        no flush; clients see a raw EOF/reset mid-whatever."""
        try:
            self.proc.kill()
        except OSError:
            pass
        self.state = "dead"

    def close(self) -> None:
        if self.alive():
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except Exception:
                self.proc.kill()
                self.proc.wait()
        for f in (self.uds, self.ready_file, self.stats_file):
            try:
                os.unlink(f)
            except OSError:
                pass


class ThreadServer(ServerHandle):
    """An in-process ``CorrectionServer`` on a daemon thread: the fast
    backend for the chaos tests (a "kill" severs every socket without
    ceremony, which is what a SIGKILL looks like from the client's side of
    the wire).  On the card the reactor replays on a CUDA stream of its
    own, so it never serialises with the client's launches on the default
    stream."""

    def __init__(self, name: str, *, cfg, params, slots: int, max_len: int,
                 root: str, coalesce: bool = True, shm: bool = False,
                 device=None):
        super().__init__(name)
        import torch

        from repro_torch.serving.server import CorrectionServer
        self.uds = os.path.join(root, f"{name}.sock")
        self.srv = CorrectionServer(cfg, params, slots=slots,
                                    max_len=max_len, uds=self.uds,
                                    coalesce=coalesce, shm=shm,
                                    device=device)
        self.address = self.srv.address
        dev = self.srv.device
        self.stream = (torch.cuda.Stream(dev) if dev.type == "cuda"
                       else None)
        if self.stream is not None:
            # the server's cache was made on this thread's stream
            self.stream.wait_stream(torch.cuda.current_stream(dev))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._serve, daemon=True, name=f"fleet-{name}")
        self._thread.start()

    def _serve(self) -> None:
        import contextlib

        import torch
        on_stream = (torch.cuda.stream(self.stream)
                     if self.stream is not None else contextlib.nullcontext())
        with on_stream:
            self.srv.serve_forever(stop=self._stop)

    def wait_ready(self, timeout_s: float) -> None:
        pass  # the listener was bound synchronously in __init__

    def alive(self) -> bool:
        return self._thread.is_alive()

    def scrape(self) -> Optional[Dict[str, Any]]:
        try:
            return self.srv.stats_snapshot()
        except Exception:
            return None  # racing a concurrent close: treat as no beat

    def drain(self) -> None:
        self.srv.request_drain()
        if self.state == "live":
            self.state = "draining"

    def kill(self) -> None:
        """Crash emulation: unlink the listener path (new connects fail
        fast), sever every client socket without BYE/GOAWAY, stop the
        reactor.  From the wire, indistinguishable from SIGKILL."""
        try:
            os.unlink(self.uds)
        except OSError:
            pass
        self._stop.set()
        for conn in list(self.srv._sessions):
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self.state = "dead"

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
        self.srv.close()


class FleetSupervisor:
    """Spawn/monitor N correction servers; route HELLOs; reap the dead.

    backend          — ``"subprocess"`` (production shape: one
                       ``launch.server`` process per server, heartbeat
                       via stats files) or ``"thread"`` (in-process, for
                       tests; needs ``cfg`` + ``params``).
    router_uds/port  — where the routing endpoint listens (UDS default:
                       ``<root>/router.sock``).
    heartbeat_timeout_s — a live server whose heartbeat is staler than
                       this is declared dead (covers hung processes; a
                       SIGKILL is caught faster via process liveness).
    respawn          — replace dead servers with fresh ones (xinference's
                       ``recover_sub_pool``); drained servers are
                       retired, never replaced.
    address_wrapper  — optional hook mapping a server address before it
                       is advertised in a REDIRECT (the chaos harness
                       interposes its proxy here).
    device           — the servers' torch device (``None``: the card;
                       passed to each subprocess as ``--device``).
    server_args      — more ``launch.server`` flags for every subprocess
                       server (e.g. ``("--full",)``).
    """

    def __init__(self, arch: Optional[str] = None, *, n_servers: int = 2,
                 slots: int = 16, max_len: int = 128,
                 backend: str = "subprocess", root: Optional[str] = None,
                 router_uds: Optional[str] = None,
                 router_host: str = "127.0.0.1",
                 router_port: Optional[int] = None,
                 heartbeat_timeout_s: float = 5.0, respawn: bool = True,
                 tracker: Optional[Tracker] = None,
                 cfg=None, params=None, ckpt_dir: Optional[str] = None,
                 coalesce: bool = True, shm: bool = False,
                 stats_interval_s: float = 0.25,
                 spawn_timeout_s: Optional[float] = None,
                 address_wrapper: Optional[Callable[[str], str]] = None,
                 device=None, server_args: Tuple[str, ...] = ()):
        if backend not in ("subprocess", "thread"):
            raise ValueError(f"unknown fleet backend {backend!r}")
        if backend == "subprocess" and arch is None:
            raise ValueError("subprocess backend needs arch=")
        if backend == "thread" and (cfg is None or params is None):
            raise ValueError("thread backend needs cfg= and params=")
        self.arch, self.cfg, self.params = arch, cfg, params
        self.backend = backend
        self.n_servers, self.slots, self.max_len = n_servers, slots, max_len
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.respawn = respawn
        self.tracker = tracker
        self.ckpt_dir, self.coalesce = ckpt_dir, coalesce
        self.shm = shm   # servers offer same-host shm arenas on HELLO
        self.stats_interval_s = stats_interval_s
        if spawn_timeout_s is None:
            spawn_timeout_s = float(
                os.environ.get("REPRO_SPAWN_DEADLINE_S", "240"))
        self.spawn_timeout_s = spawn_timeout_s
        self.address_wrapper = address_wrapper
        self.device = device
        self.server_args = tuple(server_args)
        if root is None:
            import tempfile
            root = tempfile.mkdtemp(prefix="fleet-")
        os.makedirs(root, exist_ok=True)
        self.root = root
        self.servers: Dict[str, ServerHandle] = {}
        self._seq = 0
        self.stats = {"routed": 0, "refused": 0, "respawns": 0,
                      "reaped": 0, "retired": 0}

        # -- router listener --------------------------------------------------
        if router_port is not None:
            self._listener = socket.socket(socket.AF_INET,
                                           socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET,
                                      socket.SO_REUSEADDR, 1)
            self._listener.bind((router_host, router_port))
            h, p = self._listener.getsockname()
            self.router_address = f"{h}:{p}"
            self.router_uds = None
        else:
            self.router_uds = router_uds or os.path.join(root, "router.sock")
            self._listener = socket.socket(socket.AF_UNIX,
                                           socket.SOCK_STREAM)
            self._listener.bind(self.router_uds)
            self.router_address = self.router_uds
        self._listener.listen(64)
        self._listener.setblocking(False)
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._listener, selectors.EVENT_READ, "accept")
        self._conns: Dict[socket.socket, wire.FrameReader] = {}
        self._closed = False

    # -- launch --------------------------------------------------------------
    def _spawn(self) -> ServerHandle:
        name = f"srv-{self._seq}"
        self._seq += 1
        if self.backend == "subprocess":
            extra = () if self.coalesce else ("--no-coalesce",)
            if self.shm:
                extra += ("--transport", "shm")
            extra += self.server_args
            h: ServerHandle = SubprocessServer(
                name, arch=self.arch, slots=self.slots,
                max_len=self.max_len, root=self.root,
                ckpt_dir=self.ckpt_dir,
                stats_interval_s=self.stats_interval_s,
                extra_args=extra, device=self.device)
        else:
            h = ThreadServer(name, cfg=self.cfg, params=self.params,
                             slots=self.slots, max_len=self.max_len,
                             root=self.root, coalesce=self.coalesce,
                             shm=self.shm, device=self.device)
        self.servers[name] = h
        return h

    def start(self, wait: bool = True) -> "FleetSupervisor":
        """Launch all N servers (spawned first, then ready-waited, so their
        start-ups overlap)."""
        fresh = [self._spawn() for _ in range(self.n_servers)]
        if wait:
            for h in fresh:
                h.wait_ready(self.spawn_timeout_s)
        return self

    # -- routing -------------------------------------------------------------
    def live_servers(self) -> List[ServerHandle]:
        return [h for h in self.servers.values() if h.state == "live"]

    def pick(self, batch: int) -> Optional[ServerHandle]:
        """Least-loaded LIVE server with room for ``batch`` rows."""
        fits = [h for h in self.live_servers() if h.free_rows() >= batch]
        if not fits:
            return None
        return min(fits, key=lambda h: (h.load(), h.name))

    def _route(self, conn: socket.socket, hello: wire.Hello) -> None:
        h = self.pick(hello.batch)
        if h is None or h.address is None:
            self.stats["refused"] += 1
            free = {x.name: x.free_rows() for x in self.live_servers()}
            conn.sendall(wire.encode_error(
                f"no live server with {hello.batch} free rows "
                f"(live free: {free})"))
            return
        h.pending.append((time.time(), hello.batch))
        self.stats["routed"] += 1
        addr = h.address
        if self.address_wrapper is not None:
            addr = self.address_wrapper(addr)
        conn.sendall(wire.encode_redirect(addr))

    def _router_io(self, timeout: float) -> None:
        for key, _ in self._sel.select(timeout):
            if key.data == "accept":
                while True:
                    try:
                        conn, _a = self._listener.accept()
                    except (BlockingIOError, InterruptedError, OSError):
                        break
                    conn.setblocking(False)
                    self._conns[conn] = wire.FrameReader()
                    self._sel.register(conn, selectors.EVENT_READ, "conn")
                continue
            conn = key.fileobj
            reader = self._conns.get(conn)
            if reader is None:
                continue
            try:
                data = conn.recv(1 << 16)
            except (BlockingIOError, InterruptedError):
                continue
            except OSError:
                data = b""
            done = not data
            if data:
                try:
                    for p in reader.feed(data):
                        msg = wire.decode(p)
                        if isinstance(msg, wire.Hello):
                            self._route(conn, msg)
                        else:
                            conn.sendall(wire.encode_error(
                                "router speaks HELLO only"))
                        done = True
                        break
                except (wire.WireError, OSError):
                    done = True
            if done:
                self._drop_conn(conn)

    def _drop_conn(self, conn: socket.socket) -> None:
        try:
            self._sel.unregister(conn)
        except (KeyError, ValueError):
            pass
        self._conns.pop(conn, None)
        try:
            conn.close()
        except OSError:
            pass

    # -- health / lifecycle --------------------------------------------------
    def _reap(self) -> None:
        # the flag, not a state TRANSITION, gates the reaction: kill()
        # sets state="dead" directly, so a transition-based check would
        # never respawn an explicitly killed server
        for name, h in list(self.servers.items()):
            h.refresh(self.heartbeat_timeout_s)
            if h.state == "dead" and not h.reaped:
                h.reaped = True
                h.kill()  # ensure a stale-heartbeat zombie really dies
                self.stats["reaped"] += 1
                if self.respawn:
                    self.stats["respawns"] += 1
                    self._spawn()  # ready-waits lazily via heartbeat
            elif h.state == "stopped" and not h.reaped:
                h.reaped = True
                self.stats["retired"] += 1

    def tick(self, timeout: float = 0.05) -> None:
        """One supervisor beat: router I/O, heartbeat scrape, reaping."""
        self._router_io(timeout)
        self._reap()
        if self.tracker is not None:
            self.tracker.log(self.aggregate())

    def run_forever(self, stop: Optional[threading.Event] = None,
                    poll_s: float = 0.05) -> None:
        while stop is None or not stop.is_set():
            self.tick(poll_s)

    # -- control -------------------------------------------------------------
    def drain(self, name: str) -> None:
        self.servers[name].drain()

    def kill(self, name: str) -> None:
        self.servers[name].kill()

    def aggregate(self) -> Dict[str, Any]:
        """The fleet-wide scrape: per-server heartbeats + totals."""
        per = {n: dict(h.stats, state=h.state, address=h.address)
               for n, h in self.servers.items()}
        totals: Dict[str, float] = dict(self.stats)
        for h in self.servers.values():
            for k in ("requests", "replays", "coalesced", "sessions",
                      "bytes_rx", "bytes_tx", "leased_rows"):
                if k in h.stats and h.state in ("live", "draining"):
                    totals[k] = totals.get(k, 0) + h.stats[k]
        # latency percentiles aggregate as max over live servers (the
        # fleet-wide worst case — summing percentiles is meaningless);
        # None while no server has observed that histogram yet
        for k in ("replay_s_p50", "replay_s_p99",
                  "queue_wait_s_p50", "queue_wait_s_p99",
                  "turnaround_s_p99"):
            vals = [h.stats[k] for h in self.servers.values()
                    if h.state in ("live", "draining")
                    and h.stats.get(k) is not None]
            totals[k] = max(vals) if vals else None
        totals["n_live"] = len(self.live_servers())
        return {"ts": time.time(), "servers": per, "totals": totals}

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for conn in list(self._conns):
            self._drop_conn(conn)
        try:
            self._sel.unregister(self._listener)
        except (KeyError, ValueError):
            pass
        self._listener.close()
        self._sel.close()
        if self.router_uds is not None:
            try:
                os.unlink(self.router_uds)
            except OSError:
                pass
        for h in self.servers.values():
            h.close()
        if self.tracker is not None:
            self.tracker.log_summary(self.aggregate())
            self.tracker.finish()

    def __enter__(self) -> "FleetSupervisor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
