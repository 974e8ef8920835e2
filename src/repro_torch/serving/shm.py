"""Same-host transport (``serving/shm.py``): an mmap-backed shared-memory
arena holding one single-producer single-consumer byte-ring pair per
session (client->server and server->client), negotiated over the ordinary
Unix-domain control socket.  The arena's byte layout, the doorbells and
the handshake are the JAX package's, so a client of either package can
take an arena from a server of the other.

Where edge and server share a host, the data frames move through shared
memory and the socket carries only control traffic.

Division of labor:

* **Socket (control plane):** HELLO / HELLO_ACK negotiate the session
  AND the arena (geometry + doorbell kind in the ack tail, the fds via
  ``SCM_RIGHTS`` on the same ``sendmsg``); ATTACH / DETACH / BYE /
  GOAWAY / ERROR / REDIRECT stay here, so lease lifecycle and fleet
  semantics are byte-identical to a pure-wire session.
* **Rings (data plane):** REQUEST frames flow client->server through
  ring 0, REPLY frames server->client through ring 1, using the
  UNCHANGED length-prefixed wire codec — ``wire.RingWriter`` /
  ``wire.RingReader`` give the rings socket stream semantics, so
  ``FrameReader`` handles partial frames across the wrap point exactly
  as it handles a fragmenting kernel.
* **Doorbells:** one per side (eventfd when available, pipe fallback).
  A side rings its peer after PRODUCING into the peer's rx ring and
  after CONSUMING from the peer's tx ring (freeing space) — waiters
  always drain their doorbell first and then re-check ring state, so a
  wakeup can never be lost.  The server registers its doorbell fd with
  the reactor ``selectors`` — no busy-spinning; the client selects on
  ``[control socket, doorbell]``.

Crash safety: the server creates the arena under ``/dev/shm`` (tmpdir
fallback), maps it, ships the ARENA FD to the client, and unlinks the
path immediately — from then on the file lives only as long as some
process (or an in-flight SCM_RIGHTS message, which the kernel
reference-counts) holds it, so a SIGKILL on either side leaks nothing.

Arena layout (all offsets fixed by ``ring_bytes``)::

    [arena header: u32 magic 'SHM1' | u32 ring_bytes | pad to 64]
    [ring 0 (client->server): 128B header | ring_bytes data]
    [ring 1 (server->client): 128B header | ring_bytes data]

Fallback rules (the transport degrades, never fails): the client does
not request shm over TCP addresses; a server that does not offer shm
(older version, ``--transport wire``) yields a plain session; an attach
failure on the client answers ``SHM_OPEN(ok=False)`` so the server
tears the arena down and the session continues pure-wire.  Every
fallback logs its reason (``repro_torch.serving.shm`` logger).
"""
from __future__ import annotations

import logging
import mmap
import os
import select
import socket
import struct
import tempfile
import time
from typing import List, Optional, Sequence, Tuple

from repro_torch.serving import wire

log = logging.getLogger("repro_torch.serving.shm")

ARENA_MAGIC = 0x53484D31          # "SHM1"
ARENA_HDR = 64
_ARENA_HEAD = struct.Struct("<II")  # magic, ring_bytes
DEFAULT_RING_BYTES = 1 << 20

DB_EVENTFD = 0
DB_PIPE = 1

ARENA_PREFIX = "repro-shm-"       # lifecycle tests glob for strays


class ShmError(wire.WireError):
    """Arena/ring setup or geometry violation (never a session crash:
    callers fall back to the pure-wire path)."""


def arena_size(ring_bytes: int) -> int:
    return ARENA_HDR + 2 * (wire.RING_HDR + int(ring_bytes))


# -- doorbells ---------------------------------------------------------------

class Doorbell:
    """Edge-triggered wakeup line between the two processes: ``ring()``
    makes the owner's ``fileno()`` readable, ``drain()`` re-arms it.
    Purely a wakeup — ring state is always re-checked after a drain, so
    coalesced or spurious rings are harmless."""

    def __init__(self, kind: int, rfd: int, wfd: int):
        self.kind = kind
        self._rfd = rfd
        self._wfd = wfd
        self._closed = False

    @classmethod
    def create(cls) -> "Doorbell":
        if hasattr(os, "eventfd"):
            try:
                fd = os.eventfd(0, os.EFD_NONBLOCK | os.EFD_CLOEXEC)
                return cls(DB_EVENTFD, fd, fd)
            except OSError:   # pragma: no cover - exotic kernels
                pass
        r, w = os.pipe()
        os.set_blocking(r, False)
        os.set_blocking(w, False)
        return cls(DB_PIPE, r, w)

    @classmethod
    def from_fds(cls, kind: int, fds: Sequence[int]) -> "Doorbell":
        """Adopt fds received over SCM_RIGHTS (1 for eventfd, 2 for
        pipe).  O_NONBLOCK travels with the open file description, but
        re-assert it — a blocking doorbell would deadlock the reactor."""
        fds = list(fds)
        if kind == DB_EVENTFD:
            if len(fds) != 1:
                raise ShmError(f"eventfd doorbell wants 1 fd, got {len(fds)}")
            os.set_blocking(fds[0], False)
            return cls(kind, fds[0], fds[0])
        if kind == DB_PIPE:
            if len(fds) != 2:
                raise ShmError(f"pipe doorbell wants 2 fds, got {len(fds)}")
            for fd in fds:
                os.set_blocking(fd, False)
            return cls(kind, fds[0], fds[1])
        raise ShmError(f"unknown doorbell kind {kind}")

    @property
    def n_fds(self) -> int:
        return 1 if self.kind == DB_EVENTFD else 2

    def fds(self) -> List[int]:
        """The fds to ship over SCM_RIGHTS (read end first)."""
        return [self._rfd] if self.kind == DB_EVENTFD else [self._rfd,
                                                            self._wfd]

    def fileno(self) -> int:
        return self._rfd

    def ring(self) -> None:
        if self._closed:
            return
        try:
            if self.kind == DB_EVENTFD:
                os.eventfd_write(self._wfd, 1)
            else:
                os.write(self._wfd, b"\0")
        except (BlockingIOError, OSError):
            pass  # counter saturated / peer gone: still (or never) wakeable

    def drain(self) -> None:
        try:
            if self.kind == DB_EVENTFD:
                os.eventfd_read(self._rfd)
            else:
                while os.read(self._rfd, 4096):
                    pass
        except (BlockingIOError, OSError):
            pass

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for fd in {self._rfd, self._wfd}:
            try:
                os.close(fd)
            except OSError:
                pass


# -- the peer object (one side's live view of a session arena) ---------------

class ShmPeer:
    """One side's handle on a session arena: tx/rx rings over the shared
    mapping plus the two doorbells.  ``db_own`` is the doorbell this
    side sleeps on; ``db_peer`` is rung to wake the other side."""

    def __init__(self, mm: mmap.mmap, ring_bytes: int, *, server: bool,
                 db_own: Doorbell, db_peer: Doorbell):
        c2s_off = ARENA_HDR
        s2c_off = ARENA_HDR + wire.RING_HDR + ring_bytes
        if server:
            self.writer = wire.RingWriter(mm, s2c_off, ring_bytes)
            self.reader = wire.RingReader(mm, c2s_off, ring_bytes)
        else:
            self.writer = wire.RingWriter(mm, c2s_off, ring_bytes)
            self.reader = wire.RingReader(mm, s2c_off, ring_bytes)
        self._mm = mm
        self.ring_bytes = ring_bytes
        self.db_own = db_own
        self.db_peer = db_peer
        self._closed = False

    def fileno(self) -> int:
        """The fd to select on for peer activity (data OR freed space)."""
        return self.db_own.fileno()

    def recv_frames(self) -> List[bytes]:
        """Drain the rx ring through the incremental frame parser,
        ringing the peer when space was freed (it may be blocked on a
        full ring)."""
        before = self.reader.available()
        frames = self.reader.frames()
        if before:
            self.db_peer.ring()
        return frames

    def send_all(self, data, *, timeout: Optional[float] = None,
                 wake_fds: Sequence[int] = ()) -> int:
        """Write all of ``data`` into the tx ring, ringing the peer
        after each chunk and sleeping on this side's doorbell when the
        ring is full (the peer rings back after consuming).  Returns the
        bytes written — short only when ``timeout`` elapses or one of
        ``wake_fds`` (e.g. the control socket) becomes readable, so the
        caller can service it and resume with ``data[n:]``.  Partial
        CHUNKS are fine (stream semantics); the ring is never corrupted.
        """
        mv = memoryview(data)
        off = 0
        deadline = None if timeout is None else time.monotonic() + timeout
        while off < len(mv):
            n = self.writer.write(mv[off:])
            if n:
                off += n
                self.db_peer.ring()
                continue
            # full: drain-then-recheck so a ring between our write
            # attempt and the select can't be lost
            self.db_own.drain()
            if self.writer.free():
                continue
            wait = None
            if deadline is not None:
                wait = deadline - time.monotonic()
                if wait <= 0:
                    break
            ready, _, _ = select.select(
                [self.db_own.fileno(), *wake_fds], [], [], wait)
            if any(fd in ready for fd in wake_fds):
                break
        return off

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # wake the peer one last time so a blocked sender re-checks and
        # notices the session is gone instead of sleeping out a timeout
        self.db_peer.ring()
        for db in (self.db_own, self.db_peer):
            db.close()
        try:
            self._mm.close()
        except (BufferError, ValueError):  # pragma: no cover - exported views
            pass


# -- server side: arena creation ---------------------------------------------

def _arena_root() -> str:
    root = "/dev/shm"
    return root if os.path.isdir(root) else tempfile.gettempdir()


class ServerArena:
    """The server's end of one session arena, from creation to the
    SCM_RIGHTS handoff.  Usage::

        arena = ServerArena.create(ring_bytes)
        socket.send_fds(conn, [ack_frame], arena.fds())
        arena.sent()          # unlink + close the arena fd: crash-safe
        ... arena.peer ...    # rings + doorbells, reactor side
        arena.close()
    """

    def __init__(self, peer: ShmPeer, path: str, fd: int, ring_bytes: int,
                 db_client: Doorbell):
        self.peer = peer
        self.path = path
        self.ring_bytes = ring_bytes
        self.db_kind = peer.db_own.kind
        self._fd: Optional[int] = fd
        self._db_client = db_client

    @classmethod
    def create(cls, ring_bytes: int = DEFAULT_RING_BYTES,
               root: Optional[str] = None) -> "ServerArena":
        """A new arena under ``root`` (default ``/dev/shm``).  A default
        root too small for the arena falls back to the temporary
        directory."""
        if root is not None:
            return cls._create(ring_bytes, root)
        try:
            return cls._create(ring_bytes, _arena_root())
        except OSError as e:
            if _arena_root() == tempfile.gettempdir():
                raise
            log.info("arena under %s failed (%s); using %s", _arena_root(),
                     e, tempfile.gettempdir())
            return cls._create(ring_bytes, tempfile.gettempdir())

    @classmethod
    def _create(cls, ring_bytes: int, root: str) -> "ServerArena":
        fd, path = tempfile.mkstemp(prefix=ARENA_PREFIX, suffix=".arena",
                                    dir=root)
        db_server = db_client = None
        try:
            os.ftruncate(fd, arena_size(ring_bytes))
            # commit the pages now: a full tmpfs fails here with ENOSPC,
            # not with SIGBUS at the first write into the mapping
            os.posix_fallocate(fd, 0, arena_size(ring_bytes))
            mm = mmap.mmap(fd, arena_size(ring_bytes))
            _ARENA_HEAD.pack_into(mm, 0, ARENA_MAGIC, ring_bytes)
            db_server = Doorbell.create()
            db_client = Doorbell.create()
            if db_server.kind != db_client.kind:  # pragma: no cover
                raise ShmError("mixed doorbell kinds")
            peer = ShmPeer(mm, ring_bytes, server=True,
                           db_own=db_server, db_peer=db_client)
            return cls(peer, path, fd, ring_bytes, db_client)
        except Exception:
            for db in (db_server, db_client):
                if db is not None:
                    db.close()
            os.close(fd)
            try:
                os.unlink(path)
            except OSError:
                pass
            raise

    def fds(self) -> List[int]:
        """[arena fd, server doorbell fds..., client doorbell fds...] —
        the SCM_RIGHTS payload accompanying the HELLO_ACK."""
        assert self._fd is not None, "arena already handed off"
        return [self._fd, *self.peer.db_own.fds(), *self._db_client.fds()]

    def sent(self) -> None:
        """The fds are in flight (kernel-referenced): unlink the path and
        drop our arena fd — from here a SIGKILL on either side leaks no
        file, and the mapping dies with the last process."""
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None
        if self.path is not None:
            try:
                os.unlink(self.path)
            except OSError:
                pass
            self.path = None

    def close(self) -> None:
        self.sent()
        self.peer.close()


# -- client side: attach + handshake -----------------------------------------

def attach(fds: Sequence[int], ring_bytes: int, db_kind: int) -> ShmPeer:
    """Map the arena fd and adopt the doorbells the server shipped.
    Consumes (or closes) every fd in ``fds`` — on failure nothing leaks
    and the caller answers ``SHM_OPEN(ok=False)``."""
    fds = list(fds)
    want = 1 + 2 * (1 if db_kind == DB_EVENTFD else 2)
    try:
        if len(fds) != want:
            raise ShmError(f"expected {want} fds for doorbell kind "
                           f"{db_kind}, got {len(fds)}")
        if ring_bytes <= 0 or arena_size(ring_bytes) > (1 << 31):
            raise ShmError(f"implausible ring_bytes {ring_bytes}")
        mm = mmap.mmap(fds[0], arena_size(ring_bytes))
        magic, rb = _ARENA_HEAD.unpack_from(mm, 0)
        if magic != ARENA_MAGIC or rb != ring_bytes:
            mm.close()
            raise ShmError(f"arena header mismatch (magic=0x{magic:08x}, "
                           f"ring_bytes={rb} vs {ring_bytes})")
        os.close(fds[0])
        n = 1 if db_kind == DB_EVENTFD else 2
        db_server = Doorbell.from_fds(db_kind, fds[1:1 + n])
        db_client = Doorbell.from_fds(db_kind, fds[1 + n:1 + 2 * n])
        return ShmPeer(mm, ring_bytes, server=False,
                       db_own=db_client, db_peer=db_server)
    except Exception:
        close_fds(fds)
        raise


def close_fds(fds: Sequence[int]) -> None:
    for fd in fds:
        try:
            os.close(fd)
        except OSError:
            pass


def connect_hello_shm(address: str, hello: "wire.Hello", *,
                      timeout: Optional[float] = 20.0,
                      retry_interval: float = 0.05,
                      ) -> Tuple[socket.socket, "wire.HelloAck",
                                 "wire.FrameReader", int, int,
                                 Optional[ShmPeer], str]:
    """``wire.connect_hello`` with SCM_RIGHTS awareness: same retry /
    refusal / redirect semantics, but the ack is received with
    ``socket.recv_fds`` (a plain ``recv`` would silently drop the
    ancillary fds) and, when the server offered an arena, the mapping is
    attached and confirmed with ``SHM_OPEN`` before returning.

    Returns ``(sock, ack, reader, tx, rx, peer, reason)`` — ``peer`` is
    ``None`` when the session fell back to pure wire, with ``reason``
    saying why (also logged).  ``hello.shm`` should be True; if it is
    not, this degrades to the generic handshake with ``peer=None``.
    """
    payload = wire.encode_hello(hello)
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        remaining = (None if deadline is None
                     else max(0.05, deadline - time.monotonic()))
        try:
            sock = wire.connect(address, timeout=remaining,
                                retry_interval=retry_interval)
        except OSError as e:
            raise wire.PeerGone(f"connect to {address!r} failed: {e}") from e
        tx = len(payload)
        reader = wire.FrameReader()
        fds: List[int] = []
        try:
            sock.sendall(payload)
            rx = 0
            msg = None
            while msg is None:
                chunk, new_fds, flags, _ = socket.recv_fds(sock, 65536, 8)
                fds.extend(new_fds)
                if flags & getattr(socket, "MSG_CTRUNC", 0):
                    raise ShmError("ancillary fd payload truncated")
                if not chunk:
                    raise wire.PeerGone("server closed during handshake")
                rx += len(chunk)
                frames = reader.feed(chunk)
                if frames:
                    msg = wire.decode(frames[0])
            if isinstance(msg, wire.Error):
                close_fds(fds)
                sock.close()
                raise wire.HandshakeRefused(msg.message)
            if isinstance(msg, wire.Redirect):
                close_fds(fds)
                sock.close()
                return connect_hello_shm(msg.address, hello,
                                         timeout=remaining,
                                         retry_interval=retry_interval)
            if not isinstance(msg, wire.HelloAck):
                close_fds(fds)
                sock.close()
                raise wire.WireError(f"unexpected handshake reply: {msg}")
            peer, reason = None, ""
            if msg.ring_bytes <= 0 or not fds:
                close_fds(fds)
                reason = ("server offered no shm arena (wire-only server "
                          "or pre-v5 peer)")
            else:
                try:
                    peer = attach(fds, msg.ring_bytes, msg.db_kind)
                    confirm = wire.encode_shm_open(True)
                    sock.sendall(confirm)
                    tx += len(confirm)
                except (ShmError, OSError, ValueError) as e:
                    reason = f"arena attach failed: {e}"
                    decline = wire.encode_shm_open(False)
                    sock.sendall(decline)
                    tx += len(decline)
            if reason:
                log.info("shm fallback to pure wire for %s: %s",
                         address, reason)
            return sock, msg, reader, tx, rx, peer, reason
        except (wire.PeerGone, OSError) as e:
            close_fds(fds)
            sock.close()
            if deadline is not None and time.monotonic() > deadline:
                if isinstance(e, wire.PeerGone):
                    raise
                raise wire.PeerGone(f"handshake with {address!r} failed: "
                                    f"{e}") from e
            time.sleep(retry_interval)
        except wire.WireError:
            close_fds(fds)
            sock.close()
            raise


def stray_arenas(root: Optional[str] = None) -> List[str]:
    """Arena files still on disk (should ALWAYS be empty outside the
    handshake window — the lifecycle tests assert on this)."""
    root = root or _arena_root()
    try:
        names = os.listdir(root)
    except OSError:
        return []
    return sorted(os.path.join(root, n) for n in names
                  if n.startswith(ARENA_PREFIX))
