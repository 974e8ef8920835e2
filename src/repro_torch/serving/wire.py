"""Wire codec of the collaborative protocol (``serving/wire.py``): the
versioned binary frames that the standalone correction server
(``serving/server.py``) and the ``wire`` transport
(``async_rpc.SocketWorker``) exchange.

The layout is the JAX package's, byte for byte: the same message encodes
to the same bytes in both packages, and each decodes the other's frames
(v3, v4 and v5), so a client of one package serves against a server of
the other.  The module needs only struct, numpy and socket.

* **No pickle.**  Frames are ``struct``-packed little-endian bytes with
  explicitly coded numpy arrays (dtype code + shape + raw C-order
  buffer).  A hostile or buggy peer can produce a ``WireError``, never
  code execution.
* **Length-prefixed frames.**  Every message travels as
  ``[u32 length][payload]``, so a stream socket re-frames incrementally
  (``FrameReader``).
* **Backlogs, not histories.**  A REQUEST carries only each triggered
  stream's backlog tokens ``server_pos[i]..t``, concatenated in stream
  order, so the bytes on the wire are the measured counterpart of the
  ``CommsMeter``'s token-level model.
* **Byte accounting.**  Every encode returns a complete frame whose
  length is the exact number of bytes handed to the kernel; the transport
  feeds those counts into ``CommsMeter.record_wire_tx/rx``.

Frame payload layout (all little-endian)::

    u16 magic (0xC0AB)  | u8 version | u8 msg_type | body

Arrays are encoded as ``u8 dtype_code | u8 ndim | u32 dims... | raw``.

Version history: v2 added ATTACH/DETACH (slot-pool churn: the server
zeroes and re-leases one super-batch row); v3 REDIRECT (a router answers
a HELLO with the address of a server) and GOAWAY (a draining server asks
its sessions to move); v4 an optional server-timing payload on REPLY
(``queue_s``, request arrival -> replay start, a duration, so no clock
sync is needed); v5 the same-host shared-memory negotiation (an optional
``u8 shm`` byte on HELLO, an optional arena offer on HELLO_ACK, and
SHM_OPEN).  The port's server and client speak every version, shm
included (``serving/shm.py``, whose rings carry these frames).

Compatibility: the decoder accepts any version in ``[MIN_VERSION,
VERSION]``: a v3 REPLY has no timing payload (``queue_s`` reads -1,
absent), a v3/v4 HELLO requests no shm, and every other body is
unchanged since v3.  Other versions are rejected with an error naming
the version and the window.
"""
from __future__ import annotations

import math
import socket
import struct
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np

MAGIC = 0xC0AB
VERSION = 5      # v5: shm negotiation (HELLO/HELLO_ACK tails, SHM_OPEN)
MIN_VERSION = 3  # oldest peer version still decoded (frame-compatible)

MSG_HELLO = 1
MSG_HELLO_ACK = 2
MSG_REQUEST = 3
MSG_REPLY = 4
MSG_BYE = 5
MSG_ERROR = 6
MSG_ATTACH = 7
MSG_DETACH = 8
MSG_REDIRECT = 9
MSG_GOAWAY = 10
MSG_SHM_OPEN = 11

_HEADER = struct.Struct("<HBB")       # magic, version, msg_type
_LEN = struct.Struct("<I")            # frame length prefix
MAX_FRAME_BYTES = 64 * 1024 * 1024    # hard cap against garbage prefixes

# dtype registry: stable small codes, no pickle/np dtype-string parsing
_DTYPES: Tuple[np.dtype, ...] = tuple(np.dtype(d) for d in (
    np.bool_, np.int8, np.uint8, np.int16, np.int32, np.int64,
    np.float16, np.float32, np.float64))
_DTYPE_CODE = {d: i for i, d in enumerate(_DTYPES)}


class WireError(Exception):
    """Malformed frame / protocol violation / server-reported error."""


class HandshakeRefused(WireError):
    """The peer ANSWERED the handshake with an ERROR frame: a deliberate
    refusal (server full, draining, version mismatch).  Retrying the same
    address is pointless; a fleet client would try a sibling instead.
    ``message`` carries the server's reason verbatim."""

    def __init__(self, message: str):
        super().__init__(f"server: {message}")
        self.message = message


class PeerGone(WireError):
    """The connection died MID-handshake (EOF / reset before any ACK or
    ERROR arrived): the server crashed or was killed.  Distinct from
    ``HandshakeRefused`` so the router/supervisor can mark the server
    unhealthy rather than merely loaded."""


# -- primitives --------------------------------------------------------------

def _pack_array(a: np.ndarray) -> bytes:
    a = np.ascontiguousarray(a)
    if a.dtype not in _DTYPE_CODE:
        raise WireError(f"unsupported wire dtype {a.dtype}")
    head = struct.pack("<BB", _DTYPE_CODE[a.dtype], a.ndim)
    dims = struct.pack(f"<{a.ndim}I", *a.shape) if a.ndim else b""
    return head + dims + a.tobytes()


def _unpack_array(buf: bytes, off: int) -> Tuple[np.ndarray, int]:
    try:
        code, ndim = struct.unpack_from("<BB", buf, off)
        off += 2
        shape = struct.unpack_from(f"<{ndim}I", buf, off) if ndim else ()
        off += 4 * ndim
        dtype = _DTYPES[code]
        n = math.prod(shape)  # python ints: no fixed-width overflow
        nbytes = n * dtype.itemsize
        if nbytes > MAX_FRAME_BYTES or off + nbytes > len(buf):
            raise WireError("array extends past frame end")
        a = np.frombuffer(buf, dtype=dtype, count=n, offset=off).reshape(shape)
        off += nbytes
        return a.copy(), off  # copy: detach from the recv buffer
    except (struct.error, IndexError, ValueError) as e:
        raise WireError(f"malformed array: {e}") from e


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<H", len(b)) + b


def _unpack_str(buf: bytes, off: int) -> Tuple[str, int]:
    try:
        (n,) = struct.unpack_from("<H", buf, off)
        off += 2
        return buf[off:off + n].decode("utf-8"), off + n
    except (struct.error, UnicodeDecodeError) as e:
        raise WireError(f"malformed string: {e}") from e


def frame(payload: bytes) -> bytes:
    """Length-prefix a payload: the exact bytes that hit the socket."""
    return _LEN.pack(len(payload)) + payload


def _header(msg_type: int) -> bytes:
    return _HEADER.pack(MAGIC, VERSION, msg_type)


# -- messages ----------------------------------------------------------------

@dataclass
class Hello:
    """Session open: the client declares its stream-batch geometry.

    ``coalesce=False`` opts this session out of the server's request
    coalescing (each request gets its own masked replay) — the bench's
    per-request baseline arm.

    ``shm=True`` (v5) asks the server for a same-host shared-memory ring
    pair; a pre-v5 (or wire-only) server ignores the trailing byte and
    the session stays pure-wire.
    """

    batch: int
    max_len: int
    tok_tail: Tuple[int, ...] = ()   # (K,) for audio codebooks, else ()
    coalesce: bool = True
    client: str = "edge"
    shm: bool = False


@dataclass
class HelloAck:
    session_id: int
    slot_lo: int        # first super-batch row assigned to this session
    server_max_len: int
    version: int = VERSION
    # v5 shm offer (present iff ring_bytes > 0): the arena/doorbell fds
    # ride the SAME sendmsg as this frame via SCM_RIGHTS; ``shm_path``
    # is informational (the server unlinks it right after sending — the
    # client maps the received fd, so a SIGKILL leaks no file).
    shm_path: str = ""
    ring_bytes: int = 0
    db_kind: int = 0    # 0 = eventfd (1 fd/doorbell), 1 = pipe (2 fds)


@dataclass
class WireRequest:
    """The on-the-wire form of a ``CatchupRequest``: per-stream protocol
    vectors plus ONLY the backlog tokens (concatenated over triggered
    streams, in stream order) — not the full history snapshot."""

    req_id: int
    t: int
    triggered: np.ndarray    # (B,) bool
    server_pos: np.ndarray   # (B,) int32
    u: np.ndarray            # (B,) float32 — dispatch-time monitor scores
    tokens: np.ndarray       # (n_tok, *tok_tail) int32 — concatenated backlogs

    def backlog_lengths(self) -> np.ndarray:
        """(B,) tokens each stream contributes to ``tokens``."""
        return np.where(self.triggered,
                        self.t + 1 - self.server_pos, 0).astype(np.int64)


@dataclass
class WireReply:
    req_id: int
    t: int
    triggered: np.ndarray    # (B,) bool — echo of the request's mask
    v: np.ndarray            # (B,) float32, valid where triggered
    fhat: np.ndarray         # (B,) float32 fused from the request's u
    server_time_s: float     # replay compute time on the server
    coalesced: int = 1       # requests merged into the replay that served this
    # v4 server-timing payload: request arrival -> replay start on the
    # server (a DURATION — no clock sync needed).  < 0 means "absent"
    # (a v3 peer's reply); the client then reports RTT only, with no
    # serialize/socket/queue/compute breakdown for that request.
    queue_s: float = -1.0


@dataclass
class Bye:
    pass


@dataclass
class Attach:
    """Slot-pool churn: a new stream moved into row ``slot`` of this
    session's lease — zero and re-lease that single super-batch row
    (cache + history mirror), leaving co-resident rows bit-untouched."""

    slot: int


@dataclass
class Detach:
    """Slot-pool churn: the stream in row ``slot`` departed."""

    slot: int


@dataclass
class Redirect:
    """Fleet routing: the peer is a router, not a server — re-HELLO at
    ``address`` (the least-loaded live correction server)."""

    address: str


@dataclass
class GoAway:
    """Fleet drain: the server will take no new work; finish in-flight
    requests, then re-HELLO elsewhere and replay."""

    reason: str = "draining"


@dataclass
class ShmOpen:
    """Client verdict on the server's shm offer: ``ok=True`` moves data
    frames (REQUEST/REPLY) to the rings; ``ok=False`` (mmap failed,
    geometry mismatch) tears the arena down and the session continues
    pure-wire.  Control frames stay on the socket either way."""

    ok: bool


@dataclass
class Error:
    message: str


Message = Union[Hello, HelloAck, WireRequest, WireReply, Bye, Attach,
                Detach, Redirect, GoAway, ShmOpen, Error]


# -- encode ------------------------------------------------------------------

def encode_hello(h: Hello) -> bytes:
    body = struct.pack("<IIBB", h.batch, h.max_len, len(h.tok_tail),
                       1 if h.coalesce else 0)
    body += struct.pack(f"<{len(h.tok_tail)}I", *h.tok_tail)
    body += _pack_str(h.client)
    if h.shm:
        # v5 shm request: appended after the client string so a decoder
        # detects it by presence (a v3/v4-shaped frame ends earlier)
        body += struct.pack("<B", 1)
    return frame(_header(MSG_HELLO) + body)


def encode_hello_ack(a: HelloAck) -> bytes:
    body = struct.pack("<IIIB", a.session_id, a.slot_lo, a.server_max_len,
                       a.version)
    if a.ring_bytes > 0:
        # v5 shm offer: presence-detected tail (the fds travel in the
        # same sendmsg as SCM_RIGHTS ancillary data)
        body += (_pack_str(a.shm_path)
                 + struct.pack("<IB", a.ring_bytes, a.db_kind))
    return frame(_header(MSG_HELLO_ACK) + body)


def encode_shm_open(ok: bool) -> bytes:
    return frame(_header(MSG_SHM_OPEN) + struct.pack("<B", 1 if ok else 0))


def encode_request(req_id: int, t: int, triggered: np.ndarray,
                   server_pos: np.ndarray, u: np.ndarray,
                   history: np.ndarray) -> bytes:
    """Slice the triggered backlogs out of the (host) history snapshot and
    frame them.  ``history``: (B, max_len, *tok_tail) int32."""
    triggered = np.asarray(triggered, bool)
    server_pos = np.asarray(server_pos, np.int32)
    rows = np.flatnonzero(triggered)
    if len(rows):
        backlog = np.concatenate(
            [history[i, server_pos[i]:t + 1] for i in rows], axis=0)
    else:
        backlog = np.zeros((0,) + history.shape[2:], history.dtype)
    body = (struct.pack("<QI", req_id, t)
            + _pack_array(triggered)
            + _pack_array(server_pos)
            + _pack_array(np.asarray(u, np.float32))
            + _pack_array(np.asarray(backlog, np.int32)))
    return frame(_header(MSG_REQUEST) + body)


def encode_request_arrays(r: WireRequest) -> bytes:
    """Frame a WireRequest whose backlog tokens are already concatenated
    (codec round-trip tests; server-side re-encode)."""
    body = (struct.pack("<QI", r.req_id, r.t)
            + _pack_array(np.asarray(r.triggered, bool))
            + _pack_array(np.asarray(r.server_pos, np.int32))
            + _pack_array(np.asarray(r.u, np.float32))
            + _pack_array(np.asarray(r.tokens, np.int32)))
    return frame(_header(MSG_REQUEST) + body)


def encode_reply(r: WireReply) -> bytes:
    body = (struct.pack("<QIdI", r.req_id, r.t, r.server_time_s, r.coalesced)
            + _pack_array(np.asarray(r.triggered, bool))
            + _pack_array(np.asarray(r.v, np.float32))
            + _pack_array(np.asarray(r.fhat, np.float32)))
    if r.queue_s >= 0:
        # v4 timing payload: appended after the arrays so a decoder
        # detects it by presence (a v3-shaped frame simply ends earlier)
        body += struct.pack("<d", r.queue_s)
    return frame(_header(MSG_REPLY) + body)


def encode_bye() -> bytes:
    return frame(_header(MSG_BYE))


def encode_attach(slot: int) -> bytes:
    return frame(_header(MSG_ATTACH) + struct.pack("<I", slot))


def encode_detach(slot: int) -> bytes:
    return frame(_header(MSG_DETACH) + struct.pack("<I", slot))


def encode_redirect(address: str) -> bytes:
    return frame(_header(MSG_REDIRECT) + _pack_str(address))


def encode_goaway(reason: str = "draining") -> bytes:
    return frame(_header(MSG_GOAWAY) + _pack_str(reason))


def encode_error(message: str) -> bytes:
    return frame(_header(MSG_ERROR) + _pack_str(message))


# -- decode ------------------------------------------------------------------

def decode(payload: bytes) -> Message:
    """One frame payload (length prefix already stripped) -> message."""
    if len(payload) < _HEADER.size:
        raise WireError(f"short frame ({len(payload)} bytes)")
    magic, version, msg_type = _HEADER.unpack_from(payload, 0)
    if magic != MAGIC:
        raise WireError(f"bad magic 0x{magic:04x}")
    if not (MIN_VERSION <= version <= VERSION):
        raise WireError(f"wire version {version} outside supported "
                        f"[{MIN_VERSION}, {VERSION}]")
    off = _HEADER.size
    try:
        if msg_type == MSG_HELLO:
            batch, max_len, n_tail, coal = struct.unpack_from(
                "<IIBB", payload, off)
            off += struct.calcsize("<IIBB")
            tail = struct.unpack_from(f"<{n_tail}I", payload, off)
            off += 4 * n_tail
            client, off = _unpack_str(payload, off)
            # v5 shm-request byte, detected by presence (older frames end
            # at the client string)
            shm = off < len(payload) and payload[off] != 0
            return Hello(batch, max_len, tuple(tail), bool(coal), client,
                         shm)
        if msg_type == MSG_HELLO_ACK:
            sid, lo, sml, ver = struct.unpack_from("<IIIB", payload, off)
            off += struct.calcsize("<IIIB")
            shm_path, ring_bytes, db_kind = "", 0, 0
            if off < len(payload):  # v5 shm offer, presence-detected
                shm_path, off = _unpack_str(payload, off)
                ring_bytes, db_kind = struct.unpack_from("<IB", payload, off)
            return HelloAck(sid, lo, sml, ver, shm_path, ring_bytes, db_kind)
        if msg_type == MSG_REQUEST:
            req_id, t = struct.unpack_from("<QI", payload, off)
            off += struct.calcsize("<QI")
            triggered, off = _unpack_array(payload, off)
            server_pos, off = _unpack_array(payload, off)
            u, off = _unpack_array(payload, off)
            tokens, off = _unpack_array(payload, off)
            return WireRequest(req_id, t, triggered.astype(bool),
                               server_pos.astype(np.int32),
                               u.astype(np.float32),
                               tokens.astype(np.int32))
        if msg_type == MSG_REPLY:
            req_id, t, srv_s, coal = struct.unpack_from("<QIdI", payload, off)
            off += struct.calcsize("<QIdI")
            triggered, off = _unpack_array(payload, off)
            v, off = _unpack_array(payload, off)
            fhat, off = _unpack_array(payload, off)
            # v4 timing payload is detected by presence: a v3 frame (or a
            # v4 sender with timing disabled) simply ends after fhat
            queue_s = -1.0
            if off + 8 <= len(payload):
                (queue_s,) = struct.unpack_from("<d", payload, off)
            return WireReply(req_id, t, triggered.astype(bool),
                             v.astype(np.float32), fhat.astype(np.float32),
                             srv_s, coal, queue_s)
        if msg_type == MSG_BYE:
            return Bye()
        if msg_type == MSG_ATTACH:
            (slot,) = struct.unpack_from("<I", payload, off)
            return Attach(slot)
        if msg_type == MSG_DETACH:
            (slot,) = struct.unpack_from("<I", payload, off)
            return Detach(slot)
        if msg_type == MSG_REDIRECT:
            address, off = _unpack_str(payload, off)
            return Redirect(address)
        if msg_type == MSG_GOAWAY:
            reason, off = _unpack_str(payload, off)
            return GoAway(reason)
        if msg_type == MSG_SHM_OPEN:
            (ok,) = struct.unpack_from("<B", payload, off)
            return ShmOpen(bool(ok))
        if msg_type == MSG_ERROR:
            message, off = _unpack_str(payload, off)
            return Error(message)
    # the decode boundary converts EVERY parse failure to WireError: a
    # hostile/buggy peer must never crash a reactor with anything else
    except (struct.error, ValueError, IndexError, OverflowError) as e:
        raise WireError(f"malformed frame body: {e}") from e
    raise WireError(f"unknown message type {msg_type}")


class FrameReader:
    """Incremental re-framing of a byte stream: feed arbitrary chunks,
    get back complete frame payloads.  Tolerates any fragmentation the
    kernel produces (frames split across reads, many frames per read)."""

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[bytes]:
        self._buf.extend(data)
        out: List[bytes] = []
        while True:
            if len(self._buf) < _LEN.size:
                return out
            (n,) = _LEN.unpack_from(self._buf, 0)
            if n > MAX_FRAME_BYTES:
                raise WireError(f"frame length {n} exceeds cap")
            if len(self._buf) < _LEN.size + n:
                return out
            out.append(bytes(self._buf[_LEN.size:_LEN.size + n]))
            del self._buf[:_LEN.size + n]


# -- shared-memory rings -----------------------------------------------------
#
# One SPSC byte ring = a 128-byte header (u64 head cursor at +0, u64
# tail cursor at +64 — separate cache lines) followed by ``size`` data
# bytes.  Cursors increase monotonically and never wrap (u64 at ring
# throughput outlives the hardware); the data index is ``cursor % size``.
# The producer writes only ``head``, the consumer only ``tail`` — with
# one writer per cursor an 8-byte aligned store is the only
# synchronization needed (CPython's GIL orders the surrounding memcpys;
# the reference's docs/transport.md gives the safety argument).
#
# The rings carry the SAME length-prefixed byte stream a socket would:
# ``RingWriter.write`` is ``send`` (writes what fits, two memcpys across
# the wrap), ``RingReader.read`` is ``recv`` — so partial frames across
# the wrap point, frames larger than the ring, and backpressure all
# reduce to the stream semantics ``FrameReader`` already handles.

RING_HDR = 128          # u64 head @ +0, u64 tail @ +64
_CURSOR = struct.Struct("<Q")


class _RingSide:
    """Shared geometry/cursor plumbing for one ring over any writable
    buffer (an ``mmap`` arena or a plain ``bytearray`` in tests)."""

    def __init__(self, buf, offset: int, size: int):
        if size <= 0:
            raise WireError(f"ring size must be positive, got {size}")
        self._buf = buf
        self._head_off = offset
        self._tail_off = offset + 64
        self._data_off = offset + RING_HDR
        self.size = size

    def _load(self, off: int) -> int:
        return _CURSOR.unpack_from(self._buf, off)[0]

    def _store(self, off: int, value: int) -> None:
        _CURSOR.pack_into(self._buf, off, value)


class RingWriter(_RingSide):
    """Producer side: ``write`` as much of ``data`` as fits (0 when the
    ring is full — the caller loops like ``sendall``, waiting on the
    consumer's doorbell for space)."""

    def free(self) -> int:
        return self.size - (self._load(self._head_off)
                            - self._load(self._tail_off))

    def write(self, data) -> int:
        head = self._load(self._head_off)
        n = min(len(data), self.size - (head - self._load(self._tail_off)))
        if n <= 0:
            return 0
        i = head % self.size
        first = min(n, self.size - i)
        base = self._data_off
        self._buf[base + i:base + i + first] = bytes(data[:first])
        if n > first:  # wrap: the remainder lands at the ring start
            self._buf[base:base + (n - first)] = bytes(data[first:n])
        self._store(self._head_off, head + n)  # publish AFTER the copy
        return n


class RingReader(_RingSide):
    """Consumer side: ``read`` drains whatever is available (advancing
    ``tail`` frees the space), ``frames`` feeds it straight through an
    internal ``FrameReader`` so callers get complete frame payloads."""

    def __init__(self, buf, offset: int, size: int):
        super().__init__(buf, offset, size)
        self.reader = FrameReader()

    def available(self) -> int:
        return self._load(self._head_off) - self._load(self._tail_off)

    def read(self, limit: Optional[int] = None) -> bytes:
        tail = self._load(self._tail_off)
        n = self._load(self._head_off) - tail
        if limit is not None:
            n = min(n, limit)
        if n <= 0:
            return b""
        i = tail % self.size
        first = min(n, self.size - i)
        base = self._data_off
        out = bytes(self._buf[base + i:base + i + first])
        if n > first:
            out += bytes(self._buf[base:base + (n - first)])
        self._store(self._tail_off, tail + n)  # free AFTER the copy
        return out

    def frames(self) -> List[bytes]:
        data = self.read()
        return self.reader.feed(data) if data else []


# -- addressing --------------------------------------------------------------

def parse_address(address: str) -> Tuple[int, Union[str, Tuple[str, int]]]:
    """"/path/to.sock" -> (AF_UNIX, path); "host:port" -> (AF_INET, (h, p)).

    ``shm:ADDR`` strips the prefix and parses ADDR — the shared-memory
    transport's CONTROL channel is an ordinary socket (the rings are
    negotiated over it), so a shm address is just a socket address
    wearing a transport hint."""
    if address.startswith("shm:"):
        return parse_address(address[len("shm:"):])
    if ":" in address and not address.startswith("/"):
        host, _, port = address.rpartition(":")
        return socket.AF_INET, (host or "127.0.0.1", int(port))
    return socket.AF_UNIX, address


def connect(address: str, *, timeout: Optional[float] = 20.0,
            retry_interval: float = 0.05) -> socket.socket:
    """Connect to a correction server, retrying until ``timeout`` (the
    server process may still be starting when the client does)."""
    family, target = parse_address(address)
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        sock = socket.socket(family, socket.SOCK_STREAM)
        try:
            sock.connect(target)
            if family == socket.AF_INET:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return sock
        except OSError:
            sock.close()
            if deadline is not None and time.monotonic() > deadline:
                raise
            time.sleep(retry_interval)


def connect_hello(address: str, hello: Hello, *,
                  timeout: Optional[float] = 20.0,
                  retry_interval: float = 0.05,
                  ) -> Tuple[socket.socket, HelloAck, "FrameReader",
                             int, int]:
    """Connect AND complete the HELLO handshake, distinguishing the two
    failure modes ``connect()`` used to conflate:

    * connection refused / EOF / reset before the ACK -> the server is
      (still) dead: keep retrying until ``timeout``, then raise
      ``PeerGone`` (mark-unhealthy signal for a fleet client).
    * an ERROR frame in answer to the HELLO -> the server is alive and
      REFUSING (full / draining / version skew): raise
      ``HandshakeRefused`` immediately — retrying the same address
      cannot help, but a sibling server might.

    Returns ``(sock, ack, reader, tx_bytes, rx_bytes)``; ``reader`` is
    the ``FrameReader`` holding any bytes that arrived after the ACK,
    and the byte counts cover everything this function put on / took off
    the socket (for ``CommsMeter`` accounting by the caller).
    """
    payload = encode_hello(hello)
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        remaining = (None if deadline is None
                     else max(0.05, deadline - time.monotonic()))
        try:
            sock = connect(address, timeout=remaining,
                           retry_interval=retry_interval)
        except OSError as e:
            raise PeerGone(f"connect to {address!r} failed: {e}") from e
        tx = len(payload)
        reader = FrameReader()
        try:
            sock.sendall(payload)
            rx = 0
            msg: Optional[Message] = None
            while msg is None:
                chunk = sock.recv(65536)
                if not chunk:
                    raise PeerGone("server closed during handshake")
                rx += len(chunk)
                frames = reader.feed(chunk)
                if frames:
                    msg = decode(frames[0])
            if isinstance(msg, Error):
                sock.close()
                raise HandshakeRefused(msg.message)
            if isinstance(msg, Redirect):
                # one hop only: a router handing out another router is a
                # config error, surfaced by the recursive call's types
                sock.close()
                return connect_hello(msg.address, hello, timeout=remaining,
                                     retry_interval=retry_interval)
            if not isinstance(msg, HelloAck):
                sock.close()
                raise WireError(f"unexpected handshake reply: {msg}")
            return sock, msg, reader, tx, rx
        except (PeerGone, OSError) as e:
            # transient: the server died under us — retry until deadline
            sock.close()
            if deadline is not None and time.monotonic() > deadline:
                if isinstance(e, PeerGone):
                    raise
                raise PeerGone(f"handshake with {address!r} failed: {e}"
                               ) from e
            time.sleep(retry_interval)
        except WireError:
            sock.close()
            raise
