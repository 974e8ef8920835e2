"""The port's same-host shared-memory transport (repro_torch.serving.shm,
``ShmWorker``, ``CorrectionServer(shm=True)``) against the JAX package, on
the CPU.

Mirrors tests/test_shm.py: the rings (wrap, full, torn writes, oversize
frames), doorbell backpressure over a real arena, the handshake's codec
tails, the server's arena offer and its decline, a wire client against
an shm server (plain), an shm client against a wire server (falls back),
and a kill mid-flight (no arena left).  Across packages: the same writes
leave the same arena bytes; an arena made by either package is mapped and
spoken by the other; a torch ``ShmWorker`` against the JAX
``CorrectionServer(shm=True)`` and a JAX shm client against the port's,
on granite-8b SMOKE (f32) at max_staleness 0 and 4: u and triggers exact
against the client's own package and, outside the tie band (its count is
printed), against the other's; fhat within 1e-4 at k = 0; server_pos and
bytes equal; every reply over the rings.
"""
import os
import socket
import struct
import tempfile
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from _chaos import torn_ring_write
from repro.serving import SessionConfig as JSessionConfig
from repro.serving import TransportSpec as JTransportSpec
from repro.serving import shm as jshm
from repro.serving import wire as jwire
from repro.serving.collaborative import CollaborativeEngine as JEngine
from repro.serving.server import CorrectionServer as JServer
from repro_torch.configs.paper_synthetic import SERVING
from repro_torch.core.decomposition import init_collab_lm
from repro_torch.data import tokens as tok
from repro_torch.serving import SessionConfig, TransportSpec, async_rpc
from repro_torch.serving import shm, wire
from repro_torch.serving.collaborative import CollaborativeEngine
from repro_torch.serving.server import CorrectionServer

from _torch_parity import (check_across, no_stray_arenas, serve_case,
                           with_threshold)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _uds_path(tag):
    return os.path.join(tempfile.mkdtemp(prefix=f"tshm_{tag}_"), "s.sock")


def _ring_pair(size):
    """A writer/reader pair over one in-memory ring."""
    buf = bytearray(wire.RING_HDR + size)
    return wire.RingWriter(buf, 0, size), wire.RingReader(buf, 0, size)


_MODEL = {}


def _serving():
    """paper-synthetic SERVING with the port's own seeded weights and a
    threshold of 0.1 (mixed triggers)."""
    if not _MODEL:
        cfg = with_threshold(SERVING, 0.1)
        _MODEL.update(cfg=cfg, model=init_collab_lm(
            cfg, torch.Generator().manual_seed(0), "cpu"))
    return _MODEL["cfg"], _MODEL["model"]


class _Running:
    """A correction server serving in a daemon thread until ``stop``."""

    def __init__(self, srv):
        self.srv, self.ev = srv, threading.Event()
        self.th = threading.Thread(target=srv.serve_forever,
                                   kwargs=dict(stop=self.ev), daemon=True)
        self.th.start()

    def stop(self):
        self.ev.set()
        self.th.join(timeout=10)
        self.srv.close()


def _engine(batch=3):
    cfg, model = _serving()
    return CollaborativeEngine(model, cfg, batch, 32, device="cpu")


def _run(eng, stream, address, k, kind="shm"):
    conf = SessionConfig(mode="async", max_staleness=k,
                         transport=TransportSpec(kind, address=address))
    with eng.session(conf) as s:
        return s.run(stream)


# -- the byte rings ---------------------------------------------------------------

@settings(max_examples=25, deadline=None)
@given(size=st.integers(min_value=32, max_value=257),
       sizes=st.lists(st.integers(min_value=0, max_value=300), min_size=1,
                      max_size=12),
       seed=st.integers(min_value=0, max_value=2**31 - 1))
def test_framed_round_trip_with_wrap(size, sizes, seed):
    """Any schedule of frames, larger than the ring or straddling its wrap
    point, survives a write-what-fits / drain loop bit-exactly."""
    rng = np.random.default_rng(seed)
    w, r = _ring_pair(size)
    frames = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for n in sizes]
    got = []
    for payload in frames:
        buf = wire.frame(payload)
        done = 0
        while done < len(buf):
            n = w.write(buf[done:])
            if n == 0:
                got.extend(r.frames())
                assert w.free() > 0, "drain must free space"
            done += n
    got.extend(r.frames())
    assert got == frames
    assert r.available() == 0 and w.free() == size


def test_ring_full_torn_and_oversize():
    """A full ring refuses, never clobbers; a torn write yields nothing and
    never raises; an oversize length prefix raises WireError."""
    w, r = _ring_pair(64)
    payload = bytes(range(60))
    assert w.write(payload) == 60
    assert w.write(b"x" * 10) == 4
    assert w.write(b"y") == 0
    assert r.read(60) == payload
    assert r.read() == b"x" * 4
    w, r = _ring_pair(1 << 12)
    n = torn_ring_write(w, b"z" * 600)
    assert 0 < n < 604
    assert r.frames() == [] and r.frames() == []
    assert r.available() == 0
    w, r = _ring_pair(64)
    w.write(struct.pack("<I", wire.MAX_FRAME_BYTES + 1) + b"\x00" * 10)
    with pytest.raises(wire.WireError, match="frame"):
        r.frames()


def test_blocked_writer_resumes_on_consumer_progress():
    """A real arena and doorbells: the producer blocks when the ring fills
    and resumes as the consumer frees space; every byte arrives."""
    arena = shm.ServerArena.create(1 << 10)
    fds = [os.dup(fd) for fd in arena.fds()]
    client = shm.attach(fds, 1 << 10, arena.db_kind)
    arena.sent()
    server = arena.peer
    total = 64 * 1024
    blob = np.random.default_rng(0).integers(0, 256, total,
                                             dtype=np.uint8).tobytes()
    got = bytearray()

    def produce():
        mv = memoryview(blob)
        off = 0
        while off < len(mv):
            off += client.send_all(mv[off:off + 4096], timeout=30.0)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while len(got) < total:
        assert time.monotonic() < deadline, "consumer starved"
        data = server.reader.read()
        if data:
            server.db_peer.ring()
            got.extend(data)
        else:
            server.db_own.drain()
            if not server.reader.available():
                time.sleep(0.001)
    t.join(timeout=10)
    assert bytes(got) == blob
    client.close()
    arena.close()
    assert no_stray_arenas()


# -- across packages: codec tails and arenas ----------------------------------------

def test_handshake_tails_and_arena_layout_equal_the_reference():
    """HELLO's shm flag, HELLO_ACK's arena tail and SHM_OPEN encode to the
    reference's bytes and decode alike; the arena constants, sizes and
    header are the reference's."""
    for make in (lambda w: w.encode_hello(w.Hello(4, 16, shm=True)),
                 lambda w: w.encode_hello(w.Hello(4, 16)),
                 lambda w: w.encode_hello_ack(w.HelloAck(
                     7, 3, 64, shm_path="/dev/shm/repro-shm-x",
                     ring_bytes=1 << 20, db_kind=shm.DB_PIPE)),
                 lambda w: w.encode_shm_open(True),
                 lambda w: w.encode_shm_open(False)):
        assert make(wire) == make(jwire)
    (p,) = wire.FrameReader().feed(wire.encode_hello(wire.Hello(4, 16)))
    assert wire.decode(p).shm is False and jwire.decode(p).shm is False
    for name in ("ARENA_MAGIC", "ARENA_HDR", "DEFAULT_RING_BYTES",
                 "DB_EVENTFD", "DB_PIPE", "ARENA_PREFIX"):
        assert getattr(shm, name) == getattr(jshm, name), name
    for rb in (64, 1 << 10, 1 << 20):
        assert shm.arena_size(rb) == jshm.arena_size(rb)


@pytest.mark.parametrize("maker", ["torch", "jax"])
def test_an_arena_of_either_package_is_spoken_by_the_other(maker):
    """One package creates the arena (server side), the other attaches it
    (client side): frames cross both rings, in both directions, and the
    mapping's bytes are what the same writes leave in the reference's
    layout."""
    make, take = (shm, jshm) if maker == "torch" else (jshm, shm)
    arena = make.ServerArena.create(1 << 10)
    client = take.attach([os.dup(fd) for fd in arena.fds()], 1 << 10,
                         arena.db_kind)
    arena.sent()
    try:
        frames = [wire.encode_attach(i) for i in range(40)]
        for f in frames:                       # client -> server ring
            assert client.send_all(f, timeout=5.0) == len(f)
            assert [jwire.decode(p).slot for p in arena.peer.recv_frames()
                    ] == [wire.decode(f[4:]).slot]
        reply = wire.encode_goaway("draining")  # server -> client ring
        arena.peer.send_all(reply, timeout=5.0)
        assert [type(wire.decode(p)).__name__
                for p in client.recv_frames()] == ["GoAway"]
        buf = bytearray(shm.arena_size(1 << 10))
        struct.pack_into("<II", buf, 0, shm.ARENA_MAGIC, 1 << 10)
        w = wire.RingWriter(buf, shm.ARENA_HDR, 1 << 10)
        r = wire.RingReader(buf, shm.ARENA_HDR, 1 << 10)
        for f in frames:
            w.write(f)
            r.frames()
        w2 = wire.RingWriter(buf, shm.ARENA_HDR + wire.RING_HDR + (1 << 10),
                             1 << 10)
        w2.write(reply)
        r2 = wire.RingReader(buf, shm.ARENA_HDR + wire.RING_HDR + (1 << 10),
                             1 << 10)
        r2.frames()
        assert bytes(client._mm) == bytes(buf)
    finally:
        client.close()
        arena.close()
    assert no_stray_arenas()


# -- sessions across packages -----------------------------------------------------

B, ML, S = 3, 32, 16
_CASE = {}


def _case():
    if not _CASE:
        _CASE.update(serve_case("granite-8b", B, ML, S))
    return _CASE


@pytest.fixture(scope="module")
def shm_servers():
    """A JAX and a torch shm CorrectionServer on the same weights, each in a
    thread."""
    torch.set_num_threads(1)
    c = _case()
    made = []
    try:
        made.append(_Running(JServer(c["jcfg"], c["params"], slots=8,
                                     max_len=ML, uds=_uds_path("jax"),
                                     shm=True)))
        made.append(_Running(CorrectionServer(
            c["tcfg"], c["model"], slots=8, max_len=ML,
            uds=_uds_path("torch"), shm=True, device="cpu")))
        yield {"jax": made[0].srv, "torch": made[1].srv}
    finally:
        for run in made:
            run.stop()


@pytest.mark.parametrize("k", [0, 4])
@pytest.mark.parametrize("client", ["torch", "jax"])
def test_shm_client_against_the_other_packages_server(shm_servers, client,
                                                      k):
    """A torch ShmWorker against the JAX server and a JAX shm client
    against the torch server: the data plane rides the rings, and the run
    holds to both packages' sync runs (fhat within 1e-4 at k = 0; at k = 4
    corrections merge late and fhat is held below u)."""
    c = _case()
    srv = shm_servers["jax" if client == "torch" else "torch"]
    shm_sessions = srv.stats["shm_sessions"]
    if client == "torch":
        eng = CollaborativeEngine(c["model"], c["tcfg"], B, ML, device="cpu")
        conf = SessionConfig(mode="async", max_staleness=k,
                             transport=TransportSpec("shm",
                                                     address=srv.address))
        mine, other, sync = c["rt"], c["rj"], c["tsync"]
    else:
        eng = JEngine(c["params"], c["jcfg"], batch=B, max_len=ML)
        conf = JSessionConfig(mode="async", max_staleness=k,
                              transport=JTransportSpec("shm",
                                                       address=srv.address))
        mine, other, sync = c["rj"], c["rt"], c["jsync"]
    with eng.session(conf) as s:
        r = s.run(c["toks"])
    band = check_across(r, mine, other, eng.server_pos, sync.server_pos,
                        c["thr"], plane="shm")
    print(f"{client} shm client k={k}: {band} of {r['u'].size} entries in "
          "the tie band")
    assert r["comms"].get("wire", {}).get("replies", 0) == 0
    assert srv.stats["shm_sessions"] == shm_sessions + 1
    if k == 0:
        for ref in (mine, other):
            np.testing.assert_allclose(r["fhat"], ref["fhat"], atol=1e-4)
    assert no_stray_arenas()


# -- the port's own server --------------------------------------------------------

@pytest.fixture(scope="module")
def port_shm_server():
    torch.set_num_threads(1)
    cfg, model = _serving()
    run = _Running(CorrectionServer(cfg, model, slots=8, max_len=32,
                                    uds=_uds_path("srv"), shm=True,
                                    device="cpu"))
    yield run.srv
    run.stop()


def test_strict_sync_bitwise_and_bytes_in_the_shm_section(port_shm_server):
    """max_staleness 0 over the rings: u and triggers bitwise the scan run,
    fhat within 1e-6 of the sync run, bytes and server_pos equal; the data
    plane's bytes and RTTs in ``comms["shm"]``, only the handshake on the
    socket.  At k = 4 fhat stays below u."""
    srv = port_shm_server
    cfg, _ = _serving()
    stream = next(tok.lm_batches(0, cfg, 3, 16))["tokens"]
    rs = _engine().session(SessionConfig(mode="scan")).run(stream)
    sync = _engine()
    r1 = sync.session(SessionConfig()).run(stream)
    a = _engine()
    r0 = _run(a, stream, srv.address, 0)
    assert 0.0 < r0["triggered"].mean() < 1.0, "need mixed triggers"
    np.testing.assert_array_equal(r0["u"], rs["u"])
    np.testing.assert_array_equal(r0["triggered"], rs["triggered"])
    np.testing.assert_allclose(r0["fhat"], r1["fhat"], atol=1e-6)
    np.testing.assert_array_equal(a.server_pos, sync.server_pos)
    rep = r0["comms"]
    assert rep["bytes_sent"] == r1["comms"]["bytes_sent"]
    s = rep["shm"]
    assert s["replies"] == rep["async"]["requests"] > 0
    assert s["tx_bytes"] > 0 and s["rx_bytes"] > 0 and s["rtt_mean_s"] > 0
    assert rep["wire"]["replies"] == 0
    assert rep["wire"]["tx_bytes"] < s["tx_bytes"]
    ra = _run(_engine(), stream, srv.address, 4)
    np.testing.assert_array_equal(ra["u"], rs["u"])
    np.testing.assert_array_equal(ra["triggered"], rs["triggered"])
    assert (ra["fhat"] <= ra["u"]).all()
    assert srv.stats["shm_bytes_rx"] > 0 and srv.stats["shm_bytes_tx"] > 0
    assert no_stray_arenas()


def test_wire_client_against_an_shm_server_stays_plain(port_shm_server):
    cfg, _ = _serving()
    stream = next(tok.lm_batches(0, cfg, 3, 16))["tokens"]
    r = _run(_engine(), stream, port_shm_server.address, 0, kind="wire")
    assert "shm" not in r["comms"]
    assert r["comms"]["wire"]["replies"] > 0


def test_shm_client_against_a_wire_server_falls_back():
    """A plain server offers no arena: the session degrades to the wire
    with a recorded reason, never an error."""
    cfg, model = _serving()
    run = _Running(CorrectionServer(cfg, model, slots=4, max_len=32,
                                    uds=_uds_path("plain"), device="cpu"))
    try:
        stream = next(tok.lm_batches(0, cfg, 3, 16))["tokens"]
        eng = _engine()
        conf = SessionConfig(mode="async", max_staleness=0,
                             transport=TransportSpec(
                                 "shm", address=run.srv.address))
        with eng.session(conf) as s:
            out = [s.step(stream[:, i]) for i in range(4)]
            worker = eng._worker
            assert isinstance(worker, async_rpc.ShmWorker)
            assert worker._peer is None
            assert "no shm arena" in worker.fallback_reason
            rep = s.report()
        assert len(out) == 4
        assert "shm" not in rep and rep["wire"]["replies"] > 0
    finally:
        run.stop()


def test_declined_shm_open_keeps_the_session_on_the_wire(port_shm_server):
    """A client that cannot attach answers SHM_OPEN(ok=0): the server tears
    the arena down and serves the session over the wire."""
    srv = port_shm_server
    base = srv.stats["shm_sessions"]
    sock = wire.connect(srv.address, timeout=10)
    try:
        sock.settimeout(10.0)
        sock.sendall(wire.encode_hello(wire.Hello(batch=1, max_len=16,
                                                  shm=True)))
        fds, payloads, reader = [], [], wire.FrameReader()
        while not payloads:
            data, new_fds, _, _ = socket.recv_fds(sock, 1 << 16, 8)
            assert data, "server closed during handshake"
            fds.extend(new_fds)
            payloads = reader.feed(data)
        ack = wire.decode(payloads[0])
        assert isinstance(ack, wire.HelloAck)
        assert ack.ring_bytes > 0 and len(fds) >= 2
        shm.close_fds(fds)                     # a failed attach
        sock.sendall(wire.encode_shm_open(False))
        hist = np.zeros((1, 16), np.int32)
        sock.sendall(wire.encode_request(
            1, 0, np.array([True]), np.zeros(1, np.int32),
            np.zeros(1, np.float32), hist))
        msgs = []
        while not msgs:
            data = sock.recv(1 << 16)
            assert data, "server dropped a declined-shm session"
            msgs = [wire.decode(p) for p in reader.feed(data)]
        assert isinstance(msgs[0], wire.WireReply)
        assert srv.stats["shm_sessions"] == base
    finally:
        sock.close()
    assert no_stray_arenas(timeout=10.0)


def test_kill_mid_flight_leaves_no_arena_and_fails_the_session():
    """A server severed mid-session (no BYE, no GOAWAY): a direct client
    fails with WireError, and no arena file survives."""
    cfg, model = _serving()
    run = _Running(CorrectionServer(cfg, model, slots=4, max_len=32,
                                    uds=_uds_path("kill"), shm=True,
                                    device="cpu"))
    stream = next(tok.lm_batches(0, cfg, 3, 16))["tokens"]
    eng = _engine()
    conf = SessionConfig(mode="async", max_staleness=4,
                         transport=TransportSpec("shm",
                                                 address=run.srv.address))
    try:
        with pytest.raises(wire.WireError):
            with eng.session(conf) as s:
                for i in range(stream.shape[1]):
                    s.step(stream[:, i])
                    if i == 6:
                        run.ev.set()
                        run.th.join(timeout=10)
                        for sess in list(run.srv._sessions.values()):
                            try:
                                sess.conn.shutdown(socket.SHUT_RDWR)
                            except OSError:
                                pass
                        run.srv.close()
    finally:
        run.stop()
    assert no_stray_arenas()
