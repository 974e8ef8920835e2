"""The port's wire codec (repro_torch.serving.wire) and its ``wire``
transport against the JAX package, on the CPU.

Mirrors tests/test_wire.py's codec, transport-registry and handshake
tests, held to the reference byte for byte: every message type encodes to
the same bytes in both packages, each package decodes the other's v3, v4
and v5 frames to equal fields, and malformed frames raise ``WireError``
with the same message in both.  Across frameworks, on granite-8b SMOKE
(f32) with the same weights: a torch client against the JAX
``CorrectionServer`` and a JAX client against the port's, each in a thread
of this process, at max_staleness 0 and 4 (u and triggers exact against
the client's own package, and against the other package outside the tie
band, whose count is reported; fhat within 1e-4; server_pos and bytes
equal; fhat <= u; wire bytes and RTT measured); and a torch client
against the JAX package's launcher in a second process
(``python -m repro.launch.server``).
"""
import dataclasses
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from conftest import SPAWN_DEADLINE_S
from repro.serving import SessionConfig as JSessionConfig
from repro.serving import TransportSpec as JTransportSpec
from repro.serving import wire as jwire
from repro.serving.collaborative import CollaborativeEngine as JEngine
from repro.serving.server import CorrectionServer as JServer
from repro_torch.serving import SessionConfig, TransportSpec, async_rpc
from repro_torch.serving import wire
from repro_torch.serving.collaborative import CollaborativeEngine
from repro_torch.serving.server import CorrectionServer

from _torch_parity import check_across, serve_case

PKGS = {"jax": jwire, "torch": wire}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _uds_path(tag):
    # bind() creates the file, so the path must not exist yet
    return os.path.join(tempfile.mkdtemp(prefix=f"twire_{tag}_"), "s.sock")


def _fields(msg):
    """A message's type name and fields, arrays as (dtype, shape, bytes):
    comparable across the two packages' dataclasses."""
    out = {"type": type(msg).__name__}
    for f in dataclasses.fields(msg):
        v = getattr(msg, f.name)
        if isinstance(v, np.ndarray):
            v = (v.dtype.str, v.shape, v.tobytes())
        out[f.name] = v
    return out


def _payload(buf):
    (p,) = wire.FrameReader().feed(buf)
    return p


def _same_frame(make):
    """``make(pkg)`` -> one frame from each package: the bytes must be
    equal, and each package must decode them to the same fields."""
    a, b = make(jwire), make(wire)
    assert a == b
    p = _payload(a)
    fa, fb = _fields(jwire.decode(p)), _fields(wire.decode(p))
    assert fa == fb
    return fa


# -- codec ---------------------------------------------------------------------

@settings(max_examples=20, deadline=None)
@given(batch=st.integers(min_value=1, max_value=9),
       max_len=st.integers(min_value=2, max_value=33),
       t_frac=st.floats(min_value=0.0, max_value=1.0),
       req_id=st.integers(min_value=0, max_value=2**64 - 1),
       seed=st.integers(min_value=0, max_value=2**31 - 1))
def test_request_bytes_equal_reference(batch, max_len, t_frac, req_id, seed):
    """encode_request (history slices) and encode_request_arrays
    (concatenated backlogs) give the reference's bytes; the port's
    dispatch payload (the backlog's (R, B) tokens, each stream's first
    t + 1 - server_pos[i]) is the same frame."""
    rng = np.random.default_rng(seed)
    t = int(round(t_frac * (max_len - 1)))
    triggered = rng.random(batch) < 0.5
    server_pos = rng.integers(0, t + 1, batch).astype(np.int32)
    u = rng.standard_normal(batch).astype(np.float32)
    history = rng.integers(0, 255, (batch, max_len)).astype(np.int32)
    fa = _same_frame(lambda w: w.encode_request(
        req_id, t, triggered, server_pos, u, history))
    # the backlog as the engine builds it: round r of row i is position
    # server_pos[i] + r, clipped to the history
    R = int(np.max(np.where(triggered, t + 1 - server_pos, 0), initial=0))
    pos = np.clip(server_pos[None, :] + np.arange(R)[:, None], 0, max_len - 1)
    toks = history[np.arange(batch)[None, :], pos]
    lengths = np.where(triggered, t + 1 - server_pos, 0)
    rows = np.flatnonzero(triggered)
    tokens = (np.concatenate([toks[:lengths[i], i] for i in rows])
              if len(rows) else np.zeros(0, np.int32))
    buf = wire.encode_request_arrays(wire.WireRequest(
        req_id, t, triggered, server_pos, u, tokens))
    assert buf == jwire.encode_request(req_id, t, triggered, server_pos, u,
                                       history)
    assert fa["type"] == "WireRequest" and fa["req_id"] == req_id


@settings(max_examples=10, deadline=None)
@given(batch=st.integers(min_value=1, max_value=17),
       seed=st.integers(min_value=0, max_value=2**31 - 1),
       coalesced=st.integers(min_value=1, max_value=64),
       timed=st.booleans())
def test_reply_bytes_equal_reference(batch, seed, coalesced, timed):
    rng = np.random.default_rng(seed)
    kw = dict(req_id=int(rng.integers(0, 2**63)), t=int(rng.integers(0, 1000)),
              triggered=rng.random(batch) < 0.5,
              v=rng.standard_normal(batch).astype(np.float32),
              fhat=rng.standard_normal(batch).astype(np.float32),
              server_time_s=float(rng.random()), coalesced=coalesced,
              queue_s=float(rng.random()) if timed else -1.0)
    f = _same_frame(lambda w: w.encode_reply(w.WireReply(**kw)))
    assert f["coalesced"] == coalesced and f["queue_s"] == kw["queue_s"]


@pytest.mark.parametrize("name", [
    "hello", "hello_shm", "hello_ack", "hello_ack_shm", "bye", "attach",
    "detach", "redirect", "goaway", "goaway_reason", "shm_open", "error"])
def test_control_messages_bytes_equal_reference(name):
    make = {
        "hello": lambda w: w.encode_hello(w.Hello(
            batch=4, max_len=32, tok_tail=(8,), coalesce=False,
            client="edge-7")),
        "hello_shm": lambda w: w.encode_hello(w.Hello(2, 8, shm=True)),
        "hello_ack": lambda w: w.encode_hello_ack(w.HelloAck(3, 12, 128)),
        "hello_ack_shm": lambda w: w.encode_hello_ack(w.HelloAck(
            3, 12, 128, shm_path="/dev/shm/x", ring_bytes=1 << 20,
            db_kind=1)),
        "bye": lambda w: w.encode_bye(),
        "attach": lambda w: w.encode_attach(3),
        "detach": lambda w: w.encode_detach(7),
        "redirect": lambda w: w.encode_redirect("/tmp/x.sock"),
        "goaway": lambda w: w.encode_goaway(),
        "goaway_reason": lambda w: w.encode_goaway("rebalance"),
        "shm_open": lambda w: w.encode_shm_open(True),
        "error": lambda w: w.encode_error("boom é"),
    }[name]
    _same_frame(make)


def _with_version(buf, version):
    p = bytearray(_payload(buf))
    p[2] = version
    return bytes(p)


@pytest.mark.parametrize("version", [3, 4, 5])
@pytest.mark.parametrize("src", ["jax", "torch"])
def test_old_version_frames_decode_in_both(src, version):
    """A v3 REPLY has no timing payload and a v3/v4 HELLO no shm byte;
    frames of every version in the window, written by either package,
    decode to the same fields in both."""
    w = PKGS[src]
    reply = w.WireReply(5, 9, np.array([True, False]),
                        np.array([0.5, 0.25], np.float32),
                        np.array([0.1, 0.2], np.float32), 0.003, 2,
                        queue_s=0.001 if version >= 4 else -1.0)
    frames = [w.encode_reply(reply), w.encode_hello(w.Hello(2, 16)),
              w.encode_request(1, 3, np.array([True, False]),
                               np.zeros(2, np.int32),
                               np.zeros(2, np.float32),
                               np.arange(16, dtype=np.int32).reshape(2, 8)),
              w.encode_attach(1)]
    if version == 5:
        frames.append(w.encode_hello(w.Hello(2, 16, shm=True)))
    for buf in frames:
        p = _with_version(buf, version)
        fa, fb = _fields(jwire.decode(p)), _fields(wire.decode(p))
        assert fa == fb
    assert wire.decode(_with_version(frames[0], version)).queue_s == (
        0.001 if version >= 4 else -1.0)


def _malformed():
    good = _payload(wire.encode_bye())
    req = _payload(wire.encode_request(
        1, 3, np.array([True]), np.array([0], np.int32),
        np.zeros(1, np.float32), np.zeros((1, 8), np.int32)))
    err = _payload(wire.encode_error("ok"))
    bad_dtype = bytearray(req)
    bad_dtype[4 + 12] = 200  # the trigger array's dtype code
    return {"magic": b"\x00\x00" + good[2:],
            "version 1": good[:2] + b"\x01" + good[3:],
            "version 6": good[:2] + b"\x06" + good[3:],
            "version 99": good[:2] + b"\x63" + good[3:],
            "short": good[:3],
            "truncated array": req[:-5],
            "dtype code": bytes(bad_dtype),
            "string": err[:-2] + b"\xff\xfe",
            "unknown type": good[:3] + b"\x2a"}


@pytest.mark.parametrize("case", list(_malformed()))
def test_malformed_frames_raise_wire_error_in_both(case):
    """Each package raises its WireError, with the same message."""
    p = _malformed()[case]
    msgs = []
    for w in (jwire, wire):
        with pytest.raises(w.WireError) as ei:
            w.decode(p)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    if case.startswith("version"):
        assert f"version {case.split()[1]}" in msgs[1]
        assert "supported [3, 5]" in msgs[1]


def test_frame_reader_reassembles_any_fragmentation_and_caps():
    frames = [wire.encode_bye(), wire.encode_error("x" * 300),
              wire.encode_hello(wire.Hello(2, 8))]
    stream = b"".join(frames)
    rd = wire.FrameReader()
    got = []
    for i in range(len(stream)):           # worst case: 1 byte per read
        got.extend(rd.feed(stream[i:i + 1]))
    assert [_fields(wire.decode(p)) for p in got] == \
        [_fields(jwire.decode(p)) for p in jwire.FrameReader().feed(stream)]
    for w in (jwire, wire):
        with pytest.raises(w.WireError, match="cap"):
            w.FrameReader().feed(b"\xff\xff\xff\xff")


def test_rings_carry_the_same_bytes_as_the_reference():
    """RingWriter/RingReader over a plain buffer: the same writes leave the
    same arena bytes in both packages, across the wrap and when full."""
    arenas = {}
    for name, w in PKGS.items():
        buf = bytearray(w.RING_HDR + 64)
        wr, rd = w.RingWriter(buf, 0, 64), w.RingReader(buf, 0, 64)
        frames = [w.encode_attach(i) for i in range(6)]
        wrote, got = 0, []
        for f in frames:
            wrote += wr.write(f)
            got.extend(rd.frames())
        assert wrote == sum(len(f) for f in frames)
        assert [_fields(w.decode(p)) for p in got] == \
            [{"type": "Attach", "slot": i} for i in range(6)]
        assert wr.write(b"\x00" * 100) == 64 and wr.free() == 0
        arenas[name] = bytes(buf)
    assert arenas["jax"] == arenas["torch"]


def test_parse_address():
    for a in ("/tmp/x.sock", "127.0.0.1:7431", ":9", "shm:/tmp/y.sock"):
        assert wire.parse_address(a) == jwire.parse_address(a)
    assert wire.parse_address(":9") == (socket.AF_INET, ("127.0.0.1", 9))


# -- transport registry and handshakes -----------------------------------------

def test_make_worker_wire_requires_address_and_rejects_latency(monkeypatch):
    """The reference's ValueErrors; a ``fleet:`` address whose router does
    not answer keeps routing until its deadline, then raises PeerGone."""
    with pytest.raises(ValueError, match="address"):
        async_rpc.make_worker("wire", None, None, None)
    with pytest.raises(ValueError, match="measured"):
        async_rpc.make_worker("wire", None, None, None, latency_s=0.01,
                              wire_opts={"address": "/nowhere"})
    monkeypatch.setattr(async_rpc.SocketWorker, "_CONNECT_TIMEOUT_S", 0.5)
    with pytest.raises(wire.PeerGone, match="no usable server"):
        async_rpc.SocketWorker(None, address="fleet:" + _uds_path("router"),
                               batch=1, max_len=8)


def test_no_listener_is_peer_gone_after_retries():
    path = _uds_path("gone")  # the directory exists, no socket is bound
    t0 = time.monotonic()
    with pytest.raises(wire.PeerGone):
        wire.connect_hello(path, wire.Hello(batch=1, max_len=8),
                           timeout=0.6, retry_interval=0.05)
    assert time.monotonic() - t0 >= 0.5, "must retry until the deadline"


def _listener(path, serve_one):
    """A one-connection-at-a-time test peer on ``path``: (stop event,
    thread, accept count).  The accept loop polls ``stop``."""
    lst = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    lst.bind(path)
    lst.listen(8)
    lst.settimeout(0.02)
    stop, count = threading.Event(), []

    def loop():
        try:
            while not stop.is_set():
                try:
                    c, _ = lst.accept()
                except socket.timeout:
                    continue
                count.append(1)
                try:
                    serve_one(c)
                finally:
                    c.close()
        finally:
            lst.close()
    th = threading.Thread(target=loop, daemon=True)
    th.start()
    return stop, th, count


def test_mid_handshake_eof_is_peer_gone_not_refused():
    """EOF before any ERROR frame: a dead peer, retried until the deadline,
    then PeerGone."""
    path = _uds_path("eof")
    stop, th, accepts = _listener(path, lambda c: None)
    try:
        with pytest.raises(wire.PeerGone, match="handshake"):
            wire.connect_hello(path, wire.Hello(batch=1, max_len=8),
                               timeout=0.6, retry_interval=0.05)
        assert len(accepts) >= 2, "EOF mid-handshake must be retried"
    finally:
        stop.set()
        th.join(timeout=10)


def _answer_hello(reply):
    def serve_one(c):
        c.settimeout(10.0)
        rd = wire.FrameReader()
        while not rd.feed(c.recv(1 << 16)):
            pass
        c.sendall(reply)
    return serve_one


def test_refusal_is_immediate_and_redirect_is_followed():
    """An ERROR answer raises HandshakeRefused at once, with the reason;
    a REDIRECT (written by the JAX package's codec) is followed one hop
    to the address it names."""
    refuser, router = _uds_path("ref"), _uds_path("rtr")
    server = _uds_path("srv")
    ack = jwire.encode_hello_ack(jwire.HelloAck(4, 2, 32))
    sockets = [_listener(refuser, _answer_hello(
                   jwire.encode_error("server full: 9 slots"))),
               _listener(router, _answer_hello(jwire.encode_redirect(server))),
               _listener(server, _answer_hello(ack))]
    try:
        t0 = time.monotonic()
        with pytest.raises(wire.HandshakeRefused) as ei:
            wire.connect_hello(refuser, wire.Hello(9, 8), timeout=30.0)
        assert time.monotonic() - t0 < 10.0
        assert ei.value.message == "server full: 9 slots"
        sock, got, _, tx, rx = wire.connect_hello(router, wire.Hello(2, 8),
                                                  timeout=20.0)
        sock.close()
        assert _fields(got) == _fields(wire.decode(_payload(ack)))
        assert tx == len(wire.encode_hello(wire.Hello(2, 8)))
        assert rx == len(ack)
    finally:
        for stop, th, _ in sockets:
            stop.set()
            th.join(timeout=10)


# -- across frameworks ----------------------------------------------------------

B, ML, S = 3, 32, 16
_CASE = {}


def _case():
    """Weights (the reference's init, carried into the port), a token
    stream, a mixed-trigger threshold, and each package's sync run."""
    if not _CASE:
        _CASE.update(serve_case("granite-8b", B, ML, S))
    return _CASE


@pytest.fixture(scope="module")
def servers():
    """A JAX and a torch CorrectionServer on the same weights, each in a
    thread; stopped and closed in a finally."""
    torch.set_num_threads(1)  # the torch server replays on one thread
    c = _case()
    made, stops, threads = [], [], []
    try:
        for cls, cfg, params, kw in (
                (JServer, c["jcfg"], c["params"], {}),
                (CorrectionServer, c["tcfg"], c["model"], {"device": "cpu"})):
            srv = cls(cfg, params, slots=8, max_len=ML,
                      uds=_uds_path(cls.__module__.split(".")[0]), **kw)
            made.append(srv)
            stop = threading.Event()
            th = threading.Thread(target=srv.serve_forever,
                                  kwargs=dict(stop=stop), daemon=True)
            th.start()
            stops.append(stop)
            threads.append(th)
        yield {"jax": made[0], "torch": made[1]}
    finally:
        for stop in stops:
            stop.set()
        for th in threads:
            th.join(timeout=10)
        for srv in made:
            srv.close()


def _check_across(r, mine, other, client, srv_pos, sync_pos, thr):
    """A wire run ``r`` of the ``client`` package against its own sync
    ``mine`` (u, triggers exact) and the other package's ``other`` (u
    within tolerance, triggers outside the tie band, fhat within 1e-4)."""
    band = check_across(r, mine, other, srv_pos, sync_pos, thr)
    print(f"{client} client: {band} of {r['u'].size} entries in the tie "
          "band")


@pytest.mark.parametrize("k", [0, 4])
@pytest.mark.parametrize("client", ["torch", "jax"])
def test_client_against_the_other_packages_server(servers, client, k):
    """A torch client against the JAX server, a JAX client against the
    torch server.  At k = 0 fhat is within 1e-4 of both packages' sync
    runs; at k = 4 corrections merge late, so fhat is only held below u."""
    c = _case()
    srv = servers["jax" if client == "torch" else "torch"]
    if client == "torch":
        eng = CollaborativeEngine(c["model"], c["tcfg"], B, ML, device="cpu")
        conf = SessionConfig(mode="async", max_staleness=k,
                             transport=TransportSpec("wire",
                                                     address=srv.address))
        mine, other, sync = c["rt"], c["rj"], c["tsync"]
    else:
        eng = JEngine(c["params"], c["jcfg"], batch=B, max_len=ML)
        conf = JSessionConfig(mode="async", max_staleness=k,
                              transport=JTransportSpec("wire",
                                                       address=srv.address))
        mine, other, sync = c["rj"], c["rt"], c["jsync"]
    requests = srv.stats["requests"]
    with eng.session(conf) as s:
        r = s.run(c["toks"])
    _check_across(r, mine, other, client, eng.server_pos, sync.server_pos,
                  c["thr"])
    if k == 0:
        for ref in (mine, other):
            np.testing.assert_allclose(r["fhat"], ref["fhat"], atol=1e-4)
    assert srv.stats["requests"] - requests == r["comms"]["async"]["requests"]


def test_torch_client_against_the_reference_launcher():
    """Two processes: ``python -m repro.launch.server`` (granite-8b SMOKE,
    PRNGKey(0)) and a torch client on the same weights, pipelined."""
    c = _case()  # collab_pair's weights are the reference's PRNGKey(0)
    tmp = tempfile.mkdtemp(prefix="twire_proc_")
    uds, ready = os.path.join(tmp, "s.sock"), os.path.join(tmp, "ready")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.server", "--arch", "granite-8b",
         "--uds", uds, "--slots", "4", "--max-len", str(ML),
         "--ready-file", ready, "--idle-exit-s", "30"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + SPAWN_DEADLINE_S
        while not os.path.exists(ready):
            assert proc.poll() is None, proc.stderr.read()[-3000:]
            assert time.monotonic() < deadline, "server startup timeout"
            time.sleep(0.05)
        eng = CollaborativeEngine(c["model"], c["tcfg"], B, ML,
                                  device="cpu")
        r = eng.session(SessionConfig(
            mode="async", max_staleness=2,
            transport=TransportSpec("wire", address=uds))).run(c["toks"])
        _check_across(r, c["rt"], c["rj"], "torch", eng.server_pos,
                      c["tsync"].server_pos, c["thr"])
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
