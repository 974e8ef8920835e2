"""The port's correction server (repro_torch.serving.server), its launcher
(repro_torch.launch.server) and the ``wire`` sessions served by them, on
the CPU.

Inside the port, mirroring tests/test_wire.py, tests/test_churn.py's
two-client churn, tests/test_observability.py's traced wire sessions and
tests/test_policy.py's cascade over the wire: at max_staleness 0 u and the
triggers equal the scan run bitwise and fhat is within 1e-6 of the sync
run (bitwise, with the final server cache, when the server has the
client's batch); pipelined sessions keep u, triggers, bytes and
server_pos; clients on one server are isolated; session errors carry the
reference's messages; the engine refuses to serve on after a wire
session; the lease defrag keeps a client's rows bitwise; a dead server
fails the client with ``WireError``.  Against the JAX package: its
server and the port's, ticked by hand, answer the same frames alike (the
replies' ids, steps, masks and coalescing exactly, v and fhat within
1e-4, and the coalescing counters); and a JAX client serves against
``python -m repro_torch.launch.server --device cpu`` restoring a
checkpoint written by the JAX package.
"""
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

from conftest import SPAWN_DEADLINE_S
from repro.serving import SessionConfig as JSessionConfig
from repro.serving import TransportSpec as JTransportSpec
from repro.serving import wire as jwire
from repro.serving.collaborative import CollaborativeEngine as JEngine
from repro.serving.server import CorrectionServer as JServer
from repro.training import checkpoint as jckpt
from repro_torch.configs import registry
from repro_torch.core.decomposition import init_collab_lm
from repro_torch.launch import server as launcher
from repro_torch.serving import (CascadeSession, SessionConfig,
                                 TransportSpec, async_rpc, wire)
from repro_torch.serving.collaborative import CollaborativeEngine
from repro_torch.serving.server import CorrectionServer

from _torch_parity import (collab_pair, no_stray_arenas, token_stream,
                           with_threshold)

ML = 32


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _uds_path(tag):
    # bind() creates the file, so the path must not exist yet
    return os.path.join(tempfile.mkdtemp(prefix=f"tsrv_{tag}_"), "s.sock")


_MODEL = {}


def _setup(threshold=None, batch=3, length=16, seed=0):
    """granite-8b SMOKE (f32) with the port's own seeded weights, a token
    stream and, unless given, a mixed-trigger threshold."""
    if not _MODEL:
        cfg = registry.get_smoke("granite-8b")
        _MODEL["cfg"] = cfg
        _MODEL["model"] = init_collab_lm(cfg, torch.Generator().manual_seed(0),
                                         "cpu")
    cfg, model = _MODEL["cfg"], _MODEL["model"]
    toks = token_stream(cfg, batch, length, seed)
    if threshold is None:
        probe = _engine(cfg, model, batch).session(
            SessionConfig(mode="scan")).run(toks)
        threshold = float(np.quantile(probe["u"], 0.7))
    return with_threshold(cfg, threshold), model, toks


def _engine(cfg, model, batch):
    return CollaborativeEngine(model, cfg, batch, ML, device="cpu")


def _wire(address, k, **kw):
    mode = "sync" if k is None else "async"
    extra = {} if k is None else {"max_staleness": k}
    return SessionConfig(mode=mode, transport=TransportSpec(
        "wire", address=address), **extra, **kw)


class _Running:
    """A CorrectionServer serving in a thread until ``stop``."""

    def __init__(self, srv):
        self.srv = srv
        self._stop = threading.Event()
        self._th = threading.Thread(target=srv.serve_forever,
                                    kwargs=dict(stop=self._stop), daemon=True)
        self._th.start()

    def stop(self):
        self._stop.set()
        self._th.join(timeout=10)
        self.srv.close()


def _serve(cfg, model, slots, tag):
    return _Running(CorrectionServer(cfg, model, slots=slots, max_len=ML,
                                     uds=_uds_path(tag), device="cpu"))


@pytest.fixture(scope="module")
def server():
    """One in-thread torch server (8 slots) shared by the loopback tests;
    stopped and closed in a finally."""
    torch.set_num_threads(1)  # the server replays on one thread
    cfg, model, _ = _setup()
    run = _serve(cfg, model, 8, "srv")
    try:
        yield run.srv
    finally:
        run.stop()


# -- loopback inside the port ---------------------------------------------------

def test_sync_over_wire_matches_scan_and_run(server):
    cfg, model, toks = _setup()
    rs = _engine(cfg, model, 3).session(SessionConfig(mode="scan")).run(toks)
    sync = _engine(cfg, model, 3)
    r1 = sync.session().run(toks)
    a = _engine(cfg, model, 3)
    r0 = a.session(_wire(server.address, 0)).run(toks)
    assert 0.0 < r0["triggered"].mean() < 1.0, "need mixed triggers"
    np.testing.assert_array_equal(r0["u"], rs["u"])
    np.testing.assert_array_equal(r0["triggered"], rs["triggered"])
    np.testing.assert_allclose(r0["fhat"], r1["fhat"], atol=1e-6)
    np.testing.assert_array_equal(a.server_pos, sync.server_pos)
    rep = r0["comms"]
    assert rep["bytes_sent"] == r1["comms"]["bytes_sent"]
    w = rep["wire"]
    assert w["replies"] == rep["async"]["requests"] > 0
    assert w["tx_bytes"] > 0 and w["rx_bytes"] > 0 and w["rtt_mean_s"] > 0


def test_bitwise_when_the_server_has_the_clients_batch():
    """slots == B: the server's replay sees the sync engine's shapes, so
    fhat, server_pos and the final server cache rows are bitwise sync's
    (sync mode over the wire is the strict boundary)."""
    cfg, model, toks = _setup()
    sync = _engine(cfg, model, 3)
    r1 = sync.session().run(toks)
    run = _serve(cfg, model, 3, "b3")
    try:
        a = _engine(cfg, model, 3)
        r0 = a.session(_wire(run.srv.address, None)).run(toks)
        for key in ("u", "fhat", "triggered"):
            np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)
        np.testing.assert_array_equal(a.server_pos, sync.server_pos)
        # the lease's rows are zeroed at the next HELLO, not at BYE
        for name, entry in sync.server.cache.items():
            for x, y in zip(entry, run.srv._cache[name]):
                assert torch.equal(x, y), name
    finally:
        run.stop()


def test_pipelined_over_wire_keeps_the_monitor_path(server):
    cfg, model, toks = _setup()
    rs = _engine(cfg, model, 3).session(SessionConfig(mode="scan")).run(toks)
    sync = _engine(cfg, model, 3)
    r1 = sync.session().run(toks)
    a = _engine(cfg, model, 3)
    ra = a.session(_wire(server.address, 4)).run(toks)
    np.testing.assert_array_equal(ra["u"], rs["u"])
    np.testing.assert_array_equal(ra["triggered"], rs["triggered"])
    assert (ra["fhat"] <= ra["u"]).all()
    rep = ra["comms"]
    assert rep["bytes_sent"] == r1["comms"]["bytes_sent"]
    assert (rep["per_stream"]["bytes_sent"]
            <= rep["per_stream"]["bytes_baseline"]).all()
    np.testing.assert_array_equal(a.server_pos, sync.server_pos)
    assert rep["async"]["inflight_now"] == 0


def test_multi_client_session_isolation(server):
    """Two engines on one server, stepped interleaved at k = 2: the client
    that triggers every step does not perturb the quiet one."""
    cfg, model, _ = _setup()
    loud_cfg = with_threshold(cfg, -1e9)
    toks_a = token_stream(cfg, 2, 12, seed=1)
    toks_b = token_stream(cfg, 2, 12, seed=2)
    ref_b = _engine(cfg, model, 2)
    rb_ref = ref_b.session().run(toks_b)
    a, b = _engine(loud_cfg, model, 2), _engine(cfg, model, 2)
    sessions = [a.session(_wire(server.address, 2)).__enter__(),
                b.session(_wire(server.address, 2)).__enter__()]
    outs = ([], [])
    try:
        for t in range(12):
            for sess, toks, out in zip(sessions, (toks_a, toks_b), outs):
                out.append(sess.step(toks[:, t]))
    finally:
        for sess in sessions:
            sess.close()
    assert np.stack([o["triggered"] for o in outs[0]], 1).all()
    for key in ("u", "triggered"):
        np.testing.assert_array_equal(
            np.stack([o[key] for o in outs[1]], 1), rb_ref[key])
    np.testing.assert_array_equal(b.server_pos, ref_b.server_pos)
    assert b.comms.report()["bytes_sent"] == rb_ref["comms"]["bytes_sent"]
    assert server.stats["sessions"] >= 2


def _recv_msgs(sock, rd):
    msgs = []
    while not msgs:
        data = sock.recv(1 << 16)
        assert data, "server closed without replying"
        msgs = [wire.decode(p) for p in rd.feed(data)]
    return msgs


def _hello(address, batch, max_len=16):
    sock = wire.connect(address, timeout=10)
    sock.settimeout(10.0)
    sock.sendall(wire.encode_hello(wire.Hello(batch=batch, max_len=max_len)))
    rd = wire.FrameReader()
    return sock, rd, _recv_msgs(sock, rd)[0]


def test_session_errors(server):
    """The reference's refusals, with its messages."""
    sock, _, msg = _hello(server.address, 999)
    sock.close()
    assert isinstance(msg, wire.Error) and "server full" in msg.message
    with pytest.raises(wire.WireError, match="server full"):
        async_rpc.SocketWorker(None, address=server.address, batch=999,
                               max_len=16)
    with pytest.raises(wire.WireError, match="max_len"):
        async_rpc.SocketWorker(None, address=server.address, batch=1,
                               max_len=10_000)
    # vectors that do not match the lease: refused, and the session dropped
    sock, rd, ack = _hello(server.address, 2)
    try:
        assert isinstance(ack, wire.HelloAck)
        sock.sendall(wire.encode_request_arrays(wire.WireRequest(
            0, 3, np.ones(3, bool), np.zeros(3, np.int32),
            np.zeros(3, np.float32), np.zeros(12, np.int32))))
        (msg,) = _recv_msgs(sock, rd)
        assert isinstance(msg, wire.Error) and "session batch" in msg.message
        assert sock.recv(1 << 16) == b"", "the server must drop the session"
    finally:
        sock.close()
    # a v1 peer: an ERROR naming both versions
    sock = wire.connect(server.address, timeout=10)
    try:
        sock.settimeout(10.0)
        hello = wire.encode_hello(wire.Hello(batch=1, max_len=16))
        sock.sendall(hello[:6] + b"\x01" + hello[7:])
        (msg,) = _recv_msgs(sock, wire.FrameReader())
        assert isinstance(msg, wire.Error)
        assert "version 1" in msg.message and "3" in msg.message
    finally:
        sock.close()
    # churn frames are checked against the lease like requests
    sock, rd, ack = _hello(server.address, 2)
    try:
        sock.sendall(wire.encode_attach(99))
        (msg,) = _recv_msgs(sock, rd)
        assert isinstance(msg, wire.Error) and "lease" in msg.message
    finally:
        sock.close()


def test_engine_detached_after_wire_session(server):
    cfg, model, toks = _setup(batch=2, length=8)
    a = _engine(cfg, model, 2)
    a.session(_wire(server.address, 2)).run(toks)
    with pytest.raises(RuntimeError, match="remote correction server"):
        a.session().step(toks[:, 0])
    with pytest.raises(RuntimeError, match="remote correction server"):
        a.session(SessionConfig(mode="async", transport="inproc")).__enter__()


def test_dead_server_fails_the_client():
    """No silent local replay: once the server is gone, the next catch-up
    raises WireError."""
    cfg, model, toks = _setup(threshold=-1e9, batch=2, length=8)
    run = _serve(cfg, model, 2, "dead")
    sess = _engine(cfg, model, 2).session(_wire(run.srv.address, 0))
    try:
        sess.step(toks[:, 0])
    finally:
        run.stop()
    with pytest.raises(wire.WireError):
        for t in range(1, 8):
            sess.step(toks[:, t])


def test_churn_two_clients_against_one_server(server):
    """Two clients attach and detach mid-flight against one server at
    k = 2: each client's survivors keep their fixed-batch u and triggers
    bitwise, and the joiner starts bit-cold on its re-leased row."""
    S, detach_at, attach_at = 14, 5, 8
    cfg, model, _ = _setup()
    refs, streams = {}, {}
    for tag, seed in (("A", 1), ("B", 2)):
        stream = token_stream(cfg, 3, S, seed)
        fresh = token_stream(cfg, 1, S, seed + 2)[0]
        streams[tag] = (stream, fresh)
        refs[tag] = _engine(cfg, model, 3).session().run(stream)
        refs[tag + "d"] = _engine(cfg, model, 3).session().run(
            np.stack([stream[0], fresh, stream[2]]))
    engines = {tag: _engine(cfg, model, 3) for tag in "AB"}
    sessions = {tag: engines[tag].session(
        _wire(server.address, 2), streams=["a", "b", "c"]).__enter__()
        for tag in "AB"}
    outs = {tag: {sid: [] for sid in "abcd"} for tag in "AB"}
    attaches = server.stats["attaches"]
    try:
        for t in range(S):
            for tag, off in (("A", 0), ("B", 1)):
                sess, (stream, fresh) = sessions[tag], streams[tag]
                if t == detach_at + off:
                    sess.detach("b")
                if t == attach_at + off:
                    assert sess.attach("d") == 1
                toks = {sid: stream["abc".index(sid), t]
                        for sid in sess.streams if sid != "d"}
                if "d" in sess.streams:
                    toks["d"] = fresh[t - (attach_at + off)]
                r = sess.step(toks)
                for i, sid in enumerate(r["streams"]):
                    outs[tag][sid].append(
                        (r["u"][i], r["fhat"][i], r["triggered"][i]))
    finally:
        for sess in sessions.values():
            sess.close()
    for tag, off in (("A", 0), ("B", 1)):
        o = {sid: np.asarray(v) for sid, v in outs[tag].items() if v}
        for sid, row in (("a", 0), ("c", 2)):
            np.testing.assert_array_equal(o[sid][:, 0], refs[tag]["u"][row])
            np.testing.assert_array_equal(o[sid][:, 2],
                                          refs[tag]["triggered"][row])
            assert (o[sid][:, 1] <= o[sid][:, 0]).all()
        n_d = S - (attach_at + off)
        np.testing.assert_array_equal(o["d"][:, 0],
                                      refs[tag + "d"]["u"][1][:n_d])
        np.testing.assert_array_equal(o["d"][:, 2],
                                      refs[tag + "d"]["triggered"][1][:n_d])
        w = engines[tag].comms.report()["wire"]
        assert w["tx_bytes"] > 0 and w["replies"] > 0
    assert server.stats["attaches"] - attaches == 2


def test_traced_wire_sessions(server):
    """Strict sync over the socket is deterministic, so traced equals
    untraced bitwise, fhat included, and the wire spans are there; a
    pipelined traced session keeps the monitor path and fills the RTT
    breakdown in the session's registry."""
    cfg, model, toks = _setup()
    r0 = _engine(cfg, model, 3).session(_wire(server.address, None)).run(toks)
    sess = _engine(cfg, model, 3).session(
        _wire(server.address, None, trace=True))
    r1 = sess.run(toks)
    for key in ("u", "fhat", "triggered"):
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)
    names = {s.name for s in sess.tracer.spans()}
    assert {"wire.encode", "wire.request", "wire.socket", "server.queue",
            "server.catchup"} <= names
    sess = _engine(cfg, model, 3).session(_wire(server.address, 3,
                                                trace=True))
    r2 = sess.run(toks)
    np.testing.assert_array_equal(r2["u"], r0["u"])
    np.testing.assert_array_equal(r2["triggered"], r0["triggered"])
    snap = sess.metrics()
    assert snap["rtt_s_n"] > 0 and snap["rtt_queue_s_n"] > 0


def test_cascade_over_wire(server):
    """Both rungs of the cascade over the socket, each in its own tier
    bucket, fhat <= u at every rung."""
    cfg, model, toks = _setup()
    casc = CascadeSession(
        _engine(cfg, model, 3).session(_wire(server.address, None)),
        _engine(cfg, model, 3).session(_wire(server.address, None)),
        escalate_above=0.05)
    out = casc.run(toks)
    for key in ("fhat", "fhat_tier1", "fhat_tier2"):
        assert (out[key] <= out["u"]).all(), key
    assert out["escalated"].any()
    rep = out["comms"]
    assert rep["tier1"]["wire"]["tx_bytes"] > 0
    assert rep["tier2"]["wire"]["tx_bytes"] > 0


# -- a server ticked by hand ----------------------------------------------------

def _open_raw(srv, batch, coalesce=True, w=wire):
    sock = w.connect(srv.address, timeout=5)
    sock.sendall(w.encode_hello(w.Hello(batch=batch, max_len=16,
                                        coalesce=coalesce)))
    (ack,) = _collect(srv, sock, 1, w=w)
    assert isinstance(ack, w.HelloAck), ack
    return sock, ack


def _collect(srv, sock, n, w=wire):
    reader = w.FrameReader()
    sock.settimeout(0.0)
    msgs = []
    deadline = time.monotonic() + 30
    while len(msgs) < n:
        assert time.monotonic() < deadline, "no reply within 30 s"
        srv.serve_tick(0.001)
        try:
            data = sock.recv(1 << 16)
        except (BlockingIOError, socket.timeout):
            continue
        assert data, "server closed"
        msgs.extend(w.decode(p) for p in reader.feed(data))
    return msgs


def _bye(srv, sock, w=wire):
    sock.sendall(w.encode_bye())
    sock.close()
    for _ in range(10):
        srv.serve_tick(0.001)


def _coalescing_frames(w, hist):
    u1 = np.asarray([0.7, 0.0], np.float32)
    u2 = np.asarray([0.9, 0.4], np.float32)
    # r1: row 0 triggers at t=2 (backlog 0..2); r2: rows 0 and 1 at t=5
    # (row 0 backlog 3..5, row 1 0..5): a deep pipeline re-triggering
    r1 = w.encode_request(0, 2, np.array([True, False]),
                          np.array([0, 0], np.int32), u1, hist)
    r2 = w.encode_request(1, 5, np.array([True, True]),
                          np.array([3, 0], np.int32), u2, hist)
    return r1, r2


def _coalescing_session(srv, w):
    """TestCoalescing's frames: two requests merged into one replay, then
    the same two replayed one by one by a coalesce=False session on the
    same (reset) rows.  Returns the four replies."""
    hist = np.random.default_rng(0).integers(0, 255, (2, 16)).astype(np.int32)
    sock, _ = _open_raw(srv, 2, w=w)
    r1, r2 = _coalescing_frames(w, hist)
    sock.sendall(r1 + r2)
    merged = _collect(srv, sock, 2, w=w)
    _bye(srv, sock, w)
    assert not srv._sessions, "BYE must free the session"
    sock, ack = _open_raw(srv, 2, coalesce=False, w=w)
    assert ack.slot_lo == 0, "freed rows are reused (and reset)"
    sock.sendall(r1 + r2)
    single = _collect(srv, sock, 2, w=w)
    sock.close()
    return merged + single


def test_merged_replay_equals_per_request_replay():
    cfg, model, _ = _setup()
    srv = CorrectionServer(cfg, model, slots=2, max_len=16,
                           uds=_uds_path("coal"), device="cpu")
    try:
        rep1, rep2, p1, p2 = _coalescing_session(srv, wire)
        assert (rep1.req_id, rep2.req_id) == (0, 1), "FIFO per session"
        assert rep1.coalesced == rep2.coalesced == 2
        assert p1.coalesced == p2.coalesced == 1
        assert srv.stats["replays"] == 3 and srv.stats["coalesced"] == 1
        # the merge replays row 0 through t=5 once: both replies carry the
        # fresher corrector; per request, r1's is the staler t=2 one
        np.testing.assert_array_equal(rep1.v[0], rep2.v[0])
        np.testing.assert_array_equal(rep2.v, p2.v)
        np.testing.assert_array_equal(rep2.fhat, p2.fhat)
        assert not np.array_equal(rep1.v[0], p1.v[0])
    finally:
        srv.close()


_PAIR = {}


def _pair():
    """The reference's PRNGKey(0) weights in both packages, a token
    stream and a mixed-trigger threshold from the port's scan."""
    if not _PAIR:
        jcfg, tcfg, params, model = collab_pair("granite-8b")
        toks = token_stream(tcfg, 3, 16)
        probe = _engine(tcfg, model, 3).session(
            SessionConfig(mode="scan")).run(toks)
        thr = float(np.quantile(probe["u"], 0.7))
        _PAIR.update(jcfg=with_threshold(jcfg, thr),
                     tcfg=with_threshold(tcfg, thr), params=params,
                     model=model, toks=toks)
    return _PAIR


def test_same_frames_to_both_servers():
    """The JAX server and the port's, on the same weights, answer the same
    frame sequence alike."""
    p = _pair()
    servers = [JServer(p["jcfg"], p["params"], slots=2, max_len=16,
                       uds=_uds_path("jsame")),
               CorrectionServer(p["tcfg"], p["model"], slots=2, max_len=16,
                                uds=_uds_path("tsame"), device="cpu")]
    try:
        jr, tr = (_coalescing_session(srv, w)
                  for srv, w in zip(servers, (jwire, wire)))
        for a, b in zip(jr, tr):
            assert (a.req_id, a.t, a.coalesced) == (b.req_id, b.t,
                                                    b.coalesced)
            np.testing.assert_array_equal(a.triggered, b.triggered)
            np.testing.assert_allclose(a.v, b.v, atol=1e-4)
            np.testing.assert_allclose(a.fhat, b.fhat, atol=1e-4)
        keys = ("requests", "replays", "coalesced", "sessions", "attaches",
                "detaches", "defrags")
        assert ({k: servers[0].stats[k] for k in keys}
                == {k: servers[1].stats[k] for k in keys})
    finally:
        for srv in servers:
            srv.close()


def test_defrag_keeps_a_clients_rows_bitwise():
    """Three leases of 2 rows; the middle one leaves, and the last moves
    down to close the hole: its cache rows and history mirror are bitwise
    what they were, and its next replay continues from them."""
    cfg, model, _ = _setup()
    srv = CorrectionServer(cfg, model, slots=7, max_len=16,
                           uds=_uds_path("defrag"), device="cpu")
    try:
        hist = np.random.default_rng(1).integers(0, 255, (2, 16)).astype(
            np.int32)
        socks = [_open_raw(srv, 2)[0] for _ in range(3)]
        for sock in socks:
            sock.sendall(wire.encode_request(
                0, 4, np.array([True, True]), np.zeros(2, np.int32),
                np.zeros(2, np.float32), hist))
            _collect(srv, sock, 1)
        before = {n: [x[:, 4:6].clone() for x in e]
                  for n, e in srv._cache.items()}
        hist_before = srv._history[4:6].copy()
        _bye(srv, socks[1])
        assert srv.stats["defrags"] == 1 and srv.fragmentation() == 0.0
        live = sorted(s.lo for s in srv._sessions.values())
        assert live == [0, 2]
        for n, e in srv._cache.items():
            for x, y in zip(e, before[n]):
                assert torch.equal(x[:, 2:4], y), n
        np.testing.assert_array_equal(srv._history[2:4], hist_before)
        # the moved client continues from its rows: its next replay
        # matches the first client's, which never moved and was fed the
        # same frames
        for sock in (socks[0], socks[2]):
            sock.sendall(wire.encode_request(
                1, 7, np.array([True, True]), np.full(2, 5, np.int32),
                np.zeros(2, np.float32), hist))
        (r0,), (r2,) = _collect(srv, socks[0], 1), _collect(srv, socks[2], 1)
        np.testing.assert_allclose(r0.v, r2.v, atol=1e-6)
        for sock in (socks[0], socks[2]):
            sock.close()
    finally:
        srv.close()


def test_drain_goaway_and_refusal():
    """request_drain: the next tick sends GOAWAY to every leased session and
    refuses new HELLOs (the reference's "draining" error); a port client on
    a direct address leaves once its pipeline is empty, with WireError,
    and serve_forever returns when no session is left."""
    cfg, model, toks = _setup(threshold=-1e9, batch=2, length=4)
    srv = CorrectionServer(cfg, model, slots=4, max_len=ML,
                           uds=_uds_path("drain"), device="cpu")
    try:
        sock, _ = _open_raw(srv, 2)
        srv.request_drain()
        (msg,) = _collect(srv, sock, 1)
        assert isinstance(msg, wire.GoAway) and msg.reason == "draining"
        with pytest.raises(wire.HandshakeRefused, match="draining"):
            th = threading.Thread(target=lambda: [srv.serve_tick(0.01)
                                                  for _ in range(200)])
            th.start()
            try:
                wire.connect_hello(srv.address, wire.Hello(2, 16),
                                   timeout=5.0)
            finally:
                th.join(timeout=10)
        assert srv.stats["refused_draining"] == 1
        _bye(srv, sock)
        srv.serve_forever(stop=threading.Event())  # returns: drained, empty
        assert not srv._sessions
    finally:
        srv.close()
    run = _serve(cfg, model, 2, "drain2")
    try:
        sess = _engine(cfg, model, 2).session(_wire(run.srv.address, None))
        sess.step(toks[:, 0])
        run.srv.request_drain()
        # a step's wait reads the GOAWAY (with this step's reply or the
        # next one's); the pipeline is then empty, and a direct address
        # has no sibling to move to
        with pytest.raises(wire.WireError, match="draining"):
            for t in range(1, 4):
                sess.step(toks[:, t])
    finally:
        run.stop()


# -- refusals, no fallback --------------------------------------------------------

@pytest.mark.parametrize("what,item", [("shm", "item 6"), ("mesh", "item 8")])
def test_unported_server_options_raise(what, item):
    """Both options are ported now.  ``mesh`` (item 8): the server never
    places shards virtually on its own (a spec asks for cards, and this
    host has none), while its launcher does, printing so, and serves.
    ``shm`` (item 6): the launcher's ``--transport shm`` server offers a
    shared-memory arena at HELLO, a client maps it, and no arena file is
    left behind."""
    from repro_torch.serving import shm
    cfg, model, _ = _setup()
    if what == "mesh":
        with pytest.raises(ValueError, match="needs 2 devices"):
            CorrectionServer(cfg, model, uds=_uds_path(what), device="cpu",
                             mesh="data:2")
        uds = _uds_path("climesh")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.server", "--arch",
             "paper-synthetic-serving", "--device", "cpu", "--uds", uds,
             "--mesh", "data:2", "--ready-file", uds + ".ready"],
            env={**os.environ, "PYTHONPATH": os.path.join(
                os.path.dirname(__file__), "..", "src")},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            deadline = time.monotonic() + SPAWN_DEADLINE_S
            while not os.path.exists(uds + ".ready"):
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.05)
        finally:
            proc.terminate()
            out = proc.communicate(timeout=60)[0]
        assert "2 virtual devices on cpu" in out, out
        assert "mesh=data:2 listening" in out, out
        return
    uds = _uds_path("cli")
    ready = uds + ".ready"
    run = threading.Thread(target=launcher.main, args=([
        "--arch", "paper-synthetic-serving", "--device", "cpu", "--uds", uds,
        "--transport", "shm", "--ready-file", ready, "--idle-exit-s",
        "0.2"],), daemon=True)
    run.start()
    deadline = time.monotonic() + 60
    while not os.path.exists(ready):
        assert run.is_alive() and time.monotonic() < deadline
        time.sleep(0.02)
    sock, ack, _, _, _, peer, reason = shm.connect_hello_shm(
        uds, wire.Hello(2, 8, shm=True), timeout=10)
    try:
        assert peer is not None and reason == "", reason
        assert ack.ring_bytes == shm.DEFAULT_RING_BYTES
    finally:
        peer.close()
        sock.close()
    run.join(timeout=60)
    assert not run.is_alive(), "the launcher exits once idle"
    assert no_stray_arenas()


def test_server_and_launcher_default_to_the_card(monkeypatch):
    cfg, model, _ = _setup()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CorrectionServer(cfg, model, uds=_uds_path("card"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--arch", "paper-synthetic-serving", "--uds",
                       _uds_path("cardcli")])


# -- two processes ----------------------------------------------------------------

def test_jax_client_against_the_port_launcher(tmp_path):
    """``python -m repro_torch.launch.server --device cpu`` restores a
    checkpoint the JAX package wrote; a JAX client on those weights serves
    against it, pipelined: u and triggers are its own sync run's, fhat <=
    u, server_pos and bytes equal, and the ready file's weight digest is
    the port's digest of the same weights."""
    p = _pair()
    ckpt = str(tmp_path / "ckpt")
    jckpt.save(ckpt, 0, p["params"])
    uds, ready = str(tmp_path / "s.sock"), str(tmp_path / "ready")
    proc = launcher.spawn_subprocess(
        "granite-8b", uds=uds, slots=4, max_len=ML, ready_file=ready,
        ckpt_dir=ckpt, extra_args=("--device", "cpu", "--idle-exit-s", "30"),
        timeout_s=SPAWN_DEADLINE_S)
    try:
        address, digest = launcher.read_ready(ready)
        assert address == uds
        assert digest == launcher.weights_digest(p["model"])
        toks = p["toks"]
        sync = JEngine(p["params"], p["jcfg"], batch=3, max_len=ML)
        r1 = sync.session().run(toks)
        eng = JEngine(p["params"], p["jcfg"], batch=3, max_len=ML)
        with eng.session(JSessionConfig(
                mode="async", max_staleness=2,
                transport=JTransportSpec("wire", address=uds))) as s:
            r = s.run(toks)
        np.testing.assert_array_equal(r["u"], r1["u"])
        np.testing.assert_array_equal(r["triggered"], r1["triggered"])
        assert 0.0 < np.asarray(r["triggered"]).mean() < 1.0
        assert (np.asarray(r["fhat"]) <= np.asarray(r["u"])).all()
        np.testing.assert_array_equal(eng.server_pos, sync.server_pos)
        assert r["comms"]["bytes_sent"] == r1["comms"]["bytes_sent"]
        w = r["comms"]["wire"]
        assert w["tx_bytes"] > 0 and w["rx_bytes"] > 0 and w["rtt_mean_s"] > 0
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
