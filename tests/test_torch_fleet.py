"""The port's correction-server fleet (repro_torch.serving.fleet) and the
failover of its ``fleet:`` sessions, on the CPU.

Mirrors tests/test_fleet.py on paper-synthetic SERVING with the port's own
seeded weights, reusing tests/_chaos.py's proxy by import: the health
state machine, routing and refusal, least-loaded routing, a kill
mid-flight in strict sync (the whole trace bitwise equal to the run
without it, the recovery charged to ``comms["failover"]``), a kill with
replies in flight (u and triggers bitwise, fhat <= u, requests resent), a
drain (zero streams dropped, the server retired, not replaced), a
redirect to a just-killed server, reap and respawn, a torn frame, a
duplicated and a delayed reply, random schedules of kills and churn, a
failover out of an shm session onto a wire sibling, and a SIGKILLed
``python -m repro_torch.launch.server`` subprocess.  Across packages on
granite-8b SMOKE (f32): a torch client routed by the JAX
``FleetSupervisor`` and a JAX client routed by the port's, each with its
server killed mid-run and the session finished on the sibling of the
other package: u and triggers exact against the client's own sync run
and, outside the tie band, against the other package's; fhat within 1e-4;
server_pos and bytes equal.
"""
import threading
import time
from contextlib import contextmanager

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from _chaos import ChaosProxy
from repro.serving import SessionConfig as JSessionConfig
from repro.serving import TransportSpec as JTransportSpec
from repro.serving.collaborative import CollaborativeEngine as JEngine
from repro.serving.fleet import FleetSupervisor as JFleet
from repro_torch.configs.paper_synthetic import SERVING
from repro_torch.core.decomposition import init_collab_lm
from repro_torch.data import tokens as tok
from repro_torch.serving import SessionConfig, TransportSpec, shm, wire
from repro_torch.serving.collaborative import CollaborativeEngine
from repro_torch.serving.fleet import (PENDING_TTL_S, FleetSupervisor,
                                       ServerHandle, resolve_route)

from _torch_parity import (check_across, no_stray_arenas, serve_case,
                           with_threshold)

BATCH, STEPS, MAX_LEN = 4, 24, 32


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_WORLD = {}


def _world():
    """paper-synthetic SERVING at threshold 0.1, the port's seeded weights
    and a (BATCH, STEPS) token stream."""
    if not _WORLD:
        cfg = with_threshold(SERVING, 0.1)
        model = init_collab_lm(cfg, torch.Generator().manual_seed(0), "cpu")
        stream = next(tok.lm_batches(0, cfg, BATCH, STEPS))["tokens"]
        _WORLD.update(cfg=cfg, model=model, stream=stream)
    return _WORLD["cfg"], _WORLD["model"], _WORLD["stream"]


@contextmanager
def fleet(cfg, model, *, n=2, slots=8, respawn=False, wrapper=None,
          shm=False, cls=FleetSupervisor, **kw):
    """A thread-backend fleet with a daemon supervisor loop ticking it."""
    sup = cls(backend="thread", n_servers=n, slots=slots, max_len=MAX_LEN,
              cfg=cfg, params=model, respawn=respawn,
              address_wrapper=wrapper, shm=shm, **kw)
    sup.start()
    stop = threading.Event()
    t = threading.Thread(target=sup.run_forever, args=(stop,), daemon=True)
    t.start()
    try:
        yield sup
    finally:
        stop.set()
        t.join(timeout=10)
        sup.close()


def port_fleet(cfg, model, **kw):
    return fleet(cfg, model, device="cpu", **kw)


def run_session(sup, cfg, model, stream, *, staleness, at=None,
                kind="wire"):
    """Serve ``stream`` step by step through the fleet's router, calling
    ``at[i](sup, eng, sess)`` after step i.  Returns (stacked traces, the
    comms report, the engine)."""
    eng = CollaborativeEngine(model, cfg, stream.shape[0], MAX_LEN,
                              device="cpu")
    conf = SessionConfig(mode="async", max_staleness=staleness,
                         transport=TransportSpec(
                             kind, address="fleet:" + sup.router_address))
    out = []
    with eng.session(conf) as s:
        for i in range(stream.shape[1]):
            out.append(s.step(stream[:, i]))
            if at and i in at:
                at[i](sup, eng, s)
        rep = s.report()
    res = {k: np.stack([np.asarray(o[k]) for o in out])
           for k in ("u", "fhat", "triggered")}
    return res, rep, eng


def victim_of(sup, eng):
    """The handle serving ``eng``'s worker."""
    return next(h for h in sup.servers.values()
                if h.address == eng._worker.server_address)


def wait_live(sup, n, timeout=30.0):
    deadline = time.monotonic() + timeout
    while len(sup.live_servers()) < n:
        assert time.monotonic() < deadline, \
            f"fleet never reached {n} live: " \
            f"{[(h.name, h.state) for h in sup.servers.values()]}"
        time.sleep(0.02)


def _kill_victim(sup, eng, s):
    victim_of(sup, eng).kill()


# -- the supervisor's health state machine (no sockets) ----------------------------

class _FakeHandle(ServerHandle):
    def __init__(self, name="f", alive=True, rec=None):
        super().__init__(name)
        self._alive, self._rec = alive, rec

    def alive(self):
        return self._alive

    def scrape(self):
        return self._rec


def test_starting_goes_live_on_first_heartbeat():
    h = _FakeHandle(rec=None)
    h.refresh(5.0)
    assert h.state == "starting"
    h._rec = {"ts": time.time(), "leased_rows": 2, "slots": 8,
              "address": "/tmp/x.sock"}
    h.refresh(5.0)
    assert h.state == "live" and h.address == "/tmp/x.sock"
    assert h.load() == 2 and h.free_rows() == 6


def test_stale_heartbeat_and_death_are_dead_and_a_drained_exit_retires():
    h = _FakeHandle(rec={"ts": time.time(), "slots": 8})
    h.refresh(5.0)
    h._rec = {"ts": time.time() - 60.0, "slots": 8}
    h.refresh(5.0)
    assert h.state == "dead", "a stale heartbeat is a hung server"
    h2 = _FakeHandle(rec={"ts": time.time(), "slots": 8})
    h2.refresh(5.0)
    h2._alive = False
    h2.refresh(5.0)
    assert h2.state == "dead"
    h3 = _FakeHandle(rec={"ts": time.time(), "slots": 8})
    h3.refresh(5.0)
    h3._rec = {"ts": time.time(), "slots": 8, "draining": True}
    h3.refresh(5.0)
    assert h3.state == "draining"
    h3._alive, h3._rec = False, None
    h3.refresh(5.0)
    assert h3.state == "stopped"


def test_pending_redirects_count_as_load_until_seen_or_expired():
    h = _FakeHandle(rec={"ts": time.time(), "leased_rows": 1, "slots": 8})
    h.refresh(5.0)
    h.pending.append((time.time(), 4))
    assert h.load() == 5
    h._rec = {"ts": time.time() + 0.001, "leased_rows": 5, "slots": 8}
    h.refresh(5.0)
    assert h.load() == 5
    h.pending.append((time.time() - 2 * PENDING_TTL_S, 4))
    assert h.load() == 5


# -- routing ---------------------------------------------------------------------

def test_router_redirects_refuses_and_picks_the_least_loaded():
    cfg, model, _ = _world()
    stream5 = next(tok.lm_batches(1, cfg, 5, 4))["tokens"]
    with port_fleet(cfg, model) as sup:
        wait_live(sup, 2)
        addrs = {h.address for h in sup.servers.values()}
        assert resolve_route(sup.router_address,
                             wire.Hello(batch=4, max_len=MAX_LEN)) in addrs
        with pytest.raises(wire.HandshakeRefused, match="no live"):
            resolve_route(sup.router_address,
                          wire.Hello(batch=20, max_len=MAX_LEN))
        eng = CollaborativeEngine(model, cfg, 5, MAX_LEN, device="cpu")
        conf = SessionConfig(mode="async", max_staleness=0,
                             transport="fleet:" + sup.router_address)
        with eng.session(conf) as s:
            s.step(stream5[:, 0])
            busy = victim_of(sup, eng)
            # 5 of busy's 8 rows are leased: 4 rows fit only on the sibling
            got = resolve_route(sup.router_address,
                                wire.Hello(batch=4, max_len=MAX_LEN))
            assert got != busy.address
        assert sup.stats["routed"] >= 2 and sup.stats["refused"] >= 1


# -- failover (thread backend) -----------------------------------------------------

def test_kill_mid_flight_strict_sync_is_bitwise():
    """A kill mid-run: the client re-HELLOs, replays from position 0, and
    the whole trace equals the run without the kill bitwise; the replay is
    charged to comms['failover'], not 'wire'."""
    cfg, model, stream = _world()
    with port_fleet(cfg, model) as sup:
        wait_live(sup, 2)
        ref, ref_rep, _ = run_session(sup, cfg, model, stream, staleness=0)
        got, rep, _ = run_session(sup, cfg, model, stream, staleness=0,
                                  at={10: _kill_victim})
    for k in ("u", "fhat", "triggered"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert 0.0 < ref["triggered"].mean() < 1.0, "need mixed triggers"
    assert ref_rep.get("failover") is None
    fo = rep["failover"]
    assert fo["failovers"] == 1
    assert fo["tx_bytes"] > 0 and fo["replayed_tokens"] > 0
    assert fo["replay_requests"] >= 1
    assert fo["replayed_tokens"] <= BATCH * STEPS
    assert rep["wire"]["tx_bytes"] <= ref_rep["wire"]["tx_bytes"]


def test_kill_during_pipelined_flight_recovers():
    cfg, model, stream = _world()
    with port_fleet(cfg, model) as sup:
        wait_live(sup, 2)
        ref, _, _ = run_session(sup, cfg, model, stream, staleness=2)
        got, rep, _ = run_session(sup, cfg, model, stream, staleness=2,
                                  at={12: _kill_victim})
    np.testing.assert_array_equal(got["u"], ref["u"])
    np.testing.assert_array_equal(got["triggered"], ref["triggered"])
    assert (got["fhat"] <= got["u"]).all()
    fo = rep["failover"]
    assert fo["failovers"] == 1 and fo["resent_requests"] >= 1


def test_drain_drops_zero_streams_and_retires():
    cfg, model, stream = _world()
    with port_fleet(cfg, model, respawn=True) as sup:
        wait_live(sup, 2)
        ref, _, _ = run_session(sup, cfg, model, stream, staleness=0)
        names = {}

        def drain(sup, eng, s):
            names["victim"] = victim_of(sup, eng).name
            sup.drain(names["victim"])

        got, rep, _ = run_session(sup, cfg, model, stream, staleness=0,
                                  at={8: drain})
        assert got["u"].shape == (STEPS, BATCH), "zero dropped streams"
        for k in ("u", "fhat", "triggered"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert rep["failover"]["failovers"] == 1
        h = sup.servers[names["victim"]]
        deadline = time.monotonic() + 20
        while h.state != "stopped":
            assert time.monotonic() < deadline, h.state
            time.sleep(0.02)
        assert sup.stats["retired"] >= 1 and sup.stats["respawns"] == 0


def test_kill_during_hello_retries_to_sibling_and_respawn():
    """A redirect to a just-killed server sends the client back to the
    router, onto the sibling, and no failover is charged; a killed server
    is reaped and replaced under a fresh name."""
    cfg, model, stream = _world()
    with port_fleet(cfg, model) as sup:
        wait_live(sup, 2)
        h0 = sup.servers["srv-0"]
        h0.kill()
        h0.state = "live"   # the router's view, one heartbeat stale
        seen = {}
        got, rep, _ = run_session(
            sup, cfg, model, stream, staleness=0,
            at={0: lambda sup, eng, s:
                seen.update(addr=eng._worker.server_address)})
        assert seen["addr"] == sup.servers["srv-1"].address
        rs = CollaborativeEngine(model, cfg, BATCH, MAX_LEN, device="cpu"
                                 ).session(SessionConfig(mode="scan")
                                           ).run(stream)
        np.testing.assert_array_equal(got["u"], np.asarray(rs["u"]).T)
        np.testing.assert_array_equal(got["triggered"],
                                      np.asarray(rs["triggered"]).T)
        assert rep.get("failover") is None
    with port_fleet(cfg, model, respawn=True) as sup:
        wait_live(sup, 2)
        sup.kill("srv-0")
        wait_live(sup, 2)
        assert sup.servers["srv-0"].state == "dead"
        assert "srv-2" in sup.servers, "a fresh name, never reuse"
        assert sup.stats["reaped"] >= 1 and sup.stats["respawns"] >= 1
        _, rep, _ = run_session(sup, cfg, model, stream, staleness=0)
        assert rep.get("failover") is None


# -- byte-level chaos (tests/_chaos.py's proxy) ---------------------------------

@pytest.mark.parametrize("fault", ["dup", "torn", "delay"])
def test_chaos_faults(fault):
    """A duplicated REPLY is dropped in place (no failover); a torn frame
    then EOF fails the session over; a delayed reply changes nothing but
    time.  Every trace equals the run without the fault bitwise."""
    cfg, model, stream = _world()
    proxy = ChaosProxy(seed=3)
    arm = {"dup": (5, proxy.dup_next_reply),
           "torn": (6, proxy.drop_mid_frame),
           "delay": (4, lambda: proxy.delay_next_reply(0.4))}[fault]
    try:
        with port_fleet(cfg, model, wrapper=proxy.wrap) as sup:
            wait_live(sup, 2)
            ref, _, _ = run_session(sup, cfg, model, stream, staleness=0)
            t0 = time.monotonic()
            got, rep, _ = run_session(sup, cfg, model, stream, staleness=0,
                                      at={arm[0]: lambda *_: arm[1]()})
            took = time.monotonic() - t0
    finally:
        proxy.close()
    for k in ("u", "fhat", "triggered"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    if fault == "dup":
        assert proxy.stats["duplicated"] == 1
        assert rep.get("failover") is None
    elif fault == "torn":
        assert proxy.stats["dropped_mid_frame"] == 1
        assert rep["failover"]["failovers"] >= 1
    else:
        assert proxy.stats["delayed"] == 1 and took >= 0.4


@settings(max_examples=3, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**31 - 1))
def test_random_schedule_keeps_fhat_safe_and_bytes_bounded(seed):
    """Random (kill step, staleness, churn step, stream) schedules: fhat <=
    u at every step after any failover, and the wire + failover bytes stay
    within the bound the meter's own request and token counts imply."""
    rng = np.random.default_rng(seed)
    steps = 16
    cfg, model, _ = _world()
    stream = next(tok.lm_batches(int(rng.integers(0, 1000)), cfg, BATCH,
                                 steps))["tokens"]
    staleness = int(rng.choice([0, 1, 2]))
    kill_at = int(rng.integers(3, steps - 3))
    churn_at = int(rng.integers(2, steps - 2))

    def churn(sup, eng, s):
        sid = s.streams[int(rng.integers(0, BATCH))]
        s.detach(sid)
        s.attach(("fresh", sid))

    at = {kill_at: _kill_victim}
    if churn_at != kill_at:
        at[churn_at] = churn
    with port_fleet(cfg, model, respawn=True) as sup:
        wait_live(sup, 2)
        got, rep, eng = run_session(sup, cfg, model, stream,
                                    staleness=staleness, at=at)
    assert (got["fhat"] <= got["u"]).all(), f"fhat > u (seed={seed})"
    fo = rep["failover"]
    assert fo["failovers"] >= 1
    comms = eng.comms
    n_req = comms.dispatched + fo["replay_requests"] + fo["resent_requests"]
    n_tok = comms.tokens_shipped + fo["replayed_tokens"]
    bound = ((fo["failovers"] + 1) * (160 + 16 * BATCH)
             + n_req * (64 + 16 * BATCH) + 4 * n_tok)
    total = rep["wire"]["tx_bytes"] + fo["tx_bytes"]
    assert 0 < total <= bound, (total, bound, seed)


def test_fleet_failover_from_shm_onto_a_wire_sibling():
    """Kill an shm server mid-flight: the worker re-HELLOs through the
    router onto a sibling that offers no arena and finishes over the wire,
    u and triggers bitwise the run without the kill, fhat <= u, and no
    arena file left."""
    cfg, model, stream = _world()
    with port_fleet(cfg, model, shm=True) as sup:
        wait_live(sup, 2)
        ref, ref_rep, _ = run_session(sup, cfg, model, stream, staleness=4,
                                      kind="shm")
        assert ref_rep["shm"]["replies"] > 0

        def arm(sup_, eng, s):
            victim = victim_of(sup_, eng)
            for h in sup_.servers.values():
                if h is not victim:
                    h.srv.shm = False   # the sibling stops offering shm
            victim.kill()

        res, rep, _ = run_session(sup, cfg, model, stream, staleness=4,
                                  kind="shm", at={10: arm})
    np.testing.assert_array_equal(res["u"], ref["u"])
    np.testing.assert_array_equal(res["triggered"], ref["triggered"])
    assert (res["fhat"] <= res["u"]).all()
    assert rep["failover"]["failovers"] >= 1
    assert rep["shm"]["replies"] > 0 and rep["wire"]["replies"] > 0
    assert no_stray_arenas()


def test_subprocess_sigkill_recovers_bitwise():
    """Two ``python -m repro_torch.launch.server --device cpu`` processes
    behind the router, a strict-sync client, a real SIGKILL mid-flight:
    the per-row trace equals the run without it bitwise."""
    cfg, model, _ = _world()
    batch, steps, max_len = 16, 20, 24
    stream = next(tok.lm_batches(0, cfg, batch, steps))["tokens"]
    sup = FleetSupervisor("paper-synthetic-serving", n_servers=2,
                          slots=batch, max_len=max_len, backend="subprocess",
                          respawn=False, device="cpu")
    stop = threading.Event()
    t = threading.Thread(target=sup.run_forever, args=(stop,), daemon=True)
    try:
        sup.start(wait=True)
        t.start()
        wait_live(sup, 2, timeout=60.0)

        def run(at=None):
            eng = CollaborativeEngine(model, cfg, batch, max_len,
                                      device="cpu")
            conf = SessionConfig(mode="async", max_staleness=0,
                                 transport="fleet:" + sup.router_address)
            out = []
            with eng.session(conf) as s:
                for i in range(steps):
                    out.append(s.step(stream[:, i]))
                    if at and i in at:
                        at[i](eng)
                rep = s.report()
            return ({k: np.stack([o[k] for o in out])
                     for k in ("u", "fhat", "triggered")}, rep)

        ref, ref_rep = run()
        got, rep = run(at={9: lambda eng: victim_of(sup, eng).kill()})
        for k in ("u", "fhat", "triggered"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert 0.0 < got["triggered"].mean() < 1.0, "need mixed triggers"
        fo = rep["failover"]
        assert fo["failovers"] == 1 and fo["replayed_tokens"] > 0
        assert ref_rep.get("failover") is None
    finally:
        stop.set()
        t.join(timeout=10)
        sup.close()


# -- across packages ---------------------------------------------------------------

B, ML, S = 3, 32, 16
_CASE = {}


def _case():
    if not _CASE:
        _CASE.update(serve_case("granite-8b", B, ML, S))
    return _CASE


@pytest.mark.parametrize("client", ["torch", "jax"])
def test_client_routed_by_the_other_packages_fleet(client):
    """A torch client through the JAX supervisor's router, and a JAX client
    through the port's, strict sync, its server killed after step 6: the
    session finishes on the sibling and holds to both packages' sync
    runs."""
    c = _case()
    if client == "torch":
        ctx = fleet(c["jcfg"], c["params"], cls=JFleet)
        eng = CollaborativeEngine(c["model"], c["tcfg"], B, ML, device="cpu")
        mk = lambda a: SessionConfig(mode="async", max_staleness=0,  # noqa
                                     transport="fleet:" + a)
        mine, other, sync = c["rt"], c["rj"], c["tsync"]
    else:
        ctx = port_fleet(c["tcfg"], c["model"])
        eng = JEngine(c["params"], c["jcfg"], batch=B, max_len=ML)
        mk = lambda a: JSessionConfig(  # noqa: E731
            mode="async", max_staleness=0,
            transport=JTransportSpec("wire", address="fleet:" + a))
        mine, other, sync = c["rj"], c["rt"], c["jsync"]
    with ctx as sup:
        wait_live(sup, 2)
        out = []
        with eng.session(mk(sup.router_address)) as s:
            for i in range(S):
                out.append(s.step(c["toks"][:, i]))
                if i == 6:
                    victim_of(sup, eng).kill()
            rep = s.report()
    r = {k: np.stack([np.asarray(o[k]) for o in out], 1)
         for k in ("u", "fhat", "triggered")}
    r["comms"] = rep
    band = check_across(r, mine, other, eng.server_pos, sync.server_pos,
                        c["thr"])
    print(f"{client} client through the other package's fleet: {band} of "
          f"{r['u'].size} entries in the tie band")
    assert rep["failover"]["failovers"] == 1
    for ref in (mine, other):
        np.testing.assert_allclose(r["fhat"], ref["fhat"], atol=1e-4)
