"""The port's monitoring loop (repro_torch.serving) end to end.

Parity: a JAX MonitorSession and a port session on the same weights and
token stream, in sync and in scan mode, agree on u and fhat within the
dtype's tolerance (f32 1e-4, bf16 2e-2), on ``triggered`` exactly outside
the tie band |u - thr| <= tol (each test prints the band's count), and
on the per-stream comms exactly.

Invariants the reference asserts of itself hold inside the port
(mirroring tests/test_serving.py:181-260 and the sync half of
tests/test_churn.py): scan equals a per-step loop bitwise, backlog
isolation, the bytes invariant, u-head truncation, and bit-cold attach.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decomposition as jdeco
from repro.models import api as japi
from repro.serving import SessionConfig as JSessionConfig
from repro.serving.collaborative import CollaborativeEngine as JEngine
from repro_torch.core import decomposition as tdeco
from repro_torch.core.gating import compact_correction
from repro_torch.models import api as tapi
from repro_torch.serving import MonitorSession, SessionConfig, TransportSpec
from repro_torch.serving.collaborative import CollaborativeEngine

from _torch_parity import (ARCHS, TOL_E2E, collab_pair, gap_threshold,
                           tie_band, token_stream, with_threshold)

B, S, MAX_LEN = 4, 16, 32


def _port_session(model, tcfg, thr, mode, **kw):
    return MonitorSession.open(
        model, tcfg, batch=B, max_len=MAX_LEN, device="cpu",
        config=SessionConfig(mode=mode, threshold=thr, trigger_margin=0.0,
                             **kw))


@pytest.fixture(scope="module", params=ARCHS)
def parity_case(request):
    """Weights, stream, a mixed-trigger threshold and the JAX traces."""
    jcfg, tcfg, params, model = collab_pair(request.param)
    stream = token_stream(tcfg, B, S, seed=3)
    probe = JEngine(params, jcfg, batch=B, max_len=MAX_LEN).session(
        JSessionConfig(mode="scan")).run(stream)
    thr, gap = gap_threshold(probe["u"])
    jcfg = with_threshold(jcfg, thr)
    ref = {mode: JEngine(params, jcfg, batch=B, max_len=MAX_LEN).session(
        JSessionConfig(mode=mode)).run(stream) for mode in ("sync", "scan")}
    return request.param, tcfg, model, stream, thr, gap, ref


@pytest.mark.parametrize("mode", ["sync", "scan"])
def test_session_matches_jax_session(parity_case, mode):
    arch, tcfg, model, stream, thr, gap, ref = parity_case
    tol = TOL_E2E[tcfg.dtype]
    got = _port_session(model, tcfg, thr, mode).run(stream)
    want = ref[mode]
    ties = tie_band(want["u"], thr, tol)
    print(f"\n{arch} {mode}: tie band |u-thr| <= {tol}: {int(ties.sum())} of "
          f"{ties.size} entries (threshold gap {gap:.3g}); trigger rate "
          f"{want['triggered'].mean():.3f}")
    assert 0 < want["triggered"].mean() < 1, "need mixed triggers"
    np.testing.assert_allclose(got["u"], want["u"], atol=tol, rtol=tol)
    np.testing.assert_allclose(got["fhat"], want["fhat"], atol=tol, rtol=tol)
    np.testing.assert_array_equal(got["triggered"][~ties],
                                  want["triggered"][~ties])
    for key in ("bytes_sent", "bytes_baseline"):
        np.testing.assert_array_equal(got["comms"]["per_stream"][key],
                                      want["comms"]["per_stream"][key])
    assert got["comms"]["trigger_rate"] == want["comms"]["trigger_rate"]


def _granite(threshold=0.1):
    _, tcfg, params, model = collab_pair("granite-8b")
    return with_threshold(tcfg, threshold), params, model


def test_sync_equals_scan_inside_the_port():
    tcfg, _, model = _granite()
    stream = token_stream(tcfg, 3, 20)
    r1 = CollaborativeEngine(model, tcfg, 3, 32, device="cpu").session().run(stream)
    r2 = CollaborativeEngine(model, tcfg, 3, 32, device="cpu").session(
        SessionConfig(mode="scan")).run(stream)
    assert 0 < r1["triggered"].mean() < 1
    np.testing.assert_array_equal(r1["u"], r2["u"])
    np.testing.assert_array_equal(r1["triggered"], r2["triggered"])
    np.testing.assert_allclose(r1["fhat"], r2["fhat"], atol=1e-6, rtol=0)
    assert r1["comms"]["bytes_sent"] == r2["comms"]["bytes_sent"]
    np.testing.assert_array_equal(r1["comms"]["per_stream"]["bytes_sent"],
                                  r2["comms"]["per_stream"]["bytes_sent"])
    assert (r1["fhat"] <= r1["u"]).all()


@torch.inference_mode()
def test_scan_bit_identical_to_per_step_loop():
    tcfg, _, model = _granite()
    stream = token_stream(tcfg, 3, 12)
    eng = CollaborativeEngine(model, tcfg, 3, 32, device="cpu")
    rs = eng.session(SessionConfig(mode="scan")).run(stream)
    m, ecfg = tcfg.monitor, tdeco.edge_arch(tcfg)
    ecache = tapi.init_cache(ecfg, 3, 32, "cpu")
    scache = tapi.init_cache(tcfg, 3, 32, "cpu")
    us, fhats, trigs = [], [], []
    for t in range(stream.shape[1]):
        tok = torch.as_tensor(stream[:, t]).long()
        _, eh = tapi.decode_step(model.edge, ecfg, ecache, tok, t)
        u = eng._u_head(model, eh)
        _, sh = tapi.decode_step(model.server, tcfg, scache, tok, t)
        fhat, _, _ = compact_correction(
            u, sh.float(),
            lambda buf: m.s * tdeco.sigma(eng._v_head(model, buf), m.sigma),
            m.threshold, m.trigger_margin, 3)
        us.append(u.numpy()); fhats.append(fhat.numpy())
        trigs.append((u > m.threshold - m.trigger_margin).numpy())
    np.testing.assert_array_equal(rs["u"], np.stack(us, 1))
    np.testing.assert_array_equal(rs["fhat"], np.stack(fhats, 1))
    np.testing.assert_array_equal(rs["triggered"], np.stack(trigs, 1))


def _stub_u(eng, values):
    """A deterministic per-stream monitor: stream i scores values[i]."""
    eng._u_head = lambda p, h: torch.as_tensor(values, dtype=torch.float32)


def test_backlog_isolation_and_bytes_invariant():
    """A trigger on stream 0 neither flushes stream 1's backlog nor moves
    its server position, cache rows or comms account; every token ships
    at most once."""
    tcfg, _, model = _granite(threshold=0.5)
    stream = token_stream(tcfg, 2, 12)
    eng = CollaborativeEngine(model, tcfg, 2, 32, device="cpu")
    _stub_u(eng, [1.0, -1.0])
    k_before = eng.server.cache["blocks"].k.clone()
    res = eng.session().run(stream)
    assert res["triggered"][0].all() and not res["triggered"][1].any()
    assert eng.server_pos[0] == 12 and eng.server_pos[1] == 0
    k_after = eng.server.cache["blocks"].k
    assert not torch.equal(k_after[:, 0], k_before[:, 0])
    assert torch.equal(k_after[:, 1], k_before[:, 1])
    per = res["comms"]["per_stream"]
    assert per["bytes_sent"][0] == per["bytes_baseline"][0] > 0
    assert per["bytes_sent"][1] == 0
    np.testing.assert_array_equal(res["fhat"][1], res["u"][1])
    assert (res["fhat"][0] < res["u"][0]).all()
    # mixed triggers on a real monitor: the meter agrees with the trace
    eng = CollaborativeEngine(model, tcfg, 2, 32, device="cpu")
    res = eng.session().run(stream)
    per = res["comms"]["per_stream"]
    assert (per["bytes_sent"] <= per["bytes_baseline"]).all()
    for i in range(2):
        idx = np.where(res["triggered"][i])[0]
        assert per["bytes_sent"][i] == ((idx[-1] + 1) if len(idx) else 0) * 8


def test_u_head_applies_truncation():
    """Serving u with a truncated n equals the training-side u (the JAX
    reference's edge forward with the same Eq.-8 mask), and differs from
    the full-basis u."""
    tcfg, params, model = _granite()
    jcfg = with_threshold(collab_pair("granite-8b")[0], 0.1)
    stream = token_stream(tcfg, 2, 8)
    n = tcfg.monitor.n_features // 2
    res = CollaborativeEngine(model, tcfg, 2, 16, device="cpu",
                              monitor_n=n).session().run(stream)
    eout = japi.forward(params["edge"], jdeco.edge_arch(jcfg),
                        {"tokens": jnp.asarray(stream)})
    hd = params["u_head"]
    feats = jnp.tanh(eout["hidden"].astype(jnp.float32) @ hd["w_feat"]["w"])
    mask = (jnp.arange(feats.shape[-1]) < n).astype(jnp.float32)
    u_train = feats @ (hd["a"] * mask) + jax.nn.softplus(hd["raw_t"])
    np.testing.assert_allclose(res["u"], np.asarray(u_train), atol=2e-3,
                               rtol=2e-3)
    full = CollaborativeEngine(model, tcfg, 2, 16, device="cpu").session().run(stream)
    assert not np.allclose(res["u"], full["u"])


def test_churn_survivors_exact_and_attach_bit_cold():
    """Sync-mode churn: streams present the whole run are bit-identical to
    a fixed-batch run, a detached slot accrues nothing, and a re-attached
    slot starts bit-cold (caches, history, positions) and matches a fresh
    engine."""
    tcfg, _, model = _granite()
    n_steps, detach_at, attach_at = 12, 4, 7
    stream = token_stream(tcfg, 3, n_steps)
    fresh = token_stream(tcfg, 1, n_steps, seed=7)[0]
    ref = CollaborativeEngine(model, tcfg, 3, 32, device="cpu").session().run(stream)
    ref_d = CollaborativeEngine(model, tcfg, 3, 32, device="cpu").session().run(
        np.stack([stream[0], fresh, stream[2]]))
    eng = CollaborativeEngine(model, tcfg, 3, 32, device="cpu")
    outs = {sid: [] for sid in "abcd"}
    with eng.session(streams=["a", "b", "c"]) as s:
        for t in range(n_steps):
            if t == detach_at:
                s.detach("b")
                seen_at_detach = int(eng.comms.tokens_seen[1])
            if t == attach_at:
                assert s.attach("d") == 1
                assert eng.edge_pos[1] == 0 and eng.server_pos[1] == 0
                assert not eng._history[1].any()
                for c in (eng.edge.cache, eng.server.cache):
                    assert not c["blocks"].k[:, 1].any()
                    assert not c["blocks"].v[:, 1].any()
            toks = {sid: stream["abc".index(sid), t]
                    for sid in s.streams if sid != "d"}
            if "d" in s.streams:
                toks["d"] = fresh[t - attach_at]
            r = s.step(toks)
            for i, sid in enumerate(r["streams"]):
                outs[sid].append((r["u"][i], r["fhat"][i], r["triggered"][i]))
    tr = {sid: [np.asarray(x) for x in zip(*o)] for sid, o in outs.items() if o}
    for sid, row in (("a", 0), ("c", 2)):
        for k, key in enumerate(("u", "fhat", "triggered")):
            np.testing.assert_array_equal(tr[sid][k], ref[key][row])
    np.testing.assert_array_equal(tr["b"][0], ref["u"][1][:detach_at])
    assert seen_at_detach == detach_at
    assert eng.comms.tokens_seen[1] == detach_at + n_steps - attach_at
    for k, key in enumerate(("u", "fhat", "triggered")):
        np.testing.assert_array_equal(tr["d"][k],
                                      ref_d[key][1][:n_steps - attach_at])
    with pytest.raises(RuntimeError, match="full"):
        eng.session(streams=["a", "b", "c"]).attach("x")


def test_session_config_refuses_unported_paths():
    """Every session feature is ported.  The recompile guard (item 10)
    arms over the engine's serving paths (those the warmup ran) and reports
    no violation on an unchanged session.  Mesh sharding (item 8) is ported: the
    spec parses, and a session never places shards virtually on its own
    (this host has no card).  The wire, shm and fleet transports are
    ported: a spec without an address, or with a simulated latency, is
    refused as the reference refuses it, and the addresses parse
    (``fleet:`` is shorthand for wire through a router)."""
    from repro_torch.serving.mesh import MeshSpec
    assert SessionConfig(mesh="data:8").mesh == MeshSpec.parse("data:8")
    for kind in ("wire", "shm"):
        with pytest.raises(ValueError, match=f"{kind} transport needs an "
                           "address"):
            SessionConfig(mode="async", transport=kind)
        with pytest.raises(ValueError, match="measured on the real socket"):
            TransportSpec(kind, address="/tmp/x.sock", latency_s=0.01)
    for text, want in (("wire:host:5555", ("wire", "host:5555")),
                       ("shm:/tmp/x.sock", ("shm", "/tmp/x.sock")),
                       ("fleet:/tmp/router.sock",
                        ("wire", "fleet:/tmp/router.sock"))):
        spec = SessionConfig(mode="async", transport=text).transport
        assert (spec.kind, spec.address, spec.coalesce) == want + (True,)
    spec = TransportSpec("shm", address="fleet:/tmp/router.sock")
    assert (spec.kind, spec.address) == ("shm", "fleet:/tmp/router.sock")
    tcfg, _, model = _granite()
    with pytest.raises(ValueError, match="needs 2 devices"):
        MonitorSession.open(model, tcfg, batch=2, max_len=8, device="cpu",
                            config=SessionConfig(mesh="data:2")).step([1, 2])
    guarded = MonitorSession.open(model, tcfg, batch=2, max_len=8,
                                  device="cpu")
    guarded.step([1, 2])
    # warm_only: the catch-up may stay cold through a one-step warmup
    guard = guarded.arm_recompile_guard(warm_only=True)
    guarded.step([3, 4])
    assert guard.armed and guard.violations() == []
    guard.assert_stable(allow_global=0)
    sess = MonitorSession.open(model, tcfg, batch=2, max_len=8, device="cpu",
                               config=SessionConfig(mode="scan"))
    with pytest.raises(RuntimeError, match="offline"):
        sess.step([1, 2])
    with pytest.raises(RuntimeError, match="fixed membership"):
        sess.detach(0)
