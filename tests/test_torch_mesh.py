"""The port's mesh-sharded serving (repro_torch.serving.mesh), mirroring
tests/test_mesh.py on the CPU: spec parsing, every serving path of a
data:8 engine over 8 virtual shards (``MeshSpec.build([cpu] * 8)``), the
collective-free monitor path, shard-local row resets and the correction
server's lease defrag on a sharded super-batch.

The bars differ by comparison.  torch's CPU GEMM rows are not bitwise
across batch sizes, so a sharded engine (2 rows a shard) is not bitwise
the unsharded one (16).  Inside the port, bitwise: data:1 against the
unsharded engine, and shard i of a data:8 engine against an unsharded
engine of 2 rows fed shard i's streams.  Against the reference
(granite-8b SMOKE, f32, its weights carried by the bridge, its engine
unsharded: the reference asserts sharded == unsharded bitwise): scores
within 1e-4, triggers exact outside the tie band, whose size is printed.
Where the scan's capacity binds (5 of 16) the compaction is global, so a
shard is no engine of 2 rows: ``served`` is held to the unsharded
engines', fhat within the tolerance, and, bitwise, to a plain global
compaction over the shards' own u and server hiddens.
"""
import os
import socket
import tempfile
import threading

import numpy as np
import pytest
import torch

from repro.serving import SessionConfig as JSessionConfig
from repro.serving.collaborative import CollaborativeEngine as JEngine
from repro_torch.core import decomposition as deco
from repro_torch.core.gating import compact_correction
from repro_torch.models import api as model_api
from repro_torch.serving import SessionConfig, TransportSpec, async_rpc, wire
from repro_torch.serving import mesh as mesh_mod
from repro_torch.serving.collaborative import CollaborativeEngine
from repro_torch.serving.engine import CACHE_BATCH_AXIS, _entries
from repro_torch.serving.server import CorrectionServer, Session

from _torch_parity import (TOL_E2E, collab_pair, gap_threshold, tie_band,
                           token_stream, with_threshold)

B, L, ML, N = 16, 12, 16, 8
MESH = "data:8"
CPU = torch.device("cpu")
TOL = TOL_E2E["float32"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def virtual(spec=MESH):
    spec = mesh_mod.MeshSpec.parse(spec)
    return spec.build([CPU] * spec.n_devices)


_CASE = {}


def case():
    """granite-8b SMOKE in both packages on the same weights, a (16, 12)
    stream and a mixed-trigger threshold in the widest gap of the port's
    scan u; the reference's unsharded runs."""
    if not _CASE:
        torch.set_num_threads(1)
        jcfg, tcfg, params, model = collab_pair("granite-8b")
        toks = token_stream(tcfg, B, L)
        probe = CollaborativeEngine(model, tcfg, B, ML, device="cpu").session(
            SessionConfig(mode="scan")).run(toks)
        thr, _ = gap_threshold(probe["u"])
        # a second point, about half the rows triggering, where a
        # capacity of 5 of 16 binds
        thr5, _ = gap_threshold(probe["u"], 0.35, 0.6)
        ref = {}
        for name, cap, mode, point in (
                ("sync", None, "sync", thr), ("scan", None, "scan", thr),
                ("scan5", 5, "scan", thr5)):
            eng = JEngine(params, with_threshold(jcfg, point), batch=B,
                          max_len=ML, capacity=cap)
            ref[name] = eng.session(JSessionConfig(mode=mode)).run(toks)
        _CASE.update(cfg=with_threshold(tcfg, thr),
                     cfg5=with_threshold(tcfg, thr5), model=model, toks=toks,
                     thr=thr, thr5=thr5, ref=ref)
    return _CASE


def engine(batch=B, mesh=None, cfg="cfg", **kw):
    c = case()
    return CollaborativeEngine(c["model"], c[cfg], batch, ML, device="cpu",
                               mesh=mesh, **kw)


def per_shard(run, n=N, **kw):
    """``run(engine, rows)`` on an unsharded engine of B/n rows for each
    shard's rows."""
    b = B // n
    return [run(engine(b, **kw), slice(i * b, (i + 1) * b)) for i in range(n)]


def caches_equal(a, b) -> bool:
    return all(torch.equal(x, y)
               for ea, eb in zip(a.values(), b.values())
               if ea is not None for x, y in zip(ea, eb))


def against_reference(got, want, keys=("u", "fhat")) -> int:
    """Scores within the end-to-end tolerance, triggers exact outside the
    tie band; returns the band's size (printed)."""
    thr = case()["thr"]
    for k in keys:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=TOL,
                                   err_msg=k)
    band = tie_band(np.asarray(want["u"]), thr, TOL)
    np.testing.assert_array_equal(got["triggered"][~band],
                                  np.asarray(want["triggered"])[~band])
    print(f"trigger tie band (|u - thr| <= {TOL}): {int(band.sum())} of "
          f"{band.size}")
    return int(band.sum())


class TestMeshSpec:
    def test_parse_roundtrip(self):
        for text in ("data:8", "data:1", "pod:2,data:4"):
            spec = mesh_mod.MeshSpec.parse(text)
            assert str(spec) == text
            assert mesh_mod.MeshSpec.parse(str(spec)) == spec
        assert mesh_mod.MeshSpec.parse("data:8").n_devices == 8
        assert mesh_mod.MeshSpec.parse("pod:2,data:4").data_size == 8
        spec = mesh_mod.MeshSpec.parse("data:4")
        assert mesh_mod.MeshSpec.parse(spec) is spec

    @pytest.mark.parametrize("bad", [
        "", "data", "8", "data:0", "data:-1", "data:x", "data:2,data:4",
        "model:8", "da ta:2"])
    def test_parse_rejects(self, bad):
        with pytest.raises(ValueError):
            mesh_mod.MeshSpec.parse(bad)

    def test_session_config_mesh_field_roundtrip(self):
        cfg = SessionConfig(mesh="data:8")
        assert isinstance(cfg.mesh, mesh_mod.MeshSpec)
        assert str(cfg.mesh) == "data:8"
        assert SessionConfig(mesh=cfg.mesh).mesh == cfg.mesh
        assert SessionConfig().mesh is None
        assert SessionConfig(mode="scan", mesh="data:2").mesh.n_devices == 2
        with pytest.raises(ValueError):
            SessionConfig(mesh="data:zero")

    def test_transport_spec_roundtrip_with_mesh_config(self):
        spec = TransportSpec.parse("wire:/tmp/corr.sock")
        assert (spec.kind, spec.address) == ("wire", "/tmp/corr.sock")
        assert TransportSpec.parse(spec) is spec
        cfg = SessionConfig(mode="async", transport=spec, mesh="data:8")
        assert cfg.transport == spec and str(cfg.mesh) == "data:8"

    def test_build_refuses_too_few_devices(self):
        # this host has no card: the first 8 CUDA devices do not exist
        with pytest.raises(ValueError, match="needs 8 devices"):
            mesh_mod.MeshSpec.parse("data:8").build()
        with pytest.raises(ValueError, match="8 positions"):
            mesh_mod.MeshSpec.parse("data:8").build([CPU] * 4)

    def test_build_places_data_shards(self):
        """Positions are row-major over the axes; a data shard's device is
        the position whose other coordinates are 0."""
        devs = [torch.device("cpu", i) for i in range(8)]
        mesh = mesh_mod.MeshSpec.parse("pod:2,data:2,model:2").build(devs)
        assert mesh.shape == {"pod": 2, "data": 2, "model": 2}
        assert mesh_mod.data_devices(mesh) == [devs[0], devs[2], devs[4],
                                               devs[6]]

    def test_engine_batch_must_divide(self):
        with pytest.raises(ValueError, match="divisible"):
            engine(3, mesh=virtual("data:2"))


class TestShardedPaths:
    def test_sharded_sync(self):
        c = case()
        eng = engine(mesh=virtual())
        res = eng.session(SessionConfig(mesh=MESH)).run(c["toks"])
        assert 0.0 < res["triggered"].mean() < 1.0, "need mixed triggers"

        def run(e, rows):
            return e, e.session().run(c["toks"][rows])

        for i, (e, r) in enumerate(per_shard(run)):
            rows = slice(e.batch * i, e.batch * (i + 1))
            for k in ("u", "fhat", "triggered"):
                np.testing.assert_array_equal(res[k][rows], r[k], err_msg=k)
            np.testing.assert_array_equal(eng.server_pos[rows], e.server_pos)
            np.testing.assert_array_equal(
                res["comms"]["per_stream"]["bytes_sent"][rows],
                r["comms"]["per_stream"]["bytes_sent"])
            assert caches_equal(eng.shards[i].server.cache, e.server.cache)
        against_reference(res, c["ref"]["sync"])
        # the super-batch state shrank per mesh position
        whole = mesh_mod._tree_bytes(engine().server.cache)
        assert mesh_mod.bytes_per_device(eng.server.cache) * N == whole

    def test_data1_is_the_unsharded_engine(self):
        c = case()
        ref = engine()
        r0 = ref.session().run(c["toks"])
        eng = engine(mesh=virtual("data:1"))
        r1 = eng.session(SessionConfig(mesh="data:1")).run(c["toks"])
        for k in ("u", "fhat", "triggered"):
            np.testing.assert_array_equal(r1[k], r0[k], err_msg=k)
        assert caches_equal(eng.shards[0].server.cache, ref.server.cache)
        s0 = ref.session(SessionConfig(mode="scan")).run(c["toks"])
        s1 = eng.session(SessionConfig(mode="scan")).run(c["toks"])
        for k in ("u", "fhat", "triggered", "served"):
            np.testing.assert_array_equal(s1[k], s0[k], err_msg=k)

    def test_sharded_scan(self):
        c = case()
        mesh_mod.reset_cross_shard_steps()
        res = engine(mesh=virtual()).session(
            SessionConfig(mode="scan", mesh=MESH)).run(c["toks"])
        # the capacity (B) does not bind: every shard compacts its rows
        assert mesh_mod.cross_shard_steps() == {}
        scans = per_shard(lambda e, rows: e.session(
            SessionConfig(mode="scan")).run(c["toks"][rows]))
        for k in ("u", "fhat", "triggered", "served"):
            np.testing.assert_array_equal(
                res[k], np.concatenate([s[k] for s in scans]), err_msg=k)
        against_reference(res, c["ref"]["scan"])
        np.testing.assert_array_equal(res["served"][res["triggered"]], 1.0)

    def test_sharded_scan_ragged_capacity(self):
        """capacity 5 of 16 over 8 shards: the compaction is global (one
        counted gather a step), not per shard."""
        c = case()
        mesh_mod.reset_cross_shard_steps()
        eng = engine(mesh=virtual(), capacity=5, cfg="cfg5")
        res = eng.session(SessionConfig(mode="scan", capacity=5,
                                        mesh=MESH)).run(c["toks"])
        assert mesh_mod.cross_shard_steps() == {"scan_gather": L}
        assert (res["served"].sum(axis=0) <= 5).all()
        assert (res["triggered"].sum(axis=0) > 5).any(), \
            "the capacity must bind"
        # bitwise: a plain global compaction over the shards' own u and
        # server hiddens (each shard decoded alone, at 2 rows)
        cfg, model, m = c["cfg5"], c["model"], c["cfg5"].monitor
        ecfg = deco.edge_arch(cfg)
        toks = torch.as_tensor(c["toks"]).long()
        b = B // N
        caches = [(model_api.init_cache(ecfg, b, ML, "cpu"),
                   model_api.init_cache(cfg, b, ML, "cpu")) for _ in range(N)]
        thr = torch.full((B,), np.float32(m.threshold - m.trigger_margin))
        with torch.inference_mode():
            for t in range(L):
                us, hs = [], []
                for i, (ec, sc) in enumerate(caches):
                    tok = toks[i * b:(i + 1) * b, t]
                    _, eh = model_api.decode_step(model.edge, ecfg, ec, tok,
                                                  t, with_logits=False)
                    us.append(eng._u_head(model, eh))
                    _, sh = model_api.decode_step(model.server, cfg, sc, tok,
                                                  t, with_logits=False)
                    hs.append(sh.float())
                fhat, served, _ = compact_correction(
                    torch.cat(us), torch.cat(hs),
                    lambda buf: m.s * deco.sigma(eng._v_head(model, buf),
                                                 m.sigma), thr, 0.0, 5)
                np.testing.assert_array_equal(res["fhat"][:, t], fhat.numpy())
                np.testing.assert_array_equal(res["served"][:, t],
                                              served.numpy())
        # against the unsharded engines (16 rows: GEMM rows differ): served
        # exact outside the tie band, fhat within the tolerance
        plain = engine(capacity=5, cfg="cfg5").session(
            SessionConfig(mode="scan", capacity=5)).run(c["toks"])
        for want in (plain, c["ref"]["scan5"]):
            band = tie_band(np.asarray(want["u"]), c["thr5"], TOL)
            # a tie anywhere in a step can reorder that step's selection
            steps = ~band.any(axis=0)
            np.testing.assert_array_equal(
                res["served"][:, steps], np.asarray(want["served"])[:, steps])
            np.testing.assert_allclose(res["fhat"], np.asarray(want["fhat"]),
                                       atol=TOL)
            print(f"scan at capacity 5: {int((~steps).sum())} of {L} steps "
                  "with a tie")

    @pytest.mark.parametrize("transport", ["inproc", "thread"])
    def test_sharded_async(self, transport):
        c = case()
        sync_eng = engine(mesh=virtual())
        sync = sync_eng.session().run(c["toks"])
        for k_stale in (0, 2):
            eng = engine(mesh=virtual())
            config = SessionConfig(mode="async", max_staleness=k_stale,
                                   transport=transport, mesh=MESH)
            with eng.session(config) as s:
                res = s.run(c["toks"])
            keys = ("u", "triggered") + (("fhat",) if k_stale == 0 else ())
            for k in keys:
                np.testing.assert_array_equal(res[k], sync[k], err_msg=k)
            np.testing.assert_array_equal(eng.server_pos, sync_eng.server_pos)
            assert (res["fhat"] <= res["u"]).all()
            for a, b in zip(eng.server.cache, sync_eng.server.cache):
                assert caches_equal(a, b)

    def test_stream_transport_needs_a_card(self):
        eng = engine(mesh=virtual())
        with pytest.raises(ValueError, match="CUDA"):
            eng.session(SessionConfig(mode="async", transport="stream",
                                      mesh=MESH)).step(case()["toks"][:, 0])

    def test_sharded_churn(self):
        """Attach/detach/reuse on a sharded engine: bitwise the same
        schedule on the owning shards' 2-row engines."""
        c = case()
        fresh = token_stream(c["cfg"], 2, L, seed=9)
        events = {4: [("detach", 1), ("attach", "n1")], 7: [("detach", 2)],
                  9: [("attach", "n2")]}
        born = {"n1": 4, "n2": 9}

        def drive(sess, ids):
            outs = []
            for t in range(L):
                for op, sid in events.get(t, []):
                    if op == "detach" and sid in sess.streams:
                        sess.detach(sid)
                    elif op == "attach" and (
                            (sid == "n1" and 1 in ids)
                            or (sid == "n2" and 2 in ids)):
                        sess.attach(sid)
                toks = {sid: (fresh[int(sid[1:]) - 1, t - born[sid]]
                              if isinstance(sid, str) else c["toks"][sid, t])
                        for sid in sess.streams}
                outs.append(sess.step(toks))
            return outs

        eng = engine(mesh=virtual())
        got = drive(eng.session(SessionConfig(mesh=MESH)), range(B))
        b = B // N
        parts = []
        for i in range(N):
            ids = list(range(i * b, (i + 1) * b))
            sub = engine(b)
            sess = sub.session(streams=ids)
            # the 2-row engine's slots are its streams' global ids
            parts.append((ids, drive(sess, ids)))
        for t in range(L):
            row = {}
            for ids, outs in parts:
                for sid, u, f, tr in zip(outs[t]["streams"], outs[t]["u"],
                                         outs[t]["fhat"],
                                         outs[t]["triggered"]):
                    row[sid] = (u, f, tr)
            assert tuple(got[t]["streams"]) == tuple(
                sid for sid in got[t]["streams"] if sid in row)
            for j, sid in enumerate(got[t]["streams"]):
                u, f, tr = row[sid]
                assert got[t]["u"][j] == u and got[t]["fhat"][j] == f \
                    and got[t]["triggered"][j] == tr, (t, sid)

    def test_attach_resets_only_the_owning_shard(self):
        c = case()
        eng = engine(mesh=virtual())
        sess = eng.session(SessionConfig(mesh=MESH))
        for t in range(4):
            sess.step(c["toks"][:, t])
        snap = [[x.clone() for tower in (sh.edge, sh.server)
                 for e in tower.cache.values() if e is not None for x in e]
                + [sh._history.clone()] for sh in eng.shards]
        sess.detach(5)
        assert sess.attach("new") == 5          # slot 5: shard 2, row 1
        for i, sh in enumerate(eng.shards):
            now = [x for tower in (sh.edge, sh.server)
                   for e in tower.cache.values() if e is not None
                   for x in e] + [sh._history]
            for x, y in zip(now, snap[i]):
                assert x.device == CPU
                if i != 2:
                    assert torch.equal(x, y)
                else:   # only row 1 of shard 2 went to zero
                    axis = 0 if x is sh._history else 1
                    keep = y.index_select(axis, torch.tensor([0]))
                    assert torch.equal(x.index_select(axis, torch.tensor([0])),
                                       keep)
                    assert not x.index_select(axis, torch.tensor([1])).any()

    def test_sharded_wire(self):
        """A data:8 client in sync mode over the wire against a data:8
        CorrectionServer in a thread (16 slots): each server shard replays
        its client shard's rows, so the session is bitwise the sharded
        local sync engine's; against the reference within the bars."""
        c = case()
        sync_eng = engine(mesh=virtual())
        sync = sync_eng.session().run(c["toks"])
        path = os.path.join(tempfile.mkdtemp(prefix="tmesh_"), "s.sock")
        srv = CorrectionServer(c["cfg"], c["model"], slots=B, max_len=ML,
                               uds=path, device="cpu", mesh=virtual())
        assert str(srv.mesh_spec) == MESH
        stop = threading.Event()
        th = threading.Thread(target=srv.serve_forever,
                              kwargs=dict(stop=stop), daemon=True)
        th.start()
        try:
            eng = engine(mesh=virtual())
            config = SessionConfig(mode="sync", mesh=MESH,
                                   transport=TransportSpec("wire",
                                                           address=path))
            with eng.session(config) as s:
                res = s.run(c["toks"])
            for k in ("u", "fhat", "triggered"):
                np.testing.assert_array_equal(res[k], sync[k], err_msg=k)
            np.testing.assert_array_equal(eng.server_pos, sync_eng.server_pos)
            w = res["comms"]["wire"]
            assert w["tx_bytes"] > 0 and w["replies"] > 0
            against_reference(res, c["ref"]["sync"])
        finally:
            stop.set()
            th.join(timeout=10)
            srv.close()


class TestShardedInvariants:
    def test_edge_path_collective_free(self):
        eng = engine(mesh=virtual())
        ops = mesh_mod.edge_ops(eng)
        assert set(ops) == {"decode_at", "decode_masked", "u_head",
                            "record_at"}
        for name, records in ops.items():
            assert records, name
            assert not mesh_mod.collective_ops(records), name
            mesh_mod.assert_collective_free(records, name)
        # every recorded op stayed on one shard's data
        assert any(r.shards == (3,) for r in ops["decode_at"])
        with pytest.raises(ValueError, match="not mesh-sharded"):
            mesh_mod.edge_ops(engine())

    def test_the_check_catches_cross_shard_ops(self):
        eng = engine(mesh=virtual())
        s0, s1 = eng.shards[0], eng.shards[1]
        with mesh_mod.record_ops(eng) as rec:
            _ = s0._history + s1._history       # two shards' data
        with pytest.raises(AssertionError, match="across shards"):
            mesh_mod.assert_collective_free(rec, "probe")
        with mesh_mod.record_ops(eng) as rec:
            _ = s0._history.to("meta")          # a copy off the device
        assert rec[-1].cross_device
        with pytest.raises(AssertionError):
            mesh_mod.assert_collective_free(rec, "probe")
        with mesh_mod.record_ops(eng) as rec:
            _ = s0._history + 1                 # one shard: fine
        mesh_mod.assert_collective_free(rec, "probe")

    def test_zero_rows_keeps_placement(self):
        eng = engine(mesh=virtual())
        leaves = [[x for e in sh.server.cache.values() if e is not None
                   for x in e] for sh in eng.shards]
        rows = np.zeros(B, bool)
        rows[5] = True
        eng.server.zero_rows(rows)
        eng.edge.zero_rows(rows)
        for sh, old in zip(eng.shards, leaves):
            now = [x for e in sh.server.cache.values() if e is not None
                   for x in e]
            assert all(a is b and a.device == sh.device
                       for a, b in zip(now, old))
            assert sh.server.batch == B // N

    def test_shard_engine_idempotent_and_guarded(self):
        eng = engine(mesh=virtual())
        assert mesh_mod.shard_engine(eng, MESH) is eng
        with pytest.raises(ValueError, match="already sharded"):
            mesh_mod.shard_engine(eng, "data:4")
        with pytest.raises(ValueError, match="already sharded"):
            eng.session(SessionConfig(mesh="data:4")).step(
                case()["toks"][:, 0])
        live = engine()
        s = live.session(SessionConfig(mode="async", transport="inproc"))
        s.step(case()["toks"][:, 0])
        with pytest.raises(RuntimeError, match="open async session"):
            mesh_mod.shard_engine(live, virtual())
        s.close()

    @pytest.mark.parametrize("spec", [None, "data:4"])
    def test_server_row_helpers_over_lanes(self, spec):
        """The correction server's defrag (``permute_rows``) and replies
        (``fuse_rows``) on one lane (an unsharded engine) and on four:
        each equals the plain op on the whole batch, and only rows that
        change shard count as a cross-shard step."""
        eng = engine(mesh=None if spec is None else virtual(spec))
        caches = async_rpc.parts_of(eng.server.cache)
        for i, c in enumerate(caches):
            for entry in _entries(c):
                for leaf in entry:
                    leaf.copy_((torch.arange(leaf.numel()) + 10**4 * i)
                               .reshape(leaf.shape).to(leaf.dtype))

        def joined():
            parts = [list(_entries(c)) for c in caches]
            return [torch.cat([p[ei][li] for p in parts],
                              CACHE_BATCH_AXIS[type(entry)])
                    for ei, entry in enumerate(parts[0])
                    for li in range(len(entry))]

        axes = [CACHE_BATCH_AXIS[type(entry)] for entry in _entries(caches[0])
                for _ in entry]
        rng = np.random.default_rng(0)
        perm = rng.permutation(B)
        before = joined()
        mesh_mod.reset_cross_shard_steps()
        mesh_mod.permute_rows(eng, eng.server.cache, perm)
        for old, new, axis in zip(before, joined(), axes):
            assert torch.equal(new, old.index_select(axis,
                                                     torch.as_tensor(perm)))
        assert mesh_mod.cross_shard_steps() == (
            {} if spec is None else {"defrag": 1})

        v = eng._join([torch.as_tensor(rng.standard_normal(ln.batch),
                                       dtype=torch.float32)
                       for ln in eng._lanes()])
        rows = rng.choice(B, 10, replace=False)
        u = rng.standard_normal(10).astype(np.float32)
        trig = rng.random(10) < 0.5
        v_np, fhat = mesh_mod.fuse_rows(eng, v, rows, u, trig)
        whole = async_rpc.to_host(v)
        np.testing.assert_array_equal(v_np, whole)
        np.testing.assert_array_equal(fhat, eng._fuse(
            torch.as_tensor(u), torch.as_tensor(whole[rows]),
            torch.as_tensor(trig)).numpy())

    def test_a_replica_on_another_device_object_serves_alike(self):
        """Parameters replicate one copy per distinct device: a replica
        built through the meta device serves bitwise as the original."""
        c = case()
        rep = mesh_mod._replica(c["model"], c["cfg"], CPU)
        assert rep is not c["model"]
        a = CollaborativeEngine(c["model"], c["cfg"], 2, ML, device="cpu")
        b = CollaborativeEngine(rep, c["cfg"], 2, ML, device="cpu")
        ra, rb = (e.session().run(c["toks"][:2]) for e in (a, b))
        for k in ("u", "fhat", "triggered"):
            np.testing.assert_array_equal(ra[k], rb[k])


class TestShardedLeaseDefrag:
    """The reference's ``TestLeaseDefrag`` on a super-batch of 8 slots
    sharded data:4 (2 rows a shard): leases move across shards with their
    cache rows and history mirror, and every leaf stays on its shard."""

    def _server(self, slots=8):
        c = case()
        path = os.path.join(tempfile.mkdtemp(prefix="tmdefrag_"), "s.sock")
        return CorrectionServer(c["cfg"], c["model"], slots=slots,
                                max_len=ML, uds=path, device="cpu",
                                mesh=virtual("data:4"))

    def _lease(self, srv, n):
        a, b = socket.socketpair()
        sess = Session(srv._next_sid, a)
        srv._next_sid += 1
        sess.lo, sess.batch, sess.max_len = srv._alloc(n), n, srv.max_len
        srv._sessions[a] = sess
        self._peers.append(b)
        return sess

    def setup_method(self, _):
        self._peers = []

    def teardown_method(self, _):
        for p in self._peers:
            p.close()

    def _rows(self, srv):
        """The first element of every super-batch row of the first cache
        leaf, joined over the shards."""
        out = []
        for c in srv._cache:
            leaf = mesh_mod._entries(c)[0][0]
            out.append(leaf.transpose(0, 1).reshape(leaf.shape[1], -1)[:, 0])
        return torch.cat(out)

    def test_bye_defrag_compacts_and_moves_rows(self):
        srv = self._server()
        try:
            s1, s2, s3 = (self._lease(srv, n) for n in (2, 3, 2))
            assert (s1.lo, s2.lo, s3.lo) == (0, 2, 5)
            srv._history[:] = np.arange(srv.slots)[:, None]
            lo = 0
            for c in srv._cache:      # every row carries its index
                for e in mesh_mod._entries(c):
                    for x in e:
                        n = x.shape[1]
                        x.copy_(torch.arange(lo, lo + n, dtype=x.dtype)
                                .reshape((1, n) + (1,) * (x.dim() - 2))
                                .expand_as(x))
                lo += n
            leaves = [x for c in srv._cache for e in mesh_mod._entries(c)
                      for x in e]
            mesh_mod.reset_cross_shard_steps()
            srv._drop(s2)
            assert srv.stats["defrags"] == 1
            assert mesh_mod.cross_shard_steps() == {"defrag": 1}
            assert srv.fragmentation() == 0.0
            assert (s1.lo, s3.lo) == (0, 2)
            assert srv._free == [(4, 8)]
            np.testing.assert_array_equal(srv._history[2, 0], 5)
            np.testing.assert_array_equal(srv._history[3, 0], 6)
            rows = self._rows(srv)
            assert rows[:4].tolist() == [0, 1, 5, 6]
            # the placement survives: the same tensors, on their shards
            now = [x for c in srv._cache for e in mesh_mod._entries(c)
                   for x in e]
            assert all(a is b for a, b in zip(now, leaves))
            assert srv._alloc(4) == 4
        finally:
            srv.close()

    def test_drop_defers_defrag_while_requests_pending(self):
        srv = self._server()
        try:
            s_a, s_b, s_c, s_d = (self._lease(srv, 2) for _ in range(4))
            srv._pending.append((s_b, None, 0.0))
            srv._drop(s_a)
            srv._drop(s_c)
            assert srv.stats["defrags"] == 0
            assert srv.fragmentation() > 0
            assert (s_b.lo, s_d.lo) == (2, 6)
            srv._pending.clear()
            srv._drop(s_d)
            assert srv.stats["defrags"] == 1
            assert s_b.lo == 0
            assert srv._free == [(2, 8)]
        finally:
            srv._pending.clear()
            srv.close()

    def test_fragmented_hello_defrags_then_leases(self):
        srv = self._server()
        try:
            a = self._lease(srv, 3)
            b = self._lease(srv, 2)
            c = self._lease(srv, 3)
            srv._pending.append((b, None, 0.0))
            srv._drop(a)
            srv._drop(c)
            srv._pending.clear()
            assert srv.fragmentation() > 0
            x, y = socket.socketpair()
            self._peers.extend([x, y])
            newcomer = Session(99, x)
            srv._sessions[x] = newcomer
            srv._handle(newcomer, wire.Hello(5, srv.max_len, srv.tok_tail,
                                             True, "t"))
            assert srv.stats["defrags"] == 1
            assert b.lo == 0
            assert (newcomer.lo, newcomer.batch) == (2, 5)
            assert y.recv(1 << 12)
        finally:
            srv._pending.clear()
            srv.close()

    def test_reset_rows_zeroes_only_the_owning_shard(self):
        srv = self._server()
        try:
            for c in srv._cache:
                for e in mesh_mod._entries(c):
                    for x in e:
                        x.fill_(1)
            srv._reset_rows(3, 5)        # shard 1's row 1, shard 2's row 0
            rows = self._rows(srv)
            assert rows.tolist() == [1, 1, 1, 0, 0, 1, 1, 1]
        finally:
            srv.close()

    def test_fragmentation_gauge_and_double_drop(self):
        srv = self._server()
        try:
            assert srv.fragmentation() == 0.0
            s1 = self._lease(srv, 4)
            srv._drop(s1)
            srv._drop(s1)
            assert srv._free == [(0, 8)] and srv.fragmentation() == 0.0
            assert srv._alloc(8) == 0 and srv._alloc(1) == -1
        finally:
            srv.close()
