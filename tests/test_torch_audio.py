"""musicgen-large in the port against the JAX reference on the CPU at
SMOKE size (K = 2 codebooks), f32, the same weights carried across by the
bridge: the codebook embedding and its K heads, the cross entropy over
(B, S, K, V), the audio edge tower, forward and decode on (B, [S,] K)
tokens, the joint loss and every gradient leaf, three AdamW steps,
MonitorSession sync and scan, greedy generation of (B, n, K) tokens, and
the bridge with checkpoints both ways (cases in
tests/_torch_families.py).  Then the (K,) token tail across processes'
boundaries: a torch client against the JAX ``CorrectionServer`` and a
JAX client against the port's, over the wire and over the shm rings,
each server in a thread of this process.

Tolerances: modules f32 2e-5 (``TOL``); whole towers 1e-4 (``TOL_E2E``);
trigger traces exact outside the tie band, whose size each session test
prints.
"""
import os
import tempfile
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decomposition as jdeco
from repro.core.losses import cross_entropy as j_ce
from repro.nn import embedding as jemb
from repro.serving import SessionConfig as JSessionConfig
from repro.serving import TransportSpec as JTransportSpec
from repro.serving.collaborative import CollaborativeEngine as JEngine
from repro.serving.server import CorrectionServer as JServer
from repro_torch.core import decomposition as tdeco
from repro_torch.core.losses import cross_entropy
from repro_torch.nn import embedding as temb
from repro_torch.serving import SessionConfig, TransportSpec
from repro_torch.serving.collaborative import CollaborativeEngine
from repro_torch.serving.server import CorrectionServer

import _torch_families as fam
from _torch_parity import TOL, check_across, no_stray_arenas, serve_case

ARCH = "musicgen-large"


@pytest.fixture(autouse=True)
def _one_thread():
    """Many tiny ops: one intra-op thread is as fast alone and does not
    thrash when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table(rng, K=3, V=11, d=8):
    return rng.standard_normal((K, V, d)).astype(np.float32)


def test_codebook_embed_and_heads_match_reference():
    """The sum of K per-book embeddings of (B, S, K) ids, and the (B, S,
    K, V) per-book logits."""
    rng = np.random.default_rng(0)
    tab = _table(rng)
    toks = rng.integers(0, 11, (2, 5, 3)).astype(np.int32)
    x = rng.standard_normal((2, 5, 8)).astype(np.float32)
    p = temb.CodebookEmbedding(3, 11, 8, device="cpu")
    p.table.copy_(torch.from_numpy(tab))
    jp = {"table": jnp.asarray(tab)}
    tol = TOL["float32"]
    np.testing.assert_allclose(
        temb.codebook_embed(p, torch.from_numpy(toks), torch.float32).numpy(),
        np.asarray(jemb.codebook_embed(jp, jnp.asarray(toks), jnp.float32)),
        atol=tol, rtol=tol)
    got = temb.codebook_unembed(p, torch.from_numpy(x), torch.float32)
    assert got.shape == (2, 5, 3, 11)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jemb.codebook_unembed(jp, jnp.asarray(x),
                                                      jnp.float32)),
        atol=tol, rtol=tol)


def test_cross_entropy_over_codebooks_is_the_reference_mean():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 6, 3, 17)).astype(np.float32)
    labels = rng.integers(0, 17, (2, 6, 3)).astype(np.int32)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    want = j_ce(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=TOL["float32"])


def test_edge_tower_keeps_the_codebooks():
    """The audio server's edge tower is an audio-family decoder over the
    same K codebooks, field for field the reference's."""
    jcfg, tcfg = fam.smoke_configs(ARCH)
    je, te = jdeco.edge_arch(jcfg), tdeco.edge_arch(tcfg)
    assert te.family == "audio" and te.n_codebooks == tcfg.n_codebooks
    assert te.monitor.__dict__ == je.monitor.__dict__
    for name in te.__dataclass_fields__.keys() - {"monitor"}:
        if name in je.__dataclass_fields__:
            assert getattr(te, name) == getattr(je, name), name


def test_forward_and_decode_match_reference():
    fam.forward_and_decode(ARCH)


def test_loss_and_gradients_match_reference():
    fam.loss_and_gradients(ARCH)


def test_train_steps_match_reference():
    fam.train_steps(ARCH)


@pytest.mark.parametrize("mode", ["sync", "scan"])
def test_session_matches_jax_session(mode):
    fam.session(ARCH, mode)


def test_sync_equals_scan_in_the_port():
    fam.sync_equals_scan(ARCH)


def test_greedy_generate_matches_reference():
    fam.greedy_generate(ARCH)


def test_bridge_and_checkpoints_cross_both_ways(tmp_path):
    fam.bridge_and_checkpoint(ARCH, tmp_path)


# -- the (K,) tail across the wire and the rings ------------------------------

B, ML, S = 3, 32, 16
_CASE = {}


def _case():
    """Weights (the reference's init, carried into the port), a (B, S, K)
    token stream, a mixed-trigger threshold, and each package's sync run."""
    if not _CASE:
        _CASE.update(serve_case(ARCH, B, ML, S))
    return _CASE


def _uds_path(tag):
    # bind() creates the file, so the path must not exist yet
    return os.path.join(tempfile.mkdtemp(prefix=f"taudio_{tag}_"), "s.sock")


@pytest.fixture(scope="module")
def servers():
    """A JAX and a torch CorrectionServer on the same weights, each
    offering shm and serving in a thread; stopped and closed in a
    finally."""
    torch.set_num_threads(1)  # the torch server replays on one thread
    c = _case()
    made, stops, threads = [], [], []
    try:
        for cls, cfg, params, kw in (
                (JServer, c["jcfg"], c["params"], {}),
                (CorrectionServer, c["tcfg"], c["model"], {"device": "cpu"})):
            srv = cls(cfg, params, slots=8, max_len=ML, shm=True,
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


def test_servers_declare_the_codebook_tail(servers):
    K = _case()["tcfg"].n_codebooks
    assert servers["torch"].tok_tail == servers["jax"].tok_tail == (K,)


@pytest.mark.parametrize("kind", ["wire", "shm"])
@pytest.mark.parametrize("client", ["torch", "jax"])
def test_client_against_the_other_packages_server(servers, client, kind):
    """A torch client against the JAX server and a JAX client against the
    torch server at max_staleness 0, every backlog a (n, K) block: u and
    triggers exact against the client's own sync run and, outside the tie
    band, the other package's; fhat within 1e-4 of both; server_pos and
    bytes equal; the ``kind`` plane carried every reply."""
    c = _case()
    srv = servers["jax" if client == "torch" else "torch"]
    requests = srv.stats["requests"]
    if client == "torch":
        eng = CollaborativeEngine(c["model"], c["tcfg"], B, ML, device="cpu")
        conf = SessionConfig(mode="async", max_staleness=0,
                             transport=TransportSpec(kind,
                                                     address=srv.address))
        mine, other, sync = c["rt"], c["rj"], c["tsync"]
    else:
        eng = JEngine(c["params"], c["jcfg"], batch=B, max_len=ML)
        conf = JSessionConfig(mode="async", max_staleness=0,
                              transport=JTransportSpec(kind,
                                                       address=srv.address))
        mine, other, sync = c["rj"], c["rt"], c["jsync"]
    with eng.session(conf) as s:
        r = s.run(c["toks"])
    band = check_across(r, mine, other, eng.server_pos, sync.server_pos,
                        c["thr"], plane=kind)
    print(f"\n{client} {kind} client: {band} of {r['u'].size} entries in "
          "the tie band")
    for ref in (mine, other):
        np.testing.assert_allclose(r["fhat"], ref["fhat"], atol=1e-4)
    assert srv.stats["requests"] - requests == r["comms"]["async"]["requests"]
    if kind == "shm":
        assert r["comms"].get("wire", {}).get("replies", 0) == 0
        assert no_stray_arenas()
