"""The port's launchers and their step functions (repro_torch.launch.steps,
serve, fleet, train) against the JAX package, on the CPU.

The step functions on granite-8b SMOKE (f32) with the reference's weights
carried across: ``make_serve_step`` over 12 tokens (logits, u and fhat
per step within 1e-4, whole towers; the trigger mask exact outside the
tie band, whose count is printed; the final caches within 1e-4),
``make_monitor_step`` (u within 1e-4), ``make_prefill_step`` (logits, u
and fhat within 1e-4, the trigger rate equal), and ``make_train_step``
under ``warmup_cosine`` (loss and grad norm within 1e-4 per step, every
f32 master within lr/10 after three steps).  Then the launchers as
subprocesses with ``--device cpu``: ``launch.serve --engine step``,
``--engine collab --transport shm`` against ``launch.server --transport
shm``, ``launch.fleet`` with a ``fleet:`` client, and ``launch.train``
writing a checkpoint that the JAX package loads; the refusals of
``--mesh``.
"""
import os
import signal
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.core import decomposition as jdeco
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training.schedule import warmup_cosine as j_warmup_cosine
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.core.decomposition import init_collab_lm
from repro_torch.data import tokens as ttok
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.launch.server import spawn_subprocess
from repro_torch.models import api as tapi
from repro_torch.core.decomposition import edge_arch
from repro_torch.training import optimizer as topt
from repro_torch.training.loop import to_device, trainable
from repro_torch.training.schedule import warmup_cosine

from _torch_parity import (TOL_E2E, collab_pair, gap_threshold, tie_band,
                           token_stream, with_threshold)

TOL = TOL_E2E["float32"]
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


_PAIR = {}


def _pair():
    if not _PAIR:
        _PAIR["v"] = collab_pair("granite-8b")
    return _PAIR["v"]


def _serve_both(jcfg, tcfg, params, model, toks):
    """The reference's jitted serve step and the port's over ``toks``:
    per-step outputs of each, and both final caches."""
    B, n = toks.shape
    cap = n + 4
    jstep = jax.jit(jsteps.make_serve_step(jcfg))
    jsc = japi.init_cache(jcfg, B, cap)
    jec = japi.init_cache(jdeco.edge_arch(jcfg), B, cap)
    tstep = tsteps.make_serve_step(tcfg)
    tsc = tapi.init_cache(tcfg, B, cap, "cpu")
    tec = tapi.init_cache(edge_arch(tcfg), B, cap, "cpu")
    want, got = [], []
    for t in range(n):
        w = jstep(params, jsc, jec, jnp.asarray(toks[:, t]),
                  jnp.asarray(t, jnp.int32))
        jsc, jec = w["server_cache"], w["edge_cache"]
        want.append({k: _np(w[k]) for k in ("logits", "u", "fhat", "mask")})
        g = tstep(model, tsc, tec, torch.as_tensor(toks[:, t]), t)
        tsc, tec = g["server_cache"], g["edge_cache"]
        got.append({k: _np(g[k]) for k in ("logits", "u", "fhat", "mask")})
    return want, got, (jsc, jec), (tsc, tec)


def test_serve_step_matches_reference():
    jcfg, tcfg, params, model = _pair()
    toks = token_stream(tcfg, 3, 12, seed=2)
    _, probe, _, _ = _serve_both(jcfg, tcfg, params, model, toks)
    thr, _ = gap_threshold(np.stack([p["u"] for p in probe]))
    jcfg, tcfg = with_threshold(jcfg, thr), with_threshold(tcfg, thr)
    want, got, (jsc, _), (tsc, _) = _serve_both(jcfg, tcfg, params, model,
                                                toks)
    masks = np.stack([g["mask"] for g in got])
    assert 0.0 < masks.mean() < 1.0, "need mixed triggers"
    n_band = 0
    for t, (g, w) in enumerate(zip(got, want)):
        for k in ("logits", "u", "fhat"):
            np.testing.assert_allclose(g[k], w[k], atol=TOL, rtol=TOL,
                                       err_msg=f"step {t} {k}")
        band = tie_band(w["u"], thr, TOL)
        n_band += int(band.sum())
        np.testing.assert_array_equal(g["mask"][~band], w["mask"][~band])
        assert (g["fhat"] <= g["u"]).all()
        # where the mask is off, fhat is u itself
        np.testing.assert_array_equal(g["fhat"][g["mask"] == 0],
                                      g["u"][g["mask"] == 0])
    print(f"serve step: {n_band} of {masks.size} entries in the tie band")
    np.testing.assert_allclose(_np(tsc["blocks"].k), _np(jsc["blocks"].k),
                               atol=TOL, rtol=TOL)


def test_monitor_and_prefill_steps_match_reference():
    jcfg, tcfg, params, model = _pair()
    toks = token_stream(tcfg, 3, 6, seed=3)
    jstep = jax.jit(jsteps.make_monitor_step(jcfg))
    jec = japi.init_cache(jdeco.edge_arch(jcfg), 3, 8)
    tstep = tsteps.make_monitor_step(tcfg)
    tec = tapi.init_cache(edge_arch(tcfg), 3, 8, "cpu")
    for t in range(toks.shape[1]):
        w = jstep(params, jec, jnp.asarray(toks[:, t]),
                  jnp.asarray(t, jnp.int32))
        jec = w["edge_cache"]
        g = tstep(model, tec, torch.as_tensor(toks[:, t]), t)
        np.testing.assert_allclose(_np(g["u"]), _np(w["u"]), atol=TOL,
                                   rtol=TOL, err_msg=f"step {t}")
    b = next(ttok.lm_batches(4, tcfg, 2, 24))
    u = _np(tsteps.make_prefill_step(tcfg)(model, to_device(b, "cpu"))["u"])
    thr, _ = gap_threshold(u)
    jcfg, tcfg = with_threshold(jcfg, thr), with_threshold(tcfg, thr)
    want = jax.jit(jsteps.make_prefill_step(jcfg))(
        params, {k: jnp.asarray(v) for k, v in b.items()})
    got = tsteps.make_prefill_step(tcfg)(model, to_device(b, "cpu"))
    for k in ("logits", "u", "fhat"):
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), atol=TOL,
                                   rtol=TOL, err_msg=k)
    band = tie_band(_np(want["u"]), thr, TOL)
    assert not band.any(), "the gap threshold keeps clear of ties"
    assert float(got["trigger_rate"]) == float(want["trigger_rate"])
    assert 0.0 < float(got["trigger_rate"]) < 1.0


def test_train_step_matches_reference():
    lr, n = 1e-3, 3
    jcfg, tcfg, params, _ = _pair()
    tree0 = jax.tree.map(np.asarray, params)
    model = bridge.collab_from_numpy(tree0, tcfg, "cpu")
    batches = [b for b, _ in zip(ttok.lm_batches(6, tcfg, 2, 24), range(n))]
    jo = jopt.AdamW(lr=j_warmup_cosine(lr, 2, 10))
    jstep = jax.jit(jsteps.make_train_step(jcfg, jo))
    jp, js, want = params, jo.init(params), []
    for b in batches:
        jp, js, m = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        want.append({k: float(v) for k, v in m.items()})
    to = topt.AdamW(lr=warmup_cosine(lr, 2, 10))
    state = to.init(trainable(model))
    bridge.load_masters(tree0, model, state)
    tstep = tsteps.make_train_step(tcfg, to)
    got = [{k: float(v) for k, v in
            tstep(model, state, to_device(b, "cpu")).items()}
           for b in batches]
    assert [sorted(g) for g in got] == [["grad_norm", "loss"]] * n
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=TOL, atol=TOL,
                                       err_msg=k)
    got_p = jckpt._flatten(bridge.collab_to_numpy(model, state))
    moved = 0.0
    for path, w in jckpt._flatten(jax.tree.map(np.asarray, jp)).items():
        assert np.abs(got_p[path] - w).max() <= 0.1 * lr, path
        moved = max(moved, float(np.abs(w - jckpt._flatten(tree0)[path])
                                 .max()))
    assert moved > 0.5 * lr


# -- the launchers ------------------------------------------------------------------

def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _launch(module, *args, timeout=120):
    """``python -m repro_torch.launch.<module> ...``: its stdout (asserting
    exit code 0)."""
    p = subprocess.run([sys.executable, "-m", f"repro_torch.launch.{module}",
                        *args], env=_env(), capture_output=True, text=True,
                       timeout=timeout)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout


def test_serve_launcher_step_engine_and_shm_collab():
    """``launch.serve`` with the default step engine, and with ``--engine
    collab --transport shm`` against ``launch.server --transport shm``:
    both exit 0 and print what the reference prints; the collab run's data
    frames rode the rings."""
    tmp = tempfile.mkdtemp(prefix="tlaunch_")
    uds, ready = os.path.join(tmp, "s.sock"), os.path.join(tmp, "ready")
    srv = spawn_subprocess("granite-8b", uds=uds, slots=4, max_len=40,
                           ready_file=ready, wait=False,
                           extra_args=("--device", "cpu", "--transport",
                                       "shm", "--idle-exit-s", "30"))
    try:
        out = _launch("serve", "--arch", "granite-8b", "--device", "cpu",
                      "--batch", "2", "--tokens", "8")
        assert "8 steps x batch 2:" in out and "ms/step" in out
        assert out.count("  stream ") == 2 and "trigger rate" in out
        deadline = time.monotonic() + 120
        while not os.path.exists(ready):
            assert srv.poll() is None, srv.stderr.read()[-3000:]
            assert time.monotonic() < deadline, "server startup timeout"
            time.sleep(0.05)
        out = _launch("serve", "--arch", "granite-8b", "--device", "cpu",
                      "--batch", "2", "--tokens", "8", "--engine", "collab",
                      "--mode", "async", "--transport", "shm", "--address",
                      uds, "--max-staleness", "2")
        assert "async collab engine: 8 steps x batch 2:" in out
        assert "shm rings (measured):" in out and "reduction" in out
    finally:
        srv.terminate()
        srv.wait(timeout=30)


def test_fleet_launcher_with_a_fleet_client():
    """``launch.fleet --device cpu`` (two servers), a ``fleet:`` client
    through ``launch.serve``, then SIGTERM: the fleet prints its summary
    and exits 0."""
    tmp = tempfile.mkdtemp(prefix="tfleet_")
    ready = os.path.join(tmp, "ready")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.fleet", "--arch",
         "granite-8b", "--device", "cpu", "--n-servers", "2",
         "--slots", "4", "--max-len", "40", "--root", tmp,
         "--ready-file", ready, "--log-interval-s", "600"],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.monotonic() + 120
        while not os.path.exists(ready):
            assert proc.poll() is None, proc.stderr.read()[-3000:]
            assert time.monotonic() < deadline, "fleet startup timeout"
            time.sleep(0.05)
        router = open(ready).read().strip()
        out = _launch("serve", "--arch", "granite-8b", "--device", "cpu",
                      "--batch", "2", "--tokens", "8", "--engine", "collab",
                      "--mode", "async", "--transport", "wire",
                      "--address", "fleet:" + router)
        assert "wire (measured):" in out
    finally:
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=60)
    assert proc.returncode == 0, stderr[-3000:]
    assert "fleet: all 2 servers ready" in stdout
    assert "fleet summary:" in stdout and '"routed": 1' in stdout


def test_train_launcher_checkpoint_loads_in_the_reference(tmp_path):
    """``launch.train`` for 3 steps with a checkpoint: the JAX package's
    ``checkpoint.load`` reads every leaf with the template's shape, and the
    values are the port's (read back through the port's loader)."""
    from repro_torch.training import checkpoint as tckpt
    ck = str(tmp_path / "ck")
    out = _launch("train", "--arch", "granite-8b", "--smoke", "--steps", "3",
                  "--batch", "2", "--seq", "16", "--device", "cpu",
                  "--ckpt-dir", ck)
    assert "mesh {'data': 1, 'model': 1}  arch granite-8b" in out
    assert "step     0  loss" in out and "step     2  loss" in out
    assert f"checkpoint -> {ck}" in out
    jcfg = _pair()[0]
    template = jdeco.init_collab_lm(jax.random.PRNGKey(1), jcfg)
    step, jparams, jopt_state = jckpt.load(ck, template,
                                           jopt.AdamW().init(template))
    assert step == 3 and int(jopt_state.count) == 3
    tcfg = registry.get_smoke("granite-8b")
    model = init_collab_lm(tcfg, torch.Generator().manual_seed(5), "cpu")
    tckpt.load(ck, model)
    got = jckpt._flatten(bridge.collab_to_numpy(model))
    for path, w in jckpt._flatten(jax.tree.map(np.asarray, jparams)).items():
        np.testing.assert_array_equal(got[path], w, err_msg=path)


def test_mesh_options_raise_naming_their_item():
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 8"):
        ttrain.main(["--arch", "granite-8b", "--mesh", "production",
                     "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 8"):
        tserve.main(["--arch", "granite-8b", "--engine", "collab",
                     "--mesh", "data:2", "--device", "cpu"])
