"""The port stands alone: importing it pulls in neither JAX nor any module
of the reference package, and its entry points run on the card unless
the caller asks for the CPU."""
import os
import subprocess
import sys

import pytest
import torch

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_CHECK = """
import sys
import repro_torch, repro_torch.bridge, repro_torch.serving
import repro_torch.serving.api, repro_torch.kernels.ops
import repro_torch.training.loop, repro_torch.training.schedule
import repro_torch.core.losses, repro_torch.data.tokens
import repro_torch.core.safety, repro_torch.core.theory
import repro_torch.data.synthetic, repro_torch.training.checkpoint
import repro_torch.configs.registry, repro_torch.configs.paper_financial
import repro_torch.bench.paper, repro_torch.serving.engine
import repro_torch.serving.async_rpc, repro_torch.serving.policy
import repro_torch.serving.tracker, repro_torch.observability
import repro_torch.observability.trace, repro_torch.observability.metrics
import repro_torch.observability.report
import repro_torch.serving.wire, repro_torch.serving.server
import repro_torch.launch.server, repro_torch.serving.shm
import repro_torch.serving.fleet, repro_torch.launch.fleet
import repro_torch.launch.steps, repro_torch.launch.serve
import repro_torch.launch.train
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "repro.")))
print("BAD" if bad else "OK", bad)
"""


def test_import_pulls_in_no_jax_and_no_reference():
    env = {**os.environ, "PYTHONPATH": os.path.abspath(SRC)}
    out = subprocess.run([sys.executable, "-c", _CHECK], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK"), out.stdout


def test_port_sources_name_no_jax_and_no_reference():
    root = os.path.join(SRC, "repro_torch")
    chip_smoke = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    paths = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
             if f.endswith(".py")] + [chip_smoke]
    for path in paths:
        for line in open(path):
            code = line.split("#")[0].strip()
            assert not code.startswith(("import jax", "from jax",
                                        "import repro.", "from repro.",
                                        "from repro import")), (path, line)


def test_entry_point_defaults_to_the_card(monkeypatch):
    """device=None means CUDA; without a card it raises, never slides to
    the CPU."""
    from repro_torch.configs.paper_synthetic import SERVING
    from repro_torch.core.decomposition import init_collab_lm
    from repro_torch.serving import MonitorSession
    model = init_collab_lm(SERVING, torch.Generator().manual_seed(0), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MonitorSession.open(model, SERVING, batch=2, max_len=8)


@pytest.mark.parametrize("entry", ["init_collab_lm", "init_model",
                                   "init_cache", "collab_from_numpy",
                                   "init_paper_decomposition",
                                   "paper_from_numpy", "ServeEngine"])
def test_model_constructors_default_to_the_card(monkeypatch, entry):
    """The model and cache constructors read device=None as CUDA too: they
    raise without a card instead of building on the host."""
    from repro_torch import bridge
    from repro_torch.configs.paper_synthetic import FULL, SERVING
    from repro_torch.core.decomposition import (init_collab_lm,
                                                init_paper_decomposition)
    from repro_torch.models import api
    from repro_torch.serving.engine import ServeEngine
    model = api.init_model(SERVING, torch.Generator().manual_seed(0), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    call = {"init_collab_lm": lambda: init_collab_lm(SERVING, gen),
            "init_model": lambda: api.init_model(SERVING, gen),
            "init_cache": lambda: api.init_cache(SERVING, 2, 8),
            "collab_from_numpy": lambda: bridge.collab_from_numpy(
                {}, SERVING, None),
            "init_paper_decomposition": lambda: init_paper_decomposition(
                FULL, gen),
            "paper_from_numpy": lambda: bridge.paper_from_numpy(
                {}, FULL, "truncated", None),
            "ServeEngine": lambda: ServeEngine(model, SERVING, 2, 8,
                                               None)}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


@pytest.mark.parametrize("entry", ["init_collab_lm", "init_model",
                                   "init_cache", "init_ssm_cache",
                                   "collab_from_numpy"])
def test_hybrid_constructors_default_to_the_card(monkeypatch, entry):
    """The hybrid (zamba2-7b) model, cache and SSM-state constructors read
    device=None as CUDA too, and raise without a card."""
    from repro_torch import bridge
    from repro_torch.configs.zamba2_7b import SMOKE
    from repro_torch.core.decomposition import init_collab_lm
    from repro_torch.models import api
    from repro_torch.nn.ssm import init_ssm_cache
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    call = {"init_collab_lm": lambda: init_collab_lm(SMOKE, gen),
            "init_model": lambda: api.init_model(SMOKE, gen),
            "init_cache": lambda: api.init_cache(SMOKE, 2, 8),
            "init_ssm_cache": lambda: init_ssm_cache(
                2, SMOKE.d_model, expand=SMOKE.ssm_expand,
                state=SMOKE.ssm_state, conv_k=SMOKE.ssm_conv, n_layers=1),
            "collab_from_numpy": lambda: bridge.collab_from_numpy(
                {}, SMOKE, None)}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


@pytest.mark.parametrize("entry", ["async_session", "cascade",
                                   "wire_session", "shm_session",
                                   "fleet_session"])
def test_async_session_and_cascade_default_to_the_card(monkeypatch, entry):
    """An async session, each tier a CascadeSession is built over, and a
    wire, shm or fleet session read device=None as CUDA: without a card
    they raise, and no worker falls back to the host."""
    from repro_torch.configs.paper_synthetic import SERVING
    from repro_torch.core.decomposition import init_collab_lm
    from repro_torch.serving import (CascadeSession, MonitorSession,
                                     SessionConfig)
    model = init_collab_lm(SERVING, torch.Generator().manual_seed(0), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = SessionConfig(mode="async", transport="thread", max_staleness=2)

    def tier():
        return MonitorSession.open(model, SERVING, batch=2, max_len=8,
                                   config=config)
    call = {"async_session": tier,
            "cascade": lambda: CascadeSession(tier(), tier(),
                                              escalate_above=0.0),
            "wire_session": lambda: MonitorSession.open(
                model, SERVING, batch=2, max_len=8,
                config=SessionConfig(mode="async",
                                     transport="wire:/nowhere.sock")),
            "shm_session": lambda: MonitorSession.open(
                model, SERVING, batch=2, max_len=8,
                config=SessionConfig(mode="async",
                                     transport="shm:/nowhere.sock")),
            "fleet_session": lambda: MonitorSession.open(
                model, SERVING, batch=2, max_len=8,
                config=SessionConfig(mode="async",
                                     transport="fleet:/nowhere.sock"))
            }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


@pytest.mark.parametrize("entry", ["fleet_thread", "launch_serve",
                                   "launch_train", "launch_fleet",
                                   "serve_step"])
def test_fleet_and_launchers_default_to_the_card(monkeypatch, entry):
    """The fleet's servers and the serve, train and fleet launchers read no
    ``--device`` (``device=None``) as CUDA: without a card they raise (the
    fleet launcher when its server subprocess dies of it)."""
    from repro_torch.configs import registry
    from repro_torch.configs.paper_synthetic import SERVING
    from repro_torch.core.decomposition import init_collab_lm
    from repro_torch.launch import fleet, serve, train
    from repro_torch.serving.fleet import FleetSupervisor
    model = init_collab_lm(SERVING, torch.Generator().manual_seed(0), "cpu")
    cfg = registry.get_smoke("granite-8b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"fleet_thread": lambda: FleetSupervisor(
                backend="thread", cfg=SERVING, params=model,
                n_servers=1).start(),
            "launch_serve": lambda: serve.main(["--arch", "granite-8b"]),
            "launch_train": lambda: train.main(["--arch", "granite-8b",
                                                "--smoke"]),
            "launch_fleet": lambda: fleet.main([
                "--arch", "granite-8b", "--n-servers", "1",
                "--router-uds", os.path.join(
                    __import__("tempfile").mkdtemp(), "r.sock")]),
            "serve_step": lambda: serve.run_step(
                __import__("argparse").Namespace(batch=2, tokens=2), cfg,
                model, None)}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
