"""Sign certificates over the port's exported graphs (``repro_torch.
analysis.signs``), the models on the meta device (shapes only, no
arithmetic): the training forward and the serving
catch-up of a dense arch (granite-8b), the hybrid (zamba2-7b: SSD scan
and flash nodes inlined) and MLA with an MoE layer (deepseek-v3), each at
SMOKE size under both sigma kinds, are PROVED; the flipped corrector is
REFUTED with a chain that names the ``mul`` and its ``file:line``.

The reference's certificates (``tests/test_analysis.py::TestCertificates``)
are red under the installed JAX, so the port is held to the verdicts
those tests assert.
"""
import pytest
import torch

from repro_torch.analysis import signs
from repro_torch.configs import registry

ARCHS = ("granite-8b", "zamba2-7b", "deepseek-v3-671b")
_MODELS = {}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(arch):
    if arch not in _MODELS:
        cfg = registry.get_smoke(arch)
        _MODELS[arch] = signs._model(cfg, "meta")   # shapes only
    return _MODELS[arch]


@pytest.mark.parametrize("sigma", signs.SIGMA_KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_proves(arch, sigma):
    cfg = registry.get_smoke(arch)
    cert = signs.verify_forward(cfg, arch=arch, sigma=sigma,
                                model=_model(arch))
    assert cert.ok, cert.detail
    assert cert.corr_interval.nonneg
    assert cert.corr_interval.hi <= cfg.monitor.s * (1 + 1e-6)


@pytest.mark.parametrize("sigma", signs.SIGMA_KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_catchup_proves(arch, sigma):
    cfg = registry.get_smoke(arch)
    cert = signs.verify_catchup(cfg, arch=arch, sigma=sigma,
                                model=_model(arch))
    assert cert.ok, cert.detail
    assert cert.corr_interval is not None and cert.corr_interval.nonneg


def test_flipped_sign_refuted_with_counterexample():
    cfg = registry.get_smoke("granite-8b")
    cert = signs.verify_forward(cfg, arch="granite-8b", s=-0.2,
                                model=_model("granite-8b"))
    assert not cert.ok
    assert cert.corr_interval.lo < 0.0
    muls = [ln for ln in cert.detail.splitlines() if "aten.mul" in ln]
    assert muls and all("repro_torch/core/decomposition.py:" in ln
                        for ln in muls), cert.detail


def test_flipped_catchup_refuted_at_the_kernels_plain_version():
    """The catch-up's corrector is ``monitor_combine``'s: the chain
    reaches inside the kernel's plain version, inlined."""
    cfg = registry.get_smoke("granite-8b")
    cert = signs.verify_catchup(cfg, arch="granite-8b", s=-0.2,
                                model=_model("granite-8b"))
    assert not cert.ok
    assert any("aten.mul" in ln and "kernels/monitor_combine.py:" in ln
               for ln in cert.detail.splitlines()), cert.detail


def test_catchup_graph_holds_the_kernels():
    """One decode_attention node per attention layer per round, one
    monitor_combine, no empty standing for a kernel's output."""
    cfg = registry.get_smoke("granite-8b")
    from repro_torch.serving.collaborative import CollaborativeEngine
    eng = CollaborativeEngine(_model("granite-8b"), cfg, 2, 8, device="meta")
    ep = signs.export_catchup(eng, rounds=2)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets.count("repro_torch.decode_attention.default") \
        == 2 * cfg.n_layers
    assert targets.count("repro_torch.monitor_combine.default") == 1
    assert not [t for t in targets if "empty" in t]
