"""The port's hand-written CUDA kernels against their plain versions, and a
small session through them, on the card.  A CUDA kernel has no CPU mode:
every test here is marked ``cuda`` and skips without a GPU.  The module
imports no JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import registry
from repro_torch.core.decomposition import init_collab_lm
from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  decode_attention_plain)
from repro_torch.kernels.monitor_combine import (monitor_combine_cuda,
                                                 monitor_combine_plain)
from repro_torch.serving import MonitorSession, SessionConfig


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rand(shape, dtype, gen, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Hq,Hkv,D,C", [
    (8, 32, 8, 128, 512),   # granite-8b server tower, ring
    (8, 4, 4, 64, 512),     # granite-8b edge tower, ring
    (3, 4, 2, 64, 32),      # granite-8b SMOKE
    (4, 2, 2, 32, 40),      # paper SERVING, no window, C % 64 != 0
    (2, 8, 1, 256, 100),
])
def test_decode_attention_kernel_vs_plain(cuda, dtype, B, Hq, Hkv, D, C):
    gen = torch.Generator(cuda).manual_seed(0)
    q = _rand((B, Hq, D), dtype, gen, cuda)
    k = _rand((B, C, Hkv, D), dtype, gen, cuda)
    v = _rand((B, C, Hkv, D), dtype, gen, cuda)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    for pos in (0, C - 1, 2 * C + 3,
                torch.randint(0, 2 * C, (B,), generator=gen, device=cuda)):
        out = decode_attention_cuda(q, k, v, pos)
        ref = decode_attention_plain(q, k, v, pos)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8, 1000, 2**20])
def test_monitor_combine_kernel_vs_plain(cuda, n):
    gen = torch.Generator(cuda).manual_seed(n)
    u, v, f = (torch.randn(n, generator=gen, device=cuda) for _ in range(3))
    got = monitor_combine_cuda(u, v, f, s=0.2, threshold=0.1)
    want = monitor_combine_plain(u, v, f, s=0.2, threshold=0.1)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], atol=1e-6, rtol=0)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.cuda
def test_kernel_refuses_unsupported_head_dim(cuda):
    q = torch.zeros((1, 2, 48), device=cuda, dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 2, 48), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention_cuda(q, k, k, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-8b", "paper-synthetic"])
def test_session_on_card_goes_through_kernels(cuda, arch):
    """sync and scan sessions on the card: u and triggers identical, fhat
    within 1e-6, fhat <= u, and both kernels launched."""
    cfg = registry.get_smoke(arch).replace(dtype="bfloat16")
    model = init_collab_lm(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 24))
    probe = MonitorSession.open(model, cfg, batch=4, max_len=32,
                                config=SessionConfig(mode="scan")).run(toks)
    thr = float(np.quantile(probe["u"], 0.85))
    conf = dict(threshold=thr, trigger_margin=0.0)
    kernels.reset_launch_counts()
    sync = MonitorSession.open(model, cfg, batch=4, max_len=32,
                               config=SessionConfig(**conf)).run(toks)
    scan = MonitorSession.open(model, cfg, batch=4, max_len=32,
                               config=SessionConfig(mode="scan", **conf)
                               ).run(toks)
    counts = kernels.launch_counts()
    assert 0 < sync["triggered"].mean() < 1
    np.testing.assert_array_equal(sync["u"], scan["u"])
    np.testing.assert_array_equal(sync["triggered"], scan["triggered"])
    np.testing.assert_allclose(sync["fhat"], scan["fhat"], atol=1e-6, rtol=0)
    assert (sync["fhat"] <= sync["u"]).all()
    assert counts["decode_attention"] > 0 and counts["monitor_combine"] > 0
