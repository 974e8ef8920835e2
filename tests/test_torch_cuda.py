"""The port's hand-written CUDA kernels against their plain versions, and a
small session and train step through them, on the card.  A CUDA kernel
has no CPU mode: every test here is marked ``cuda`` and skips without a
GPU.  The module imports no JAX, so it also runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import copy
import time

import numpy as np
import pytest
import torch

from repro_torch import bridge, kernels
from repro_torch.configs import paper_synthetic, registry
from repro_torch.core.decomposition import init_collab_lm
from repro_torch.data.tokens import lm_batches
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  decode_attention_plain,
                                                  decode_attention_split)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.monitor_combine import (MAX_BLOCKS, ONE_BLOCK_MAX,
                                                 combine_blocks,
                                                 monitor_combine_blocks,
                                                 monitor_combine_cuda,
                                                 monitor_combine_plain)
from repro_torch.kernels.ssm_scan import (REG_BLOCKS, SMEM_PER_SM,
                                          SMEM_RESERVED, THREADS,
                                          THREADS_PER_SM, TILES,
                                          max_active_blocks, ssd_scan_cuda,
                                          ssd_scan_plain, ssd_scan_tiled,
                                          tile_smem_bytes)
from repro_torch.serving import MonitorSession, SessionConfig
from repro_torch.training.loop import make_train_step, to_device, trainable
from repro_torch.training.optimizer import AdamW


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rand(shape, dtype, gen, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Hq,Hkv,D,C", [
    (8, 32, 8, 128, 512),   # granite-8b server tower, ring
    (8, 4, 4, 64, 512),     # granite-8b edge tower, ring
    (3, 4, 2, 64, 32),      # granite-8b SMOKE
    (4, 2, 2, 32, 40),      # paper SERVING, no window, C % 32 != 0
    (2, 8, 1, 256, 100),
])
def test_decode_attention_kernel_vs_plain(cuda, dtype, B, Hq, Hkv, D, C,
                                          splits):
    """The cache split as planned (None) and over 1, 2, 4 and 8 blocks of
    a cluster, at an empty, full and wrapped prefix, a ragged position
    vector and one whose 1..7 valid rows leave splits empty."""
    gen = torch.Generator(cuda).manual_seed(0)
    q = _rand((B, Hq, D), dtype, gen, cuda)
    k = _rand((B, C, Hkv, D), dtype, gen, cuda)
    v = _rand((B, C, Hkv, D), dtype, gen, cuda)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    for pos in (0, C - 1, 2 * C + 3,
                torch.randint(0, 2 * C, (B,), generator=gen, device=cuda),
                torch.arange(B, device=cuda) % 7):
        out = (decode_attention_cuda(q, k, v, pos) if splits is None
               else decode_attention_split(q, k, v, pos, splits))
        ref = decode_attention_plain(q, k, v, pos)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [None, 1, 7, MAX_BLOCKS])
@pytest.mark.parametrize("n", [1, 8, 1000, ONE_BLOCK_MAX + 1, 2**20])
def test_monitor_combine_kernel_vs_plain(cuda, n, blocks):
    """As planned (None) and on forced block counts, twice in a row on one
    stream (the second call must not see the first one's counts): fhat,
    mask and counts bitwise equal to the plain version."""
    gen = torch.Generator(cuda).manual_seed(n)
    u, v, f = (torch.randn(n, generator=gen, device=cuda) for _ in range(3))
    want = monitor_combine_plain(u, v, f, s=0.2, threshold=0.1)
    for _ in range(2):
        got = (monitor_combine_cuda(u, v, f, s=0.2, threshold=0.1)
               if blocks is None else
               monitor_combine_blocks(u, v, f, blocks, s=0.2, threshold=0.1))
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_monitor_combine_is_one_device_kernel_at_the_serve_batch(cuda):
    """At the serving paths' N = 8 a call is one device kernel (no fill of
    a scratch), as the profiler counts them."""
    assert combine_blocks(8) == 1
    u = torch.randn(8, device=cuda)
    monitor_combine_cuda(u, u, u, s=0.2)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            monitor_combine_cuda(u, u, u, s=0.2)
        torch.cuda.synchronize()
    kinds = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kinds) == 5, kinds


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
    cfg = (paper_synthetic.SERVING if arch == "paper-synthetic"
           else registry.get_smoke(arch)).replace(dtype="bfloat16")
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window", [
    (2, 512, 32, 8, 128, 0),    # granite-8b server heads, GQA
    (2, 512, 4, 4, 64, 100),    # granite-8b edge heads, window < S
    (2, 256, 4, 2, 64, 0),      # granite-8b SMOKE
    (3, 1000, 4, 2, 32, 0),     # ragged S
    (2, 1, 4, 2, 64, 0),        # S = 1
    (1, 333, 8, 1, 128, 37),    # MQA, ragged, window
    (2, 4096, 4, 4, 64, 1024),  # granite-8b edge tower at full length
    (2, 129, 8, 2, 64, 0),      # ragged against the 128-row query tile
    (1, 191, 4, 4, 128, 0),
    (2, 300, 4, 2, 32, 50),     # window < the 128-row K/V tile at D = 32
])
def test_flash_attention_kernel_vs_plain(cuda, dtype, B, S, Hq, Hkv, D,
                                         window):
    gen = torch.Generator(cuda).manual_seed(S)
    q = _rand((B, S, Hq, D), dtype, gen, cuda)
    k = _rand((B, S, Hkv, D), dtype, gen, cuda)
    v = _rand((B, S, Hkv, D), dtype, gen, cuda)
    o, lse = flash_attention_cuda(q, k, v, window=window)
    po, plse = flash_attention_plain(q, k, v, window=window)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(o.float(), po.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, plse, atol=2e-5, rtol=2e-5)
    if dtype == torch.bfloat16:
        # both round p to bf16 (at different scales) and then o: per entry
        # within 2^-8 (P|V|) (+25% for f32 summation order) + 2 ulp(|o|)
        pv = flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                   window=window)[0]
        _, e = torch.frexp(po.float())
        bound = 1.25 * 2.0 ** -8 * pv + 2 * torch.ldexp(torch.ones_like(pv),
                                                         e - 8)
        assert ((o.float() - po.float()).abs() <= bound).all()


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 50])
def test_flash_attention_gradient_on_card(cuda, window):
    """The Function (kernel forward, tensor-op backward) against autograd
    through the plain version, f32, rel 1e-4 of the largest entry."""
    gen = torch.Generator(cuda).manual_seed(1)
    q, k, v = (_rand(s, torch.float32, gen, cuda)
               for s in ((2, 200, 8, 64), (2, 200, 2, 64), (2, 200, 2, 64)))
    do = _rand(q.shape, torch.float32, gen, cuda)
    grads = []
    for fn in (lambda a, b, c: ops.flash_attention(a, b, c, window=window),
               lambda a, b, c: flash_attention_plain(a, b, c,
                                                     window=window)[0]):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        (fn(*leaves) * do).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))


@pytest.mark.cuda
def test_flash_kernel_refuses_unsupported_head_dim(cuda):
    q = torch.zeros((1, 8, 2, 48), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_cuda(q, q, q)


def _leaves(tree):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    else:
        yield tree


@pytest.mark.cuda
def test_smoke_train_step_card_matches_cpu(cuda):
    """One granite-8b SMOKE (f32) train step on the card, through the
    flash kernel, against the same step on the CPU: loss parts and grad
    norm within 1e-4, every updated master within lr/10."""
    cfg, lr = registry.get_smoke("granite-8b"), 1e-3
    cpu = torch.device("cpu")
    model_cpu = init_collab_lm(cfg, torch.Generator().manual_seed(0), cpu)
    runs = []
    kernels.reset_launch_counts()
    for model, dev in ((copy.deepcopy(model_cpu).to(cuda), cuda),
                       (model_cpu, cpu)):
        opt = AdamW(lr=lr)
        state = opt.init(trainable(model))
        batch = to_device(next(lm_batches(0, cfg, 2, 100)), dev)
        m = make_train_step(cfg, opt)(model, state, batch)
        runs.append(({k: float(x) for k, x in m.items()},
                     list(_leaves(bridge.collab_to_numpy(model, state)))))
    assert kernels.launch_counts()["flash_attention"] == (
        cfg.n_layers + cfg.monitor.n_layers)
    (ma, pa), (mb, pb) = runs
    for key in ("total", "lm", "monitor", "safety", "grad_norm"):
        assert ma[key] == pytest.approx(mb[key], rel=1e-4, abs=1e-4), key
    for a, b in zip(pa, pb):
        np.testing.assert_allclose(a, b, atol=0.1 * lr, rtol=0)


def _ssd_inputs(B, S, H, P, N, gen, device):
    """Model-like SSD inputs: dt = softplus(normal), zamba2's decays
    A = -linspace(1, 16, H), so la reaches about -11 per step."""
    x = 0.5 * torch.randn((B, S, H, P), generator=gen, device=device)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device=device))
    A = -torch.linspace(1.0, 16.0, H, device=device)
    Bm, Cm = (0.5 * torch.randn((B, S, N), generator=gen, device=device)
              for _ in range(2))
    return x, dt, A, Bm, Cm


SSD_CASES = [
    (2, 256, 4, 32, 16, 64),      # tests/test_kernels.py:72-76
    (1, 128, 2, 64, 64, 128),
    (2, 512, 8, 16, 32, 32),
    (2, 1, 4, 64, 64, 128),       # S = 1
    (2, 300, 6, 64, 64, 128),     # ragged S
    (1, 1024, 112, 64, 64, 128),  # zamba2 heads, state and chunk
    (1, 200, 3, 48, 48, 48),      # P, N and the chunk not powers of two
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,N,chunk,pt", [
    (*case, pt) for case in SSD_CASES
    for pt in (None, *(t for t in TILES if case[3] % t == 0))])
def test_ssd_scan_kernel_vs_plain(cuda, B, S, H, P, N, chunk, pt):
    """y and h_final within the reference's SSD tolerance (atol 5e-5,
    rtol 5e-4), with the planned tile (None) and every tile that divides
    P, twice in a row on one stream (no scratch carried between calls)."""
    gen = torch.Generator(cuda).manual_seed(S)
    x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, P, N, gen, cuda)
    xdt, la = x * dt[..., None], dt * A
    py, ph = ssd_scan_plain(xdt, la, Bm, Cm, chunk=chunk)
    for _ in range(2):
        y, h = (ssd_scan_cuda(xdt, la, Bm, Cm, chunk=chunk) if pt is None
                else ssd_scan_tiled(xdt, la, Bm, Cm, pt, chunk=chunk))
        torch.cuda.synchronize()
        torch.testing.assert_close(y, py, atol=5e-5, rtol=5e-4)
        torch.testing.assert_close(h, ph, atol=5e-5, rtol=5e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("pt", TILES)
def test_ssd_plan_residency_matches_the_card(cuda, pt):
    """The plan's blocks an SM, from the shared bytes, threads and register
    budget, are what the card's occupancy calculation gives at the zamba2
    train shape."""
    want = min(SMEM_PER_SM // (tile_smem_bytes(pt, 128, 64) + SMEM_RESERVED),
               THREADS_PER_SM // THREADS, REG_BLOCKS[pt])
    assert max_active_blocks(pt, 128, 64) == want


@pytest.mark.cuda
def test_ssd_scan_gradient_on_card(cuda):
    """The SSDScan Function (kernel forward, plain-form backward) against
    autograd through the plain version in f32 and in f64, rel 1e-4 of the
    largest entry."""
    gen = torch.Generator(cuda).manual_seed(2)
    ins = _ssd_inputs(2, 384, 8, 64, 64, gen, cuda)
    dy = torch.randn(ins[0].shape, generator=gen, device=cuda)
    dh = torch.randn((2, 8, 64, 64), generator=gen, device=cuda)

    def plain(x, dt, A, Bm, Cm):
        return ssd_scan_plain(x * dt[..., None], dt * A, Bm, Cm, chunk=128)

    grads = []
    kernels.reset_launch_counts()
    for fn, dtype in ((lambda *a: ops.ssd_scan(*a, chunk=128), torch.float32),
                      (plain, torch.float32), (plain, torch.float64)):
        leaves = [t.to(dtype).clone().requires_grad_(True) for t in ins]
        y, h = fn(*leaves)
        ((y * dy.to(dtype)).sum() + (h * dh.to(dtype)).sum()).backward()
        grads.append([t.grad for t in leaves])
    assert kernels.launch_counts()["ssd_scan"] == 1
    for a, b, b64 in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))
        torch.testing.assert_close(a.double(), b64, rtol=1e-4,
                                   atol=1e-4 * float(b64.abs().max()))


@pytest.mark.cuda
def test_ssd_scan_kernel_refuses_unsupported_shapes(cuda):
    z = torch.zeros((1, 32, 2, 40), device=cuda)
    la, bc = torch.zeros((1, 32, 2), device=cuda), torch.zeros((1, 32, 16),
                                                               device=cuda)
    with pytest.raises(ValueError, match="multiples of 16"):
        ssd_scan_cuda(z, la, bc, bc, chunk=32)
    with pytest.raises(ValueError, match="float32"):
        ssd_scan_cuda(z[..., :32].contiguous().half(), la, bc, bc)
    with pytest.raises(ValueError, match="chunk <= 128"):
        ssd_scan_cuda(z[..., :32].contiguous(), la, bc, bc, chunk=256)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,window", [
    (2, 512, 32, 0),      # zamba2 shared block, causal
    (1, 333, 4, 37),      # ragged, window
    (2, 300, 4, 40),      # window < the 64-row K/V tile at D = 112
])
def test_flash_attention_kernel_head_dim_112(cuda, dtype, B, S, H, window):
    """zamba2's head_dim 112 (32/32 heads): bf16 within 2e-2 and the
    per-entry rounding bound, f32 within 2e-5."""
    gen = torch.Generator(cuda).manual_seed(S)
    q, k, v = (_rand((B, S, H, 112), dtype, gen, cuda) for _ in range(3))
    o, lse = flash_attention_cuda(q, k, v, window=window)
    po, plse = flash_attention_plain(q, k, v, window=window)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(o.float(), po.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, plse, atol=2e-5, rtol=2e-5)
    if dtype == torch.bfloat16:
        pv = flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                   window=window)[0]
        _, e = torch.frexp(po.float())
        bound = 1.25 * 2.0 ** -8 * pv + 2 * torch.ldexp(torch.ones_like(pv),
                                                         e - 8)
        assert ((o.float() - po.float()).abs() <= bound).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("G", [1, 4])
def test_decode_attention_kernel_head_dim_112(cuda, dtype, G):
    """zamba2's shared block decodes with G = 1 (32/32 heads) at D = 112;
    a grouped case too, over empty, full, wrapped and ragged positions."""
    B, Hkv, C = 8, 32 // G, 512
    gen = torch.Generator(cuda).manual_seed(G)
    q = _rand((B, Hkv * G, 112), dtype, gen, cuda)
    k = _rand((B, C, Hkv, 112), dtype, gen, cuda)
    v = _rand((B, C, Hkv, 112), dtype, gen, cuda)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    for pos in (0, C - 1, 2 * C + 3,
                torch.randint(0, 2 * C, (B,), generator=gen, device=cuda)):
        out = decode_attention_cuda(q, k, v, pos)
        ref = decode_attention_plain(q, k, v, pos)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.cuda
def test_zamba2_smoke_on_card_matches_cpu(cuda):
    """zamba2 SMOKE (f32, chunk 16 so the SSD kernel takes it) on the
    card through the kernels against the CPU through the plain versions:
    forward logits within 1e-4, then six decode steps' hidden states."""
    from repro_torch.models import api
    cfg = registry.get_smoke("zamba2-7b").replace(ssm_chunk=16)
    cpu = torch.device("cpu")
    model_cpu = init_collab_lm(cfg, torch.Generator().manual_seed(0), cpu)
    model_dev = copy.deepcopy(model_cpu).to(cuda)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 48)))
    kernels.reset_launch_counts()
    with torch.no_grad():
        a = api.forward(model_dev.server, cfg, {"tokens": toks.to(cuda)})
        b = api.forward(model_cpu.server, cfg, {"tokens": toks})
    torch.testing.assert_close(a["logits"].cpu(), b["logits"], atol=1e-4,
                               rtol=1e-4)
    counts = kernels.launch_counts()
    assert counts["ssd_scan"] == cfg.n_layers
    assert counts["flash_attention"] == cfg.n_layers // cfg.shared_attn_every
    caches = [api.init_cache(cfg, 2, 16, d) for d in (cuda, cpu)]
    with torch.inference_mode():
        for t in range(6):
            ha = api.decode_step(model_dev.server, cfg, caches[0],
                                 toks[:, t].to(cuda), t)[1]
            hb = api.decode_step(model_cpu.server, cfg, caches[1],
                                 toks[:, t], t)[1]
            torch.testing.assert_close(ha.cpu(), hb, atol=1e-4, rtol=1e-4)
    assert kernels.launch_counts()["decode_attention"] == 6 * (
        cfg.n_layers // cfg.shared_attn_every)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-8b", "paper-synthetic",
                                  "zamba2-7b"])
def test_generate_on_card_matches_cpu(cuda, arch):
    """Greedy generate on the card (decode kernel) against the CPU (plain
    version), granite and zamba2 SMOKE in f32 and the paper's SERVING in
    bf16: logits within the end-to-end tolerance (1e-4, 2e-2), tokens
    equal row by row up to a first difference, allowed only inside the tie
    band; decode_attention launched once per attention layer per
    position; a seeded sampled run repeats itself bitwise."""
    from repro_torch.models import api
    from repro_torch.models.hybrid import _layout
    from repro_torch.serving.engine import ServeEngine
    cfg = (paper_synthetic.SERVING if arch == "paper-synthetic"
           else registry.get_smoke(arch))
    cpu = torch.device("cpu")
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[cfg.dtype]
    model_cpu = api.init_model(cfg, torch.Generator().manual_seed(0), cpu)
    model_dev = copy.deepcopy(model_cpu).to(cuda)
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 8)))
    kernels.reset_launch_counts()
    ta, la = ServeEngine(model_dev, cfg, 4, 32, cuda).generate(
        prompt, 8, return_logits=True)
    layers = (_layout(cfg)[0] if cfg.family == "hybrid" else cfg.n_layers)
    assert kernels.launch_counts()["decode_attention"] == layers * 16
    tb, lb = ServeEngine(model_cpu, cfg, 4, 32, cpu).generate(
        prompt, 8, return_logits=True)
    ta, la = ta.cpu(), la.cpu()
    top2 = lb.topk(2, dim=-1).values
    for b in range(4):
        for j in range(8):
            torch.testing.assert_close(la[b, j], lb[b, j], atol=tol, rtol=tol)
            if ta[b, j] != tb[b, j]:
                margin = top2[b, j, 0] - top2[b, j, 1]
                assert margin <= 2 * tol * (1 + top2[b, j, 0].abs())
                break
    runs = [ServeEngine(model_dev, cfg, 4, 32, cuda, seed=3).generate(
        prompt, 8, temperature=1.0) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("u_mode", ["truncated", "cosine", "independent"])
def test_train_paper_on_card_matches_cpu(cuda, u_mode):
    """Ten make_paper_step steps of the financial FULL config on the card
    against the CPU from the same weights and batches: every parameter
    within lr/10; train_paper runs on the card and keeps fhat <= u."""
    from repro_torch import bridge
    from repro_torch.configs import paper_financial
    from repro_torch.core.decomposition import init_paper_decomposition
    from repro_torch.data.synthetic import financial_series, financial_xy
    from repro_torch.training.loop import (make_paper_step, paper_batches,
                                           train_paper)
    cfg, lr, cpu = paper_financial.FULL, 2e-3, torch.device("cpu")
    kw = {"cosine": {"n_modes": 48},
          "independent": {"u_dims": (29, 10, 1)}}.get(u_mode, {})
    x, f = financial_xy(financial_series(0))
    m_cpu = init_paper_decomposition(cfg, torch.Generator().manual_seed(0),
                                     u_mode=u_mode, device=cpu, **kw)
    m_dev = bridge.paper_from_numpy(bridge.paper_to_numpy(m_cpu), cfg,
                                    u_mode, cuda)
    idx = paper_batches(x.shape[0], steps=10, batch=256, seed=0)
    for model, dev in ((m_dev, cuda), (m_cpu, cpu)):
        opt = AdamW(lr=lr, clip_norm=0.0)
        state = opt.init(trainable(model))
        step = make_paper_step(cfg, opt, u_mode=u_mode, safety_weight=20.0)
        xd, fd = torch.as_tensor(x, device=dev), torch.as_tensor(f, device=dev)
        for row in idx:
            ix = torch.as_tensor(row, device=dev)
            step(model, state, xd[ix], fd[ix])
    for (name, a), (_, b) in zip(m_dev.named_parameters(),
                                 m_cpu.named_parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), atol=0.1 * lr,
                                   rtol=0, msg=name)
    _, res = train_paper(torch.Generator(cuda).manual_seed(0), cfg, x, f,
                         u_mode=u_mode, steps=50, lr=lr, device=cuda, **kw)
    out = res["out"]
    assert out["u"].is_cuda and (out["fhat"] <= out["u"]).all()


# -- async serving on the card: the side stream and the worker thread ----------

def _async_case(cuda, arch="granite-8b", B=4, S=24):
    """A bf16 model on the card, its stream and a mixed-trigger operating
    point calibrated from a scan probe."""
    cfg = (paper_synthetic.SERVING if arch == "paper-synthetic"
           else registry.get_smoke(arch)).replace(dtype="bfloat16")
    model = init_collab_lm(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    probe = MonitorSession.open(model, cfg, batch=B, max_len=32,
                                config=SessionConfig(mode="scan")).run(toks)
    conf = dict(threshold=float(np.quantile(probe["u"], 0.8)),
                trigger_margin=0.0)
    return cfg, model, toks, conf


def _serve(model, cfg, toks, conf, **kw):
    sess = MonitorSession.open(model, cfg, batch=toks.shape[0], max_len=32,
                               config=SessionConfig(**conf, **kw))
    return sess.run(toks), sess.engine


def sleep_cycles(cuda, seconds: float) -> int:
    """Cycles of ``torch.cuda._sleep`` that keep the card busy for about
    ``seconds``, measured with CUDA events."""
    n = 10**7
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(n)
    end.record()
    end.synchronize()
    return int(n * seconds * 1e3 / start.elapsed_time(end))


def _caches_equal(a, b):
    return all(torch.equal(x, y) for name in a for x, y in zip(a[name],
                                                                b[name]))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-8b", "zamba2-7b"])
@pytest.mark.parametrize("transport", ["stream", "thread"])
def test_async_workers_match_sync_on_card(cuda, arch, transport):
    """A worker on a stream of its own against the sync session on the
    default stream: at max_staleness=0 u, fhat, triggers, per-stream bytes,
    server_pos and the final server cache bitwise; at 2 u and triggers
    bitwise, fhat <= u, and the same final cache and server_pos."""
    cfg, model, toks, conf = _async_case(cuda, arch)
    r1, e1 = _serve(model, cfg, toks, conf)
    assert 0 < r1["triggered"].mean() < 1
    for k in (0, 2):
        r, e = _serve(model, cfg, toks, conf, mode="async",
                      transport=transport, max_staleness=k)
        keys = ("u", "fhat", "triggered") if k == 0 else ("u", "triggered")
        for key in keys:
            np.testing.assert_array_equal(r[key], r1[key], err_msg=key)
        assert (r["fhat"] <= r["u"]).all()
        np.testing.assert_array_equal(r["comms"]["per_stream"]["bytes_sent"],
                                      r1["comms"]["per_stream"]["bytes_sent"])
        assert r["comms"]["async"]["inflight_now"] == 0
        np.testing.assert_array_equal(e.server_pos, e1.server_pos)
        assert _caches_equal(e.server.cache, e1.server.cache), (transport, k)


@pytest.mark.cuda
def test_thread_worker_runs_on_its_own_stream(cuda):
    """The worker thread computes on its own (non-default) stream, on the
    engine's device, in inference mode."""
    from repro_torch.serving.async_rpc import ThreadWorker
    cfg, model, toks, conf = _async_case(cuda)
    seen = []
    eng = MonitorSession.open(model, cfg, batch=4, max_len=32,
                              config=SessionConfig(**conf)).engine

    def catchup(*a):
        seen.append((torch.cuda.current_stream(cuda),
                     torch.is_inference_mode_enabled(),
                     torch.cuda.current_device()))
        return eng._catchup_apply(*a)
    worker = ThreadWorker(catchup, eng.params, eng.server.cache)
    eng.session(SessionConfig(mode="async", transport="thread",
                              max_staleness=2), worker=worker).run(toks)
    assert seen
    for stream, inference, device in seen:
        assert stream == worker.stream
        assert stream != torch.cuda.default_stream(cuda)
        assert inference and device == eng.device.index


@pytest.mark.cuda
def test_stream_dispatch_does_not_block_on_the_card(cuda):
    """After a few warm steps, a dispatch queued behind 0.5 s of device
    work on the worker's stream returns at once: nothing in dispatch
    waits for the side stream (no synchronise, no pageable copy).  The
    SMOKE catch-up's launches fit in the stream's launch queue; a longer
    one would block in cudaLaunchKernel once the queue is full."""
    from repro_torch.serving.async_rpc import StreamWorker
    cfg, model, toks, conf = _async_case(cuda)
    eng = MonitorSession.open(model, cfg, batch=4, max_len=32,
                              config=SessionConfig(**conf)).engine
    eng._u_head = lambda p, h: torch.ones(h.shape[0], device=cuda)
    worker = StreamWorker(eng._catchup_apply, eng.params, eng.server.cache)
    sess = eng.session(SessionConfig(mode="async", transport="stream",
                                     max_staleness=2), worker=worker)
    for t in range(4):                     # every stream triggers each step
        sess.step(toks[:, t])
    torch.cuda.synchronize()
    with torch.cuda.stream(worker.stream):
        torch.cuda._sleep(sleep_cycles(cuda, 0.5))
    t0 = time.perf_counter()
    sess.step(toks[:, 4])                  # triggers: dispatches behind it
    step_s = time.perf_counter() - t0
    last = worker.timings[-1]
    assert last.pending_at_return
    assert last.host_s < 0.1 and step_s < 0.25, (last.host_s, step_s)
    sess.close()
    assert last.done.query()
    assert last.device_ms() > 0


@pytest.mark.cuda
def test_launch_counts_exact_with_two_issuing_threads(cuda):
    """Two threads launch monitor_combine on their own streams: the count
    is exact; and a thread-worker session launches what the sync session
    does (the same catch-up rounds and combines)."""
    import threading
    u = torch.rand(8, device=cuda)
    calls = 500

    def launch():
        with torch.cuda.stream(torch.cuda.Stream(cuda)):
            for _ in range(calls):
                monitor_combine_cuda(u, u, u, s=1.0)
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    threads = [threading.Thread(target=launch) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert kernels.launch_counts()["monitor_combine"] == 2 * calls
    cfg, model, toks, conf = _async_case(cuda)
    counts = []
    for kw in ({}, dict(mode="async", transport="thread", max_staleness=2)):
        kernels.reset_launch_counts()
        _serve(model, cfg, toks, conf, **kw)
        counts.append(kernels.launch_counts())
    assert counts[0] == counts[1]
    assert counts[0]["decode_attention"] > 0
    assert counts[0]["monitor_combine"] > 0


# -- the wire transport on the card ---------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("slots", [8, 4], ids=["slots8", "slots=B"])
@pytest.mark.parametrize("k", [0, 2])
def test_wire_loopback_on_card(cuda, k, slots, tmp_path):
    """A correction server on the card in a thread of this process, a wire
    session of B = 4 streams against it: u and triggers bitwise the port's
    own sync run, server_pos and per-stream bytes equal, fhat <= u, and
    the server's replays launch both serve kernels.  At k = 0 fhat is
    within bf16's 2e-2 of sync; with slots == B the server's replay has
    the sync engine's shapes, and fhat and the lease's final cache rows
    are bitwise sync's."""
    import threading
    from repro_torch.serving import TransportSpec
    from repro_torch.serving.server import CorrectionServer
    cfg, model, toks, conf = _async_case(cuda)
    r1, e1 = _serve(model, cfg, toks, conf)
    srv = CorrectionServer(cfg, model, slots=slots, max_len=32,
                           uds=str(tmp_path / "s.sock"), device=cuda)
    stop = threading.Event()
    th = threading.Thread(target=srv.serve_forever, kwargs=dict(stop=stop),
                          daemon=True)
    th.start()
    try:
        kernels.reset_launch_counts()
        r, e = _serve(model, cfg, toks, conf, mode="async", max_staleness=k,
                      transport=TransportSpec("wire", address=srv.address))
    finally:
        stop.set()
        th.join(timeout=60)
        srv.close()
    assert not th.is_alive()
    for key in ("u", "triggered"):
        np.testing.assert_array_equal(r[key], r1[key], err_msg=key)
    assert 0 < r1["triggered"].mean() < 1
    assert (r["fhat"] <= r["u"]).all()
    if k == 0:
        np.testing.assert_allclose(r["fhat"], r1["fhat"], atol=2e-2)
        if slots == toks.shape[0]:
            np.testing.assert_array_equal(r["fhat"], r1["fhat"])
            assert _caches_equal(e1.server.cache, srv._cache)
    np.testing.assert_array_equal(e.server_pos, e1.server_pos)
    np.testing.assert_array_equal(r["comms"]["per_stream"]["bytes_sent"],
                                  r1["comms"]["per_stream"]["bytes_sent"])
    assert r["comms"]["wire"]["replies"] == srv.stats["requests"] > 0
    counts = kernels.launch_counts()
    assert counts["decode_attention"] > 0 and counts["monitor_combine"] > 0


# -- the shm transport and fleet failover on the card ---------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 2])
def test_shm_loopback_on_card(cuda, k, tmp_path):
    """A correction server on the card with ``shm=True`` (slots == B) in a
    thread of this process, an shm session against it: every reply rides
    the rings; u and triggers bitwise sync, server_pos and bytes equal,
    fhat <= u, bitwise sync at k = 0; no arena file is left."""
    import threading
    from repro_torch.serving import TransportSpec, shm
    from repro_torch.serving.server import CorrectionServer
    cfg, model, toks, conf = _async_case(cuda)
    r1, e1 = _serve(model, cfg, toks, conf)
    srv = CorrectionServer(cfg, model, slots=toks.shape[0], max_len=32,
                           uds=str(tmp_path / "s.sock"), shm=True,
                           device=cuda)
    stop = threading.Event()
    th = threading.Thread(target=srv.serve_forever, kwargs=dict(stop=stop),
                          daemon=True)
    th.start()
    try:
        kernels.reset_launch_counts()
        r, e = _serve(model, cfg, toks, conf, mode="async", max_staleness=k,
                      transport=TransportSpec("shm", address=srv.address))
    finally:
        stop.set()
        th.join(timeout=60)
        srv.close()
    for key in ("u", "triggered") + (("fhat",) if k == 0 else ()):
        np.testing.assert_array_equal(r[key], r1[key], err_msg=key)
    assert (r["fhat"] <= r["u"]).all()
    np.testing.assert_array_equal(e.server_pos, e1.server_pos)
    np.testing.assert_array_equal(r["comms"]["per_stream"]["bytes_sent"],
                                  r1["comms"]["per_stream"]["bytes_sent"])
    assert r["comms"]["shm"]["replies"] == srv.stats["requests"] > 0
    assert srv.stats["shm_sessions"] == 1
    counts = kernels.launch_counts()
    assert counts["decode_attention"] > 0 and counts["monitor_combine"] > 0
    assert shm.stray_arenas() == []


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["wire", "shm"])
def test_fleet_failover_on_card(cuda, kind, tmp_path):
    """Two thread servers on the card (slots == B, each replaying on a
    stream of its own) behind the router; a strict-sync ``fleet:`` session
    whose server is killed after step 8 finishes on the sibling bitwise
    equal to the sync run: u, fhat, triggers, server_pos and bytes; one
    failover."""
    import threading
    from repro_torch.serving import TransportSpec
    from repro_torch.serving.fleet import FleetSupervisor
    cfg, model, toks, conf = _async_case(cuda)
    r1, e1 = _serve(model, cfg, toks, conf)
    sup = FleetSupervisor(backend="thread", n_servers=2,
                          slots=toks.shape[0], max_len=32, cfg=cfg,
                          params=model, respawn=False, shm=kind == "shm",
                          root=str(tmp_path), device=cuda,
                          heartbeat_timeout_s=60.0)
    stop = threading.Event()
    loop = threading.Thread(target=sup.run_forever, args=(stop,),
                            daemon=True)
    try:
        sup.start()
        loop.start()
        deadline = time.monotonic() + 60
        while len(sup.live_servers()) < 2:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        sess = MonitorSession.open(
            model, cfg, batch=toks.shape[0], max_len=32,
            config=SessionConfig(**conf, mode="async", max_staleness=0,
                                 transport=TransportSpec(
                                     kind, address="fleet:"
                                     + sup.router_address)))
        out = []
        for t in range(toks.shape[1]):
            out.append(sess.step(toks[:, t]))
            if t == 8:
                worker = sess.engine._worker
                next(h for h in sup.servers.values()
                     if h.address == worker.server_address).kill()
        rep = sess.report()
        sess.close()
    finally:
        stop.set()
        loop.join(timeout=60)
        sup.close()
    r = {key: np.stack([o[key] for o in out], 1)
         for key in ("u", "fhat", "triggered")}
    for key in r:
        np.testing.assert_array_equal(r[key], r1[key], err_msg=key)
    np.testing.assert_array_equal(sess.engine.server_pos, e1.server_pos)
    np.testing.assert_array_equal(rep["per_stream"]["bytes_sent"],
                                  r1["comms"]["per_stream"]["bytes_sent"])
    assert rep["failover"]["failovers"] == 1
