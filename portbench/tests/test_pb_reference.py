"""The plain reference against the port at small sizes on the CPU, both in
float32 so that only rounding order differs: the towers' hidden states,
u and v, the joint loss, the first AdamW steps, and the fleet's served
scores."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.tests import tiny
from portbench import port, traffic
from portbench.reference import model as ref
from portbench.reference import serve as ref_serve
from portbench.reference import train as ref_train

CPU = torch.device("cpu")
SEED = 2**31 + 3
FAMILIES = {"granite": tiny.GRANITE, "zamba2": tiny.ZAMBA}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def batch(p, B=2, S=32, seed=SEED):
    mix = traffic.load_mix("train")
    return next(traffic.lm_batches(seed, p["vocab_size"], B, S, mix["data"]))


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_forward_scores_and_loss(fam):
    from repro_torch.core.decomposition import collab_forward
    from repro_torch.core.losses import collab_lm_loss
    p = tiny.f32(FAMILIES[fam])
    cfg, model = port.collab_model(p, SEED, CPU)
    b = batch(p)
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    with torch.no_grad():
        out = collab_forward(model, cfg, tb)
        parts = collab_lm_loss(out, tb)
        W = ref_train.initial(SEED, p, CPU).__getitem__
        hs = ref.tower_hidden(W, p, "server", tb["tokens"].long())
        he = ref.tower_hidden(W, p, "edge", tb["tokens"].long())
        u, v = ref.u_score(W, p, he), ref.v_score(W, hs)
        mine = ref.collab_loss(W, p, tb, traffic.load_mix("train")["loss"])
    assert torch.allclose(u, out["u"], atol=2e-5, rtol=1e-5)
    assert torch.allclose(v, out["v"], atol=2e-4, rtol=1e-4)
    for k in ("lm", "monitor", "safety", "total"):
        assert abs(float(mine[k]) - float(parts[k])) <= 1e-4 * max(
            1.0, abs(float(parts[k]))), k


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_adamw_steps(fam):
    """The reference's three steps against the program's at f32: losses,
    first-gradient norms and the weights' change, leaf by leaf."""
    p = tiny.f32(FAMILIES[fam])
    wl = "granite-8b.train" if fam == "granite" else "zamba2-7b.train"
    out, ctx = tiny.drive(wl, CPU, p=p, limits={})
    n = out["numbers"]
    assert n["loss_gap"] < 1e-5, n
    assert n["grad_gap"] < 1e-3, n
    assert n["update_gap"] < 1e-3, n
    assert n["leaves_left_out"] == 0.0


def test_ssd_matches_a_sequential_scan():
    """The chunked SSD against the recurrence itself, at a length that is
    not a multiple of the chunk and one that is."""
    g = torch.Generator().manual_seed(1)
    for S in (37, 128):
        B, H, P, N = 2, 3, 4, 5
        x = torch.randn(B, S, H, P, generator=g, dtype=torch.float64)
        dt = torch.rand(B, S, H, generator=g, dtype=torch.float64)
        A = -torch.rand(H, generator=g, dtype=torch.float64) * 2
        Bm = torch.randn(B, S, N, generator=g, dtype=torch.float64)
        Cm = torch.randn(B, S, N, generator=g, dtype=torch.float64)
        h = torch.zeros(B, H, P, N, dtype=torch.float64)
        ys = []
        for t in range(S):
            a = torch.exp(dt[:, t] * A)
            h = h * a[:, :, None, None] + torch.einsum(
                "bn,bhp->bhpn", Bm[:, t], x[:, t] * dt[:, t, :, None])
            ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t], h))
        seq = torch.stack(ys, dim=1)
        got = ref.ssd(x, dt, A, Bm, Cm)
        assert torch.allclose(got, seq, atol=1e-10, rtol=1e-9)


def test_fleet_scores_match_the_served_session():
    """u and v of the reference over the streams' tokens against a sync
    session of the port in f32: every served u, every alarm's v."""
    p = tiny.f32(tiny.GRANITE)
    out, ctx = tiny.drive("granite-8b.fleet", CPU, p=p,
                          limits={"u_err": 1e-3})
    n = out["numbers"]
    assert n["u_err"] < 1e-5 and n["fhat_err"] < 1e-5, n
    assert n["v_err"] < 1e-3 and n["no_alarms"] == 0.0, n
    assert n["trig_flips"] == 0.0 and n["unsafe"] == 0.0, n


def test_fp8_rounds_to_three_mantissa_bits():
    x = torch.tensor([[1.0, 1.0625, 3.0, 448.0]])
    q = ref.fp8(x, -1)
    assert torch.equal(q, torch.tensor([[1.0, 1.0, 3.0, 448.0]]))
    assert ref.fp8(x.requires_grad_(True), -1).sum().backward() is None
    assert torch.equal(x.grad, torch.ones_like(x))


def test_serve_scores_in_blocks_equal_one_block(monkeypatch):
    p = tiny.f32(tiny.GRANITE)
    toks = np.stack([traffic.stream_tokens(SEED, i, 12, p["vocab_size"])
                     for i in range(5)])
    u1, v1 = ref_serve.scores(SEED, p, toks, CPU)
    monkeypatch.setattr(ref_serve, "TOKENS_PER_BLOCK", 24)
    u2, v2 = ref_serve.scores(SEED, p, toks, CPU)
    assert np.allclose(u1, u2, atol=1e-6) and np.allclose(v1, v2, atol=1e-5)
