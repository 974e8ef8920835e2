"""The port's training path (repro_torch.training and what it runs:
flash attention, forward, collab_forward, the losses, AdamW) against the
JAX reference on the CPU, with inputs made by numpy from a seed and
weights carried across with the bridge.

Tolerances: kernels f32 2e-5 and bf16 2e-2 (tests/test_kernels.py:23);
gradients of attention rel 1e-4 of the largest entry (f32 sums in
another order); whole towers f32 1e-4, bf16 2e-2 (``TOL_E2E``).
"""
import contextlib
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.core import decomposition as jdeco
from repro.data import tokens as jtok
from repro.kernels import ref as R
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import api as japi
from repro.nn.attention import chunked_attention
from repro.training import optimizer as jopt
from repro.training import schedule as jsched
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.core.decomposition import collab_forward, init_collab_lm
from repro_torch.data import tokens as ttok
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_backward,
                                                 flash_attention_plain)
from repro_torch.models import api as tapi
from repro_torch.training import optimizer as topt
from repro_torch.training import schedule as tsched
from repro_torch.training.loop import (make_train_step, to_device, trainable,
                                      train_collab_lm)

from _torch_parity import ARCHS, TOL, TOL_E2E
from _torch_parity import collab_pair as _collab_pair
from _torch_parity import port_config, port_train_steps, ref_train_steps

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(shape_q, shape_kv, dtype, seed=0):
    """Seeded numpy q, k, v as (jax arrays, torch tensors) in ``dtype``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in (shape_q, shape_kv, shape_kv)]
    jd, td = DT[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


_PAIRS = {}


def collab_pair(arch):
    """``_torch_parity.collab_pair`` with the reference's init drawn once
    per arch; every call bridges a fresh port model (tests train it)."""
    if arch not in _PAIRS:
        _PAIRS[arch] = _collab_pair(arch)[:3]
    jcfg, tcfg, params = _PAIRS[arch]
    return jcfg, tcfg, params, bridge.collab_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu")


def _block_rows(monkeypatch, rows, B, Hq, T):
    """Make the plain forward and the backward run ``rows`` query rows per
    block (their block size follows from ``fa.BLOCK_BYTES``)."""
    monkeypatch.setattr(fa, "BLOCK_BYTES", rows * 4 * B * Hq * T)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


# ------------------------------------------------------------ flash forward
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,bq,bk,window", [
    (1, 128, 4, 4, 64, 64, 64, 0),       # MHA
    (2, 256, 8, 2, 64, 128, 64, 0),      # GQA
    (1, 256, 4, 1, 128, 64, 128, 0),     # MQA, wide head
    (2, 256, 4, 2, 32, 64, 64, 96),      # sliding window
    (1, 512, 2, 2, 64, 128, 128, 128),   # SWA block-aligned
])
def test_flash_plain_matches_pallas_and_oracle(monkeypatch, dtype, B, S, Hq,
                                               Hkv, D, bq, bk, window):
    """TestFlashAttention's grid (tests/test_kernels.py:27-33): the plain
    version against the Pallas kernel in interpret mode and the naive
    oracle; 96-row query blocks so blocks and windows do not align."""
    (jq, jk, jv), (q, k, v) = _qkv((B, S, Hq, D), (B, S, Hkv, D), dtype)
    _block_rows(monkeypatch, 96, B, Hq, S)
    o, lse = flash_attention_plain(q, k, v, window=window)
    pallas = pallas_flash(jq, jk, jv, causal=True, window=window, bq=bq,
                          bk=bk)
    oracle = R.attention_ref(jq, jk, jv, causal=True, window=window)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(o), _np(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(o), _np(oracle), atol=tol, rtol=tol)
    assert lse.shape == (B, Hq, S) and lse.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,window", [(1, 0), (37, 0), (100, 0), (100, 7)])
def test_flash_plain_ragged_matches_oracle(monkeypatch, dtype, S, window):
    """Lengths no tile divides (the Pallas kernel asserts S % bq == 0, so
    only the oracle is compared); GQA, 16-row blocks; the LSE is the log
    of the softmax denominator."""
    (jq, jk, jv), (q, k, v) = _qkv((2, S, 4, 32), (2, S, 2, 32), dtype, 1)
    _block_rows(monkeypatch, 16, 2, 4, S)
    o, lse = flash_attention_plain(q, k, v, window=window)
    oracle = R.attention_ref(jq, jk, jv, causal=True, window=window)
    np.testing.assert_allclose(_np(o), _np(oracle), atol=TOL[dtype],
                               rtol=TOL[dtype])
    s = torch.einsum("bsgd,btgd->bgst", q.float(),
                     k.float().repeat_interleave(2, dim=2)) / np.sqrt(32)
    row, col = torch.arange(S)[:, None], torch.arange(S)[None, :]
    ok = (col <= row) & ((col > row - window) if window else True)
    want = torch.logsumexp(torch.where(ok, s, -torch.inf), -1)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)


# --------------------------------------------------------- flash gradients
GRAD_CASES = {"mha": ((2, 96, 4, 4, 32), 0), "gqa": ((2, 96, 8, 2, 32), 0),
              "window": ((1, 128, 4, 2, 16), 24)}


def _jax_grads(jq, jk, jv, do, window):
    def f(q, k, v):
        o = chunked_attention(q, k, v, q_block=32, causal=True, window=window)
        return jnp.sum(o * do)
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)]


def _assert_grads(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_flash_gradients_match_jax_grad(monkeypatch, case):
    """dQ/dK/dV of the autograd Function (default blocks) and of
    ``flash_attention_backward`` with 40-row blocks (ragged, crossing the
    window) against jax.grad of the reference's chunked_attention, f32."""
    (B, S, Hq, Hkv, D), window = GRAD_CASES[case]
    (jq, jk, jv), (q, k, v) = _qkv((B, S, Hq, D), (B, S, Hkv, D), "float32", 2)
    do = np.random.default_rng(3).standard_normal((B, S, Hq, D)
                                                  ).astype(np.float32)
    want = _jax_grads(jq, jk, jv, jnp.asarray(do), window)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention(*leaves, window=window)
    (out * torch.from_numpy(do)).sum().backward()
    _assert_grads([t.grad for t in leaves], want)
    _block_rows(monkeypatch, 40, B, Hq, S)
    o, lse = flash_attention_plain(q, k, v, window=window)
    _assert_grads(flash_attention_backward(q, k, v, o, lse,
                                           torch.from_numpy(do),
                                           window=window), want)


def test_flash_gradient_survives_checkpoint_recompute():
    """Under torch.utils.checkpoint the Function's forward runs again in
    the backward and saves a fresh lse: the gradients equal the plain
    autograd pass bit for bit."""
    _, (q, k, v) = _qkv((2, 50, 4, 16), (2, 50, 2, 16), "float32", 4)
    grads = []
    for remat in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        f = lambda a, b, c: ops.flash_attention(a, b, c, window=9) * 2.0
        out = checkpoint(f, *leaves, use_reentrant=False) if remat \
            else f(*leaves)
        out.square().sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ----------------------------------------------------- forward / collab
def _batch(cfg, B=2, S=24, seed=0):
    return next(ttok.lm_batches(seed, cfg, B, S))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("window", [0, 5])
def test_forward_matches_reference(arch, window):
    """Server tower logits over 24 tokens, and the hidden states in f32;
    ``window=5`` puts both packages' server on a sliding window.  (bf16
    hidden states are the bf16 residual stream after the final norm: a
    one-ulp rounding difference at |h| ~ 3 is 0.03, above 2e-2 on its
    small entries, so the comparison in bf16 is on the logits.)"""
    jcfg, tcfg, params, model = collab_pair(arch)
    if window:
        jcfg, tcfg = (c.replace(sliding_window=window) for c in (jcfg, tcfg))
    b = _batch(tcfg)
    want = jax.jit(lambda p, t: japi.forward(p, jcfg, {"tokens": t}))(
        params["server"], jnp.asarray(b["tokens"]))
    with torch.no_grad():
        got = tapi.forward(model.server, tcfg, to_device(b, "cpu"))
    tol = TOL_E2E[tcfg.dtype]
    keys = ("logits", "hidden") if tcfg.dtype == "float32" else ("logits",)
    for key in keys:
        np.testing.assert_allclose(_np(got[key]), _np(want[key]), atol=tol,
                                   rtol=tol, err_msg=key)
    assert float(got["aux_loss"]) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_collab_forward_matches_reference(arch):
    jcfg, tcfg, params, model = collab_pair(arch)
    b = _batch(tcfg, S=40)
    want = jax.jit(lambda p, t: jdeco.collab_forward(p, jcfg, {"tokens": t}))(
        params, jnp.asarray(b["tokens"]))
    with torch.no_grad():
        got = collab_forward(model, tcfg, to_device(b, "cpu"))
    tol = TOL_E2E[tcfg.dtype]
    for key in ("u", "v", "fhat", "corr", "logits", "t"):
        np.testing.assert_allclose(_np(got[key]), _np(want[key]), atol=tol,
                                   rtol=tol, err_msg=key)
    assert (got["fhat"] <= got["u"]).all()


def test_lm_batches_match_reference():
    cfg = treg.get_smoke("granite-8b")
    for a, b in zip(jtok.lm_batches(3, cfg, 2, 50), ttok.lm_batches(3, cfg, 2,
                                                                    50)):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
        break


# -------------------------------------------------------------- train step
def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree, np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch):
    """Three steps from the same weights on the same lm_batches: every
    loss part and the grad norm per step, then every f32 master against
    the reference's parameter, then the stored bf16 weights against the
    masters' casts, bit for bit.

    f32: every master within lr/10.  bf16: the bf16 gradients differ from
    the reference's by bf16 rounding, and where an entry near 0 takes the
    other sign Adam steps the other way (up to ~2 lr per step), so every
    master is held to 5 lr and each leaf to at most 5% of entries beyond
    lr/10.  Updating the bf16 weights without masters puts about 60% of a
    projection's entries beyond lr/10 (measured on this case), against
    at most 2.7% with them."""
    lr, n = 1e-3, 3
    jcfg, tcfg, params, model = collab_pair(arch)
    tree0 = jax.tree.map(np.asarray, params)
    batches = [b for b, _ in zip(ttok.lm_batches(5, tcfg, 2, 40), range(n))]
    want_p, want_h = ref_train_steps(jcfg, params, batches, lr)
    state, got_h = port_train_steps(tcfg, model, tree0, batches, lr)
    tol = TOL_E2E[tcfg.dtype]
    for g, w in zip(got_h, want_h):
        for key in ("total", "lm", "monitor", "safety", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=tol, atol=tol,
                                       err_msg=key)
    got_p = dict(_leaves(bridge.collab_to_numpy(model, state)))
    bf16 = tcfg.dtype == "bfloat16"
    for path, w in _leaves(want_p):
        d = np.abs(got_p[path] - w)
        assert d.max() <= (5 * lr if bf16 else 0.1 * lr), (path, d.max())
        assert (d > 0.1 * lr).mean() <= 0.05, path
    moved = max(np.abs(w - w0).max() for (_, w), (_, w0)
                in zip(_leaves(want_p), _leaves(tree0)))
    assert moved > 2 * lr  # the steps really moved the weights
    for p, mw in zip(model.parameters(), state.master):
        if mw is not None:
            assert p.dtype == torch.bfloat16
            assert torch.equal(p.detach(), mw.to(torch.bfloat16))


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    """Every parameter's gradient of the joint loss, leaf by leaf, against
    jax.grad of the reference's loss, relative to the leaf's largest
    entry (bf16: the bf16 gradients of the cast weights)."""
    from repro.core.losses import collab_lm_loss as j_loss
    jcfg, tcfg, params, model = collab_pair(arch)
    b = _batch(tcfg, S=40, seed=9)

    def loss(p, jb):
        return j_loss(jdeco.collab_forward(p, jcfg, jb), jb)["total"]

    want = jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(
        params, {k: jnp.asarray(v) for k, v in b.items()}))
    trainable(model)
    from repro_torch.core.losses import collab_lm_loss
    collab_lm_loss(collab_forward(model, tcfg, to_device(b, "cpu")),
                   to_device(b, "cpu"))["total"].backward()
    got = dict(_leaves(bridge.collab_to_numpy(model, grads=True)))
    tol = TOL_E2E[tcfg.dtype]
    for path, w in _leaves(want):
        np.testing.assert_allclose(got[path], w, rtol=tol,
                                   atol=tol * np.abs(w).max(), err_msg=path)


# ----------------------------------------------------- end to end (port)
@pytest.mark.parametrize("arch", ARCHS)
def test_losses_decrease(arch):
    """Mirror of test_system.py::test_losses_decrease for the port's
    train_collab_lm on the CPU; afterwards fhat <= u holds on a fresh
    batch."""
    cfg = port_config(arch)
    batches = ttok.lm_batches(0, cfg, batch=4, seq=32)
    model, hist = train_collab_lm(torch.Generator().manual_seed(0), cfg,
                                  batches, steps=30, lr=1e-3, log_every=1,
                                  log_fn=lambda *_: None, device="cpu")
    first = np.mean([h["total"] for h in hist[:5]])
    last = np.mean([h["total"] for h in hist[-5:]])
    assert last < first and np.isfinite(last)
    s_first = np.mean([h["safety"] for h in hist[:5]])
    s_last = np.mean([h["safety"] for h in hist[-5:]])
    assert s_last <= s_first * 1.1
    with torch.no_grad():
        out = collab_forward(model, cfg, to_device(next(batches), "cpu"))
    assert torch.isfinite(out["u"]).all()
    assert (out["fhat"] <= out["u"]).all()


def test_train_collab_lm_defaults_to_the_card(monkeypatch):
    """device=None means CUDA: without a card it raises before it builds
    anything on the host."""
    cfg = port_config("paper-synthetic")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_collab_lm(torch.Generator().manual_seed(0), cfg,
                        ttok.lm_batches(0, cfg, 2, 8), steps=1)



# ------------------------------------------- the step's profiler ranges
STEP_RANGES = ("train.forward", "train.backward", "adamw_update")


def _smoke_step(arch):
    """(model, state, step, batches): the port's SMOKE of ``arch`` from
    seed 0 on the CPU, with ``make_train_step`` and AdamW."""
    cfg = treg.get_smoke(arch)
    model = init_collab_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = topt.AdamW(lr=1e-3)
    state = opt.init(trainable(model))
    return model, state, make_train_step(cfg, opt), \
        ttok.lm_batches(0, cfg, 2, 32)


@pytest.mark.parametrize("arch", ["granite-8b", "zamba2-7b"])
def test_train_step_ranges_under_the_profiler(arch, tmp_path):
    """One step under a CPU profiler records ``train.forward``,
    ``train.backward`` and ``adamw_update`` once each, in that order,
    without overlap, on the caller's thread; the kernels' backward ranges
    lie inside ``train.backward``."""
    from torch.profiler import ProfilerActivity, profile
    model, state, step, batches = _smoke_step(arch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(model, state, to_device(next(batches), "cpu"))
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        evs = [e for e in json.load(fh)["traceEvents"]
               if e.get("cat") == "user_annotation"]
    got = [e for e in evs if e["name"] in STEP_RANGES]
    assert [e["name"] for e in got] == list(STEP_RANGES)
    assert {e["tid"] for e in got} == {threading.get_native_id()}
    for a, b in zip(got, got[1:]):
        assert a["ts"] + a["dur"] <= b["ts"], (a["name"], b["name"])
    bwd = got[1]
    inner = [e for e in evs if e["name"] in ("flash_attention_backward",
                                             "ssd_scan_backward")]
    assert inner
    for e in inner:
        assert bwd["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= bwd["ts"] + bwd["dur"], e["name"]


@pytest.mark.parametrize("arch", ["granite-8b", "zamba2-7b"])
def test_traced_steps_are_bitwise_untraced(arch):
    """Two steps under a CPU profiler and two without, from the same
    weights on the same batches: every loss part and every weight and
    optimizer moment bitwise equal."""
    from torch.profiler import ProfilerActivity, profile
    runs = []
    for traced in (False, True):
        model, state, step, batches = _smoke_step(arch)
        ctx = (profile(activities=[ProfilerActivity.CPU]) if traced
               else contextlib.nullcontext())
        with ctx:
            parts = [step(model, state, to_device(next(batches), "cpu"))
                     for _ in range(2)]
        runs.append((parts, list(model.parameters()), state))
    (pa, wa, sa), (pb, wb, sb) = runs
    for a, b in zip(pa, pb):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for xs, ys in ((wa, wb), (sa.m, sb.m), (sa.v, sb.v)):
        for x, y in zip(xs, ys):
            assert torch.equal(x, y)


# ------------------------------------------- optimizer and schedules
def _quadratic(opt_t, opt_j, steps):
    """Both optimizers on sum(w^2) + b^2 from the same start."""
    w = [torch.tensor([3.0, -2.0]), torch.tensor(5.0)]
    jp = {"w": jnp.array([3.0, -2.0]), "b": jnp.array(5.0)}
    st, jst = opt_t.init(w), opt_j.init(jp)
    for _ in range(steps):
        gn = opt_t.update([2 * x for x in w], st, w)
        jp, jst, jgn = opt_j.update({"w": 2 * jp["w"], "b": 2 * jp["b"]},
                                    jst, jp)
    return w, jp, float(gn), float(jgn)


class TestOptimizer:
    def test_adamw_quadratic_matches_reference(self):
        w, jp, gn, jgn = _quadratic(topt.AdamW(lr=0.1, clip_norm=1.0),
                                    jopt.AdamW(lr=0.1, clip_norm=1.0), 300)
        np.testing.assert_allclose(w[0].numpy(), jp["w"], atol=1e-5)
        np.testing.assert_allclose(w[1].numpy(), jp["b"], atol=1e-5)
        assert float(w[0].square().sum() + w[1] ** 2) < 1e-4
        assert gn == pytest.approx(jgn, rel=1e-5)

    def test_first_step(self):
        p = [torch.tensor([1.0])]
        opt = topt.AdamW(lr=0.1, clip_norm=0.0)
        opt.update([torch.tensor([0.5])], opt.init(p), p)
        assert float(p[0][0]) == pytest.approx(0.9, abs=1e-5)

    def test_clip_norm_reports_unclipped(self):
        p = [torch.tensor([0.0])]
        opt = topt.AdamW(lr=0.1, clip_norm=1.0)
        gn = opt.update([torch.tensor([1000.0])], opt.init(p), p)
        assert float(gn) == pytest.approx(1000.0, rel=1e-5)

    def test_weight_decay_pulls_to_zero(self):
        p = [torch.tensor([1.0])]
        opt = topt.AdamW(lr=0.1, weight_decay=0.1, clip_norm=0.0)
        st = opt.init(p)
        for _ in range(500):
            opt.update([torch.tensor([0.0])], st, p)
        assert abs(float(p[0][0])) < 0.05

    def test_sgd_momentum_matches_reference(self):
        w, jp, gn, jgn = _quadratic(topt.SGD(lr=0.05), jopt.SGD(lr=0.05), 200)
        np.testing.assert_allclose(w[0].numpy(), jp["w"], atol=1e-6)
        assert abs(float(w[1])) < 1e-3
        assert gn == pytest.approx(jgn, rel=1e-5, abs=1e-9)

    def test_bf16_parameter_keeps_an_f32_master(self):
        """Steps of 1e-4, below half the bf16 spacing under 1.0 (2^-9),
        would each round back to 1.0 in bf16; they accumulate in the
        master, and the stored weight, always the master's cast, moves
        once the master crosses a rounding boundary."""
        p = [torch.tensor([1.0], dtype=torch.bfloat16)]
        opt = topt.AdamW(lr=1e-4, clip_norm=0.0)
        st = opt.init(p)
        for _ in range(3):
            opt.update([torch.tensor([1.0], dtype=torch.bfloat16)], st, p)
        assert float(st.master[0][0]) == pytest.approx(0.9997, abs=1e-6)
        assert float(p[0][0]) == 1.0
        for _ in range(20):
            opt.update([torch.tensor([1.0], dtype=torch.bfloat16)], st, p)
        assert torch.equal(p[0], st.master[0].to(torch.bfloat16))
        assert float(p[0][0]) < 1.0


class TestSchedules:
    @pytest.mark.parametrize("step", [0, 17, 50, 100, 400, 1000, 2000])
    def test_match_reference(self, step):
        pairs = [(tsched.warmup_cosine(1.0, 100, 1000, 0.1),
                  jsched.warmup_cosine(1.0, 100, 1000, 0.1)),
                 (tsched.inverse_sqrt(1.0, 100),
                  jsched.inverse_sqrt(1.0, 100)),
                 (tsched.constant(3e-4), jsched.constant(3e-4))]
        for t, j in pairs:
            assert float(t(torch.tensor(step))) == pytest.approx(
                float(j(jnp.asarray(step))), rel=1e-6)

    def test_warmup_cosine_shape(self):
        f = tsched.warmup_cosine(peak=1.0, warmup=100, total=1000, floor=0.1)
        assert float(f(torch.tensor(0))) == 0.0
        assert float(f(torch.tensor(100))) == pytest.approx(1.0, rel=1e-3)
        assert float(f(torch.tensor(1000))) == pytest.approx(0.1, rel=1e-2)
