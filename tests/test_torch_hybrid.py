"""The port's hybrid family (zamba2-7b, models/hybrid.py) against the JAX
reference on the CPU at SMOKE size, with inputs made by numpy from a seed
and weights carried across with the bridge: forward, decode, the
collaborative loss and its gradients, AdamW steps, sessions, and the
bridge.  The SSD scan and the Mamba2 block alone are in
tests/test_torch_ssm.py.

Tolerances: whole towers f32 1e-4 (``TOL_E2E``); trigger traces exact
outside the tie band.  The port's bitwise invariants
(scan == per-step loop, masked decode, fhat <= u, sync == scan) hold on
the hybrid as on the dense tower.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import decomposition as jdeco
from repro.kernels import ops as jops
from repro.models import api as japi
from repro.serving import SessionConfig as JSessionConfig
from repro.serving.collaborative import CollaborativeEngine as JEngine
from repro.training.checkpoint import _flatten
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.core import decomposition as tdeco
from repro_torch.core.gating import compact_correction
from repro_torch.core.losses import collab_lm_loss
from repro_torch.data import tokens as ttok
from repro_torch.models import api as tapi
from repro_torch.models import hybrid
from repro_torch.nn import ssm as tssm
from repro_torch.serving import MonitorSession, SessionConfig
from repro_torch.serving.collaborative import CollaborativeEngine
from repro_torch.training.loop import to_device, train_collab_lm, trainable

from _torch_parity import (TOL_E2E, gap_threshold, port_train_steps,
                           ref_train_steps, tie_band, token_stream,
                           with_threshold)

ARCH = "zamba2-7b"
_REF = {}


def _ref_params():
    """The reference's zamba2 SMOKE init, drawn once per process."""
    if "params" not in _REF:
        _REF["params"] = jdeco.init_collab_lm(jax.random.PRNGKey(0),
                                              jreg.get_smoke(ARCH))
    return _REF["params"]


def pair():
    """(JAX cfg, port cfg, reference params, a fresh port model on the CPU
    with the same weights)."""
    jcfg, tcfg = jreg.get_smoke(ARCH), treg.get_smoke(ARCH)
    params = _ref_params()
    return jcfg, tcfg, params, bridge.collab_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu")


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# ------------------------------------------------------------ the model
def _ref_ssm_stack(jcache):
    """The reference's hybrid cache as the port's: SSM states of every
    Mamba2 layer stacked in forward order, (n_mamba, B, ...)."""
    out = []
    for name in tssm.SSMCache._fields:
        blocks = np.asarray(getattr(jcache["ssm"], name), np.float32)
        leaf = blocks.reshape((-1,) + blocks.shape[2:])
        if jcache["ssm_tail"] is not None:
            leaf = np.concatenate(
                [leaf, np.asarray(getattr(jcache["ssm_tail"], name))], 0)
        out.append(leaf)
    return out


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_forward_matches_reference(impl):
    """Server tower logits and hidden states over 40 tokens (SMOKE, f32,
    five chunks of 8 rows) against the reference's forward,
    with the reference's scan through XLA and through its Pallas kernel
    (restored to XLA afterwards)."""
    jcfg, tcfg, params, model = pair()
    jcfg, tcfg = (c.replace(ssm_chunk=8) for c in (jcfg, tcfg))
    b = next(ttok.lm_batches(0, tcfg, 2, 40))
    try:
        jops.set_impl(impl)
        want = japi.forward(params["server"], jcfg,
                            {"tokens": jnp.asarray(b["tokens"])})
    finally:
        jops.set_impl("xla")
    with torch.no_grad():
        got = tapi.forward(model.server, tcfg, to_device(b, "cpu"))
    for key in ("logits", "hidden"):
        np.testing.assert_allclose(_np(got[key]), _np(want[key]),
                                   atol=TOL_E2E["float32"],
                                   rtol=TOL_E2E["float32"], err_msg=key)
    assert float(got["aux_loss"]) == 0.0


def test_decode_step_matches_reference():
    """Hidden states and logits over 6 tokens on a 16-slot cache and on a
    4-slot ring (zamba2's long-context window makes the shared block's
    cache a ring), and the SSM states of every layer after them."""
    jcfg, tcfg, params, model = pair()
    toks = token_stream(tcfg, 3, 6, seed=1)
    for max_len in (16, 4):
        jcache = japi.init_cache(jcfg, 3, max_len)
        cache = tapi.init_cache(tcfg, 3, max_len, "cpu")
        assert cache["attn"].k.shape[2] == max_len
        step = jax.jit(lambda c, t, p: japi.decode_step(params["server"],
                                                        jcfg, c, t, p))
        with torch.inference_mode():
            for t in range(toks.shape[1]):
                wl, wh, jcache = step(jcache, jnp.asarray(toks[:, t]),
                                      jnp.asarray(t, jnp.int32))
                gl, gh = tapi.decode_step(model.server, tcfg, cache,
                                          torch.as_tensor(toks[:, t]), t)
                for g, w in ((gh, wh), (gl, wl)):
                    np.testing.assert_allclose(_np(g), _np(w), atol=1e-4,
                                               rtol=1e-4)
        for name, got, want in zip(tssm.SSMCache._fields, cache["ssm"],
                                   _ref_ssm_stack(jcache)):
            np.testing.assert_allclose(_np(got), want, atol=1e-4, rtol=1e-4,
                                       err_msg=name)
        np.testing.assert_allclose(_np(cache["attn"].k),
                                   _np(jcache["attn"].k), atol=1e-4,
                                   rtol=1e-4)


def test_collab_forward_and_gradients_match_reference():
    """Every output of collab_forward, the loss parts, and every
    parameter's gradient of the joint loss (leaf by leaf, relative to its
    largest entry) against the reference, f32, with remat on in both."""
    from repro.core.losses import collab_lm_loss as j_loss
    jcfg, tcfg, params, model = pair()
    jcfg, tcfg = (c.replace(remat=True, ssm_chunk=16) for c in (jcfg, tcfg))
    b = next(ttok.lm_batches(9, tcfg, 2, 40))
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def loss(p):
        parts = j_loss(jdeco.collab_forward(p, jcfg, jb), jb)
        return parts["total"], parts

    (_, jparts), want = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    jout = jax.jit(lambda p: jdeco.collab_forward(p, jcfg, jb))(params)
    trainable(model)
    out = tdeco.collab_forward(model, tcfg, to_device(b, "cpu"))
    parts = collab_lm_loss(out, to_device(b, "cpu"))
    parts["total"].backward()
    tol = TOL_E2E["float32"]
    for key in ("u", "v", "fhat", "corr", "logits", "t"):
        np.testing.assert_allclose(_np(out[key]), _np(jout[key]), atol=tol,
                                   rtol=tol, err_msg=key)
    for key in ("total", "lm", "monitor", "safety"):
        np.testing.assert_allclose(_np(parts[key]), _np(jparts[key]),
                                   atol=tol, rtol=tol, err_msg=key)
    assert (out["fhat"] <= out["u"]).all()
    got = _flatten(bridge.collab_to_numpy(model, grads=True))
    want = _flatten(jax.tree.map(np.asarray, want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=tol,
                                   atol=tol * np.abs(w).max(), err_msg=path)


def test_train_steps_match_reference():
    """Three AdamW steps from the same weights on the same lm_batches: loss
    parts and grad norm per step, then every f32 parameter against the
    reference's: within lr/4, and within lr/10 for all but 1e-4 of each
    leaf's entries.  The SSD scan sums in another order than XLA (grad
    norms differ by ~2e-5 relative at step 1), and Adam scales each
    entry's step by that entry's own gradient history, so an entry whose
    gradients nearly cancel across the steps moves the rounding
    difference up to a step's size: on this case 1 or 2 entries of the
    largest leaves (524288 entries) lie beyond lr/10, the worst at
    0.14 lr."""
    lr = 1e-3
    jcfg, tcfg, params, model = pair()
    tree0 = jax.tree.map(np.asarray, params)
    batches = [b for b, _ in zip(ttok.lm_batches(5, tcfg, 2, 40), range(3))]
    want_p, want_h = ref_train_steps(jcfg, params, batches, lr)
    state, got_h = port_train_steps(tcfg, model, tree0, batches, lr)
    tol = TOL_E2E["float32"]
    for g, w in zip(got_h, want_h):
        for key in ("total", "lm", "monitor", "safety", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=tol, atol=tol,
                                       err_msg=key)
    got_p = _flatten(bridge.collab_to_numpy(model, state))
    moved = 0.0
    for path, w in _flatten(want_p).items():
        d = np.abs(got_p[path] - w)
        assert d.max() <= 0.25 * lr, (path, d.max())
        assert (d > 0.1 * lr).mean() <= 1e-4, path
        moved = max(moved, float(np.abs(w - _flatten(tree0)[path]).max()))
    assert moved > 2 * lr


def test_bridge_round_trip_zamba2():
    """Every leaf of the doubly stacked mamba_blocks, the shared block and
    the tail lands in the port module of the same path and comes back
    unchanged; a leaf with the wrong number of stacked layers raises."""
    jcfg, tcfg, params, model = pair()
    tree = jax.tree.map(np.asarray, params)
    flat = _flatten(tree)
    assert sum(p.numel() for p in model.parameters()) == sum(
        w.size for w in flat.values())
    back = _flatten(bridge.collab_to_numpy(model))
    assert back.keys() == flat.keys()
    for path, w in flat.items():
        np.testing.assert_array_equal(back[path], w)
    np.testing.assert_array_equal(
        model.server.mamba_blocks[1][0].mamba.A_log.numpy(),
        tree["server"]["mamba_blocks"]["mamba"]["A_log"][1, 0])
    np.testing.assert_array_equal(
        model.server.tail[0].mamba.conv_x.w.numpy(),
        tree["server"]["tail"]["mamba"]["conv_x"]["w"][0])
    tree["server"]["mamba_blocks"]["ln"]["scale"] = \
        tree["server"]["mamba_blocks"]["ln"]["scale"][:, :1]
    with pytest.raises(ValueError, match="stacked layers"):
        bridge.collab_from_numpy(tree, tcfg, "cpu")


# -------------------------------------------------------------- serving
B, S, MAX_LEN = 4, 16, 32


@pytest.fixture(scope="module")
def serve_case():
    """Weights, a stream, a mixed-trigger threshold and the JAX traces."""
    jcfg, tcfg, params, model = pair()
    stream = token_stream(tcfg, B, S, seed=3)
    probe = JEngine(params, jcfg, batch=B, max_len=MAX_LEN).session(
        JSessionConfig(mode="scan")).run(stream)
    thr, gap = gap_threshold(probe["u"])
    jcfg = with_threshold(jcfg, thr)
    ref = {mode: JEngine(params, jcfg, batch=B, max_len=MAX_LEN).session(
        JSessionConfig(mode=mode)).run(stream) for mode in ("sync", "scan")}
    return tcfg, model, stream, thr, gap, ref


@pytest.mark.parametrize("mode", ["sync", "scan"])
def test_session_matches_jax_session(serve_case, mode):
    tcfg, model, stream, thr, gap, ref = serve_case
    tol = TOL_E2E[tcfg.dtype]
    got = MonitorSession.open(
        model, tcfg, batch=B, max_len=MAX_LEN, device="cpu",
        config=SessionConfig(mode=mode, threshold=thr, trigger_margin=0.0)
    ).run(stream)
    want = ref[mode]
    ties = tie_band(want["u"], thr, tol)
    print(f"\n{ARCH} {mode}: tie band |u-thr| <= {tol}: {int(ties.sum())} "
          f"of {ties.size} entries (threshold gap {gap:.3g}); trigger rate "
          f"{want['triggered'].mean():.3f}")
    assert 0 < want["triggered"].mean() < 1, "need mixed triggers"
    np.testing.assert_allclose(got["u"], want["u"], atol=tol, rtol=tol)
    np.testing.assert_allclose(got["fhat"], want["fhat"], atol=tol, rtol=tol)
    np.testing.assert_array_equal(got["triggered"][~ties],
                                  want["triggered"][~ties])
    for key in ("bytes_sent", "bytes_baseline"):
        np.testing.assert_array_equal(got["comms"]["per_stream"][key],
                                      want["comms"]["per_stream"][key])


def test_sync_scan_and_per_step_loop_agree_bitwise():
    """Inside the port on the hybrid: the scan path equals a per-step loop
    of decode_step + compact_correction bit for bit; sync and scan agree
    on u, triggers and per-stream bytes, fhat within 1e-6; fhat <= u."""
    _, tcfg, _, model = pair()
    tcfg = with_threshold(tcfg, 0.1)
    stream = token_stream(tcfg, 3, 12)
    eng = CollaborativeEngine(model, tcfg, 3, 32, device="cpu")
    rs = eng.session(SessionConfig(mode="scan")).run(stream)
    m, ecfg = tcfg.monitor, tdeco.edge_arch(tcfg)
    ecache = tapi.init_cache(ecfg, 3, 32, "cpu")
    scache = tapi.init_cache(tcfg, 3, 32, "cpu")
    fhats = []
    with torch.inference_mode():
        for t in range(stream.shape[1]):
            tok = torch.as_tensor(stream[:, t]).long()
            _, eh = tapi.decode_step(model.edge, ecfg, ecache, tok, t)
            u = eng._u_head(model, eh)
            _, sh = tapi.decode_step(model.server, tcfg, scache, tok, t)
            fhat, _, _ = compact_correction(
                u, sh.float(),
                lambda buf: m.s * tdeco.sigma(eng._v_head(model, buf),
                                              m.sigma),
                m.threshold, m.trigger_margin, 3)
            fhats.append(fhat.numpy())
    np.testing.assert_array_equal(rs["fhat"], np.stack(fhats, 1))
    r1 = CollaborativeEngine(model, tcfg, 3, 32, device="cpu").session().run(
        stream)
    assert 0 < r1["triggered"].mean() < 1
    np.testing.assert_array_equal(r1["u"], rs["u"])
    np.testing.assert_array_equal(r1["triggered"], rs["triggered"])
    np.testing.assert_allclose(r1["fhat"], rs["fhat"], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(r1["comms"]["per_stream"]["bytes_sent"],
                                  rs["comms"]["per_stream"]["bytes_sent"])
    assert (r1["fhat"] <= r1["u"]).all() and (rs["fhat"] <= rs["u"]).all()


@torch.inference_mode()
def test_masked_decode_keeps_inactive_rows_and_zero_rows():
    """A masked decode on the hybrid server leaves an inactive row's SSM
    states, conv tails and KV rows bit-unchanged in every layer, and
    zero_rows resets one row of every hybrid cache leaf."""
    _, tcfg, _, model = pair()
    toks = torch.as_tensor(token_stream(tcfg, 3, 4, seed=2))
    eng = CollaborativeEngine(model, tcfg, 3, 16, device="cpu").server
    eng.decode_at(toks[:, 0], 0, torch.ones(3, dtype=torch.bool))
    leaves = lambda: [*eng.cache["ssm"], *eng.cache["attn"]]
    before = [t.clone() for t in leaves()]
    eng.decode_masked(toks[:, 1], 1, torch.tensor([True, False, True]))
    for old, new in zip(before, leaves()):
        assert torch.equal(old[:, 1], new[:, 1])
        assert not torch.equal(old[:, 0], new[:, 0])
    eng.zero_rows(torch.tensor([False, True, False]))
    for leaf in leaves():
        assert not leaf[:, 1].any() and leaf[:, 0].any()


# ------------------------------------------------------- arch smoke mirror
def test_arch_smoke_forward_train_step_decode():
    """tests/test_arch_smoke.py's three zamba2 cases in the port: forward
    shapes with no NaN, one train step with a finite, moving loss, one
    decode step on a fresh cache; and the FULL config's assignment."""
    from repro_torch.training.optimizer import AdamW
    cfg = treg.get_smoke(ARCH)
    gen = torch.Generator().manual_seed(0)
    model = tdeco.init_collab_lm(cfg, gen, "cpu")
    b = to_device(next(ttok.lm_batches(0, cfg, 2, 32)), "cpu")
    with torch.no_grad():
        out = tapi.forward(model.server, cfg, b)
    assert out["logits"].shape == (2, 32, cfg.vocab_size)
    assert out["hidden"].shape == (2, 32, cfg.d_model)
    assert torch.isfinite(out["logits"]).all()
    params = trainable(model)
    loss = collab_lm_loss(tdeco.collab_forward(model, cfg, b), b)["total"]
    loss.backward()
    assert torch.isfinite(loss) and sum(
        float(p.grad.abs().sum()) for p in params if p.grad is not None) > 0
    opt = AdamW(lr=1e-3)
    opt.update([p.grad for p in params], opt.init(params), params)
    with torch.no_grad():
        l2 = collab_lm_loss(tdeco.collab_forward(model, cfg, b), b)["total"]
    assert torch.isfinite(l2) and float(l2) != float(loss.detach())
    cache = tapi.init_cache(cfg, 2, 32, "cpu")
    with torch.no_grad():
        logits, hidden = tapi.decode_step(model.server, cfg, cache,
                                          b["tokens"][:, 0], 31)
    assert logits.shape == (2, cfg.vocab_size)
    assert hidden.shape == (2, cfg.d_model)
    assert torch.isfinite(logits).all()
    full = treg.get_full(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.d_ff, full.vocab_size) == (81, 3584, 32, 32, 14336, 32000)
    assert hybrid._layout(full) == (13, 6, 3)
    assert full.resolved_head_dim == 112


def test_losses_decrease():
    """Mirror of test_system.py::test_losses_decrease[zamba2-7b] for the
    port's train_collab_lm on the CPU; afterwards fhat <= u on a fresh
    batch."""
    cfg = treg.get_smoke(ARCH)
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
        out = tdeco.collab_forward(model, cfg, to_device(next(batches), "cpu"))
    assert (out["fhat"] <= out["u"]).all()
