"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the
tolerance table, weights carried across with the bridge, token streams
made with numpy, and the tie band of a trigger comparison."""
import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import registry as jreg
from repro.core import decomposition as jdeco
from repro.training import optimizer as jopt
from repro.training.loop import make_train_step as j_make_train_step
from repro_torch import bridge
from repro_torch.configs import paper_synthetic as tsyn_cfg
from repro_torch.configs import registry as treg
from repro_torch.training import optimizer as topt
from repro_torch.training.loop import make_train_step, to_device, trainable

# tests/test_kernels.py:23 -- f32 2e-5, bf16 2e-2
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# end-to-end scores after a whole tower: f32 1e-4, bf16 2e-2
TOL_E2E = {"float32": 1e-4, "bfloat16": 2e-2}

ARCHS = ("granite-8b", "paper-synthetic")


def port_config(arch):
    """The port's LM config of ``arch``: its SMOKE, or for
    ``paper-synthetic`` the LM-scale SERVING workload (the registry gives
    that name's PaperMLPConfig, as the reference's does)."""
    if arch == "paper-synthetic":
        return tsyn_cfg.SERVING
    return treg.get_smoke(arch)


def configs(arch):
    """(JAX cfg, port cfg): an LM config's SMOKE (granite-8b f32, zamba2-7b
    f32) or the paper's SERVING workload (bf16)."""
    if arch == "paper-synthetic":
        from repro.configs.paper_synthetic import SERVING
        return SERVING, port_config(arch)
    return jreg.get_smoke(arch), port_config(arch)


def with_threshold(cfg, threshold, margin=0.0):
    return cfg.replace(monitor=cfg.monitor.__class__(
        **{**cfg.monitor.__dict__, "threshold": threshold,
           "trigger_margin": margin}))


def collab_pair(arch, seed=0):
    """Reference params from ``init_collab_lm`` and the same weights in the
    port, on the CPU."""
    jcfg, tcfg = configs(arch)
    params = jdeco.init_collab_lm(jax.random.PRNGKey(seed), jcfg)
    model = bridge.collab_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                     "cpu")
    return jcfg, tcfg, params, model


def ref_train_steps(jcfg, params, batches, lr):
    """The reference's AdamW steps (jit) over ``batches``: (final params as
    numpy, per-step metrics as floats)."""
    opt = jopt.AdamW(lr=lr)
    step = jax.jit(j_make_train_step(jcfg, opt))
    state, hist = opt.init(params), []
    for b in batches:
        params, state, m = step(params, state,
                                {k: jnp.asarray(v) for k, v in b.items()})
        hist.append({k: float(v) for k, v in m.items()})
    return jax.tree.map(np.asarray, params), hist


def port_train_steps(tcfg, model, tree, batches, lr):
    """The port's AdamW steps on the CPU from the reference's tree
    ``tree`` (masters loaded from it): (optimizer state, per-step
    metrics as floats)."""
    params = trainable(model)
    opt = topt.AdamW(lr=lr)
    state = opt.init(params)
    bridge.load_masters(tree, model, state)
    step = make_train_step(tcfg, opt)
    hist = [{k: float(v) for k, v in step(model, state,
                                          to_device(b, "cpu")).items()}
            for b in batches]
    return state, hist


def token_stream(cfg, batch, length, seed=0):
    """(batch, length) token ids, or (batch, length, K) for the audio
    family's K codebooks."""
    tail = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, length) + tail).astype(np.int32)


def gap_threshold(u, lo=0.75, hi=0.92):
    """A threshold in the widest gap between sorted u values whose
    quantiles lie in [lo, hi]: a mixed-trigger operating point (about the
    paper's Fig-4 rates) away from ties."""
    s = np.sort(np.asarray(u, np.float64).ravel())
    i0, i1 = int(lo * (s.size - 1)), int(hi * (s.size - 1))
    gaps = s[i0 + 1:i1 + 1] - s[i0:i1]
    k = i0 + int(np.argmax(gaps))
    return float((s[k] + s[k + 1]) / 2), float(s[k + 1] - s[k])


def tie_band(u, thr, tol):
    """Entries whose trigger decision a difference of ``tol`` could flip."""
    return np.abs(np.asarray(u, np.float64) - thr) <= tol


# ------------------------------------------------- the SSD kernel's numerics
def tf32(a):
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as the kernel does on the bits: (bits + 0x1000) & ~0x1fff."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32_matmul(a, b, passes=3):
    """a @ b in f32 from TF32 operands: one product (hi hi) or three (lo hi
    + hi lo, then hi hi), each operand split as hi = tf32(x), lo =
    tf32(x - hi), as the kernel's tensor-core products."""
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def ssd_emulate(xdt, la, Bm, Cm, chunk, pt, passes=3):
    """The arithmetic of ``csrc/ssd_scan.cu`` in numpy: C B^T once per
    (batch row, chunk) in f32; per chunk the f64 inclusive cumsum of la,
    exp(cum_t), exp(cum_last - cum_t) and the score weights 2^x of f64
    differences of log2(e)-scaled cumsums, each rounded once to f32; the
    P columns in tiles of ``pt``, each on its own; every product in TF32
    (``passes`` = 3 or 1) with f32 sums.  A ragged last chunk is padded
    with zero rows.  Returns (y (B, S, H, P), h_final (B, H, P, N))."""
    xdt, la, Bm, Cm = (np.asarray(t, np.float32) for t in (xdt, la, Bm, Cm))
    B, S, H, P = xdt.shape
    N, L = Bm.shape[-1], chunk
    nch = -(-S // L)
    pad = nch * L - S
    if pad:
        xdt, la, Bm, Cm = (np.concatenate(
            [t, np.zeros((B, pad) + t.shape[2:], np.float32)], axis=1)
            for t in (xdt, la, Bm, Cm))
    y = np.zeros((B, nch * L, H, P), np.float32)
    hT = np.zeros((B, H, N, P), np.float32)  # the state, transposed
    tril = np.tril(np.ones((L, L), bool))
    for c in range(nch):
        rows = slice(c * L, (c + 1) * L)
        Bc, Cc = Bm[:, rows], Cm[:, rows]                      # (B, L, N)
        cb = (Cc @ np.swapaxes(Bc, 1, 2))[:, None]             # (B, 1, L, L)
        cum = np.cumsum(np.moveaxis(la[:, rows], 1, 2).astype(np.float64),
                        axis=-1)                               # (B, H, L)
        ec = np.exp(cum.astype(np.float32))
        dte = np.exp((cum[..., -1:] - cum).astype(np.float32))
        cum2 = cum * np.log2(np.e)
        d = np.where(tril, cum2[..., :, None] - cum2[..., None, :], -np.inf)
        G = (cb * np.exp2(d.astype(np.float32))).astype(np.float32)
        decay = ec[..., -1, None, None]
        Bd = (Bc[:, None] * dte[..., None]).astype(np.float32)  # (B, H, L, N)
        for p0 in range(0, P, pt):
            cols = slice(p0, p0 + pt)
            X = np.moveaxis(xdt[:, rows, :, cols], 1, 2)       # (B, H, L, pt)
            yc = tf32_matmul(Cc[:, None], hT[..., cols], passes)
            yc = (yc * ec[..., None]).astype(np.float32)
            yc = yc + tf32_matmul(G, X, passes)
            y[:, rows, :, cols] = np.moveaxis(yc, 1, 2)
            hT[..., cols] = (decay * hT[..., cols]
                             + tf32_matmul(np.swapaxes(Bd, -1, -2), X,
                                           passes))
    return y[:, :S], np.swapaxes(hT, -1, -2).copy()


def serve_case(arch, batch, max_len, steps):
    """A cross-package serving case: the reference's weights carried into
    the port, a token stream, a mixed-trigger threshold (``gap_threshold``
    of the port's scan u) set in both configs, and each package's sync
    engine and run on them."""
    from repro.serving.collaborative import CollaborativeEngine as JEngine
    from repro_torch.serving import SessionConfig
    from repro_torch.serving.collaborative import CollaborativeEngine
    jcfg, tcfg, params, model = collab_pair(arch)
    toks = token_stream(tcfg, batch, steps)
    probe = CollaborativeEngine(model, tcfg, batch, max_len,
                                device="cpu").session(
        SessionConfig(mode="scan")).run(toks)
    thr, _ = gap_threshold(probe["u"])
    jcfg, tcfg = with_threshold(jcfg, thr), with_threshold(tcfg, thr)
    tsync = CollaborativeEngine(model, tcfg, batch, max_len, device="cpu")
    jsync = JEngine(params, jcfg, batch=batch, max_len=max_len)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, model=model, toks=toks,
                thr=thr, tsync=tsync, rt=tsync.session().run(toks),
                jsync=jsync, rj=jsync.session().run(toks))


def check_across(r, mine, other, srv_pos, sync_pos, thr, plane="wire"):
    """A transported run ``r`` against its own package's sync ``mine`` (u,
    triggers exact) and the other package's ``other`` (u within the
    end-to-end tolerance, triggers equal outside the tie band, whose size
    it returns); server_pos and bytes equal to sync; fhat <= u; the
    ``plane`` section of the comms report carried every reply."""
    np.testing.assert_array_equal(r["u"], mine["u"])
    np.testing.assert_array_equal(r["triggered"], mine["triggered"])
    assert 0.0 < r["triggered"].mean() < 1.0, "need mixed triggers"
    np.testing.assert_allclose(r["u"], other["u"], atol=TOL_E2E["float32"])
    band = tie_band(other["u"], thr, TOL_E2E["float32"])
    np.testing.assert_array_equal(r["triggered"][~band],
                                  np.asarray(other["triggered"])[~band])
    np.testing.assert_array_equal(srv_pos, sync_pos)
    assert (np.asarray(r["fhat"]) <= np.asarray(r["u"])).all()
    rep = r["comms"]
    assert rep["bytes_sent"] == mine["comms"]["bytes_sent"]
    np.testing.assert_array_equal(rep["per_stream"]["bytes_sent"],
                                  mine["comms"]["per_stream"]["bytes_sent"])
    p = rep[plane]
    assert p["tx_bytes"] > 0 and p["rx_bytes"] > 0 and p["rtt_mean_s"] > 0
    assert p["replies"] == rep["async"]["requests"] > 0
    assert rep["async"]["inflight_now"] == 0
    return int(band.sum())


def no_stray_arenas(timeout=5.0):
    """True once no shared-memory arena file is left on disk.  Another
    test process of the suite may hold one for the instant between its
    creation and its unlink at the handshake, so this waits a moment for
    the directory to clear before it answers."""
    import time

    from repro_torch.serving import shm
    deadline = time.monotonic() + timeout
    while shm.stray_arenas():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True
