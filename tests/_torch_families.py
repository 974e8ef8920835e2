"""The cases of the family parity tests (tests/test_torch_families.py for
the dense Qwen archs, tests/test_torch_moe.py for mixtral-8x22b and
deepseek-v3, tests/test_torch_vlm.py, tests/test_torch_audio.py and
tests/test_torch_xlstm.py for the last three families): each takes an
arch name and holds the port to the JAX reference on the CPU at SMOKE
size in f32, the same weights carried across by the bridge.

A VLM's cross blocks would add nothing with the reference's zero gates
(tanh(0) = 0), nor its decode with zero image K/V, so ``pair`` opens the
gates in the reference's tree before the bridge carries it, and
``filled_cross`` has both packages' ``init_cache`` fill the image K/V
with the same seeded normal draws."""
import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jreg
from repro.core import decomposition as jdeco
from repro.core.losses import collab_lm_loss as j_loss
from repro.models import api as japi
from repro.serving import SessionConfig as JSessionConfig
from repro.serving.collaborative import CollaborativeEngine as JEngine
from repro.serving.engine import ServeEngine as JServeEngine
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training.checkpoint import _flatten
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.core import decomposition as tdeco
from repro_torch.core.losses import collab_lm_loss
from repro_torch.data import tokens as ttok
from repro_torch.models import api as tapi
from repro_torch.nn import moe as tmoe
from repro_torch.nn.module import linear
from repro_torch.serving import MonitorSession, SessionConfig
from repro_torch.serving.collaborative import CollaborativeEngine
from repro_torch.serving.engine import ServeEngine
from repro_torch.training import checkpoint as tckpt
from repro_torch.training.loop import to_device, trainable
from repro_torch.training.optimizer import AdamW, keeps_masters

from _torch_parity import (TOL_E2E, gap_threshold, port_train_steps,
                           ref_train_steps, tie_band, token_stream,
                           with_threshold)

TIE = 1e-6  # routing near-tie band on router probabilities
_PAIRS = {}
# arch variants: name -> (registry arch, SMOKE overrides)
VARIANTS = {
    # a VLM whose layers leave a tail after the super-blocks
    "llama-3.2-vision-11b+tail": ("llama-3.2-vision-11b", dict(n_layers=3)),
    # an MoE backbone with no MoE layers: an empty blocks_moe stack
    "deepseek-v3-671b+dense1": ("deepseek-v3-671b",
                                dict(n_layers=1, first_dense_layers=1,
                                     mtp_depth=0)),
}
GATE_SEED, CROSS_SEED = 7, 11


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def smoke_configs(arch):
    """(JAX cfg, port cfg) of ``arch``'s SMOKE, or of a ``VARIANTS`` name."""
    base, over = VARIANTS.get(arch, (arch, {}))
    return (jreg.get_smoke(base).replace(**over),
            treg.get_smoke(base).replace(**over))


def open_gates(params):
    """A VLM tree with its cross gates at seeded values in [0.5, 1) (the
    reference initialises them to zero)."""
    gate = params["server"]["cross"]["gate"]
    vals = np.random.default_rng(GATE_SEED).uniform(
        0.5, 1.0, gate.shape).astype(np.float32)
    server = dict(params["server"], cross=dict(params["server"]["cross"],
                                               gate=jnp.asarray(vals)))
    return dict(params, server=server)


def pair(arch):
    """(JAX cfg, port cfg, reference params (drawn once per process; a
    VLM's with its gates opened), a fresh port model on the CPU with the
    same weights)."""
    jcfg, tcfg = smoke_configs(arch)
    if arch not in _PAIRS:
        params = jax.jit(lambda k: jdeco.init_collab_lm(k, jcfg))(
            jax.random.PRNGKey(0))
        _PAIRS[arch] = open_gates(params) if jcfg.family == "vlm" \
            else params
    params = _PAIRS[arch]
    return jcfg, tcfg, params, bridge.collab_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu")


def cross_rows(shape):
    """The image keys and values a filled VLM cache holds: seeded normal
    draws of ``shape`` (n_super, B, n_image_tokens, Hkv, D), f32."""
    rng = np.random.default_rng(CROSS_SEED)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(2))


@contextlib.contextmanager
def filled_cross():
    """Within: both packages' ``init_cache`` (the engines', the scans' and
    the tests' own) return a VLM cache whose image K/V hold
    ``cross_rows``; other families' caches are as ever."""
    j_init, t_init = japi.init_cache, tapi.init_cache

    def jfill(cfg, batch, seq_len, *a, **kw):
        cache = j_init(cfg, batch, seq_len, *a, **kw)
        if cfg.family != "vlm":
            return cache
        k, v = cross_rows(cache["cross_k"].shape)
        dt = cache["cross_k"].dtype
        return dict(cache, cross_k=jnp.asarray(k, dt),
                    cross_v=jnp.asarray(v, dt))

    def tfill(cfg, batch, seq_len, device=None):
        cache = t_init(cfg, batch, seq_len, device)
        if cfg.family == "vlm":
            for leaf, val in zip(cache["cross"],
                                 cross_rows(tuple(cache["cross"].k.shape))):
                leaf.copy_(torch.from_numpy(val))
        return cache

    with mock.patch.object(japi, "init_cache", jfill), \
            mock.patch.object(tapi, "init_cache", tfill):
        yield


def ref_cache_fields(jcfg, jcache):
    """The reference's decode cache as {entry: {field: leaf} or None} in
    the port's layout: a VLM's image K/V as the entry ``cross``, an
    xLSTM's mLSTM states (super-blocks' then tail's) as one stack."""
    def fields(e):
        return None if e is None else dict(e._asdict())

    if jcfg.family == "vlm":
        return {"self": fields(jcache["self"]),
                "cross": {"k": jcache["cross_k"], "v": jcache["cross_v"]}}
    if jcfg.family == "ssm":
        parts = []
        if jcache["mlstm"] is not None:
            parts.append({f: np.asarray(x).reshape((-1,) + x.shape[2:])
                          for f, x in fields(jcache["mlstm"]).items()})
        if jcache["tail"] is not None:
            parts.append({f: np.asarray(x)
                          for f, x in fields(jcache["tail"]).items()})
        return {"mlstm": {f: np.concatenate([p[f] for p in parts])
                          for f in parts[0]} if parts else None,
                "slstm": fields(jcache["slstm"])}
    return {key: fields(e) for key, e in jcache.items()}


def batch_arrays(b):
    """The model inputs of a numpy batch as JAX arrays."""
    return {k: jnp.asarray(b[k]) for k in ("tokens", "image_embeds")
            if k in b}


def routing_margin(p, x, top_k: int) -> torch.Tensor:
    """Per token, the gap between its k-th and (k+1)-th router
    probabilities (the MoE's router in f32, as the dispatch runs it)."""
    probs = torch.softmax(linear(p.router, x.reshape(-1, x.shape[-1]).float()),
                          dim=-1)
    top = torch.topk(probs, top_k + 1, dim=-1).values
    return top[:, top_k - 1] - top[:, top_k]


def routing_near_ties(model, tcfg, batch) -> int:
    """Tokens of the server's MoE dispatches whose k-th and (k+1)-th router
    probabilities lie within TIE, over a forward of ``batch`` (0 for a
    dense backbone): where rounding could route differently."""
    from repro_torch.models import base
    seen = []

    def counting(p, x, **kw):
        seen.append(int((routing_margin(p, x, tcfg.top_k) <= TIE).sum()))
        return tmoe.moe_dispatch(p, x, **kw)

    with mock.patch.object(base, "moe_dispatch", counting), torch.no_grad():
        tdeco.collab_forward(model, tcfg, to_device(batch, "cpu"))
    return sum(seen)


def forward_and_decode(arch):
    """collab_forward (u, v, fhat, corr, logits, aux_loss, mtp_logits)
    over 2 x 16 tokens (with a VLM's image rows), then 5 decode steps of
    the server (logits, hidden and every cache leaf; a VLM's over filled
    image K/V) against the reference's."""
    jcfg, tcfg, params, model = pair(arch)
    b = next(ttok.lm_batches(2, tcfg, 2, 16))
    ties = routing_near_ties(model, tcfg, b)
    print(f"\n{arch}: routing near-ties (<= {TIE}) {ties}")
    assert ties == 0, "a routing near-tie: compare outside it"
    want = jax.jit(lambda p, jb: jdeco.collab_forward(p, jcfg, jb))(
        params, batch_arrays(b))
    with torch.no_grad():
        got = tdeco.collab_forward(model, tcfg, to_device(b, "cpu"))
    tol = TOL_E2E["float32"]
    keys = ["u", "v", "fhat", "corr", "logits", "aux_loss"]
    if tcfg.mtp_depth:
        keys.append("mtp_logits")
    else:
        assert got["mtp_logits"] is None and want["mtp_logits"] is None
    for key in keys:
        np.testing.assert_allclose(_np(got[key]), _np(want[key]), atol=tol,
                                   rtol=tol, err_msg=key)
    assert (got["fhat"] <= got["u"]).all()
    assert (float(got["aux_loss"]) > 0) == tcfg.is_moe
    toks = token_stream(tcfg, 3, 5, seed=1)
    with filled_cross():
        jcache = japi.init_cache(jcfg, 3, 16)
        cache = tapi.init_cache(tcfg, 3, 16, "cpu")
    step = jax.jit(lambda c, t, p: japi.decode_step(params["server"], jcfg,
                                                    c, t, p))
    with torch.inference_mode():
        for t in range(toks.shape[1]):
            wl, wh, jcache = step(jcache, jnp.asarray(toks[:, t]),
                                  jnp.asarray(t, jnp.int32))
            gl, gh = tapi.decode_step(model.server, tcfg, cache,
                                      torch.as_tensor(toks[:, t]), t)
            for g, w in ((gh, wh), (gl, wl)):
                np.testing.assert_allclose(_np(g), _np(w), atol=tol,
                                           rtol=tol)
    jfields = ref_cache_fields(jcfg, jcache)
    assert jfields.keys() == cache.keys()
    for key, entry in cache.items():
        if entry is None:
            assert jfields[key] is None
            continue
        for name, leaf in zip(entry._fields, entry):
            np.testing.assert_allclose(_np(leaf), _np(jfields[key][name]),
                                       atol=tol, rtol=tol,
                                       err_msg=f"{key}.{name}")


def loss_and_gradients(arch, null_leaves=()):
    """collab_lm_loss's parts (lm, monitor, safety, aux, mtp, total) and
    every parameter's gradient of the joint loss (leaf by leaf, relative
    to its largest entry) against the reference's, remat on in both.
    ``null_leaves``: paths whose gradient is zero in exact arithmetic
    (both packages' are rounding noise); each must be within the
    tolerance of the largest gradient entry of all leaves, in both."""
    jcfg, tcfg, params, model = pair(arch)
    jcfg, tcfg = (c.replace(remat=True) for c in (jcfg, tcfg))
    b = next(ttok.lm_batches(9, tcfg, 2, 24))
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def loss(p):
        parts = j_loss(jdeco.collab_forward(p, jcfg, jb), jb)
        return parts["total"], parts

    (_, jparts), want = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    trainable(model)
    parts = collab_lm_loss(tdeco.collab_forward(model, tcfg,
                                                to_device(b, "cpu")),
                           to_device(b, "cpu"))
    parts["total"].backward()
    assert parts.keys() == jparts.keys()
    tol = TOL_E2E["float32"]
    for key in parts:
        np.testing.assert_allclose(_np(parts[key]), _np(jparts[key]),
                                   atol=tol, rtol=tol, err_msg=key)
    got = _flatten(bridge.collab_to_numpy(model, grads=True))
    want = _flatten(jax.tree.map(np.asarray, want))
    assert got.keys() == want.keys()
    top = max(float(np.abs(w).max()) for w in want.values())
    for path in null_leaves:
        w = want.pop(path)
        for g in (got[path], w):
            assert np.abs(g).max() <= tol * top, (path, np.abs(g).max())
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=tol,
                                   atol=tol * np.abs(w).max(), err_msg=path)


def train_steps(arch):
    """Three AdamW steps from the same weights on the same lm_batches:
    each step's loss parts and grad norm, then every parameter within
    lr/10 of the reference's (all but 1e-4 of each leaf's entries)."""
    lr = 1e-3
    jcfg, tcfg, params, model = pair(arch)
    tree0 = jax.tree.map(np.asarray, params)
    batches = [b for b, _ in zip(ttok.lm_batches(5, tcfg, 2, 16), range(3))]
    want_p, want_h = ref_train_steps(jcfg, params, batches, lr)
    state, got_h = port_train_steps(tcfg, model, tree0, batches, lr)
    tol = TOL_E2E["float32"]
    for g, w in zip(got_h, want_h):
        assert g.keys() == w.keys()
        for key in g:
            np.testing.assert_allclose(g[key], w[key], rtol=tol, atol=tol,
                                       err_msg=key)
    got_p = _flatten(bridge.collab_to_numpy(model, state))
    flat0 = _flatten(tree0)
    moved = 0.0
    for path, w in _flatten(want_p).items():
        d = np.abs(got_p[path] - w)
        assert (d > 0.1 * lr).mean() <= 1e-4, (path, float(d.max()))
        moved = max(moved, float(np.abs(w - flat0[path]).max()))
    assert moved > 2 * lr


B, S, MAX_LEN = 4, 16, 32


def session(arch, mode):
    """A MonitorSession in ``mode`` against the reference's on the same
    weights, stream and a mixed-trigger threshold: u and fhat within the
    end-to-end tolerance, triggers equal outside the tie band (counted
    and printed), per-stream bytes equal."""
    jcfg, tcfg, params, model = pair(arch)
    stream = token_stream(tcfg, B, S, seed=3)
    with filled_cross():
        probe = JEngine(params, jcfg, batch=B, max_len=MAX_LEN).session(
            JSessionConfig(mode="scan")).run(stream)
        thr, gap = gap_threshold(probe["u"])
        want = JEngine(params, with_threshold(jcfg, thr), batch=B,
                       max_len=MAX_LEN).session(JSessionConfig(mode=mode)
                                                ).run(stream)
        got = MonitorSession.open(
            model, tcfg, batch=B, max_len=MAX_LEN, device="cpu",
            config=SessionConfig(mode=mode, threshold=thr,
                                 trigger_margin=0.0)).run(stream)
    tol = TOL_E2E["float32"]
    ties = tie_band(want["u"], thr, tol)
    print(f"\n{arch} {mode}: tie band |u-thr| <= {tol}: {int(ties.sum())} "
          f"of {ties.size} (threshold gap {gap:.3g}); trigger rate "
          f"{want['triggered'].mean():.3f}")
    assert 0 < want["triggered"].mean() < 1, "need mixed triggers"
    np.testing.assert_allclose(got["u"], want["u"], atol=tol, rtol=tol)
    np.testing.assert_allclose(got["fhat"], want["fhat"], atol=tol, rtol=tol)
    np.testing.assert_array_equal(got["triggered"][~ties],
                                  want["triggered"][~ties])
    assert (got["fhat"] <= got["u"]).all()
    for key in ("bytes_sent", "bytes_baseline"):
        np.testing.assert_array_equal(got["comms"]["per_stream"][key],
                                      want["comms"]["per_stream"][key])


def sync_equals_scan(arch):
    """Inside the port: sync and scan agree on u, triggers and per-stream
    bytes, fhat within 1e-6 (at B = 4 no expert can overflow, so per-row
    and batched routing keep the same tokens); fhat <= u."""
    _, tcfg, _, model = pair(arch)
    tcfg = with_threshold(tcfg, 0.1)
    stream = token_stream(tcfg, 3, 12)
    with filled_cross():
        rs = CollaborativeEngine(model, tcfg, 3, 32, device="cpu").session(
            SessionConfig(mode="scan")).run(stream)
        r1 = CollaborativeEngine(model, tcfg, 3, 32,
                                 device="cpu").session().run(stream)
    assert 0 < r1["triggered"].mean() < 1
    np.testing.assert_array_equal(r1["u"], rs["u"])
    np.testing.assert_array_equal(r1["triggered"], rs["triggered"])
    np.testing.assert_allclose(r1["fhat"], rs["fhat"], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(r1["comms"]["per_stream"]["bytes_sent"],
                                  rs["comms"]["per_stream"]["bytes_sent"])
    assert (r1["fhat"] <= r1["u"]).all() and (rs["fhat"] <= rs["u"]).all()


def greedy_generate(arch):
    """Greedy generate (prompt 6, 6 new tokens) against the reference's
    engine: every step's logits within the end-to-end tolerance and the
    tokens equal (the logits' top-2 margins are far outside the
    tolerance here; a tie would fail loudly rather than hide)."""
    jcfg, tcfg, params, model = pair(arch)
    prompt = token_stream(tcfg, 3, 6, seed=3)
    with filled_cross():
        want = JServeEngine(params["server"], jcfg, 3, 16).generate(
            jnp.asarray(prompt), 6)
        eng = ServeEngine(model.server, tcfg, 3, 16, "cpu")
    toks, logits = eng.generate(torch.as_tensor(prompt), 6,
                                return_logits=True)
    top2 = torch.topk(logits, 2, dim=-1).values
    margin = float((top2[..., 0] - top2[..., 1]).min())
    print(f"\n{arch}: greedy top-2 margin min {margin:.3g}")
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want))


def bridge_and_checkpoint(arch, tmp_path):
    """Every leaf of the reference's tree lands in the port module of the
    same path and comes back unchanged; a port checkpoint (params and
    AdamW moments) loads into the reference's templates exactly, and a
    reference checkpoint into the port."""
    jcfg, tcfg, params, model = pair(arch)
    flat = _flatten(jax.tree.map(np.asarray, params))
    assert sum(p.numel() for p in model.parameters()) == sum(
        w.size for w in flat.values())
    back = _flatten(bridge.collab_to_numpy(model))
    assert back.keys() == flat.keys()
    for path, w in flat.items():
        np.testing.assert_array_equal(back[path], w, err_msg=path)
    opt = AdamW()
    state = opt.init(trainable(model), masters=keeps_masters(tcfg))
    gen = torch.Generator().manual_seed(0)
    for m, v in zip(state.m, state.v):
        m.normal_(0, 1e-3, generator=gen)
        v.uniform_(0, 1e-6, generator=gen)
    state.count = 3
    tckpt.save(str(tmp_path / "port"), 9, model, state)
    tmpl = jax.tree.map(jnp.zeros_like, params)
    step, jparams, jst = jckpt.load(str(tmp_path / "port"), tmpl,
                                    jopt.AdamW().init(tmpl))
    assert step == 9 and int(jst.count) == 3
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ours = bridge.moments_to_numpy(model, state)
    for key in ("m", "v"):
        for a, b in zip(jax.tree.leaves(ours[key]),
                        jax.tree.leaves(getattr(jst, key))):
            np.testing.assert_array_equal(a, np.asarray(b))
    jckpt.save(str(tmp_path / "ref"), 4, params, jst)
    fresh = tdeco.CollabLM(tcfg, "cpu")
    st2 = AdamW().init(trainable(fresh), masters=keeps_masters(tcfg))
    assert tckpt.load(str(tmp_path / "ref"), fresh, st2)[0] == 4
    for a, b in zip(jax.tree.leaves(bridge.collab_to_numpy(fresh, st2)),
                    jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
