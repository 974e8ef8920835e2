"""The port's dense backbone (repro_torch.models) against the JAX tower on
the same weights: decode_step hidden states and logits over several
tokens, a wrapped ring cache, the bridge's two input forms, and the
per-element masked decode of the serving engine."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import api as japi
from repro.training.checkpoint import _flatten
from repro_torch import bridge
from repro_torch.core.decomposition import edge_arch
from repro_torch.models import api as tapi
from repro_torch.serving.engine import ServeEngine

from _torch_parity import ARCHS, TOL_E2E, collab_pair, token_stream


def _jax_decode(cfg, params, cache, toks, pos0=0):
    step = jax.jit(lambda c, t, p: japi.decode_step(params, cfg, c, t, p))
    out = []
    for t in range(toks.shape[1]):
        logits, h, cache = step(cache, jnp.asarray(toks[:, t]),
                                jnp.asarray(pos0 + t, jnp.int32))
        out.append((np.asarray(logits, np.float32), np.asarray(h, np.float32)))
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tower", ["server", "edge"])
def test_decode_step_matches_jax_tower(arch, tower):
    """Hidden states and logits over 6 tokens, on the cache sizes the
    sessions use; the short capacity (4) wraps the ring when the tower
    runs one (granite's long-context window, the edge's sliding window)."""
    from repro.core.decomposition import edge_arch as jedge
    jcfg, tcfg, params, model = collab_pair(arch)
    if tower == "edge":
        jcfg, tcfg = jedge(jcfg), edge_arch(tcfg)
    jp, tm = params[tower], getattr(model, tower)
    tol = TOL_E2E[tcfg.dtype]
    toks = token_stream(tcfg, 3, 6, seed=1)
    for max_len in (16, 4):
        ring = max_len == 4
        if ring and not (tcfg.sliding_window or tcfg.long_context_window):
            continue  # a linear cache of 4 cannot hold 6 tokens
        if ring and tcfg.sliding_window:
            # the edge sizes its ring by its window: force a 4-slot ring
            jcfg, tcfg = (c.replace(sliding_window=4) for c in (jcfg, tcfg))
        want = _jax_decode(jcfg, jp, japi.init_cache(jcfg, 3, max_len), toks)
        cache = tapi.init_cache(tcfg, 3, max_len, "cpu")
        assert cache["blocks"].k.shape[2] == max_len
        with torch.inference_mode():
            for t, (wl, wh) in enumerate(want):
                logits, h = tapi.decode_step(tm, tcfg, cache,
                                             torch.as_tensor(toks[:, t]), t)
                np.testing.assert_allclose(h.float().numpy(), wh, atol=tol,
                                           rtol=tol)
                np.testing.assert_allclose(logits.numpy(), wl, atol=tol,
                                           rtol=tol)


def test_bridge_copies_every_leaf_and_rejects_mismatch():
    """Every reference leaf lands in the port parameter of the same path
    (layer l of a stacked leaf in block l); a missing or misshaped leaf
    raises."""
    jcfg, tcfg, params, model = collab_pair("paper-synthetic")
    flat = _flatten(params)  # the reference checkpoint's leaf paths
    ported = dict(model.named_parameters())
    assert len(ported) == len(flat)
    np.testing.assert_array_equal(ported["u_head.a"].numpy(),
                                  flat["['u_head']['a']"])
    np.testing.assert_array_equal(
        ported["edge.blocks.0.ln_mlp.scale"].numpy(),
        flat["['edge']['blocks']['ln_mlp']['scale']"][0])
    # bf16 storage of the projections is the reference's per-use cast
    w = params["server"]["blocks"]["attn"]["wq"]["w"][0]
    np.testing.assert_array_equal(
        model.server.blocks[0].attn.wq.w.float().numpy(),
        np.asarray(jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32)))
    tree = jax.tree.map(np.asarray, params)
    del tree["u_head"]["a"]
    with pytest.raises(ValueError, match="lacks"):
        bridge.collab_from_numpy(tree, tcfg, "cpu")
    tree = jax.tree.map(np.asarray, params)
    tree["v_head"]["w"] = tree["v_head"]["w"][:-1]
    with pytest.raises(ValueError, match="shape"):
        bridge.collab_from_numpy(tree, tcfg, "cpu")


@torch.inference_mode()
def test_decode_at_positions_and_masking():
    """The per-element decode: uniform vector positions equal the plain
    decode bitwise; inactive rows' cache stays bit-unchanged; a row held
    at position 0 while another advances decodes like a fresh engine."""
    _, tcfg, _, model = collab_pair("granite-8b")
    toks = torch.as_tensor(token_stream(tcfg, 3, 8, seed=2))
    ref = ServeEngine(model.server, tcfg, 3, 16, "cpu")
    per = ServeEngine(model.server, tcfg, 3, 16, "cpu")
    for t in range(4):
        _, h_ref = ref.decode(toks[:, t])
        _, h_per = per.decode_at(toks[:, t], torch.full((3,), t),
                                 torch.ones(3, dtype=torch.bool))
        assert torch.equal(h_per, h_ref)

    eng = ServeEngine(model.server, tcfg, 3, 16, "cpu")
    eng.decode_at(toks[:, 0], 0, torch.ones(3, dtype=torch.bool))
    before = eng.cache["blocks"].k.clone()
    eng.decode_masked(toks[:, 1], 1, torch.tensor([True, False, True]))
    after = eng.cache["blocks"].k
    assert not torch.equal(before[:, 0], after[:, 0])
    assert torch.equal(before[:, 1], after[:, 1])

    het = ServeEngine(model.server, tcfg, 2, 16, "cpu")
    for t in range(3):
        het.decode_at(toks[:2, t], torch.full((2,), t),
                      torch.tensor([True, False]))
    _, h = het.decode_at(torch.stack([toks[0, 3], toks[1, 0]]),
                         torch.tensor([3, 0]), torch.ones(2, dtype=torch.bool))
    fresh = ServeEngine(model.server, tcfg, 2, 16, "cpu")
    _, h0 = fresh.decode(torch.stack([toks[0, 0], toks[1, 0]]))
    assert torch.equal(h[1], h0[1])

    het.zero_rows(torch.tensor([False, True]))
    assert not het.cache["blocks"].k[:, 1].any()
    assert het.cache["blocks"].k[:, 0].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_reference(dtype):
    """Half-split rotation at per-row positions (incl. 0 and past a ring's
    capacity), against nn/rotary.py::apply_rope."""
    from repro.nn.rotary import apply_rope as japply
    from repro_torch.nn.rotary import apply_rope
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    x = np.random.default_rng(0).standard_normal((5, 4, 64)).astype(np.float32)
    pos = np.array([0, 1, 17, 511, 9000])
    jx = jnp.asarray(x).astype(jdt)
    want = np.asarray(japply(jx[:, None], jnp.asarray(pos)[:, None])[:, 0],
                      np.float32)
    got = apply_rope(torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype)), torch.as_tensor(pos))
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
