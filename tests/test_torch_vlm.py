"""llama-3.2-vision-11b in the port against the JAX reference on the CPU
at SMOKE size, f32, the same weights carried across by the bridge: the
cross attention and its single-query decode, forward and decode, the
joint loss and every gradient leaf, three AdamW steps, MonitorSession
sync and scan, greedy generation, and the bridge with checkpoints both
ways; on SMOKE (one super-block of 2 self blocks + a cross block) and on
SMOKE with n_layers=3 (a tail self block after it).  The family cases
are in tests/_torch_families.py.

The cross path is made visible: the gates are opened (the reference
initialises them to zero, and tanh(0) = 0) in the reference's tree before
it is carried across, and both packages' caches hold the same seeded
image K/V (``fam.filled_cross``).

Tolerances: modules f32 2e-5 (``TOL``); whole towers 1e-4 (``TOL_E2E``);
trigger traces exact outside the tie band, whose size each session test
prints.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtf
from repro.nn import attention as jattn
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.engine import cache_batch_axes, zero_cache_rows
from repro_torch.models import transformer as ttf
from repro_torch.nn import attention as tattn
from repro_torch.serving.engine import ServeEngine

import _torch_families as fam
from _torch_parity import TOL, TOL_E2E, token_stream

ARCH = "llama-3.2-vision-11b"
ARCHS = (ARCH, "llama-3.2-vision-11b+tail")


@pytest.fixture(autouse=True)
def _one_thread():
    """Many tiny ops: one intra-op thread is as fast alone and does not
    thrash when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gqa(model):
    """The first cross block's attention, with its reference leaves."""
    return model.server.cross[0].attn


@pytest.mark.parametrize("T", [16, 37])
def test_cross_attn_matches_reference(T):
    """Non-causal attention of 12 query rows over T image rows, no rope,
    GQA at G = 2: the port's tensor ops against ``chunked_attention``."""
    jcfg, tcfg, params, model = fam.pair(ARCH)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, tcfg.d_model)).astype(np.float32)
    img = rng.standard_normal((2, T, tcfg.d_model)).astype(np.float32)
    kw = dict(n_heads=tcfg.n_heads, n_kv=tcfg.n_kv_heads,
              head_dim=tcfg.resolved_head_dim, compute_dtype=jnp.float32)
    cp = jax.tree.map(lambda a: a[0], params["server"]["cross"]["attn"])
    want = jattn.cross_attn(cp, jnp.asarray(x), jnp.asarray(img), **kw)
    kw["compute_dtype"] = torch.float32
    got = tattn.cross_attn(_gqa(model), torch.from_numpy(x),
                           torch.from_numpy(img), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL[
        "float32"], rtol=TOL["float32"])


@pytest.mark.parametrize("T", [16, 37])
def test_cross_attn_decode_matches_reference(T):
    """One query a row against T image K/V rows through the decode
    attention at position T - 1 (every row valid)."""
    jcfg, tcfg, params, model = fam.pair(ARCH)
    rng = np.random.default_rng(2)
    B, Hkv, D = 3, tcfg.n_kv_heads, tcfg.resolved_head_dim
    x = rng.standard_normal((B, tcfg.d_model)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
            for _ in range(2))
    cp = jax.tree.map(lambda a: a[0], params["server"]["cross"]["attn"])
    want = jtf.cross_attn_decode(cp, jnp.asarray(x), jnp.asarray(k),
                                 jnp.asarray(v), jcfg)
    got = tattn.cross_attn_decode(
        _gqa(model), torch.from_numpy(x), torch.from_numpy(k),
        torch.from_numpy(v), n_heads=tcfg.n_heads, head_dim=D,
        compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL["float32"], rtol=TOL["float32"])


def test_cross_path_moves_the_output():
    """With the gates opened and the image K/V filled, the cross blocks
    move the forward's logits and the decode's hidden states well past
    the tolerance from the same model with its gates shut."""
    _, tcfg, _, model = fam.pair(ARCH)
    batch = fam.to_device(next(fam.ttok.lm_batches(2, tcfg, 2, 8)), "cpu")
    toks = torch.as_tensor(token_stream(tcfg, 2, 1))[:, 0]

    def run():
        with torch.no_grad(), fam.filled_cross():
            logits = ttf.forward(model.server, tcfg, batch)["logits"]
            cache = fam.tapi.init_cache(tcfg, 2, 8, "cpu")
            return logits, ttf.decode_step(model.server, tcfg, cache, toks,
                                           0)[1]

    opened = run()
    gates = [cb.gate.clone() for cb in model.server.cross]
    try:
        for cb in model.server.cross:
            cb.gate.zero_()
        shut = run()
    finally:
        for cb, g in zip(model.server.cross, gates):
            cb.gate.copy_(g)
    for a, b in zip(opened, shut):
        assert float((a - b).abs().max()) > 100 * TOL_E2E["float32"]


def test_zero_rows_clears_cross_rows_as_the_reference():
    """``zero_rows`` clears the selected rows of the self-attention cache
    and of the image K/V, leaving the other rows bit-unchanged, as the
    reference's ``zero_cache_rows`` over its discovered batch axes."""
    jcfg, tcfg, params, model = fam.pair(ARCH)
    toks = token_stream(tcfg, 3, 2, seed=4)
    with fam.filled_cross():
        eng = ServeEngine(model.server, tcfg, 3, 16, "cpu")
        jeng = JServeEngine(params["server"], jcfg, 3, 16)
    with torch.no_grad():
        for t in range(toks.shape[1]):
            eng.decode(torch.as_tensor(toks[:, t]))
    before = [leaf.clone() for e in eng.cache.values() for leaf in e]
    rows = np.array([False, True, False])
    eng.zero_rows(rows)
    after = [leaf for e in eng.cache.values() for leaf in e]
    for old, new in zip(before, after):
        assert (new[:, 1] == 0).all()
        assert torch.equal(new[:, [0, 2]], old[:, [0, 2]])
    axes = cache_batch_axes(jcfg, 3, 16)
    jz = zero_cache_rows(jeng.cache, axes, jnp.asarray(rows))
    for key, name in (("cross_k", "k"), ("cross_v", "v")):
        np.testing.assert_array_equal(
            getattr(eng.cache["cross"], name).numpy(), np.asarray(jz[key]))


def test_masked_decode_leaves_inactive_rows_unchanged():
    """``decode_at`` and ``decode_masked`` commit only the active rows:
    every cache leaf of an inactive row, image K/V included, comes back
    bit-unchanged."""
    _, tcfg, _, model = fam.pair(ARCH)
    toks = torch.as_tensor(token_stream(tcfg, 3, 3, seed=5))
    act = torch.tensor([True, False, True])
    with fam.filled_cross():
        eng = ServeEngine(model.server, tcfg, 3, 16, "cpu")
    with torch.no_grad():
        eng.decode(toks[:, 0])
        for step in (lambda: eng.decode_at(toks[:, 1], 1, act),
                     lambda: eng.decode_masked(toks[:, 2], 2, act)):
            before = [leaf[:, 1].clone() for e in eng.cache.values()
                      for leaf in e]
            step()
            for old, e_leaf in zip(before, [leaf for e in eng.cache.values()
                                            for leaf in e]):
                assert torch.equal(e_leaf[:, 1], old)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_match_reference(arch):
    fam.forward_and_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    fam.loss_and_gradients(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch):
    fam.train_steps(arch)


@pytest.mark.parametrize("mode", ["sync", "scan"])
@pytest.mark.parametrize("arch", ARCHS)
def test_session_matches_jax_session(arch, mode):
    fam.session(arch, mode)


@pytest.mark.parametrize("arch", ARCHS)
def test_sync_equals_scan_in_the_port(arch):
    fam.sync_equals_scan(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(arch):
    fam.greedy_generate(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_and_checkpoints_cross_both_ways(arch, tmp_path):
    fam.bridge_and_checkpoint(arch, tmp_path)
