"""xlstm-350m in the port against the JAX reference on the CPU at SMOKE
size, f32, the same weights carried across by the bridge: the mLSTM's
parallel and recurrent forms, the sLSTM step and scan, forward and
decode (every state leaf), the joint loss and every gradient leaf, three
AdamW steps, MonitorSession sync and scan, greedy generation, and the
bridge with checkpoints both ways (cases in tests/_torch_families.py).
Inside the port: the recurrent mLSTM equal to the parallel one (as
tests/test_nn.py holds the reference's), and the masked per-row decode
leaving an inactive row's states bit-unchanged.

Tolerances: modules f32 2e-5 (``TOL``); the recurrent form against the
parallel one 1e-4, as tests/test_nn.py; whole towers 1e-4 (``TOL_E2E``);
trigger traces exact outside the tie band, whose size each session test
prints.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import xlstm as jx
from repro_torch import bridge
from repro_torch.nn import xlstm as tx
from repro_torch.serving.engine import ServeEngine

import _torch_families as fam
from _torch_parity import TOL, token_stream

ARCH = "xlstm-350m"
B, S, D, H = 2, 12, 32, 4
# The sLSTM's input-gate bias moves every step's unstabilised input gate
# by one factor, which scales c and n alike and leaves h = o c / n
# unchanged: its gradient is zero in exact arithmetic, rounding noise in
# both packages.
NULL_LEAVES = ("['server']['super']['slstm']['cell']['w_i']['b']",)


@pytest.fixture(autouse=True)
def _one_thread():
    """Many tiny ops: one intra-op thread is as fast alone and does not
    thrash when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cells():
    """A reference mLSTM and sLSTM cell at d = 32 over 4 heads, their
    weights carried into port cells, and an input sequence."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    jm, js = jx.init_mlstm(k1, D, H), jx.init_slstm(k2, D, H)
    tm = tx.MLSTM(D, H, device="cpu")
    ts = tx.SLSTM(D, H, device="cpu")
    bridge.load_numpy(tm, jax.tree.map(np.asarray, jm))
    bridge.load_numpy(ts, jax.tree.map(np.asarray, js))
    x = np.random.default_rng(4).standard_normal((B, S, D)).astype(
        np.float32)
    return jm, js, tm, ts, x


def test_mlstm_parallel_and_decode_match_reference():
    jm, _, tm, _, x = _cells()
    tol = TOL["float32"]
    want = jx.mlstm_parallel(jm, jnp.asarray(x), H,
                             compute_dtype=jnp.float32)
    got = tx.mlstm_parallel(tm, torch.from_numpy(x), H,
                            compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)
    jst = jx.init_mlstm_state(B, D, H)
    st = tx.init_mlstm_state(B, D, H, n_layers=1, device="cpu")
    st = tx.MLSTMState(*(leaf[0] for leaf in st))
    for t in range(S):
        wy, jst = jx.mlstm_decode(jm, jnp.asarray(x[:, t]), jst, H,
                                  compute_dtype=jnp.float32)
        gy = tx.mlstm_decode(tm, torch.from_numpy(x[:, t]), st, H,
                             compute_dtype=torch.float32)
        np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=tol,
                                   rtol=tol)
    for name in st._fields:
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(jst, name)),
                                   atol=tol, rtol=tol, err_msg=name)


def test_mlstm_recurrent_matches_parallel_in_the_port():
    _, _, tm, _, x = _cells()
    xt = torch.from_numpy(x)
    want = tx.mlstm_parallel(tm, xt, H, compute_dtype=torch.float32)
    st = tx.init_mlstm_state(B, D, H, n_layers=1, device="cpu")
    st = tx.MLSTMState(*(leaf[0] for leaf in st))
    got = torch.stack([tx.mlstm_decode(tm, xt[:, t], st, H,
                                       compute_dtype=torch.float32)
                       for t in range(S)], dim=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


def test_slstm_step_and_scan_match_reference():
    _, js, _, ts, x = _cells()
    tol = TOL["float32"]
    want, jfin = jx.slstm_scan(js, jnp.asarray(x), H,
                               compute_dtype=jnp.float32)
    got = tx.slstm_scan(ts, torch.from_numpy(x), H,
                        compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)
    jst = jx.init_slstm_state(B, D)
    st = tx.init_slstm_state(B, D, n_layers=1, device="cpu")
    st = tx.SLSTMState(*(leaf[0] for leaf in st))
    for t in range(S):
        wh, jst = jx.slstm_step(js, jnp.asarray(x[:, t]), jst, H)
        gh = tx.slstm_step(ts, torch.from_numpy(x[:, t]), st, H)
        np.testing.assert_allclose(gh.numpy(), np.asarray(wh), atol=tol,
                                   rtol=tol)
    for name in st._fields:
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(jfin, name)),
                                   atol=tol, rtol=tol, err_msg=name)


def test_masked_decode_leaves_inactive_rows_unchanged():
    """``decode_at`` and ``decode_masked`` commit only the active rows:
    an inactive row's C, n, m (mLSTM) and c, n, h, m (sLSTM) come back
    bit-unchanged, and ``pos`` plays no part."""
    _, tcfg, _, model = fam.pair(ARCH)
    toks = torch.as_tensor(token_stream(tcfg, 3, 3, seed=5))
    act = torch.tensor([True, False, True])
    eng = ServeEngine(model.server, tcfg, 3, 16, "cpu")
    with torch.no_grad():
        eng.decode(toks[:, 0])
        for step in (lambda: eng.decode_at(toks[:, 1], 7, act),
                     lambda: eng.decode_masked(toks[:, 2], 2, act)):
            leaves = [leaf for e in eng.cache.values() for leaf in e]
            before = [leaf.clone() for leaf in leaves]
            step()
            for old, new in zip(before, leaves):
                assert torch.equal(new[:, 1], old[:, 1])
                assert not torch.equal(new[:, 0], old[:, 0])


def test_forward_and_decode_match_reference():
    fam.forward_and_decode(ARCH)


def test_loss_and_gradients_match_reference():
    fam.loss_and_gradients(ARCH, null_leaves=NULL_LEAVES)


def test_train_steps_match_reference():
    fam.train_steps(ARCH)


@pytest.mark.parametrize("mode", ["sync", "scan"])
def test_session_matches_jax_session(mode):
    fam.session(ARCH, mode)


def test_sync_equals_scan_in_the_port():
    fam.sync_equals_scan(ARCH)


def test_greedy_generate_matches_reference():
    fam.greedy_generate(ARCH)


def test_bridge_and_checkpoints_cross_both_ways(tmp_path):
    fam.bridge_and_checkpoint(ARCH, tmp_path)
