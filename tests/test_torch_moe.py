"""The port's MoE dispatch (``nn/moe.py``) against the JAX reference on
the CPU, f32, with the same weights carried across by the bridge:
``moe_apply`` with and without a shared expert and with capacity drops,
per-row routing in the engine's catch-up (``decode_at``) against the
reference's vmapped ``step_at``, batched routing in ``decode_masked``,
AdamW on a bf16 parameter against the reference's in-place update; then
mixtral-8x22b and deepseek-v3 (MLA, a shared expert, the MTP head) end
to end, with the cases of tests/_torch_families.py.

Routing near-ties (a token whose k-th and (k+1)-th router probabilities
lie within ``TIE``, where rounding could pick another expert) are counted
and reported like the trigger tie band, never hidden by a new seed; such
tokens are left out of the comparison.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import decomposition as jdeco
from repro.nn import moe as jmoe
from repro.serving.engine import ServeEngine as JServeEngine
from repro.training import optimizer as jopt
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.nn import moe as tmoe
from repro_torch.serving.engine import ServeEngine
from repro_torch.training import optimizer as topt

import _torch_families as fam
from _torch_parity import TOL, TOL_E2E, token_stream

TIE = fam.TIE


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _moe_pair(d, f, E, n_shared, seed):
    """The reference's ``init_moe`` tree (f32) and a port ``MoE`` with the
    same weights."""
    tree = jmoe.init_moe(jax.random.PRNGKey(seed), d, f, E,
                         n_shared=n_shared)
    mod = tmoe.MoE(d, f, E, n_shared=n_shared, device="cpu")
    bridge.load_numpy(mod, jax.tree.map(np.asarray, tree))
    return tree, mod


def near_ties(mod, x, top_k):
    """Tokens whose k-th and (k+1)-th router probabilities differ by at
    most TIE."""
    return (fam.routing_margin(mod, x, top_k) <= TIE).numpy()


@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("E,k", [(4, 2), (8, 3)])
def test_moe_apply_matches_reference(E, k, capacity_factor, n_shared):
    """y and the load-balance loss over 2 x 24 tokens; at capacity factor
    0.5 the capacity is below the tokens some experts get, so tokens are
    dropped in both, the same ones."""
    d, f = 32, 48
    tree, mod = _moe_pair(d, f, E, n_shared, seed=E + n_shared)
    x = np.random.default_rng(E).standard_normal((2, 24, d)).astype(
        np.float32)
    want, waux = jmoe.moe_apply(tree, jnp.asarray(x), n_experts=E, top_k=k,
                                capacity_factor=capacity_factor,
                                compute_dtype=jnp.float32)
    got, aux = tmoe.moe_apply(mod, torch.as_tensor(x), n_experts=E,
                              top_k=k, capacity_factor=capacity_factor,
                              compute_dtype=torch.float32)
    ties = near_ties(mod, torch.as_tensor(x), k)
    print(f"routing near-ties (<= {TIE}): {int(ties.sum())} of {ties.size}")
    keep = ~ties.reshape(2, 24)
    np.testing.assert_allclose(_np(got)[keep], _np(want)[keep],
                               atol=TOL["float32"], rtol=TOL["float32"])
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)
    if capacity_factor < 1:
        T = 48
        C = tmoe.expert_capacity(T, E, k, capacity_factor)
        assert C == jmoe.expert_capacity(T, E, k, capacity_factor)
        _, top_i, _ = tmoe._route(mod, torch.as_tensor(x).reshape(T, d),
                                  E, k)
        _, slot_of, _ = tmoe._slot_table(top_i, n_experts=E, C=C)
        assert (slot_of == E * min(T, C)).any(), "no token dropped"


def test_routing_groups_are_independent_dispatches():
    """groups=n routes n runs of tokens each on its own: the same as n
    separate calls, each with its own capacity (up to f32 rounding: the
    expert products run over one buffer of another height)."""
    d, f, E, k = 16, 24, 4, 2
    _, mod = _moe_pair(d, f, E, 1, seed=3)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (4, 6, d)).astype(np.float32))
    kw = dict(n_experts=E, top_k=k, capacity_factor=0.5,
              compute_dtype=torch.float32)
    got, _ = tmoe.moe_apply(mod, x, groups=4, **kw)
    want = torch.cat([tmoe.moe_apply(mod, x[i:i + 1], **kw)[0]
                      for i in range(4)])
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    batched, _ = tmoe.moe_apply(mod, x, **kw)
    # capacity 8 for 24 tokens: the batched dispatch drops some
    assert (got - batched).abs().max() > 1e-2


def _mixtral_pair(capacity_factor):
    jcfg, tcfg = (c.replace(capacity_factor=capacity_factor) for c in
                  (jreg.get_smoke("mixtral-8x22b"),
                   treg.get_smoke("mixtral-8x22b")))
    params = jdeco.init_collab_lm(jax.random.PRNGKey(0), jcfg)
    model = bridge.collab_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                     "cpu")
    return jcfg, tcfg, params, model


def test_decode_at_routes_each_row_like_the_reference_step_at():
    """16 rows at capacity factor 0.5: a batched dispatch would drop tokens
    (capacity 8 of 16), the reference's vmapped ``step_at`` routes each row
    alone and drops none.  The port's ``decode_at`` (per-row groups) holds
    to ``step_at`` over rows at different depths with some inactive, its
    ``decode_masked`` to the reference's batched ``decode_masked``, and the
    two routings differ here."""
    jcfg, tcfg, params, model = _mixtral_pair(0.5)
    B, L = 16, 5
    toks = token_stream(tcfg, B, L, seed=4)
    jeng = JServeEngine(params["server"], jcfg, B, 16)
    teng = ServeEngine(model.server, tcfg, B, 16, "cpu")
    rng = np.random.default_rng(0)
    depth = np.zeros(B, np.int32)
    tol = TOL_E2E["float32"]
    with torch.inference_mode():
        for t in range(L):
            active = rng.uniform(size=B) < 0.7
            wl, wh = jeng.decode_at(jnp.asarray(toks[:, t]),
                                    jnp.asarray(depth), jnp.asarray(active))
            gl, gh = teng.decode_at(torch.as_tensor(toks[:, t]),
                                    torch.as_tensor(depth),
                                    torch.as_tensor(active))
            np.testing.assert_allclose(_np(gh)[active], _np(wh)[active],
                                       atol=tol, rtol=tol)
            depth = depth + active
        for key in ("k", "v"):
            np.testing.assert_allclose(
                _np(getattr(teng.cache["moe"], key)),
                _np(getattr(jeng.cache["moe"], key)), atol=tol, rtol=tol)
        mask = np.ones(B, bool)
        mask[::3] = False
        tok = toks[:, 0]
        wl, wh = jeng.decode_masked(jnp.asarray(tok), 6, jnp.asarray(mask))
        gl, gh = teng.decode_masked(torch.as_tensor(tok), 6,
                                    torch.as_tensor(mask))
        np.testing.assert_allclose(_np(gh), _np(wh), atol=tol, rtol=tol)
        _, per_row = teng.decode_at(torch.as_tensor(tok),
                                    torch.full((B,), 7), torch.as_tensor(
                                        np.zeros(B, bool)))
        _, batched = teng.decode_masked(torch.as_tensor(tok), 7,
                                        torch.as_tensor(np.zeros(B, bool)))
    assert not torch.allclose(per_row, batched, atol=1e-3)


def test_adamw_updates_bf16_parameters_in_place_like_the_reference():
    """Where param_dtype is bf16 the reference updates the bf16 parameter
    itself, (p.astype(f32) - lr * step).astype(bf16), with no master; so
    does the port (``masters=False``): three steps from the same bf16
    weights and gradients land on the reference's bf16 weights, every
    entry within one bf16 rounding of them and nearly all bitwise."""
    rng = np.random.default_rng(0)
    shapes = [(64, 48), (48,), (3, 16, 8)]
    w0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    lr = 3e-3
    jp = [jnp.asarray(w, jnp.bfloat16) for w in w0]
    opt = jopt.AdamW(lr=lr, weight_decay=0.01)
    st = opt.init(jp)
    for g in grads:
        jp, st, _ = opt.update([jnp.asarray(x, jnp.bfloat16) for x in g],
                               st, jp)
    tp = [torch.as_tensor(w).to(torch.bfloat16) for w in w0]
    topt_ = topt.AdamW(lr=lr, weight_decay=0.01)
    ts = topt_.init(tp, masters=False)
    assert all(m is None for m in ts.master)
    for g in grads:
        topt_.update([torch.as_tensor(x).to(torch.bfloat16) for x in g], ts,
                     tp)
    for got, want, w in zip(tp, jp, w0):
        assert got.dtype == torch.bfloat16
        want = np.asarray(want.astype(jnp.float32))
        got = got.float().numpy()
        ulp = np.abs(want) * 2.0 ** -7 + 1e-30
        assert (np.abs(got - want) <= ulp).all()
        assert (got == want).mean() >= 0.99
        assert np.abs(want - w).max() > lr  # the weights moved


def test_keeps_masters_follows_param_dtype():
    assert topt.keeps_masters(treg.get_full("granite-8b"))
    for name in ("mixtral-8x22b", "deepseek-v3-671b", "qwen1.5-110b"):
        assert not topt.keeps_masters(treg.get_full(name))
        assert topt.keeps_masters(treg.get_smoke(name))


# ------------------------------------------ the MoE archs end to end
MOE_ARCHS = ("mixtral-8x22b", "deepseek-v3-671b")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_and_decode_match_reference(arch):
    """With aux_loss and, for deepseek-v3, the MTP head's logits and the
    MLA latent cache."""
    fam.forward_and_decode(arch)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_gradients_match_reference(arch):
    """Loss parts including aux and mtp, every gradient leaf."""
    fam.loss_and_gradients(arch)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_steps_match_reference(arch):
    fam.train_steps(arch)


@pytest.mark.parametrize("mode", ["sync", "scan"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_session_matches_jax_session(arch, mode):
    fam.session(arch, mode)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_sync_equals_scan_in_the_port(arch):
    fam.sync_equals_scan(arch)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_greedy_generate_matches_reference(arch):
    fam.greedy_generate(arch)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bridge_and_checkpoints_cross_both_ways(arch, tmp_path):
    fam.bridge_and_checkpoint(arch, tmp_path)


def test_bridge_and_checkpoints_carry_an_empty_moe_stack(tmp_path):
    """deepseek-v3 SMOKE with its one layer dense and no MTP head: the
    reference stacks zero MoE layers into ``blocks_moe`` leaves of length
    0, and the bridge and the checkpoints carry that empty stack both
    ways in the reference's shapes."""
    arch = "deepseek-v3-671b+dense1"
    _, tcfg, params, model = fam.pair(arch)
    assert len(model.server.blocks_moe) == 0
    leaves = jax.tree.leaves(params["server"]["blocks_moe"])
    assert leaves and all(a.shape[0] == 0 for a in leaves)
    fam.bridge_and_checkpoint(arch, tmp_path)
