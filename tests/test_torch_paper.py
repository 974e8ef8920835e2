"""The port's paper-scale decomposition (§4) against the JAX reference:
the data generators, the registry's paper configs, paper_forward on
bridged weights, the step of train_paper, the §2.3 metrics, and mirrors
of the reference's structural-safety, gating and theory tests and of its
end-to-end pipeline claims, run on the port's functions on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import decomposition as jdeco
from repro.core import gating as jgating
from repro.core import safety as jsafety
from repro.data import synthetic as jsyn
from repro.training.loop import train_paper as j_train_paper
from repro_torch import bridge
from repro_torch.configs import paper_financial, paper_synthetic
from repro_torch.configs import registry as treg
from repro_torch.core import decomposition as tdeco
from repro_torch.core import safety, theory
from repro_torch.core.gating import CommsMeter, masked_correction, trigger_mask
from repro_torch.data import synthetic as tsyn
from repro_torch.training.loop import (make_paper_step, paper_batches,
                                       train_paper, trainable)
from repro_torch.training.optimizer import AdamW

from _torch_parity import TOL

SYN = paper_synthetic.SMOKE  # the reference tests' SYN
KEY = jax.random.PRNGKey(0)
U_MODES = ("truncated", "cosine", "independent")
PAPER = ("paper-synthetic", "paper-financial")



@pytest.fixture(autouse=True)
def _one_thread():
    """These tests run many tiny ops: one intra-op thread is as fast alone
    and does not thrash when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _data(name, n=512, seed=0):
    """(x, f) of the paper experiment ``name``, numpy f32."""
    if name == "paper-synthetic":
        return tsyn.paper_synthetic(seed, n, rho=0.9, n_modes=24)
    x, f = tsyn.financial_xy(tsyn.financial_series(seed))
    return x[:n], f[:n]


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ------------------------------------------------------------ data, configs
def test_data_generators_are_bitwise_the_reference():
    for args, kw in (((0, 4096), dict(rho=0.9, n_modes=48)),
                     ((3, 100), dict(rho=0.8, n_modes=24,
                                     x_range=(-1.0, 2.0)))):
        for a, b in zip(tsyn.paper_synthetic(*args, **kw),
                        jsyn.paper_synthetic(*args, **kw)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    x = tsyn.paper_synthetic(1, 300)[0]
    for n in (0, 8, 40):
        assert np.array_equal(tsyn.synthetic_residual(x, n, n_modes=48),
                              jsyn.synthetic_residual(x, n, n_modes=48))
    assert np.array_equal(tsyn.synthetic_residual(x[:, 0], 5),
                          jsyn.synthetic_residual(x[:, 0], 5))
    for seed, kw in ((0, {}), (5, dict(n_days=300, n_tickers=6, corr=0.1))):
        panel = tsyn.financial_series(seed, **kw)
        assert np.array_equal(panel, jsyn.financial_series(seed, **kw))
        for col in (0, 3):
            for a, b in zip(tsyn.financial_xy(panel, col),
                            jsyn.financial_xy(panel, col)):
                assert np.array_equal(a, b)


@pytest.mark.parametrize("name", PAPER)
def test_registry_paper_configs_are_the_reference(name):
    """get_full/get_smoke of the paper experiments give the reference's
    PaperMLPConfig fields (the port once returned the LM-scale SERVING)."""
    for get in ("get_full", "get_smoke"):
        ours, ref = getattr(treg, get)(name), getattr(jreg, get)(name)
        assert type(ours).__name__ == "PaperMLPConfig"
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert treg.get_module(name).FULL is treg.get_full(name)
    assert paper_synthetic.SERVING.name == "paper-synthetic-serving"


def test_registry_names_are_the_reference_less_the_unported():
    """Nothing is left to port: the names are the reference's, in its
    order, and every config is a copy of the reference's."""
    assert treg._LATER == ()
    for paper in (False, True):
        want = [n for n in jreg.names(include_paper=paper)
                if n not in treg._LATER]
        assert treg.names(include_paper=paper) == want
    for name in ("musicgen-large", "llama-3.2-vision-11b", "xlstm-350m"):
        for get in ("get_full", "get_smoke"):
            t, j = getattr(treg, get)(name), getattr(jreg, get)(name)
            assert t.monitor.__dict__ == j.monitor.__dict__
            for field in t.__dataclass_fields__.keys() - {"monitor"}:
                assert getattr(t, field) == getattr(j, field), (name, field)
    with pytest.raises(KeyError):
        treg.get_smoke("no-such-arch")


def test_serving_operating_points_equal_the_reference():
    """Every ``SERVING_*`` operating point of the reference's
    ``configs/paper_synthetic.py`` is in the port's, with its value."""
    from repro.configs import paper_synthetic as jsyn
    from repro_torch.configs import paper_synthetic as tsyn
    names = [n for n in dir(jsyn) if n.startswith("SERVING_")]
    assert {"SERVING_TRIGGER_RATE", "SERVING_LATENCY_S",
            "SERVING_MAX_STALENESS", "SERVING_WIRE_SLOTS"} <= set(names)
    assert names == [n for n in dir(tsyn) if n.startswith("SERVING_")]
    for n in names:
        assert getattr(tsyn, n) == getattr(jsyn, n), n


# ------------------------------------------------------------ paper_forward
def _mlp_tree(rng, dims):
    return {f"l{i}": {"w": (rng.standard_normal((dims[i], dims[i + 1]))
                            / np.sqrt(dims[i])).astype(np.float32),
                      "b": (0.1 * rng.standard_normal(dims[i + 1])
                            ).astype(np.float32)}
            for i in range(len(dims) - 1)}


def _pair(cfg, u_mode, seed=0):
    """Weights in the reference's ``init_paper_decomposition`` layout, made
    with numpy (nonzero biases), as the reference's tree of jax arrays and
    bridged into the port."""
    rng = np.random.default_rng(seed)
    tree = {"v": _mlp_tree(rng, (cfg.in_dim,) + tuple(cfg.hidden) + (1,))}
    if u_mode == "independent":
        tree["u_net"] = _mlp_tree(rng, (cfg.in_dim, 10, 1))
    else:
        n = 24 if u_mode == "cosine" else cfg.n_basis
        tree["a"] = (0.1 * rng.standard_normal(n)).astype(np.float32)
    tree["raw_t"] = np.asarray(jdeco._inv_softplus(cfg.t_init), np.float32)
    model = bridge.paper_from_numpy(tree, cfg, u_mode, "cpu")
    return jax.tree.map(jnp.asarray, tree), model


@pytest.mark.parametrize("u_mode", U_MODES)
@pytest.mark.parametrize("size", ["FULL", "SMOKE"])
@pytest.mark.parametrize("name", PAPER)
def test_paper_forward_matches_reference(name, size, u_mode):
    """u, v, corr, fhat and t from the same weights within 2e-5, at the
    config's defaults and with s, monitor_n and sigma overridden."""
    cfg = getattr(jreg, f"get_{size.lower()}")(name)
    params, model = _pair(cfg, u_mode)
    x = _data(name)[0]
    tol = TOL["float32"]
    for kw in ({}, dict(s=0.7, monitor_n=5, sigma_kind="tanh01")):
        want = jax.jit(lambda p, x: jdeco.paper_forward(
            p, x, cfg, u_mode=u_mode, **kw))(params, jnp.asarray(x))
        with torch.no_grad():
            got = tdeco.paper_forward(model, _t(x), cfg, u_mode=u_mode, **kw)
        for k in ("u", "v", "corr", "fhat", "t"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=tol, rtol=tol, err_msg=k)


@pytest.mark.parametrize("u_mode", U_MODES)
def test_paper_bridge_round_trip(u_mode):
    """The reference's own init tree crosses both ways unchanged."""
    cfg = paper_financial.SMOKE
    params = jdeco.init_paper_decomposition(
        KEY, cfg, u_mode=u_mode, n_modes=24 if u_mode == "cosine" else 0)
    model = bridge.paper_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                    u_mode, "cpu")
    back = bridge.paper_to_numpy(model)
    want = jax.tree.map(np.asarray, params)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.shape == b.shape and np.array_equal(a, b)


def test_paper_init_uses_the_reference_distributions():
    cfg = paper_financial.FULL
    model = tdeco.init_paper_decomposition(
        cfg, torch.Generator().manual_seed(0), u_mode="truncated",
        device="cpu")
    tree = jax.tree.map(np.asarray, jdeco.init_paper_decomposition(KEY, cfg))
    assert jax.tree.structure(bridge.paper_to_numpy(model)) == \
        jax.tree.structure(tree)
    w = model.v.l2.w.numpy()      # (128, 256): std 1/sqrt(128)
    assert abs(w.std() - 128 ** -0.5) < 0.005 and not model.v.l2.b.any()
    assert abs(model.a.std().item() - 0.1) < 0.02     # 256 draws
    assert float(torch.nn.functional.softplus(model.raw_t)) == \
        pytest.approx(cfg.t_init, rel=1e-5)


# ---------------------------------------- mirrors of TestStructuralSafety
def _model(u_mode, **kw):
    return tdeco.init_paper_decomposition(
        SYN, torch.Generator().manual_seed(0), u_mode=u_mode, device="cpu",
        **kw)


@pytest.mark.parametrize("u_mode,kw", [("cosine", {"n_modes": 24}),
                                       ("truncated", {}),
                                       ("independent", {})])
def test_u_dominates_fhat(u_mode, kw):
    x = torch.empty(512, 1).uniform_(-3.0, 3.0,
                                     generator=torch.Generator().manual_seed(1))
    out = tdeco.paper_forward(_model(u_mode, **kw), x, SYN, u_mode=u_mode)
    assert (out["u"] >= out["fhat"]).all()
    assert (out["corr"] > 0).all() and (out["corr"] < SYN.s).all()


def test_t_is_positive():
    out = tdeco.paper_forward(_model("truncated"), torch.zeros(4, 1), SYN)
    assert float(out["t"]) > 0


def test_truncation_masks_basis():
    """Features beyond n must not affect u (they never ship to the device)."""
    model = _model("cosine", n_modes=24)
    x = torch.empty(64, 1).uniform_(-3.0, 3.0,
                                    generator=torch.Generator().manual_seed(2))
    u1 = tdeco.paper_forward(model, x, SYN, u_mode="cosine", monitor_n=8)["u"]
    with torch.no_grad():
        model.a[8:] = 123.0  # poison the truncated coefficients
    u2 = tdeco.paper_forward(model, x, SYN, u_mode="cosine", monitor_n=8)["u"]
    np.testing.assert_allclose(u1.numpy(), u2.numpy(), atol=1e-6)


def test_sigma_inv_inverts_sigma():
    y = torch.linspace(0.01, 0.99, 99)
    for kind in ("sigmoid", "tanh01"):
        np.testing.assert_allclose(
            tdeco.sigma(tdeco.sigma_inv(y, kind), kind).numpy(), y.numpy(),
            atol=1e-6)
        np.testing.assert_allclose(
            tdeco.sigma_inv(y, kind).numpy(),
            np.asarray(jdeco.sigma_inv(jnp.asarray(y.numpy()), kind)),
            atol=2e-5, rtol=2e-5)


# --------------------------------------------------------- gating mirrors
@pytest.mark.parametrize("thr,margin,seed", [(-1.0, 0.0, 0), (0.0, 0.25, 1),
                                             (0.3, 1.0, 2), (1.0, 0.5, 3),
                                             (-0.4, 0.1, 4)])
def test_untriggered_rows_pass_through(thr, margin, seed):
    """Mirror of test_gating.py::TestMaskedCorrection, and the reference's
    masked_correction on the same arrays."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(256).astype(np.float32)
    corr = (1 / (1 + np.exp(-rng.standard_normal(256)))).astype(np.float32)
    fhat, mask = masked_correction(_t(u), _t(corr), thr, margin)
    fhat, mask = fhat.numpy(), mask.numpy()
    quiet = mask == 0
    np.testing.assert_allclose(fhat[quiet], u[quiet])
    np.testing.assert_allclose(fhat[~quiet], (u - corr)[~quiet], atol=1e-6)
    jf, jm = jgating.masked_correction(jnp.asarray(u), jnp.asarray(corr),
                                       thr, margin)
    np.testing.assert_array_equal(mask, np.asarray(jm))
    np.testing.assert_array_equal(fhat, np.asarray(jf))
    np.testing.assert_array_equal(
        trigger_mask(_t(u), thr, margin).numpy(),
        np.asarray(jgating.trigger_mask(jnp.asarray(u), thr, margin)))


def test_comms_reduction_math():
    """Mirror of test_gating.py::TestCommsMeter::test_reduction_math."""
    m = CommsMeter(bytes_per_request=8)
    for _ in range(90):
        m.update(0, 10)
    for _ in range(10):
        m.update(10, 10)
    assert m.trigger_rate == 0.1
    assert m.reduction == 10.0
    rep = m.report()
    assert rep["bytes_baseline"] == 1000 * 8
    assert rep["bytes_sent"] == 100 * 8
    assert "per_stream" not in rep


# ---------------------------------------------------------- theory mirrors
def _target(x, rho=0.9, n_modes=100):
    i = np.arange(1, n_modes + 1)
    return (np.cos(x[:, None] * i) @ (rho ** (i - 1))).astype(np.float32)


@pytest.mark.parametrize("n", [5, 10, 20, 40])
def test_prop2_safety_offset_guarantees_upper_bound(n):
    rho, n_modes = 0.9, 100
    xs = np.linspace(-3, 3, 4001).astype(np.float32)
    f = _target(xs, rho, n_modes)
    i = np.arange(1, n + 1)
    u_trunc = (np.cos(xs[:, None] * i) @ (rho ** (i - 1))).astype(np.float32)
    resid = tsyn.synthetic_residual(xs, n, rho=rho, n_modes=n_modes)
    u = u_trunc + float(np.max(np.abs(resid)))
    assert np.all(u >= f - 1e-5), "Prop 2: u_{n,t(n)} must dominate f"
    assert float(safety.fn_rate(_t(f), _t(u))) == 0.0


def test_prop2_practical_t_and_its_decrease():
    rho, n_modes = 0.9, 100
    xs = np.linspace(-3, 3, 2001).astype(np.float32)
    for n in (3, 10, 30):
        t_sur = theory.t_of_n(theory.exp_coeffs(rho, n_modes), n)
        t_exact = theory.t_of_n_sampled(
            lambda z: tsyn.synthetic_residual(z, n, rho=rho,
                                              n_modes=n_modes), xs)
        assert t_sur >= t_exact - 1e-6
    c = theory.exp_coeffs(0.9, 100)
    ts = [theory.t_of_n(c, n) for n in range(0, 90, 10)]
    assert all(a > b for a, b in zip(ts, ts[1:]))


@pytest.mark.parametrize("s,eps,seed", [(0.05, 0.05, 0), (0.5, 0.1, 1),
                                        (1.0, 0.3, 2), (2.0, 0.5, 3)])
def test_prop3_fp_bound_holds(s, eps, seed):
    rng = np.random.default_rng(seed)
    f = rng.uniform(-1, 1, size=4096).astype(np.float32)
    v = rng.normal(size=4096).astype(np.float32)
    delta = 0.05
    fhat = f + rng.uniform(-delta, delta, size=4096).astype(np.float32)
    u = fhat + s / (1 + np.exp(-v))
    mu_fp = float(safety.fp_rate(_t(f), _t(u), eps))
    assert mu_fp <= theory.prop3_fp_bound(delta, s, eps, vol=1.0) + 1e-6


def test_prop3_fp_grows_with_s():
    rng = np.random.default_rng(0)
    f = rng.uniform(-1, 1, size=8192).astype(np.float32)
    v = rng.normal(size=8192).astype(np.float32)
    rates = [float(safety.fp_rate(_t(f), _t(f + s / (1 + np.exp(-v))), 0.05))
             for s in (0.1, 0.5, 1.0, 2.0)]
    assert rates == sorted(rates), "FP rate must be monotone in s"


@pytest.mark.parametrize("n,eps,tf", [(5, 0.02, 0.1), (20, 0.1, 0.5),
                                      (60, 0.3, 0.9), (12, 0.05, 0.3)])
def test_prop4_fn_chebyshev_bound(n, eps, tf):
    rho, n_modes = 0.9, 100
    xs = np.linspace(-3, 3, 4001).astype(np.float32)
    f = _target(xs, rho, n_modes)
    i = np.arange(1, n + 1)
    resid = tsyn.synthetic_residual(xs, n, rho=rho, n_modes=n_modes)
    t = tf * float(np.max(np.abs(resid)))  # deliberately undersized
    u = (np.cos(xs[:, None] * i) @ (rho ** (i - 1))).astype(np.float32) + t
    mu_fn = float(safety.fn_rate(_t(f), _t(u), eps))
    bound = theory.prop4_fn_bound(float(np.mean(resid ** 2)), eps, t)
    assert mu_fn <= bound + 1e-6


def test_selection_rules():
    for n in (5, 20, 50):
        assert theory.t_of_n(theory.exp_coeffs(0.9, 10_000), n) == \
            pytest.approx(theory.exp_decay_s(0.9, n), rel=1e-6)
    assert theory.s_rule(0.37) == pytest.approx(0.74)
    tail = sum((1 / i) ** 2 for i in range(51, 200_000))
    assert tail == pytest.approx(50 ** -1.0, rel=0.05)
    assert theory.power_law_s(1.0, 50) == pytest.approx(1 / 50)
    assert theory.prop4_region_bound(0.01, 0.1, 0.3) == \
        pytest.approx((1 / 0.01 + 1 / 0.04) * 0.01)
    np.testing.assert_array_equal(theory.power_coeffs(1.5, 7),
                                  (1.0 / np.arange(1, 8)) ** 1.5)


# ---------------------------------------------------------------- safety
@pytest.mark.parametrize("threshold,eps", [(0.0, 0.05), (0.8, 0.01)])
def test_metrics_report_matches_reference(threshold, eps):
    rng = np.random.default_rng(7)
    f = rng.uniform(-1, 1.5, 2048).astype(np.float32)
    u = (f + rng.normal(0.1, 0.3, 2048)).astype(np.float32)
    fhat = (u - 0.2 / (1 + np.exp(-rng.normal(size=2048)))).astype(np.float32)
    got = safety.metrics_report(_t(f), _t(u), _t(fhat), eps=eps,
                                threshold=threshold)
    want = jsafety.metrics_report(jnp.asarray(f), jnp.asarray(u),
                                  jnp.asarray(fhat), eps=eps,
                                  threshold=threshold)
    assert set(got) == set(want)
    for k, w in want.items():
        assert float(got[k]) == pytest.approx(float(w), rel=1e-5, abs=1e-7), k
        assert got[k].dtype == torch.float32 and got[k].dim() == 0


# ---------------------------------------------------------- train_paper
def test_paper_batches_are_the_per_step_draws():
    """The index rows train_paper uploads once are the reference loop's
    draws, one rng.integers call per step (an odd batch included)."""
    for n, steps, batch, seed in ((4096, 50, 256, 0), (2519, 7, 33, 3)):
        rng = np.random.default_rng(seed)
        want = [rng.integers(0, n, size=batch) for _ in range(steps)]
        np.testing.assert_array_equal(
            paper_batches(n, steps=steps, batch=batch, seed=seed),
            np.stack(want))


@pytest.mark.parametrize("name,u_mode,kw", [
    ("paper-synthetic", "cosine", dict(n_modes=24, monitor_n=8, s=0.6,
                                       freeze_t=0.3, safety_weight=0.1)),
    ("paper-synthetic", "truncated", {}),
    ("paper-financial", "truncated", dict(safety_weight=20.0)),
    ("paper-financial", "independent", dict(u_dims=(29, 10, 1),
                                            safety_weight=20.0,
                                            freeze_t=0.05)),
])
def test_paper_steps_match_reference(name, u_mode, kw):
    """Five steps of make_paper_step from the reference's init (bridged)
    over the reference loop's batches, against the reference's own
    train_paper: every parameter within lr/10, t unchanged under
    freeze_t, and the final forward within the end-to-end tolerance."""
    cfg, lr, steps, seed = jreg.get_full(name), 2e-3, 5, 4
    x, f = _data(name, n=1024)
    key = jax.random.PRNGKey(3)
    jparams, jres = j_train_paper(key, cfg, x, f, u_mode=u_mode, steps=steps,
                                  lr=lr, seed=seed, **kw)
    init = jdeco.init_paper_decomposition(
        key, cfg, u_mode=u_mode, n_modes=kw.get("n_modes", 0),
        u_dims=kw.get("u_dims"))
    tree = jax.tree.map(np.asarray, init)
    frozen = kw.get("freeze_t")
    if frozen is not None:
        tree["raw_t"] = np.asarray(jdeco._inv_softplus(frozen), np.float32)
    model = bridge.paper_from_numpy(tree, cfg, u_mode, "cpu")
    opt = AdamW(lr=lr, clip_norm=0.0)
    state = opt.init(trainable(model))
    step = make_paper_step(cfg, opt, u_mode=u_mode, s=kw.get("s"),
                           monitor_n=kw.get("monitor_n"),
                           safety_weight=kw.get("safety_weight", 0.0),
                           freeze_t=frozen is not None)
    xt, ft = _t(x), _t(f)
    for idx in paper_batches(x.shape[0], steps=steps, batch=256, seed=seed):
        loss = step(model, state, xt[idx], ft[idx])
    assert float(loss) == pytest.approx(jres["final_loss"], rel=1e-4)
    got = bridge.paper_to_numpy(model)
    want = jax.tree.map(np.asarray, jparams)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, atol=0.1 * lr, rtol=0)
    if frozen is not None:
        assert got["raw_t"] == tree["raw_t"]
    with torch.no_grad():
        out = tdeco.paper_forward(model, xt, cfg, u_mode=u_mode,
                                  s=kw.get("s"), monitor_n=kw.get("monitor_n"))
    for k in ("u", "fhat"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jres["out"][k]),
                                   atol=1e-4, rtol=1e-4)


def test_train_paper_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, f = _data("paper-synthetic", n=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_paper(torch.Generator().manual_seed(0), SYN, x, f,
                    u_mode="truncated", steps=1)


# --------------------------------- mirror of TestPaperPipelineEndToEnd
def _calibrated(seed, steps, **kw):
    rho, n_modes, n = SYN.rho, 24, 8
    x, f = tsyn.paper_synthetic(seed, 4096, rho=rho, n_modes=n_modes)
    t = theory.t_of_n_sampled(
        lambda z: tsyn.synthetic_residual(z, n, rho=rho, n_modes=n_modes), x)
    _, res = train_paper(torch.Generator().manual_seed(0), SYN, x, f,
                         u_mode="cosine", n_modes=n_modes, monitor_n=n,
                         s=theory.s_rule(t), freeze_t=t, steps=steps, lr=5e-3,
                         device="cpu", **kw)
    return f, t, res["out"]


def test_calibrated_monitor_is_safe_and_accurate():
    """Prop-2 calibration (t sampled, s = 2t) with a small safety hinge:
    FN ~ 0 and a small L2, as test_system.py claims for the reference."""
    f, t, out = _calibrated(0, 1500, safety_weight=0.1)
    fj = _t(f)
    fn = float(safety.fn_rate(fj, out["u"], eps=0.05))
    assert fn < 0.005, f"FN rate {fn} must be ~0 under Prop-2 calibration"
    l2 = float(safety.approx_error(fj, out["fhat"], 2.0))
    assert l2 < 0.35, f"combined model must approximate f, got L2={l2}"
    viol, vmax = safety.safety_violation(fj, out["u"])
    assert float(viol) < 0.2 and float(vmax) < 2 * t
    assert (out["fhat"] <= out["u"]).all()


def test_trigger_rate_matches_event_rate_order():
    f, _, out = _calibrated(1, 1200)
    u = out["u"].numpy()
    thr = np.quantile(f, 0.9)  # top-decile events
    trig, event = (u > thr).mean(), (f > thr).mean()
    assert trig < 0.5, "monitor must not page the server for most inputs"
    assert trig >= event - 0.01, "every true event must trigger"
