"""The port's SSD scan (kernels/ssm_scan.py, kernels/ops.py::ssd_scan) and
Mamba2 block (nn/ssm.py) against the JAX reference on the CPU, with inputs
made by numpy from a seed.  The hand-written CUDA kernel runs only on the
card: its tests are in tests/test_torch_cuda.py.

Tolerances: the SSD scan at the reference's own (atol 5e-5, rtol 5e-4,
tests/test_kernels.py:89); its gradients rel 1e-4 of the largest entry
(f32 sums in another order); the Mamba2 block f32 1e-4, as
tests/test_nn.py::TestMamba2 holds the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro.kernels.ssm_scan import ssd_scan as pallas_ssd
from repro.nn import ssm as jssm
from repro_torch import bridge
from repro_torch.kernels import ops
from repro_torch.kernels.ssm_scan import ssd_scan_cuda, ssd_scan_plain
from repro_torch.nn import ssm as tssm

SSD_TOL = dict(atol=5e-5, rtol=5e-4)  # tests/test_kernels.py:89


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _ssd_inputs(B, S, H, P, N, seed=0):
    """TestSSDScan's input distributions, drawn with numpy: x, dt, A, Bm,
    Cm as f32 arrays."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = 0.3 * f(B, S, H, P)
    dt = np.asarray(jax.nn.softplus(jnp.asarray(f(B, S, H))))
    A = np.asarray(-jnp.exp(jnp.linspace(0.0, 1.0, H)))
    return x, dt, A, 0.5 * f(B, S, N), 0.5 * f(B, S, N)


def _pre(x, dt, A):
    """xdt and la as the port's call site forms them (f32 products)."""
    xt, dtt = torch.from_numpy(x), torch.from_numpy(dt)
    return xt * dtt[..., None], dtt * torch.from_numpy(A)[None, None, :]


# ------------------------------------------------------------- SSD scan
SSD_GRID = [(2, 256, 4, 32, 16, 64), (1, 128, 2, 64, 64, 128),
            (2, 512, 8, 16, 32, 32)]  # tests/test_kernels.py:72-76


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_GRID)
def test_ssd_plain_matches_pallas_oracle_and_chunked(B, S, H, P, N, chunk):
    """TestSSDScan's grid: the plain version against the Pallas kernel
    (interpret mode), the sequential oracle and ssd_chunked, whose final
    state it also returns."""
    x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, P, N)
    xdt, la = _pre(x, dt, A)
    y, h = ssd_scan_plain(xdt, la, torch.from_numpy(Bm),
                          torch.from_numpy(Cm), chunk=chunk)
    jx = [jnp.asarray(a) for a in (xdt.numpy(), la.numpy(), Bm, Cm)]
    np.testing.assert_allclose(_np(y), _np(pallas_ssd(*jx, chunk=chunk)),
                               **SSD_TOL)
    np.testing.assert_allclose(_np(y), _np(R.ssd_ref(*jx)), **SSD_TOL)
    yc, hc = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                              chunk=chunk)
    np.testing.assert_allclose(_np(y), _np(yc), **SSD_TOL)
    np.testing.assert_allclose(_np(h), _np(hc), **SSD_TOL)


@pytest.mark.parametrize("S,chunk", [(200, 64), (1, 128), (37, 16)])
def test_ssd_plain_ragged_matches_oracle_and_chunked(S, chunk):
    """Lengths the chunk does not divide take one chunk of S rows, as in
    ssd_chunked (the Pallas kernel asserts S % chunk == 0, so only the
    oracle and ssd_chunked are compared)."""
    x, dt, A, Bm, Cm = _ssd_inputs(2, S, 4, 16, 16, seed=1)
    xdt, la = _pre(x, dt, A)
    y, h = ssd_scan_plain(xdt, la, torch.from_numpy(Bm),
                          torch.from_numpy(Cm), chunk=chunk)
    jx = [jnp.asarray(a) for a in (xdt.numpy(), la.numpy(), Bm, Cm)]
    np.testing.assert_allclose(_np(y), _np(R.ssd_ref(*jx)), **SSD_TOL)
    yc, hc = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                              chunk=chunk)
    np.testing.assert_allclose(_np(y), _np(yc), **SSD_TOL)
    np.testing.assert_allclose(_np(h), _np(hc), **SSD_TOL)


@pytest.mark.parametrize("S,chunk", [(96, 32), (50, 32)])
def test_ssd_scan_gradients_match_jax_grad(S, chunk):
    """Gradients of ``ops.ssd_scan`` (the SSDScan Function, its backward
    the plain chunked form under autograd) with respect to x, dt, A, Bm
    and Cm, through y and h_final, against jax.grad of ssd_chunked;
    rel 1e-4 of each gradient's largest entry."""
    x, dt, A, Bm, Cm = _ssd_inputs(2, S, 4, 16, 16, seed=2)
    rng = np.random.default_rng(3)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    dh = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)

    def f(*a):
        y, h = jssm.ssd_chunked(*a, chunk=chunk)
        return jnp.sum(y * dy) + jnp.sum(h * dh)

    want = jax.grad(f, argnums=tuple(range(5)))(
        *map(jnp.asarray, (x, dt, A, Bm, Cm)))
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, dt, A, Bm, Cm)]
    y, h = ops.ssd_scan(*leaves, chunk=chunk)
    ((y * torch.from_numpy(dy)).sum()
     + (h * torch.from_numpy(dh)).sum()).backward()
    for name, t, w in zip(("x", "dt", "A", "Bm", "Cm"), leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(t.grad), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_ssd_scan_refuses_h0_and_cpu_tensors_at_the_kernel():
    x, dt, A, Bm, Cm = map(torch.from_numpy, _ssd_inputs(1, 16, 2, 16, 16))
    with pytest.raises(ValueError, match="initial state"):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=16, h0=torch.zeros(1))
    xdt, la = x * dt[..., None], dt * A
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(xdt, la, Bm, Cm, chunk=16)


# ---------------------------------------------------------------- Mamba2
D_MODEL, KW = 64, dict(expand=2, state=16, conv_k=4, head_p=32)


def _mamba_pair(seed=0):
    """The reference's init_mamba2 (f32) and the same weights in a port
    Mamba2 (f32), as in tests/test_nn.py::TestMamba2."""
    p = jssm.init_mamba2(jax.random.PRNGKey(seed), D_MODEL, expand=2,
                         state=16, head_p=32)
    m = tssm.Mamba2(D_MODEL, expand=2, state=16, conv_k=4, head_p=32)
    bridge._load(m, jax.tree.map(np.asarray, p), "")
    return p, m


def _one_layer_cache() -> "tssm.SSMCache":
    """Layer 0 of a one-layer cache stack on the CPU, as views that the
    decode step writes in place."""
    stack = tssm.init_ssm_cache(2, D_MODEL, **KW, n_layers=1, device="cpu")
    return tssm.SSMCache(*(t[0] for t in stack))


def _x_seq(B=2, S=24, seed=4):
    return np.random.default_rng(seed).standard_normal(
        (B, S, D_MODEL)).astype(np.float32)


def test_mamba2_prefill_and_decode_match_reference():
    """Prefill over 24 tokens (3 chunks of 8) and 24 decode steps from a
    zero cache: outputs and the final state and conv tails against the
    reference's mamba2_prefill / mamba2_decode, f32."""
    p, m = _mamba_pair()
    x = _x_seq()
    kw = dict(KW, compute_dtype=jnp.float32)
    want = jssm.mamba2_prefill(p, jnp.asarray(x), chunk=8, **kw)
    with torch.no_grad():
        got = tssm.mamba2_prefill(m, torch.from_numpy(x), chunk=8, **KW,
                                  compute_dtype=torch.float32)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
    jcache = jssm.init_ssm_cache(2, D_MODEL, **{k: KW[k] for k in
                                                ("expand", "state", "conv_k",
                                                 "head_p")})
    cache = _one_layer_cache()
    step = jax.jit(lambda c, xt: jssm.mamba2_decode(p, xt, c, **kw))
    with torch.no_grad():
        for t in range(x.shape[1]):
            wy, jcache = step(jcache, jnp.asarray(x[:, t]))
            gy = tssm.mamba2_decode(m, torch.from_numpy(x[:, t]), cache, **KW,
                                    compute_dtype=torch.float32)
            np.testing.assert_allclose(_np(gy), _np(wy), atol=1e-4, rtol=1e-4)
    for name in tssm.SSMCache._fields:
        np.testing.assert_allclose(_np(getattr(cache, name)),
                                   _np(getattr(jcache, name)), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


@torch.no_grad()
def test_mamba2_port_invariants():
    """tests/test_nn.py::TestMamba2 inside the port: decode equals prefill,
    and prefill does not depend on the chunk (8, or 48 which does not
    divide S and takes one chunk); a masked decode leaves an inactive
    row's state and conv tails bit-unchanged."""
    _, m = _mamba_pair(seed=1)
    x = torch.from_numpy(_x_seq(seed=5))
    f32 = dict(KW, compute_dtype=torch.float32)
    y_ref = tssm.mamba2_prefill(m, x, chunk=16, **f32)
    cache = _one_layer_cache()
    outs = [tssm.mamba2_decode(m, x[:, t], cache, **f32)
            for t in range(x.shape[1])]
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(y_ref),
                               atol=1e-4)
    np.testing.assert_allclose(_np(tssm.mamba2_prefill(m, x, chunk=8, **f32)),
                               _np(tssm.mamba2_prefill(m, x, chunk=48, **f32)),
                               atol=1e-4)
    before = tssm.SSMCache(*(t.clone() for t in cache))
    tssm.mamba2_decode(m, x[:, 0], cache, **f32,
                       active=torch.tensor([True, False]))
    for name, old, new in zip(tssm.SSMCache._fields, before, cache):
        assert torch.equal(new[1], old[1]), name
        assert not torch.equal(new[0], old[0]), name
