"""The SSD scan kernel's arithmetic, rehearsed on the CPU.

``csrc/ssd_scan.cu`` runs every product on TF32 tensor cores as three
products (lo hi + hi lo + hi hi).  The kernel runs only on the card
(tests/test_torch_cuda.py); here ``_torch_parity.ssd_emulate`` repeats its
arithmetic in numpy (C B^T once per batch row and chunk, the P columns in
tiles, the f64 cumsum, TF32 operands by rounding their bits) and is held
to the scan's tolerance (atol 5e-5, rtol 5e-4, tests/test_kernels.py:89)
against the plain version in f64, the reference's ``ssd_chunked`` and the
Pallas kernel in interpret mode: on the reference's test grid and under
zamba2's decays (A = -linspace(1, 16), la ~ -11 a step).  One TF32
product instead of three does not hold it, which is why the kernel runs
three.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import ssd_emulate
from repro.kernels.ssm_scan import ssd_scan as pallas_ssd
from repro.nn import ssm as jssm
from repro_torch.kernels.ssm_scan import ssd_scan_plain

ATOL, RTOL = 5e-5, 5e-4  # tests/test_kernels.py:89


def ratio(a, ref) -> float:
    """Largest |a - ref| / (atol + rtol |ref|): at most 1 holds."""
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(a - ref) / (ATOL + RTOL * np.abs(ref))).max())


def inputs(B, S, H, P, N, decays, seed=0):
    """x, dt, A, Bm, Cm (f32) and xdt, la as the port's call site forms
    them.  "test": TestSSDScan's distributions (A = -exp(linspace(0, 1)));
    "zamba2": A = -linspace(1, 16), as zamba2's A_log gives."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = (0.3 if decays == "test" else 0.5) * f(B, S, H, P)
    dt = np.logaddexp(0.0, f(B, S, H)).astype(np.float32)
    A = (-np.exp(np.linspace(0.0, 1.0, H)) if decays == "test"
         else -np.linspace(1.0, 16.0, H)).astype(np.float32)
    Bm, Cm = 0.5 * f(B, S, N), 0.5 * f(B, S, N)
    xdt, la = x * dt[..., None], dt * A[None, None, :]
    return (x, dt, A, Bm, Cm), (xdt, la, Bm, Cm)


CASES = [  # (B, S, H, P, N, chunk, tile, decays)
    (2, 256, 4, 32, 16, 64, 16, "test"),     # tests/test_kernels.py:72-76
    (1, 128, 2, 64, 64, 128, 16, "test"),
    (2, 512, 8, 16, 32, 32, 16, "test"),
    (1, 512, 8, 64, 64, 128, 64, "zamba2"),  # zamba2's P, N and chunk
]


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{c[-1]}-S{c[1]}-P{c[3]}-N{c[4]}" for c in CASES])
def case(request):
    B, S, H, P, N, chunk, pt, decays = request.param
    raw, pre = inputs(B, S, H, P, N, decays)
    y64, h64 = ssd_scan_plain(*(torch.from_numpy(t).double() for t in pre),
                              chunk=chunk)
    return dict(raw=raw, pre=pre, chunk=chunk, pt=pt, y64=y64.numpy(),
                h64=h64.numpy(),
                emu=ssd_emulate(*pre, chunk, pt, passes=3))


def test_three_tf32_products_hold_against_f64(case):
    y, h = case["emu"]
    assert ratio(y, case["y64"]) <= 1.0
    assert ratio(h, case["h64"]) <= 1.0


def test_three_tf32_products_hold_against_ssd_chunked(case):
    yc, hc = jssm.ssd_chunked(*map(jnp.asarray, case["raw"]),
                              chunk=case["chunk"])
    y, h = case["emu"]
    assert ratio(y, np.asarray(yc)) <= 1.0
    assert ratio(h, np.asarray(hc)) <= 1.0


def test_three_tf32_products_hold_against_the_pallas_kernel(case):
    """The Pallas kernel in interpret mode (it drops the final state)."""
    yp = pallas_ssd(*map(jnp.asarray, case["pre"]), chunk=case["chunk"])
    assert ratio(case["emu"][0], np.asarray(yp)) <= 1.0


@pytest.mark.parametrize("pt", [16, 32, 64])
def test_the_column_tiles_do_not_change_the_result(pt):
    """Each row p of the state evolves on its own: every tile of P gives
    the same y and h_final, bit for bit."""
    _, pre = inputs(1, 256, 2, 64, 32, "zamba2", seed=3)
    y, h = ssd_emulate(*pre, 128, pt)
    y64, h64 = ssd_emulate(*pre, 128, 64)
    assert np.array_equal(y, y64) and np.array_equal(h, h64)


def test_one_tf32_product_does_not_hold_under_zamba2_decays():
    """One TF32 product keeps 10 mantissa bits: under zamba2's decays it
    misses the tolerance against f64 many times over, where three hold."""
    _, pre = inputs(1, 512, 8, 64, 64, "zamba2")
    y64, _ = ssd_scan_plain(*(torch.from_numpy(t).double() for t in pre),
                            chunk=128)
    one = ratio(ssd_emulate(*pre, 128, 64, passes=1)[0], y64.numpy())
    three = ratio(ssd_emulate(*pre, 128, 64, passes=3)[0], y64.numpy())
    assert one > 1.0 and three <= 1.0, (one, three)


def test_ragged_last_chunk_is_padded_with_zero_rows():
    """A ragged S (the kernel masks the last chunk by index) against the
    plain form in f64, whose single S-row chunk is the same sum."""
    _, pre = inputs(2, 300, 3, 32, 16, "zamba2", seed=4)
    y, h = ssd_emulate(*pre, 128, 32)
    y64, h64 = ssd_scan_plain(*(torch.from_numpy(t).double() for t in pre),
                              chunk=128)
    assert ratio(y, y64.numpy()) <= 1.0 and ratio(h, h64.numpy()) <= 1.0
