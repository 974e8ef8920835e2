"""The port's kernels (repro_torch.kernels): each plain version against the
JAX Pallas kernel (interpret=True, as tests/test_kernels.py runs it) and
the reference oracle (repro/kernels/ref.py), on TestDecodeAttention's and
TestMonitorCombine's cases plus a ragged (B,) position vector.  The
hand-written CUDA kernels run only on the card: their tests are in
tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.monitor_combine import monitor_combine as pallas_combine
from repro.nn.attention import decode_attention as xla_decode
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  decode_attention_plain)
from repro_torch.kernels.monitor_combine import (monitor_combine_cuda,
                                                 monitor_combine_plain)

from _torch_parity import TOL

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rand(shape, dtype, seed):
    """Same values (rounded to ``dtype``) for both frameworks."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x).astype(DT[dtype][0])
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        DT[dtype][1])


def _close(port, ref, dtype):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


class TestDecodeAttentionPlain:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("B,Hq,Hkv,D,C,bk,pos,window", [
        (2, 8, 2, 64, 512, 128, 100, 0),
        (1, 4, 4, 128, 256, 256, 255, 0),
        (2, 8, 1, 64, 512, 64, 700, 512),   # ring buffer fully wrapped
        (1, 16, 2, 64, 1024, 256, 0, 0),    # first token
    ])
    def test_vs_pallas_and_oracle(self, dtype, B, Hq, Hkv, D, C, bk, pos,
                                  window):
        jq, q = _rand((B, Hq, D), dtype, 1)
        jk, k = _rand((B, C, Hkv, D), dtype, 2)
        jv, v = _rand((B, C, Hkv, D), dtype, 3)
        # one mask serves ring and linear caches: the same output as the
        # reference's call with and without its window
        out = decode_attention_plain(q, k, v, pos)
        assert out.dtype == q.dtype and out.shape == q.shape
        _close(out, pallas_decode(jq, jk, jv, pos, window=window, bk=bk),
               dtype)
        _close(out, R.decode_attention_ref(jq, jk, jv, pos, window=window),
               dtype)
        # the XLA form the reference's serving path runs: same rounding
        # points, so f32 tolerance even in bf16 (one output ulp allowed)
        xla = np.asarray(xla_decode(jq, jk, jv, pos, window=window), np.float32)
        np.testing.assert_allclose(out.float().numpy(), xla,
                                   atol=TOL["float32"],
                                   rtol=TOL[dtype] if dtype == "bfloat16"
                                   else TOL["float32"])

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("window", [0, 64])
    def test_ragged_pos_vector_vs_per_row_reference(self, dtype, window):
        """One call over rows at different depths == one reference call per
        row at its own scalar position (incl. pos 0 and a wrapped ring)."""
        B, Hq, Hkv, D, C = 5, 8, 2, 32, 64
        pos = np.array([0, 7, 63, 64, 150])
        jq, q = _rand((B, Hq, D), dtype, 4)
        jk, k = _rand((B, C, Hkv, D), dtype, 5)
        jv, v = _rand((B, C, Hkv, D), dtype, 6)
        out = decode_attention_plain(q, k, v, torch.as_tensor(pos))
        for b in range(B):
            sl = slice(b, b + 1)
            args = (jq[sl], jk[sl], jv[sl], int(pos[b]))
            _close(out[sl], R.decode_attention_ref(*args, window=window), dtype)
            _close(out[sl], xla_decode(*args, window=window), dtype)

    def test_ops_routes_cpu_tensors_to_plain(self):
        _, q = _rand((2, 4, 32), "float32", 7)
        _, k = _rand((2, 16, 2, 32), "float32", 8)
        a = ops.decode_attention(q, k, k, 5)
        b = decode_attention_plain(q, k, k, 5)
        assert torch.equal(a, b)

    def test_kernel_wrapper_refuses_cpu_tensors(self):
        """The CUDA wrapper never falls back: a tensor it does not take
        raises before anything launches."""
        _, q = _rand((2, 4, 32), "bfloat16", 7)
        _, k = _rand((2, 16, 2, 32), "bfloat16", 8)
        with pytest.raises(ValueError, match="CUDA"):
            decode_attention_cuda(q, k, k, 5)


class TestMonitorCombinePlain:
    @pytest.mark.parametrize("n", [8, 256, 1000, 1024])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_vs_pallas_and_oracle(self, n, seed):
        rng = np.random.default_rng(seed)
        u, v, f = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
        s = float(rng.uniform(0.05, 2.0))
        thr = float(rng.uniform(-0.5, 0.5))
        fh, m, c = monitor_combine_plain(*map(torch.from_numpy, (u, v, f)),
                                         s=s, threshold=thr)
        for ref in (pallas_combine(*map(jnp.asarray, (u, v, f)), s=s,
                                   threshold=thr, block=256),
                    R.monitor_combine_ref(*map(jnp.asarray, (u, v, f)), s=s,
                                          threshold=thr)):
            fr, mr, cr = (np.asarray(x) for x in ref)
            np.testing.assert_allclose(fh.numpy(), fr, atol=1e-6)
            np.testing.assert_array_equal(m.numpy(), mr)
            np.testing.assert_array_equal(c.numpy(), cr)

    def test_kernel_wrapper_refuses_cpu_tensors(self):
        u = torch.zeros(8)
        with pytest.raises(ValueError, match="CUDA"):
            monitor_combine_cuda(u, u, u, s=0.2)
