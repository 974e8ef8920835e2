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
from repro_torch.configs import registry as treg
from repro_torch.training import optimizer as topt
from repro_torch.training.loop import make_train_step, to_device, trainable

# tests/test_kernels.py:23 -- f32 2e-5, bf16 2e-2
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# end-to-end scores after a whole tower: f32 1e-4, bf16 2e-2
TOL_E2E = {"float32": 1e-4, "bfloat16": 2e-2}

ARCHS = ("granite-8b", "paper-synthetic")


def configs(arch):
    """(JAX cfg, port cfg): granite-8b SMOKE (f32) or the paper's SERVING
    workload (bf16)."""
    if arch == "paper-synthetic":
        from repro.configs.paper_synthetic import SERVING
        return SERVING, treg.get_smoke(arch)
    return jreg.get_smoke(arch), treg.get_smoke(arch)


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
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, length)).astype(np.int32)


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
