"""The port's expert-parallel MoE dispatch (``nn/moe.py::moe_apply_ep``)
on gloo process groups spawned here, against the reference's dense
``moe_apply`` (``src/repro/nn/moe.py``) in f32.

Eight ranks form a (data 2, model 4) DeviceMesh.  With E = 8 each model
rank holds two experts (expert-parallel); with E = 6 every rank holds a
quarter of each expert's d_ff (ff-parallel).  A data rank routes only its
own tokens at their capacity, so at capacity factor 1.25 its output and
gradients are the reference's dense dispatch over that data shard alone
(2e-5), and at a capacity factor that drops nothing they are the global
dispatch's.  The reference's own EP test compares 97% of positions and is
red under jax 0.9.0; it is no ground truth here.  Each test bounds its
workers' join at 120 s, so a hang fails the test instead of the suite.
"""
import os
import socket
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import moe as jmoe
from repro_torch.distributed import sharding as shd
from repro_torch.nn import moe as tmoe

from _torch_parity import TOL

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WORKER = os.path.join(HERE, "_torch_ep_worker.py")
JOIN_S = 120
MESH = (2, 4)
K, D, F = 2, 64, 128
B, S = 4, 32
NO_DROP = 8.0   # capacity >= every local token's choices: nothing dropped


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v, np.float32)
    return out


def _run_ranks(tmp, E, n_shared, cfs, seed):
    """The reference's weights and tokens to every rank; returns (tree, x,
    cot, per-rank outputs)."""
    tree = jmoe.init_moe(jax.random.PRNGKey(seed), D, F, E,
                         n_shared=n_shared)
    tree = jax.tree.map(np.asarray, tree)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    cot = rng.standard_normal((B, S, D)).astype(np.float32)
    case = os.path.join(tmp, "case.npz")
    meta = dict(E=E, K=K, D=D, F=F, n_shared=n_shared, mesh=MESH, cfs=cfs)
    np.savez(case, x=x, cot=cot, meta=np.asarray(meta, dtype=object),
             **{f"p/{k}": v for k, v in _flat(tree).items()})
    world, port = MESH[0] * MESH[1], _free_port()
    env = {**os.environ, "PYTHONPATH": os.path.abspath(SRC),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, case, tmp, str(r), str(world), str(port)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    deadline = time.monotonic() + JOIN_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pytest.fail(f"EP ranks did not finish within {JOIN_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = [p.stdout.read().decode(errors="replace") for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-3000:]}"
    outs = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
            for r in range(world)]
    return tree, x, cot, outs


def _dense(tree, x, cot, E, cf):
    """The reference's dense dispatch: (y, aux, grads of sum(y * cot) by
    parameter path and for x)."""
    def f(p, xx):
        return jmoe.moe_apply(p, xx, n_experts=E, top_k=K,
                              capacity_factor=cf, compute_dtype=jnp.float32)

    def loss(p, xx, c):
        return jnp.sum(f(p, xx)[0] * c)

    y, aux = f(tree, jnp.asarray(x))
    gp, gx = jax.grad(loss, argnums=(0, 1))(tree, jnp.asarray(x),
                                            jnp.asarray(cot))
    return (np.asarray(y), float(aux),
            {**_flat(jax.tree.map(np.asarray, gp)), "x": np.asarray(gx)})


def _spec(out, name):
    return eval(str(out[f"spec/{name}"]))


def _check_rank(out, cf, want_y, want_aux, want_g):
    """One rank's output, aux and gradients against the dense reference
    (its block of each cut parameter)."""
    tol = TOL["float32"]
    np.testing.assert_allclose(out[f"{cf}/y"], want_y, atol=tol, rtol=tol)
    np.testing.assert_allclose(out[f"{cf}/aux"], want_aux, rtol=1e-5)
    np.testing.assert_allclose(out[f"{cf}/grad/x"], want_g["x"], atol=tol,
                               rtol=tol)
    coords = dict(zip(("data", "model"), out["coords"].tolist()))
    mesh = shd.abstract_mesh(MESH, ("data", "model"))
    n = 0
    for key in out:
        if not key.startswith(f"{cf}/grad/") or key.endswith("/x"):
            continue
        name = key[len(f"{cf}/grad/"):]
        spec = _spec(out, name) if f"spec/{name}" in out else ()
        block = shd.local_shard(torch.as_tensor(want_g[name]), spec, mesh,
                                coords).numpy()
        np.testing.assert_allclose(out[key], block, atol=tol, rtol=tol,
                                   err_msg=name)
        n += 1
    assert n >= 4


@pytest.mark.parametrize("E,layout", [(8, "expert"), (6, "ff")])
def test_ep_matches_dense_per_data_shard_and_globally(E, layout):
    """E = 8: expert-parallel (two experts a model rank); E = 6: the d_ff
    split.  At capacity factor 1.25 each data rank equals the reference's
    dense dispatch over its own tokens; at a capacity factor that drops
    nothing, the global dispatch over all tokens; gradients too.  The
    load-balance loss is the global batch's at both."""
    with tempfile.TemporaryDirectory(prefix="ep_") as tmp:
        tree, x, cot, outs = _run_ranks(tmp, E, n_shared=1,
                                        cfs=(1.25, NO_DROP), seed=E)
    lead = _spec(outs[0], "w_gate")
    assert lead == (("model", None, None) if layout == "expert"
                    else (None, None, "model"))
    xs, cs = np.split(x, MESH[0]), np.split(cot, MESH[0])
    shard = [_dense(tree, xs[i], cs[i], E, 1.25) for i in range(MESH[0])]
    y_all, aux_all, g_all = _dense(tree, x, cot, E, NO_DROP)
    for out in outs:
        i = int(out["coords"][0])
        y, _, g = shard[i]
        _check_rank(out, 1.25, y, aux_all, g)
        np.testing.assert_allclose(out[f"{NO_DROP}/aux"], aux_all,
                                   rtol=1e-5)
        # no drops: the global dispatch's rows of this data shard; the
        # gradients of the replicated parameters are per data shard
        # (a data-parallel step sums them)
        np.testing.assert_allclose(out[f"{NO_DROP}/y"], np.split(
            y_all, MESH[0])[i], atol=TOL["float32"], rtol=TOL["float32"])
    # summed over the data ranks, a model rank's gradients are the global
    # dispatch's
    by_model = {}
    for out in outs:
        by_model.setdefault(int(out["coords"][1]), []).append(out)
    mesh = shd.abstract_mesh(MESH, ("data", "model"))
    for m, group in by_model.items():
        for key in group[0]:
            if not key.startswith(f"{NO_DROP}/grad/") or key.endswith("/x"):
                continue
            name = key[len(f"{NO_DROP}/grad/"):]
            spec = _spec(group[0], name) if f"spec/{name}" in group[0] \
                else ()
            want = shd.local_shard(torch.as_tensor(g_all[name]), spec, mesh,
                                   {"data": 0, "model": m}).numpy()
            got = sum(o[key] for o in group)
            np.testing.assert_allclose(got, want, atol=4e-5, rtol=4e-5,
                                       err_msg=name)


def test_dispatch_is_moe_apply_without_a_model_split():
    """No mesh current: ``auto`` is ``moe_apply``; a one-rank (1, 1) mesh
    with ``impl="ep"``: bit for bit ``moe_apply`` (one all_reduce over one
    rank)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    tree = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(1), D,
                                                  F, 8, n_shared=1))
    from repro_torch import bridge
    mod = tmoe.MoE(D, F, 8, n_shared=1, device="cpu")
    bridge.load_numpy(mod, tree)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (B, S, D)).astype(np.float32))
    kw = dict(n_experts=8, top_k=K, capacity_factor=1.25,
              compute_dtype=torch.float32)
    want, waux = tmoe.moe_apply(mod, x, **kw)
    got, aux = tmoe.moe_dispatch(mod, x, impl="auto", **kw)
    assert torch.equal(got, want) and torch.equal(aux, waux)
    assert not tmoe.ep_applicable(8)
    with pytest.raises(ValueError, match="DeviceMesh"):
        tmoe.moe_dispatch(mod, x, impl="ep", **kw)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        with shd.use_mesh(mesh):
            assert not tmoe.ep_applicable(8)
            local = tmoe.local_moe(mod, mesh)
            got, aux = tmoe.moe_dispatch(local, x, impl="ep", **kw)
        assert torch.equal(got, want) and torch.equal(aux, waux)
    finally:
        dist.destroy_process_group()
