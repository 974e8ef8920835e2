"""The port's serve step on the model axis (``launch/steps.py::
make_serve_step`` on a DeviceMesh) against the reference's unsharded
``jit`` serve step, and the partial entry of the decode attention
(``kernels/decode_attention.py``) against the reference's decode
attention, on the CPU.

The kernel functions, f32 and bf16 (tolerances 2e-5 and 2e-2): a cache
cut into M = 1, 2, 4, 8 time slices, each slice's partial
(``decode_attention_partial_plain``: o normalised by the slice's own sum,
f32, and its log-sum-exp) joined by ``combine_partials``, against the
reference's ``decode_attention`` (``repro/nn/attention.py:136``), the
Pallas kernel in interpret mode and ``decode_attention_plain`` on the
whole cache; a position vector that leaves whole slices empty (their
rows must give o = 0, lse = -inf), and a ring stepped past its capacity.

The serve step: one spawn of 4 gloo workers (``tests/
_torch_mesh_serve_worker.py``) runs every case below through the entry
points a user calls (the bridge's placed model, ``init_cache(...,
device_mesh=)``, ``distribute_batch``), ``T`` steps from an empty cache
at pos 0, so the first steps leave the upper ranks' slices empty; the
parent runs the reference's ``jax.jit(make_serve_step)`` meanwhile, on
the same weights (the port's seeded init carried over by the bridge; a
VLM's cross gates opened and its image K/V filled with the same rows in
both packages), at a threshold in a gap of the reference's u (margin 0),
which the workers wait for.  Per step, logits, u and fhat within 1e-4
and the trigger mask exact outside the tie band (whose count is
printed); after the last step the whole server and edge caches within
1e-4.  The cases: every arch on (data 2, model 2); on (data 1, model 4)
the archs whose placement differs there; a ring smaller than the context
stepped past its capacity (the ``long_500k`` form: granite-8b and the
hybrid's shared attention); the ``"heads"`` cache split (the cache
gathered where the rule split head_dim).  Then a worker alone in a
group of one holds the step placed on a (1, 1) mesh to the unplaced
step, bit for bit.  The MoE archs run at a capacity factor that drops
nothing (each data rank routes its own rows).  The join is bounded at
``JOIN_S``.
"""
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import decomposition as jdeco
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.nn.attention import decode_attention as ref_decode
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.core import decomposition as tdeco
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (
    combine_partials, decode_attention_partial_plain, decode_attention_plain)

from _torch_families import cross_rows, ref_cache_fields
from _torch_parity import TOL, TOL_E2E, gap_threshold, tie_band, token_stream

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WORKER = os.path.join(HERE, "_torch_mesh_serve_worker.py")
JOIN_S = 150
WORLD = 4
TOL_STEP = TOL_E2E["float32"]
ARCHS = tuple(jreg.names())
B = 4
# (case name) -> (arch, variant, mesh, extra overrides); a variant is the
# config the reference runs (its weights, tokens and threshold)
VARIANTS = {"base": dict(S=8, S_edge=8, T=5, overrides={}),
            # a ring of 8 slots (a context past LONG_CONTEXT_THRESHOLD),
            # stepped 12 times: the long_500k form
            "ring": dict(S=70000, S_edge=8, T=12,
                         overrides={"long_context_window": 8})}
CASES = {f"d2m2-{a}": (a, "base", (2, 2), {}) for a in ARCHS}
# kv heads that do not divide model 4 (granite: 2), q heads that do not
# (qwen2.5-32b: 5 of 1 kv head), the SSM heads and conv tails (zamba2),
# the latent cache at 2 rows a rank (deepseek-v3), two mLSTM heads
# (xlstm), the image rows at 4 a rank (the VLM)
CASES.update({f"d1m4-{a}": (a, "base", (1, 4), {}) for a in (
    "granite-8b", "qwen2.5-32b", "zamba2-7b", "deepseek-v3-671b",
    "xlstm-350m", "llama-3.2-vision-11b")})
CASES.update({f"ring-{a}": (a, "ring", (2, 2), {}) for a in (
    "granite-8b", "zamba2-7b")})
CASES.update({f"heads-{a}": (a, "base", (2, 2), {"decode_cache_shard":
                                                  "heads"}) for a in (
    "granite-8b", "llama-3.2-vision-11b", "zamba2-7b", "deepseek-v3-671b")})
BITWISE = ARCHS
_RUN = {}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# ------------------------------------------------------- kernel functions
def _kernel_inputs(dtype, ring):
    """q, caches and a (B,) position vector: linear positions that leave
    whole slices empty at every split, or a ring past its capacity."""
    rng = np.random.default_rng(11)
    Bk, Hq, Hkv, D, C = 4, 8, 2, 32, 64
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((Bk, Hq, D), (Bk, C, Hkv, D), (Bk, C, Hkv, D)))
    pos = np.array([C + 5, 2 * C + 1, C, 3 * C - 1] if ring
                   else [3, 20, 40, 63], np.int32)
    return q, k, v, pos


@lru_cache(maxsize=None)
def _whole_cache(dtype, ring):
    """The whole cache's output from the reference's decode attention,
    the Pallas kernel (interpret mode) and the plain version; the first
    two take a scalar position, so one row at a time."""
    q, k, v, pos = _kernel_inputs(dtype, ring)
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    window = k.shape[1] if ring else 0
    rows = range(q.shape[0])
    want_ref = np.concatenate([np.asarray(ref_decode(
        jq[b:b + 1], jk[b:b + 1], jv[b:b + 1], int(pos[b]), window=window),
        np.float32) for b in rows])
    want_pallas = np.concatenate([np.asarray(pallas_decode(
        jq[b:b + 1], jk[b:b + 1], jv[b:b + 1], int(pos[b]), window=window,
        bk=16), np.float32) for b in rows])
    tq, tk, tv = (torch.as_tensor(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    want_plain = _np(decode_attention_plain(tq, tk, tv, torch.as_tensor(pos)))
    return {"reference": want_ref, "pallas": want_pallas,
            "plain": want_plain}


@pytest.mark.parametrize("ring", [False, True], ids=["linear", "ring"])
@pytest.mark.parametrize("m", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_partials_combine_to_the_whole_cache(dtype, m, ring):
    q, k, v, pos = _kernel_inputs(dtype, ring)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.as_tensor(a).to(tdt) for a in (q, k, v))
    Cl = k.shape[1] // m
    o_parts, lse_parts = [], []
    for r in range(m):
        o, lse = decode_attention_partial_plain(
            tq, tk[:, r * Cl:(r + 1) * Cl].contiguous(),
            tv[:, r * Cl:(r + 1) * Cl].contiguous(), torch.as_tensor(pos),
            r * Cl)
        assert o.dtype == lse.dtype == torch.float32
        empty = torch.as_tensor(pos < r * Cl)
        assert bool((lse[empty] == -math.inf).all())
        assert bool((o[empty] == 0).all())
        assert bool(torch.isfinite(lse[~empty]).all())
        o_parts.append(o)
        lse_parts.append(lse)
    got = _np(combine_partials(o_parts, lse_parts).to(tdt))
    tol = TOL[dtype]
    for name, want in _whole_cache(dtype, ring).items():
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol,
                                   err_msg=f"{name} M={m}")


def test_partial_entry_shape_function_counts_the_slice():
    """A meta operand reaches the shape function: f32 (o, lse) of the
    kernel's shapes, and the slice's FLOPs and bytes recorded."""
    q = torch.empty(8, 32, 128, dtype=torch.bfloat16, device="meta")
    kv = torch.empty(8, 2048, 8, 128, dtype=torch.bfloat16, device="meta")
    counts = {}
    ops.shape_counters.append(counts)
    try:
        o, lse = ops.decode_attention_partial(q, kv, kv, 5, 2048)
    finally:
        ops.shape_counters.remove(counts)
    assert o.shape == q.shape and lse.shape == (8, 32)
    assert o.dtype == lse.dtype == torch.float32
    e = counts["decode_attention_partial"]
    assert e["calls"] == 1 and e["flops"] == 4.0 * 8 * 32 * 2048 * 128
    # the slice's K and V read once: the bound's 67.1 MB
    assert 2 * 8 * 2048 * 8 * 128 * 2 <= e["bytes"] < 1.01 * 67.2e6


def test_cache_placement_names_the_batch_axis():
    """A model cache stacks layers on axis 0 and streams on axis 1.  With
    as many layers as streams the reference's rule (the first axis of the
    batch's size) takes the layer axis; the placed cache's
    (``cache_placements``, ``batch_axis=1``) takes axis 1."""
    from repro.distributed import sharding as jshd
    from repro_torch.distributed import sharding as shd
    from repro_torch.nn.attention import KVCache
    shape = (8, 8, 16, 2, 64)
    cache = {"blocks": KVCache(k=shape, v=shape)}
    mesh = shd.abstract_mesh((2, 2), ("data", "model"))
    got = shd.cache_specs(cache, mesh, 8, mode="time")["blocks"].k
    jmesh = jax.sharding.AbstractMesh((2, 2), ("data", "model"))
    want = jshd.cache_specs({"blocks": jax.ShapeDtypeStruct(shape, jnp.float32)},
                            jmesh, 8, mode="time")["blocks"]
    assert tuple(got) == tuple(want) == ("data", "model", None, None, None)
    placed = shd.cache_specs(cache, mesh, 8, mode="time", batch_axis=1)
    assert placed["blocks"].k == (None, "data", "model", None, None)


# ------------------------------------------------------------ serve step
def _overrides(arch):
    """A capacity factor that drops nothing for the MoE archs."""
    cfg = treg.get_smoke(arch)
    return {"capacity_factor": float(cfg.n_experts) / cfg.top_k} \
        if cfg.n_experts else {}


def _write(arch, case_dir):
    """The arch's weights (the port's init from seed 0, a VLM's cross
    gates opened), tokens and a VLM's image K/V, for both packages."""
    tcfg = treg.get_smoke(arch)
    tree = bridge.collab_to_numpy(tdeco.init_collab_lm(
        tcfg, torch.Generator().manual_seed(0), "cpu"))
    flat = {}
    if tcfg.family == "vlm":
        gate = tree["server"]["cross"]["gate"]
        tree["server"]["cross"]["gate"] = np.random.default_rng(7).uniform(
            0.5, 1.0, gate.shape).astype(np.float32)
        n_super = tcfg.n_layers // tcfg.cross_attn_every
        k, v = cross_rows((n_super, B, tcfg.n_image_tokens, tcfg.n_kv_heads,
                           tcfg.resolved_head_dim))
        flat.update({"cross/k": k, "cross/v": v})
    tokens = token_stream(tcfg, B, max(v["T"] for v in VARIANTS.values()),
                          seed=3)

    def walk(t, prefix):
        for key, val in t.items():
            path = f"{prefix}/{key}"
            if isinstance(val, dict):
                walk(val, path)
            else:
                flat[f"p{path}"] = val

    walk(tree, "")
    np.savez(os.path.join(case_dir, f"{arch}.npz"), tokens=tokens, **flat)
    return dict(tree=tree, tokens=tokens, cross=(
        (flat["cross/k"], flat["cross/v"]) if "cross/k" in flat else None))


def _ref_leaves(jcfg, jcache):
    """The reference's decode cache under the port's leaf paths."""
    if jcfg.family == "hybrid":
        out = {}
        for name in ("h", "conv_x", "conv_B", "conv_C"):
            leaf = np.asarray(getattr(jcache["ssm"], name), np.float32)
            leaf = leaf.reshape((-1,) + leaf.shape[2:])
            if jcache["ssm_tail"] is not None:
                leaf = np.concatenate([leaf, np.asarray(
                    getattr(jcache["ssm_tail"], name), np.float32)])
            out[f"ssm/{name}"] = leaf
        for name, leaf in jcache["attn"]._asdict().items():
            out[f"attn/{name}"] = np.asarray(leaf, np.float32)
        return out
    return {f"{key}/{name}": np.asarray(leaf, np.float32)
            for key, entry in ref_cache_fields(jcfg, jcache).items()
            if entry is not None for name, leaf in entry.items()}


def _reference(variant, arch, data, case_dir):
    """The reference's unsharded jit serve step over the variant's steps:
    u at any threshold gives the gap threshold (written for the workers),
    then every step's outputs and the final caches at it."""
    v = VARIANTS[variant]
    jcfg = jreg.get_smoke(arch).replace(**_overrides(arch), **v["overrides"])

    def run(params, thr):
        cfg = jcfg.replace(monitor=jcfg.monitor.__class__(**{
            **jcfg.monitor.__dict__, "threshold": thr,
            "trigger_margin": 0.0}))
        step = jax.jit(jsteps.make_serve_step(cfg))
        sc = japi.init_cache(jcfg, B, v["S"])
        ec = japi.init_cache(jdeco.edge_arch(jcfg), B, v["S_edge"])
        if data["cross"] is not None:
            sc = dict(sc, cross_k=jnp.asarray(data["cross"][0],
                                              sc["cross_k"].dtype),
                      cross_v=jnp.asarray(data["cross"][1],
                                          sc["cross_v"].dtype))
        outs = []
        for t in range(v["T"]):
            w = step(params, sc, ec, jnp.asarray(data["tokens"][:, t]),
                     jnp.asarray(t, jnp.int32))
            sc, ec = w["server_cache"], w["edge_cache"]
            outs.append({k: np.asarray(w[k], np.float32)
                         for k in ("logits", "u", "fhat", "mask")})
        return outs, sc, ec

    params = jax.tree.map(jnp.asarray, data["tree"])
    probe, _, _ = run(params, 0.0)
    thr = gap_threshold(np.stack([o["u"] for o in probe]))[0]
    name = f"{variant}-{arch}"
    tmp = os.path.join(case_dir, f"thr_{name}.tmp.npy")
    np.save(tmp, np.asarray(thr))
    os.replace(tmp, os.path.join(case_dir, f"thr_{name}.npy"))
    outs, sc, ec = run(params, thr)
    leaves = {f"server/{k}": x for k, x in _ref_leaves(jcfg, sc).items()}
    leaves.update({f"edge/{k}": x for k, x in _ref_leaves(
        jdeco.edge_arch(jcfg), ec).items()})
    return {"thr": thr, "steps": outs, "caches": leaves}


def _case(arch, variant, mesh, extra):
    v = VARIANTS[variant]
    return {"arch": arch, "variant": f"{variant}-{arch}", "mesh": mesh,
            "B": B, "S": v["S"], "S_edge": v["S_edge"], "T": v["T"],
            "overrides": {**_overrides(arch), **v["overrides"], **extra}}


def _start():
    """The workers, then the reference beside them (in a thread: the
    kernel tests run meanwhile); once."""
    if _RUN:
        return
    case_dir = _RUN["dir"] = tempfile.mkdtemp(prefix="mesh_serve_")
    data = {arch: _write(arch, case_dir) for arch in ARCHS}
    cases = {name: _case(*c) for name, c in CASES.items()}
    bitwise = {f"d1m1-{a}": _case(a, "base", (1, 1), {}) for a in BITWISE}
    with open(os.path.join(case_dir, "case.json"), "w") as fh:
        json.dump({"cases": cases, "bitwise": bitwise}, fh)
    port, port1 = _free_port(), _free_port()
    env = {**os.environ, "PYTHONPATH": os.path.abspath(SRC),
           "OMP_NUM_THREADS": "1"}
    _RUN["t0"] = time.monotonic()
    _RUN["procs"] = [subprocess.Popen(
        [sys.executable, WORKER, case_dir, str(r), str(WORLD), str(port),
         str(port1)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(WORLD)]
    _RUN["deadline"] = time.monotonic() + JOIN_S
    # the workers take the cases in order: the references in that order,
    # XLA compiling outside the GIL three at a time
    variants = []
    for c in cases.values():
        if c["variant"] not in variants:
            variants.append(c["variant"])

    def references():
        with ThreadPoolExecutor(3) as pool:
            futs = {name: pool.submit(_reference, name.split("-", 1)[0],
                                      name.split("-", 1)[1],
                                      data[name.split("-", 1)[1]], case_dir)
                    for name in variants}
            _RUN["refs"] = {name: f.result() for name, f in futs.items()}

    _RUN["ref_thread"] = threading.Thread(target=references, daemon=True)
    _RUN["ref_thread"].start()


def _outputs():
    """Join the references and the workers (once) and check their
    exits."""
    _start()
    _RUN["ref_thread"].join(timeout=max(_RUN["deadline"] - time.monotonic(),
                                        0.1))
    assert "refs" in _RUN, "the reference's serve steps did not finish"
    if "logs" not in _RUN:
        procs = _RUN["procs"]
        try:
            for p in procs:
                p.wait(timeout=max(_RUN["deadline"] - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            pytest.fail(f"mesh serving ranks did not finish within {JOIN_S} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        _RUN["logs"] = [p.stdout.read().decode(errors="replace")
                        for p in procs]
        print(f"mesh serving: workers joined after "
              f"{time.monotonic() - _RUN['t0']:.1f} s")
    for r, p in enumerate(_RUN["procs"]):
        assert p.returncode == 0, f"rank {r}:\n{_RUN['logs'][r][-3000:]}"
    return _RUN["refs"]


@pytest.fixture(scope="module", autouse=True)
def _workers():
    _start()
    yield
    _RUN["ref_thread"].join(timeout=JOIN_S)   # before its files go
    for p in _RUN.get("procs", ()):
        if p.poll() is None:
            p.kill()
            p.wait()
    if "dir" in _RUN:
        shutil.rmtree(_RUN["dir"], ignore_errors=True)


@pytest.mark.parametrize("name", list(CASES))
def test_placed_serve_step_matches_the_unsharded_reference(name):
    refs = _outputs()
    arch, variant, mesh, extra = CASES[name]
    ref = refs[f"{variant}-{arch}"]
    got = dict(np.load(os.path.join(_RUN["dir"], f"out_{name}.npz")))
    n_band = n = 0
    for t, want in enumerate(ref["steps"]):
        for k in ("logits", "u", "fhat"):
            np.testing.assert_allclose(got[f"s{t}/{k}"], want[k],
                                       atol=TOL_STEP, rtol=TOL_STEP,
                                       err_msg=f"{name} step {t} {k}")
        band = tie_band(want["u"], ref["thr"], TOL_STEP)
        n_band += int(band.sum())
        n += band.size
        np.testing.assert_array_equal(got[f"s{t}/mask"][~band],
                                      want["mask"][~band])
        assert (got[f"s{t}/fhat"] <= got[f"s{t}/u"]).all()
    masks = np.stack([got[f"s{t}/mask"] for t in range(len(ref["steps"]))])
    assert 0.0 < masks.mean() < 1.0, "need mixed triggers"
    assert set(ref["caches"]) == {k for k in got
                                  if k.split("/")[0] in ("server", "edge")}
    for key, want in ref["caches"].items():
        np.testing.assert_allclose(got[key], want, atol=TOL_STEP,
                                   rtol=TOL_STEP, err_msg=f"{name} {key}")
    print(f"{name}: {n_band} of {n} trigger entries in the tie band, "
          f"a rank's {float(got['seconds']):.1f} s")


def test_placed_step_on_one_rank_is_the_unplaced_step():
    """Every arch's serve step placed on a (1, 1) mesh: logits, u, fhat,
    mask and both caches after every step bitwise the unplaced step's."""
    _outputs()
    with open(os.path.join(_RUN["dir"], "bitwise.json")) as fh:
        res = json.load(fh)
    assert set(res) == {f"d1m1-{a}" for a in BITWISE}
    for name, r in res.items():
        assert r["equal"] and r["keys"] > 0, name
