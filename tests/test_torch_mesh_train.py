"""The port's train and prefill steps across a DeviceMesh
(``distributed/sharding.py::distribute_collab``, DTensor parameters,
moments and batch) against the reference's unsharded ``jit`` steps, on
the CPU with gloo process groups spawned here.

At SMOKE (f32), on the same weights in both packages (the port's
seeded init, carried to the reference through the bridge): three train
steps under ``warmup_cosine`` of each of the 10 archs on (data 2, model
2), and of the archs whose placement differs there (``MESHES``) on
(data 1, model 4) and with ZeRO-1 on (data 4, model 1) (``zero1=True``),
against ``jax.jit(repro.launch.steps.make_train_step)`` unsharded; the
bar is ``test_torch_launch.py::
test_train_step_matches_reference``'s (loss and grad norm within 1e-4,
every gathered parameter within lr/10, some moved past lr/2; a leaf
where the port's own unplaced steps already take half of that takes the
families' bar, all but 1e-4 of its entries within lr/10, and is
printed).  The placed init of every arch on every mesh is its unplaced
init placed after, bit for bit.  The prefill step of every arch on
(data 2, model 2) against the reference's ``make_prefill_step`` at 1e-4
(a threshold clear of ties).  The MoE archs run at a capacity factor that drops
nothing: a data rank routes only its own tokens
(``nn/moe.py::_moe_region``), which equals the reference's global
routing only then.  A VLM's cross gates are opened (seeded), so its
image path counts.

One spawn of 4 workers (``tests/_torch_mesh_worker.py``) runs the three
meshes, the train steps first and the prefill steps last; the parent
runs the port's unplaced steps and the reference meanwhile (the prefill
thresholds first, which the workers wait for).  The join is bounded
at ``JOIN_S``, so a hang fails the tests, not the suite.
"""
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import steps as jsteps
from repro.training import optimizer as jopt
from repro.training.schedule import warmup_cosine as j_warmup_cosine
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.core import decomposition as tdeco
from repro_torch.data import tokens as ttok
from repro_torch.launch import steps as tsteps
from repro_torch.training.loop import to_device, trainable
from repro_torch.training.optimizer import AdamW, keeps_masters
from repro_torch.training.schedule import warmup_cosine

from _torch_parity import TOL_E2E, gap_threshold, tie_band

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WORKER = os.path.join(HERE, "_torch_mesh_worker.py")
JOIN_S = 240
WORLD = 4
TOL = TOL_E2E["float32"]
LR = 1e-3
B, S = 4, 16
ARCHS = tuple(jreg.names())
PREFILL = "2,2"   # the mesh the prefill step runs on
# every arch on (data 2, model 2); on the other two meshes the archs whose
# placement differs there: kv heads that do not divide model 4 (granite:
# 2 of 4), q heads that do not (qwen2.5-32b: 5), the SSD heads and the
# convolution (zamba2), four experts over four ranks (mixtral), the
# codebook tables split on the vocab (musicgen), two mLSTM heads
# (xlstm); under ZeRO-1 the moments of each kind of leaf split over
# data 4
MESHES = {"2,2": ARCHS,
          "1,4": ("granite-8b", "qwen2.5-32b", "zamba2-7b", "mixtral-8x22b",
                  "musicgen-large", "xlstm-350m"),
          "4,1z": ("granite-8b", "zamba2-7b", "mixtral-8x22b",
                   "musicgen-large", "xlstm-350m")}
_RUN = {}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _overrides(arch):
    """A capacity factor that drops nothing (every local token's choices
    fit) for the MoE archs."""
    cfg = treg.get_smoke(arch)
    return {"capacity_factor": float(cfg.n_experts) / cfg.top_k} \
        if cfg.n_experts else {}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _with_threshold(cfg, thr):
    return cfg.replace(monitor=cfg.monitor.__class__(
        **{**cfg.monitor.__dict__, "threshold": thr, "trigger_margin": 0.0}))


def _write(arch, case_dir):
    """The arch's weights (the port's init from seed 0, a VLM's cross
    gates opened), train batches and prefill batch, for both packages."""
    tcfg = treg.get_smoke(arch)
    tree = bridge.collab_to_numpy(tdeco.init_collab_lm(
        tcfg, torch.Generator().manual_seed(0), "cpu"))
    if tcfg.family == "vlm":   # open the cross gates (zero at init)
        gate = tree["server"]["cross"]["gate"]
        tree["server"]["cross"]["gate"] = np.random.default_rng(7).uniform(
            0.5, 1.0, gate.shape).astype(np.float32)
    batches = [b for b, _ in zip(ttok.lm_batches(6, tcfg, B, S), range(3))]
    pre = next(ttok.lm_batches(4, tcfg, B, S))
    pre = {k: v for k, v in pre.items() if k in ("tokens", "image_embeds")}
    flat = {f"p/{k}": v for k, v in _flat(tree).items()}
    for i, b in enumerate(batches):
        flat.update({f"b{i}/{k}": v for k, v in b.items()})
    flat.update({f"pre/{k}": np.asarray(v) for k, v in pre.items()})
    np.savez(os.path.join(case_dir, f"{arch}.npz"), **flat)
    return dict(tree=tree, batches=batches, pre=pre,
                jcfg=jreg.get_smoke(arch).replace(**_overrides(arch)))


def _reference_prefill(r, arch, case_dir):
    """The reference's prefill step, its threshold an argument: u, then
    the outputs at a threshold clear of ties, which the workers read."""
    jcfg, params = r["jcfg"], r["params"]
    jpre = jax.jit(lambda p, b, thr: jsteps.make_prefill_step(
        _with_threshold(jcfg, thr))(p, b))
    jb = {k: jnp.asarray(v) for k, v in r["pre"].items()}
    r["thr"] = gap_threshold(np.asarray(jpre(params, jb, 0.0)["u"]))[0]
    r["prefill"] = {k: np.asarray(v, np.float32)
                    for k, v in jpre(params, jb, r["thr"]).items()}
    tmp = os.path.join(case_dir, f"thr_{arch}.tmp.npy")
    np.save(tmp, np.asarray(r["thr"]))
    os.replace(tmp, os.path.join(case_dir, f"thr_{arch}.npy"))


def _reference_train(r):
    """The reference's three unsharded ``jit`` train steps."""
    jo = jopt.AdamW(lr=j_warmup_cosine(LR, 2, 10))
    jstep = jax.jit(jsteps.make_train_step(r["jcfg"], jo))
    jp, js, hist = r["params"], jo.init(r["params"]), []
    for b in r["batches"]:
        jp, js, m = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        hist.append({k: float(v) for k, v in m.items()})
    r["hist"] = hist
    r["final"] = _flat(jax.tree.map(np.asarray, jp))


def _unplaced(r, arch):
    """The port's own three steps, unplaced: the leaves where its
    trajectory already leaves lr/10 of the reference's."""
    cfg = treg.get_smoke(arch).replace(**_overrides(arch))
    model = bridge.collab_from_numpy(r["tree"], cfg, "cpu")
    opt = AdamW(lr=warmup_cosine(LR, 2, 10))
    state = opt.init(trainable(model), masters=keeps_masters(cfg))
    step = tsteps.make_train_step(cfg, opt)
    for b in r["batches"]:
        step(model, state, to_device(b, "cpu"))
    r["unplaced"] = _flat(bridge.collab_to_numpy(model, state))


def _start():
    """The workers, then the reference and the unplaced steps beside
    them; once."""
    if _RUN:
        return
    case_dir = _RUN["dir"] = tempfile.mkdtemp(prefix="mesh_")
    refs = _RUN["refs"] = {arch: _write(arch, case_dir) for arch in ARCHS}
    with open(os.path.join(case_dir, "case.json"), "w") as fh:
        json.dump({"meshes": {m: list(a) for m, a in MESHES.items()},
                   "prefill": PREFILL, "lr": LR,
                   "overrides": {a: _overrides(a) for a in ARCHS}}, fh)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": os.path.abspath(SRC),
           "OMP_NUM_THREADS": "1"}
    _RUN["procs"] = [subprocess.Popen(
        [sys.executable, WORKER, case_dir, str(r), str(WORLD), str(port)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    _RUN["deadline"] = time.monotonic() + JOIN_S
    for arch, r in refs.items():
        _unplaced(r, arch)
        r["params"] = jax.tree.map(jnp.asarray, r["tree"])
        r["initial"] = _flat(r["tree"])
    # XLA compiles outside the GIL: three archs' reference at a time
    with ThreadPoolExecutor(3) as pool:
        pres = [pool.submit(_reference_prefill, refs[a], a, case_dir)
                for a in ARCHS]
        trains = [pool.submit(_reference_train, refs[a]) for a in ARCHS]
        for f in pres + trains:
            f.result()


def _outputs():
    """Join the workers (once) and read their outputs."""
    _start()
    if "logs" not in _RUN:
        procs = _RUN["procs"]
        try:
            for p in procs:
                p.wait(timeout=max(_RUN["deadline"] - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            pytest.fail(f"mesh ranks did not finish within {JOIN_S} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        _RUN["logs"] = [p.stdout.read().decode(errors="replace")
                        for p in procs]
    for r, p in enumerate(_RUN["procs"]):
        assert p.returncode == 0, f"rank {r}:\n{_RUN['logs'][r][-3000:]}"
    return _RUN["refs"]


@pytest.fixture(scope="module", autouse=True)
def _workers():
    yield
    for p in _RUN.get("procs", ()):
        if p.poll() is None:
            p.kill()
            p.wait()
    if "dir" in _RUN:
        shutil.rmtree(_RUN["dir"], ignore_errors=True)


def _load(name):
    return dict(np.load(os.path.join(_RUN["dir"], f"{name}.npz")))


def _check(arch, ref, out):
    """The reference's bar for one arch on one mesh."""
    assert bool(out["placed_init_equal"]), arch
    for i, w in enumerate(ref["hist"]):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(out[f"step{i}/{k}"], w[k], rtol=TOL,
                                       atol=TOL, err_msg=f"{arch} step {i} {k}")
    moved, loose = 0.0, []
    for path, w in ref["final"].items():
        d = np.abs(out[f"p/{path}"] - w)
        if float(np.abs(ref["unplaced"][path] - w).max()) > 0.05 * LR:
            # the port's own unplaced steps already take half of lr/10
            # here (Adam scales rounding noise on near-zero gradients to a
            # step; summation order on the mesh adds its own): the
            # families' bar, all but 1e-4 of the entries
            loose.append(path)
            assert (d > 0.1 * LR).mean() <= 1e-4, (arch, path,
                                                   float(d.max()))
        else:
            assert float(d.max()) <= 0.1 * LR, (arch, path, float(d.max()))
        moved = max(moved, float(np.abs(w - ref["initial"][path]).max()))
    assert moved > 0.5 * LR, arch
    if loose:
        print(f"{arch}: unplaced port past lr/10 on {loose}")


def _check_prefill(arch, ref, out):
    want = ref["prefill"]
    for k in ("logits", "u", "fhat"):
        np.testing.assert_allclose(out[f"prefill/{k}"], want[k], atol=TOL,
                                   rtol=TOL, err_msg=f"{arch} prefill {k}")
    assert not tie_band(want["u"], ref["thr"], TOL).any()
    assert float(out["prefill/trigger_rate"]) == float(want["trigger_rate"])


@pytest.mark.parametrize("mesh_arg", [
    pytest.param("2,2", id="data2-model2"),
    pytest.param("1,4", id="data1-model4"),
    pytest.param("4,1z", id="data4-model1-zero1")])
def test_sharded_steps_match_the_unsharded_reference(mesh_arg):
    """The mesh's archs (``MESHES``): the train step's three steps (and on
    (data 2, model 2) the prefill step) against the reference's unsharded
    ``jit`` steps."""
    refs = _outputs()
    outs = {arch: _load(f"out_{mesh_arg}_{arch}")
            for arch in MESHES[mesh_arg]}
    print(f"mesh {mesh_arg}: seconds a rank per arch "
          f"{ {a: round(float(o['seconds']), 2) for a, o in outs.items()} }")
    for arch in outs:
        _check(arch, refs[arch], outs[arch])
        if mesh_arg == PREFILL:
            _check_prefill(arch, refs[arch], _load(f"out_prefill_{arch}"))
