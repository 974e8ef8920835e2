"""The port's dry run (``repro_torch.launch.dryrun``, ``layer_costs``,
``roofline``, ``report``) on the CPU.

The pure-Python parts against the reference's (``repro.launch.layer_costs``
and ``repro.launch.report`` touch no JAX device state): the layer groups,
probes and extrapolation for every arch, and the report's tables on the
same records.  The counting on fake process groups, as subprocesses (a
fake group must be a process's default group): ``placements`` against
``local_shard`` block for block; the FLOP counter sees local shards (a
column-split product at model 2 counts half the whole); the probes'
extrapolation within 0.1% of a direct count of the whole depth at SMOKE
(zamba2-7b: two layer groups, both kernels' shape functions); argument
bytes equal to the local blocks' sizes; model-axis collectives in a
model-2 train step and none in the monitor step; and one FULL pair,
granite-8b ``train_4k`` on the production mesh, to a roofline row.  The
reference's own ``test_dryrun_small_mesh`` is red under jax 0.9.0, so
its numbers are no ground truth here.
"""
import json
import os
import subprocess
import sys
import tempfile

import pytest

from repro.configs import registry as jreg
from repro.launch import layer_costs as jlc
from repro.launch import report as jreport
from repro_torch.configs import registry as treg
from repro_torch.launch import layer_costs as tlc
from repro_torch.launch import report as treport
from repro_torch.launch import roofline as trf

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
JOIN_S = 240
ARCHS = tuple(jreg.names())
_RUNS = {}


def _env():
    return {**os.environ, "PYTHONPATH": os.path.abspath(SRC),
            "OMP_NUM_THREADS": "2"}


def _start():
    """Both subprocesses at once, on first use: the mesh checks and the
    FULL pair."""
    if _RUNS:
        return
    tmp = tempfile.mkdtemp(prefix="dryrun_")
    out = os.path.join(tmp, "pair.jsonl")
    _RUNS["out"] = out
    _RUNS["checks"] = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_dryrun_worker.py")],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    _RUNS["pair"] = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "granite-8b", "--shape", "train_4k", "--out", out], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _result(name):
    _start()
    p = _RUNS[name]
    if f"{name}/out" not in _RUNS:
        try:
            _RUNS[f"{name}/out"] = p.communicate(timeout=JOIN_S)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            pytest.fail(f"{name} did not finish within {JOIN_S} s")
    out, err = _RUNS[f"{name}/out"]
    assert p.returncode == 0, err[-3000:]
    return out


@pytest.fixture(scope="module", autouse=True)
def _children():
    _start()
    yield
    for key in ("checks", "pair"):
        p = _RUNS.get(key)
        if p is not None and p.poll() is None:
            p.kill()
            p.wait()


def _cfg_counts(cfg):
    return (cfg.n_layers, cfg.first_dense_layers)


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_costs_equal_the_reference(arch):
    """count_knobs, with_counts, probe_plan and extrapolate: the
    reference's, for the arch's FULL and SMOKE."""
    for get in ("get_full", "get_smoke"):
        jcfg, tcfg = getattr(jreg, get)(arch), getattr(treg, get)(arch)
        assert tlc.count_knobs(tcfg) == jlc.count_knobs(jcfg)
        full, probes = tlc.probe_plan(tcfg)
        assert (full, probes) == jlc.probe_plan(jcfg)
        for _, counts in probes:
            assert _cfg_counts(tlc.with_counts(tcfg, counts)) == \
                _cfg_counts(jlc.with_counts(jcfg, counts))
        costs = {name: {"flops": 1e9 * (i + 1) + 7.0 * sum(k.values()),
                        "bytes": 3e6 * (i + 2), "coll_all-reduce": 5.0 * i}
                 for i, (name, k) in enumerate(probes)}
        assert tlc.extrapolate(full, costs) == jlc.extrapolate(full, costs)


def _records():
    recs = []
    for i, arch in enumerate(ARCHS[:6]):
        for j, shape in enumerate(("train_4k", "prefill_32k")):
            r = trf.analyze_costs(
                {"flops": 1e14 * (i + 1) + 1e12 * j,
                 "bytes": 2e12 / (i + 1) + 5e11 * j,
                 "coll_all-gather": 1e10 * j, "coll_all-reduce": 3e9 * i,
                 "coll_reduce-scatter": 2e9, "coll_all-to-all": 0.0,
                 "coll_collective-permute": 0.0},
                arch=arch, shape=shape, mesh_desc="16x16", chips=256,
                model_flops=5e15 * (i + 1)).as_dict()
            r.update(status="ok", compile_full_s=12.5, compile_probes_s=3.0,
                     memory_analysis={"argument_size_in_bytes": 3 << 30,
                                      "temp_size_in_bytes": (i + 1) << 30})
            recs.append(r)
    recs.append({"arch": ARCHS[6], "shape": "train_4k", "status": "FAIL",
                 "error": "ValueError('a placement bug')"})
    return recs


def test_report_tables_equal_the_reference(tmp_path):
    """The report's tables, summary and picks on the same records (a
    rerun superseding an earlier record, a failed pair among them): the
    reference's, character for character."""
    recs = _records()
    path = tmp_path / "dryrun_single_pod.jsonl"
    with open(path, "w") as fh:
        fh.write(json.dumps(dict(recs[0], compute_s=9.0)) + "\n")
        for r in recs:
            fh.write(json.dumps(r) + "\n")
    got, want = treport.load(str(path)), jreport.load(str(path))
    assert got == want and len(got) == len(recs)
    for fn in ("roofline_table", "dryrun_table", "summarize",
               "pick_hillclimb"):
        assert getattr(treport, fn)(got) == getattr(jreport, fn)(want), fn


def test_shape_table_fills_the_four_shape_columns():
    """The port's per-arch table: a column for each of the reference's
    four shapes, each counted pair's three terms and bottleneck, a dash
    for a pair not counted, FAIL for a failed one."""
    recs = []
    for j, shape in enumerate(treport.SHAPE_ORDER):
        r = trf.analyze_costs({"flops": 1e14, "bytes": 1e12 * (j + 1),
                               "coll_all-reduce": 1e9}, arch=ARCHS[0],
                              shape=shape, mesh_desc="16x16", chips=256,
                              model_flops=1e15).as_dict()
        recs.append(dict(r, status="ok"))
    recs.append({"arch": ARCHS[1], "shape": "long_500k", "status": "FAIL"})
    rows = treport.shape_table(recs).splitlines()
    assert rows[0] == "| arch | " + " | ".join(treport.SHAPE_ORDER) + " |"
    cells = {r.split("|")[1].strip(): [c.strip() for c in r.split("|")[2:-1]]
             for r in rows[2:]}
    assert len(cells[ARCHS[0]]) == 4
    assert all("**memory**" in c for c in cells[ARCHS[0]])
    assert cells[ARCHS[1]] == ["—", "—", "—", "FAIL"]


def test_roofline_terms_at_the_h100_peaks():
    """The three terms over the H100 SXM's peaks, per device."""
    assert (trf.PEAK_FLOPS, trf.HBM_BW, trf.LINK_BW) == (989e12, 3.35e12,
                                                         450e9)
    r = trf.analyze_costs({"flops": 989e12, "bytes": 6.7e12,
                           "coll_all-reduce": 45e9}, arch="a", shape="s",
                          mesh_desc="16x16", chips=256, model_flops=2.0)
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 2.0, 0.1)
    assert r.bottleneck == "memory"
    assert r.useful_flops_ratio == 2.0 / (256 * 989e12)


def _checks():
    return json.loads(_result("checks").strip().splitlines()[-1])


def test_placements_cut_as_local_shard():
    """Every rank's DTensor block under ``placements(spec)`` is
    ``local_shard``'s, on (data 2, model 4) and (pod 2, data 2, model 2)
    meshes, for split, doubly split and replicated specs; so are the six
    leaves of zamba2's decode cache placed by ``distribute_cache`` on
    (data 4, model 2), and ``init_cache(..., device_mesh=)`` allocates
    blocks of the same placements and shapes."""
    assert _checks()["blocks"] == 8 * (6 + 4 + 6)


def test_flop_counter_sees_local_shards():
    """A product whose weight is split by columns over model 2 counts half
    the whole product's FLOPs on a rank."""
    got, whole, local = _checks()["split_flops"]
    assert local == [64, 8] and got * 2 == whole


def test_probe_extrapolation_matches_a_direct_count():
    """zamba2-7b SMOKE (super-blocks and a tail) on a (data 4, model 2)
    mesh: FLOPs, bytes and collective bytes from the probes within 0.1%
    of the whole depth counted directly; both kernels counted."""
    c = _checks()
    assert c["groups"] == {"super": 2, "tail": 1}
    for key, want in c["direct"].items():
        got = c["extrapolated"][key]
        assert abs(got - want) <= 1e-3 * max(abs(want), 1.0), key
    assert c["direct"]["flops"] > 0 and c["direct"]["bytes"] > 0
    assert set(c["kernels"]) == {"ssd_scan", "flash_attention"}


def test_argument_bytes_are_the_local_blocks():
    got, want = _checks()["arg_bytes"]
    assert got == want


def test_collectives_on_the_model_axis_and_none_in_the_monitor_step():
    """The model-2 train step moves bytes over the model group; the edge
    tower and heads are whole on every rank, and the monitor step on a
    rank's own rows runs no ``c10d`` op (``serving.mesh``'s
    namespaces)."""
    from repro_torch.serving.mesh import C10D_NAMESPACES
    c = _checks()
    assert c["model_group_bytes"] > 0
    assert c["edge_replicated"]
    assert not set(c["monitor"]["namespaces"]) & set(C10D_NAMESPACES)
    assert sum(c["monitor"]["collectives"].values()) == 0
    assert c["monitor"]["u_shape"] == [2]


@pytest.mark.parametrize("arch", ["granite-8b", "deepseek-v3-671b",
                                  "zamba2-7b"])
def test_decode_kind_runs_on_a_small_mesh(arch):
    """``step_and_specs``'s decode kind on (data 4, model 2) at SMOKE (B
    8, a 64-token cache), counted: the server cache split on its time
    axis over ``model`` (``decode_cache_shard = "time"``), the edge cache
    whole there; flash-decode's collectives over the model group; the
    partial entry once a GQA layer (MLA runs tensor ops), the whole
    kernel once an edge layer; the combine on each rank's own rows."""
    d = _checks()["decode"][arch]
    assert d["edge_model_whole"]
    # (data, model) dims of each leaf: the model axis on the axis after
    # the batch (time; an SSM state's heads) or whole (a conv tail)
    pls = d["server_placements"]
    assert all(m in (b + 1, None) for b, m in pls), pls
    assert any(m is not None for _, m in pls), pls
    assert d["model_bytes"] > 0
    assert d["collectives"]["all-gather"] > 0
    assert d["kernels"]["decode_attention"] == 1   # the edge's one layer
    # the combine on each rank's 2 of the 8 rows: 8 flops a row
    assert d["kernels"]["monitor_combine"] == 1 and \
        d["combine_flops"] == 8.0 * 2
    if arch == "granite-8b":
        assert d["kernels"]["decode_attention_partial"] == d["layers"]
        # each layer's combine: lse (4 B a row and q head) and [w o, w]
        # (D + 1 f32 values), over each rank's 2 rows
        combine = d["layers"] * 2 * d["heads"] * 4 * (d["head_dim"] + 2)
        assert d["collectives"]["all-reduce"] >= combine
    elif arch == "zamba2-7b":   # the shared block, once a super-block
        assert d["kernels"]["decode_attention_partial"] == 2
    else:
        assert "decode_attention_partial" not in d["kernels"]


def test_placed_monitor_step_records_no_collective():
    """The monitor step on a placed model (DTensor parameters: the edge
    tower whole on every rank) and an edge cache over the data axes only
    runs no ``c10d`` op on any axis."""
    from repro_torch.serving.mesh import C10D_NAMESPACES
    m = _checks()["placed_monitor"]
    assert not set(m["namespaces"]) & set(C10D_NAMESPACES)
    assert sum(m["collectives"].values()) == 0
    assert m["u_shape"] == [8]


def test_full_pair_runs_to_a_roofline_row():
    """granite-8b ``train_4k`` at FULL on the production mesh (256 fake
    ranks): a record with per-device counts, the three terms, argument
    and peak bytes and the useful-FLOPs ratio."""
    out = _result("pair")
    assert "1/1 pairs counted OK" in out
    with open(_RUNS["out"]) as fh:
        rec = json.loads(fh.readline())
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["chips"] == 256
    for key in ("flops_per_device", "bytes_per_device",
                "collective_bytes_per_device", "compute_s", "memory_s",
                "collective_s"):
        assert rec[key] > 0, key
    assert set(rec["collective_breakdown"]) == set(trf.COLLECTIVES)
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0 and \
        mem["temp_size_in_bytes"] > 0
    assert 0.3 < rec["useful_flops_ratio"] < 1.0
    assert rec["kernels"]["flash_attention"]["calls"] > 0
    assert rec["peaks"]["note"] == "computed from counts, not measured"
