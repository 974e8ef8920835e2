"""BENCHMARK.json against the benchmark's rules, and the harness's
hygiene: names and units, what each per-layer metric moves, files found
by name, no JAX in a run, no program in the reference."""
from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
import textwrap

import pytest

from portbench.tests import tiny
from portbench import manifest, spec

ROOT = tiny.ROOT
BENCH = manifest.load()
NAME = manifest.NAME
UNIT = manifest.UNIT


def all_names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[key]:
            yield e["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(all_names())))
def test_name_characters(name):
    assert NAME.match(name), name


def test_units_and_fields():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["why"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_every_cell_reports_what_its_metrics_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        moves = e2e[m["moves"]]
        for w in m.get("workloads", cells):
            assert w in moves.get("workloads", cells), (m["name"], w)
    for w in cells:
        names = {m["name"] for m in manifest.metrics_of(BENCH, w,
                                                        "end_to_end")}
        assert "setup_s" in names and len(names) >= 2, w
        assert manifest.metrics_of(BENCH, w, "per_layer"), w


def test_layers_are_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"], []).append(m["name"])
    perf = (ROOT / "PERF.md").read_text()
    for layer in by_layer:
        assert layer in perf, f"PERF.md's layers lack {layer!r}"


def test_files_found_by_name():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)
        manifest.config_file(BENCH, w["config"])
        manifest.runner(tiny.traffic.load_mix(w["traffic"]))
        assert "limits" in manifest.limits(w["name"])
    for m in BENCH["per_layer"]:
        assert callable(manifest.reader(m["name"]))
    for path in BENCH["paths"]:
        assert (ROOT / path).is_dir()
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")


@pytest.mark.parametrize("cfg", [c["name"] for c in BENCH["configs"]])
def test_config_matches_its_port_block(cfg):
    """The published keys and the sizes the port runs agree, except what
    the file lists as reduced or assumed."""
    f = manifest.config_file(BENCH, cfg)
    p = f["port"]
    assert f["num_hidden_layers"] == p["n_layers"]
    assert f["hidden_size"] == p["d_model"]
    assert f["num_attention_heads"] == p["n_heads"]
    assert f["num_key_value_heads"] == p["n_kv_heads"]
    assert f["vocab_size"] == p["vocab_size"]
    ff = f.get("intermediate_size", f.get("ffn_hidden_size"))
    assert ff == p["d_ff"]
    entry = next(c for c in BENCH["configs"] if c["name"] == cfg)
    assert entry["reduced"] == f["reduced"]
    if p["family"] == "hybrid":
        assert f["mamba_d_state"] == p["ssm_state"]
        assert f["mamba_expand"] == p["ssm_expand"]
        assert f["mamba_d_conv"] == p["ssm_conv"]
        assert f["n_mamba_heads"] == spec.ssm_dims(p)["H"]
        assert f["mamba_headdim"] == spec.ssm_dims(p)["P"]
        assert f["kv_channels"] == spec.head_dim(p)
        n_super, k, tail = spec.hybrid_layout(p)
        assert f["layers_block_type"].count("hybrid") == n_super
        assert len(f["layers_block_type"]) == p["n_layers"]
    widths = ("_dim", "_rank", "_size", "expand", "state", "head",
              "experts_per_tok", "latent", "proj", "channels")
    for key in f["reduced"]:
        assert not any(w in key for w in widths), key


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from portbench import run
    monkeypatch.setitem(sys.modules, "repro_torch_fake_mod", object())
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in run.forbidden_modules()


def test_reference_imports_no_program():
    for path in sorted((ROOT / "portbench" / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("repro_torch", "repro", "jax"), (path, n)
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(ROOT)!r}]
        import portbench.reference.model, portbench.reference.serve
        import portbench.reference.train
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("repro_torch", "repro", "jax"))
        print(bad)
        assert not bad, bad
    """)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_new_mix_metric_and_config_found_by_name(tmp_path):
    """A copy of the benchmark with a throwaway configuration, mix, metric
    reader and limits added as new files (and entries): a run of the new
    cell finds each by name and reports the new metric, and after the
    run no module named jax or repro is loaded."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    pb = tmp_path / "portbench"
    (pb / "configs" / "tiny-dense.json").write_text(json.dumps(
        {"name": "tiny-dense", "port": tiny.GRANITE}))
    (pb / "mixes" / "fleet-tiny.json").write_text(json.dumps(
        tiny.mix("granite-8b.fleet")))
    (pb / "metrics" / "steps_seen.tiny.py").write_text(
        "def read(run):\n    return float(run.steps)\n")
    (pb / "limits" / "tiny-dense.fleet-tiny.json").write_text(json.dumps(
        {"limits": {"u_err": 0.05, "trig_flips": 0, "unsafe": 0}}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny-dense", "source": "test",
                             "file": "portbench/configs/tiny-dense.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-dense.fleet-tiny",
                               "config": "tiny-dense",
                               "traffic": "fleet-tiny", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "obs_per_s", "unit": "obs/s",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny-dense.fleet-tiny"]})
    bench["per_layer"].append({"name": "steps_seen.tiny", "unit": "steps",
                               "better": "higher",
                               "source": "host_clock", "layer": "test",
                               "moves": "obs_per_s",
                               "workloads": ["tiny-dense.fleet-tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = textwrap.dedent(f"""
        import json, sys, time
        sys.path[:0] = [{str(tmp_path)!r}, {str(tmp_path / 'src')!r}]
        import torch
        torch.set_num_threads(2)
        import portbench.runners.fleet as fleet
        fleet.profiling.trace_steps = lambda torch, steps, n, counts: (
            steps(n) or {{"complete": False, "steps": n, "busy_s": 0.0,
                          "window_s": 0.0, "device_ops": [],
                          "idle_gaps": [], "calls": {{}}, "ranges": {{}},
                          "kernels": 0}})
        fleet.decode_bound_s = lambda infos, p: 0.0
        from portbench import run
        for trace in (False, True):
            res = run.execute("tiny-dense.fleet-tiny", 5, 0.5, trace,
                              torch.device("cpu"), time.perf_counter())
            print(json.dumps({{k: res[k] for k in ("correct", "metrics")}}))
        print(json.dumps(run.forbidden_modules()))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()[-3:]]
    assert set(lines[0]["metrics"]) == {"obs_per_s", "setup_s"}
    assert lines[0]["correct"] is True
    assert set(lines[1]["metrics"]) == {"steps_seen.tiny"}
    assert lines[2] == []
