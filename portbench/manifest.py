"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration, its traffic mix (whose ``runner`` names a module of
``runners/``), its per-layer metric readers (``metrics/<name>.py``) and
its limits (``limits/<cell>.json``)."""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json: "
                   + ", ".join(w["name"] for w in bench["workloads"]))


def config_file(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r}")


def runner(mix: dict):
    return importlib.import_module(f"portbench.runners.{mix['runner']}")


def limits(workload: str) -> dict:
    return json.loads((HERE / "limits" / f"{workload}.json").read_text())


def metrics_of(bench: dict, workload: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    that list it, or list no cells."""
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def reader(name: str) -> Callable:
    """The ``read`` function of ``metrics/<name>.py`` (file names may hold
    dots, so the file is loaded by path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_per_layer(bench: dict, workload: str, run) -> Dict[str, dict]:
    """Each per-layer metric of the cell whose reader found something:
    {name: {"value", "unit"}}; a reader that returns None is left out."""
    out = {}
    for m in metrics_of(bench, workload, "per_layer"):
        value: Optional[float] = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
