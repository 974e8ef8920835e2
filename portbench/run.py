#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card this process sees.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s`` of the profiled
sub-window), with ``--trace 1`` a ``breakdown``, and last ``checks``:
each number compared with its limit, which also end standard error.
Exits non-zero, printing no result, without enough CUDA cards, without
the program beside ``portbench/``, or when ``jax``, ``jaxlib``, ``flax``
or the JAX package ``repro`` is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Context:
    """What a runner gets: the cell's files, the run's arguments and the
    device's bookkeeping."""

    def __init__(self, *, p, mix, limits, seed, seconds, trace, device,
                 t_start, control=False):
        self.p, self.mix, self.limits = p, mix, limits
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t_start = device, t_start
        self.control = control
        self.readings = {}   # the control's and the planted faults' numbers

    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        import torch
        if self._cuda():
            torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        import torch
        if self._cuda():
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        import torch
        return (int(torch.cuda.max_memory_allocated(self.device))
                if self._cuda() else 0)

    def free(self) -> None:
        import torch
        if self._cuda():
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def execute(workload: str, seed: int, seconds: float, trace: bool, device,
            t_start: float, keep_ctx: bool = False, **kw) -> dict:
    """Run a cell's runner and assemble its result (no printing)."""
    from portbench import judge, manifest, traffic
    bench = manifest.load()
    cell = manifest.cell(bench, workload)
    cfg = manifest.config_file(bench, cell["config"])
    mix = traffic.load_mix(cell["traffic"])
    limits = manifest.limits(workload)["limits"]
    ctx = Context(p=cfg["port"], mix=mix, limits=limits, seed=seed,
                  seconds=seconds, trace=trace, device=device,
                  t_start=t_start, **kw)
    out = manifest.runner(mix).run(ctx)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"portbench: forbidden modules loaded: {found}")
    if trace:
        metrics = manifest.read_per_layer(bench, workload, out["run"])
    else:
        metrics = {}
        for m in manifest.metrics_of(bench, workload, "end_to_end"):
            value = out["metrics"].get(m["name"])
            if value is None:
                raise RuntimeError(f"{workload} measured no {m['name']}")
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct, checks = judge.verdict(out["numbers"], limits)
    out.setdefault("diag", {})["readings"] = {
        k: v for k, v in out["numbers"].items() if k not in checks}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": device_kind(device), "count": 1,
           "memory_peak_bytes": out["memory_peak_bytes"]}
    res = {"correct": bool(correct), "attempted": int(out["attempted"]),
           "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    if trace:
        prof = out["run"].profile
        dev["busy_s"], dev["window_s"] = prof["busy_s"], prof["window_s"]
        res["breakdown"] = {"device_ops": prof["device_ops"],
                            "idle_gaps": prof["idle_gaps"]}
    res["checks"] = checks
    res["_diag"] = out.get("diag", {})
    if keep_ctx:
        res["_ctx"] = ctx
    return res


def device_kind(device) -> str:
    import torch
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("portbench: the program (src/repro_torch) is not beside "
              "portbench/", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ.setdefault("USE_FLAX", "0")
    from portbench import manifest
    chips = manifest.cell(manifest.load(), args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"this process sees {seen}", file=sys.stderr)
        return 3
    torch.set_num_threads(2)   # the host's work is one dispatching thread
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    res = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                  device, T_START)
    diag = res.pop("_diag")
    print("[portbench] " + json.dumps(diag), file=sys.stderr)
    print(f"correct {res['correct']}; each number compared, beside its "
          f"limit:", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
