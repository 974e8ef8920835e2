#!/usr/bin/env python3
"""Readings that set a cell's limits: over several seeds in one process,
the numbers that sound runs of the program give (the lower readings), and
for the first ``--control-seeds`` of them the numbers of the control (the
reference in float8 in the program's place) and, for a training cell, of
the reference fed half of each batch (the upper readings).

    python3 portbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control-seeds <k>]

One JSON line a seed on standard output, with the verdict that the
cell's limits give each control or fault reading (``verdicts``: false
where it fails them, as it has to).  The benchmark's runs do not run
this; ``tests/test_pb_cuda.py`` holds the control against the limits on
the card at a small size.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import judge, manifest, run
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    limits = manifest.limits(args.workload)["limits"]
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        res = run.execute(args.workload, seed, args.seconds, False, dev, t0,
                          control=i < args.control_seeds, keep_ctx=True)
        ctx = res.pop("_ctx")
        diag = res["_diag"]
        numbers = {k: c["value"] for k, c in res["checks"].items()}
        numbers.update(diag.pop("readings"))
        line = {"seed": seed, "correct": res["correct"], "numbers": numbers,
                "readings": ctx.readings,
                "verdicts": {k: judge.verdict(v, limits)[0]
                             for k, v in ctx.readings.items()},
                "metrics": {k: m["value"] for k, m in res["metrics"].items()},
                "diag": diag, "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        del res, ctx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
