"""Time the port's unsharded serving path in two checkouts on one card.

Runs A, B, B, A: each run is a process of its own in that checkout's
root, which builds the kernels (``chip_smoke.phase_build``) and serves
``--arch`` (granite-8b) FULL through ``chip_smoke.phase_serve`` (sync and
scan, B = 8, 64 steps) and, with ``--wire``, through
``chip_smoke.phase_wire`` (the correction server in a second process).  Each run's ``[serve]``,
``[serve-wire]`` and ``[time]`` lines are printed under an ``[ab]`` line
naming the checkout; the last lines give each cell's ms/step a run, A
then B, so two versions of the engine compare within one call.  The
wire cell runs all 64 steps in both checkouts, as it did before the
script's own run cut it to 32.

    python3 serve_ab.py PARENT_CHECKOUT . --wire
    python3 serve_ab.py PARENT_CHECKOUT . --arch musicgen-large

Needs one CUDA card; a run that fails stops the script with its exit
code.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path

RUN = """
import sys, time, types
WIRE, ARCH = sys.argv[1] == "wire", sys.argv[2]
sys.path.insert(0, "src")
import torch
import chip_smoke as c
from repro_torch.configs import registry
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
torch.zeros(1, device=dev)   # the memory statistics need a context
args = types.SimpleNamespace(seed=0, profile=False)
c.WIRE_STEPS = c.STEPS   # a checkout that cut the wire cell runs it whole
c.phase_build()
t0 = time.perf_counter()
cfg = registry.get_full(ARCH)
with c.ImageRows(torch, args.seed):   # a VLM's image K/V, as chip_smoke
    c.phase_serve(torch, dev, args, cfg)
print(f"[time] serve {ARCH}: {time.perf_counter() - t0:.1f} s")
if WIRE:
    t0 = time.perf_counter()
    c.phase_wire(torch, dev, args, cfg)
    print(f"[time] serve-wire: {time.perf_counter() - t0:.1f} s")
"""

# "[serve] granite-8b sync: ... 41.20 ms/step", "[serve-wire] wire k=0: ..."
CELL = re.compile(r"^\[(serve|serve-wire)\] (.*?): .*?([0-9.]+) ms/step")


def run(tree: Path, wire: bool, arch: str) -> dict:
    print(f"[ab] {tree}", flush=True)
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", RUN, "wire" if wire else "serve", arch],
        cwd=tree, env=env, capture_output=True, text=True, timeout=1200)
    cells = {}
    for line in proc.stdout.splitlines():
        found = CELL.match(line)
        if found or line.startswith("[time]"):
            print(line, flush=True)
        if found:
            cells[f"{found.group(1)} {found.group(2)}"] = float(found.group(3))
    if proc.returncode:
        print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
        sys.exit(proc.returncode)
    return cells


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--wire", action="store_true")
    ap.add_argument("--arch", default="granite-8b")
    args = ap.parse_args()
    a, b = args.a.resolve(), args.b.resolve()
    runs = [(tree, run(tree, args.wire, args.arch)) for tree in (a, b, b, a)]
    for cell in runs[0][1]:
        per = {tree: [r[cell] for t, r in runs if t == tree and cell in r]
               for tree in (a, b)}
        print(f"[ab] {cell}: A {per[a]} ms/step, B {per[b]} ms/step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
