"""Tables of the dry run's JSONL records (``launch/report.py``): the
roofline and dry-run tables, a summary and the hill-climb picks, in the
reference's format, from ``launch/dryrun.py --out`` files
(``dryrun_single_pod.jsonl``, ``dryrun_multi_pod.jsonl``).

Usage:  PYTHONPATH=src python -m repro_torch.launch.report [--results DIR]

This module only formats; every number comes from the counted step
(``launch/dryrun.py``), computed over the H100's peaks, not measured.
The ``compile s`` column holds the seconds the full step and the probes
took to run over fake tensors.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(path: str) -> List[Dict]:
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    # keep the LAST record per (arch, shape) — reruns supersede
    dedup: Dict = {}
    for r in out:
        dedup[(r.get("arch"), r.get("shape"))] = r
    recs = list(dedup.values())
    recs.sort(key=lambda r: (r.get("arch", ""),
                             SHAPE_ORDER.index(r["shape"])
                             if r.get("shape") in SHAPE_ORDER else 99))
    return recs


def _ms(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def _gib(b: float) -> str:
    return f"{b/2**30:.2f}"


def roofline_table(recs: List[Dict]) -> str:
    hdr = ("| arch | shape | mesh | compute | memory | collective | "
           "bottleneck | useful FLOPs | HBM GiB/dev |\n"
           "|---|---|---|---|---|---|---|---|---|")
    rows = [hdr]
    for r in recs:
        if r.get("status") == "FAIL":
            rows.append(f"| {r['arch']} | {r['shape']} | — | FAIL | | | "
                        f"`{r.get('error','')[:60]}` | | |")
            continue
        mem = r.get("memory_analysis") or {}
        hbm = mem.get("argument_size_in_bytes", 0) + mem.get(
            "temp_size_in_bytes", 0)
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {_ms(r['compute_s'])} | {_ms(r['memory_s'])} "
            f"| {_ms(r['collective_s'])} | **{r['bottleneck']}** "
            f"| {100*r['useful_flops_ratio']:.1f}% | {_gib(hbm)} |")
    return "\n".join(rows)


def dryrun_table(recs: List[Dict]) -> str:
    hdr = ("| arch | shape | mesh | per-dev FLOPs | per-dev HBM bytes | "
           "per-dev collective bytes | AG/AR/RS/A2A/CP (GiB) | compile s |\n"
           "|---|---|---|---|---|---|---|---|")
    rows = [hdr]
    for r in recs:
        if r.get("status") == "FAIL":
            rows.append(f"| {r['arch']} | {r['shape']} | — | FAIL "
                        f"`{r.get('error','')[:60]}` | | | | |")
            continue
        cb = r.get("collective_breakdown", {})
        brk = "/".join(f"{cb.get(k,0)/2**30:.2f}" for k in (
            "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute"))
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['flops_per_device']:.3e} | {r['bytes_per_device']:.3e} "
            f"| {r['collective_bytes_per_device']:.3e} | {brk} "
            f"| {r.get('compile_full_s',0)}+{r.get('compile_probes_s',0)} |")
    return "\n".join(rows)


def shape_table(recs: List[Dict]) -> str:
    """One row an arch, one column a shape of SHAPE_ORDER: each pair's
    compute / memory / collective terms and its bottleneck (a pair not
    counted: a dash; a failed one: FAIL)."""
    by = {(r.get("arch"), r.get("shape")): r for r in recs}
    archs = sorted({r.get("arch") for r in recs if r.get("arch")})
    rows = ["| arch | " + " | ".join(SHAPE_ORDER) + " |",
            "|---|" + "---|" * len(SHAPE_ORDER)]
    for a in archs:
        cells = []
        for shape in SHAPE_ORDER:
            r = by.get((a, shape))
            if r is None:
                cells.append("—")
            elif r.get("status") == "FAIL":
                cells.append("FAIL")
            else:
                cells.append(f"{_ms(r['compute_s'])} / {_ms(r['memory_s'])}"
                             f" / {_ms(r['collective_s'])} "
                             f"**{r['bottleneck']}**")
        rows.append(f"| {a} | " + " | ".join(cells) + " |")
    return "\n".join(rows)


def summarize(recs: List[Dict]) -> str:
    ok = [r for r in recs if r.get("status") == "ok"]
    fails = [r for r in recs if r.get("status") != "ok"]
    lines = [f"{len(ok)}/{len(recs)} pairs lowered + compiled OK."]
    if fails:
        lines.append("FAILURES: " + ", ".join(
            f"{r['arch']}x{r['shape']}" for r in fails))
    by_bneck: Dict[str, int] = {}
    for r in ok:
        by_bneck[r["bottleneck"]] = by_bneck.get(r["bottleneck"], 0) + 1
    lines.append("Bottleneck mix: " + ", ".join(
        f"{k}={v}" for k, v in sorted(by_bneck.items())))
    return "\n".join(lines)


def pick_hillclimb(recs: List[Dict]) -> List[str]:
    """Worst useful-FLOPs ratio / most collective-bound / paper-central."""
    ok = [r for r in recs if r.get("status") == "ok"]
    if not ok:
        return []
    worst = min(ok, key=lambda r: r["useful_flops_ratio"] or 1.0)
    coll = max(ok, key=lambda r: (r["collective_s"] /
                                  max(r["compute_s"], r["memory_s"], 1e-12)))
    notes = [
        f"worst useful-FLOPs: {worst['arch']} x {worst['shape']} "
        f"({100*worst['useful_flops_ratio']:.1f}%)",
        f"most collective-bound: {coll['arch']} x {coll['shape']} "
        f"(coll/max(other)={coll['collective_s']/max(coll['compute_s'], coll['memory_s']):.2f})",
    ]
    return notes


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="results")
    args = ap.parse_args()
    for mesh_kind in ("single_pod", "multi_pod"):
        recs = load(os.path.join(args.results, f"dryrun_{mesh_kind}.jsonl"))
        print(f"\n## {mesh_kind} ({len(recs)} records)\n")
        print(summarize(recs))
        print()
        print(roofline_table(recs))
        print("\ncompute / memory / collective per shape:\n")
        print(shape_table(recs))
        if mesh_kind == "single_pod":
            print("\nHillclimb candidates:")
            for n in pick_hillclimb(recs):
                print(" -", n)


if __name__ == "__main__":
    main()
