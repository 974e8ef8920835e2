"""The traced sub-window: a few steps under ``torch.profiler``, read from its
Chrome trace.

On the H100 the profiler has dropped the device events of whole calls
after heavy work, so a trace is trusted only when it holds one device
event for every launch the program counted of its own kernels
(``repro_torch.kernels.launch_counts()``); otherwise the sub-window is
halved and traced again, and a trace that never agrees is reported as
incomplete (its readers then return nothing).  The trace file lives in
the run's temporary directory and is deleted once read."""
from __future__ import annotations

import json
import os
import re
import sys
import tempfile
import time
from typing import Callable, Dict, List, Tuple

# the port's device kernels by the launch counter that counts them
PORT_KERNELS = {"decode_attention": ("decode_attention_kernel",),
                "monitor_combine": ("monitor_combine_kernel",),
                "flash_attention": ("flash_attention_tc",
                                    "flash_attention_f32"),
                "ssd_scan": ("ssd_chunk_kernel",)}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "portbench.window"
TRIES = 3


def short(name: str) -> str:
    """A kernel's name without 'void ' and its argument list."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:160]


def port_kind(name: str):
    for kind, prefixes in PORT_KERNELS.items():
        if any(p in name for p in prefixes):
            return kind
    return None


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(trace: dict) -> dict:
    evs = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    win = [e for e in evs if e.get("name") == WINDOW
           and e.get("cat") in HOST_CATS]
    if not win:
        raise RuntimeError("the profiled window's range is not in the trace")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev = [e for e in evs if e.get("cat") in DEVICE_CATS]
    busy = _merge([(max(w0, e["ts"]), min(w1, e["ts"] + e["dur"]))
                   for e in dev if e["ts"] < w1 and e["ts"] + e["dur"] > w0])
    busy_us = sum(b - a for a, b in busy)
    gaps, last = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    # the host ops of the window's thread are nested intervals: a sweep
    # with a stack finds the innermost one at each gap's midpoint
    host = sorted((e for e in evs if e.get("cat") in HOST_CATS
                   and e.get("tid") == win[0].get("tid")
                   and e.get("name") != WINDOW),
                  key=lambda e: (e["ts"], -e["dur"]))
    idle: Dict[str, float] = {}
    stack, i = [], 0
    for a, b in gaps:
        mid = 0.5 * (a + b)
        while i < len(host) and host[i]["ts"] <= mid:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < host[i]["ts"]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < mid:
            stack.pop()
        name = stack[-1]["name"] if stack else "host outside any op"
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    by_name: Dict[str, float] = {}
    calls: Dict[str, List[Tuple[str, float]]] = {}
    for e in dev:
        n = short(e["name"])
        by_name[n] = by_name.get(n, 0.0) + e["dur"] * 1e-6
        kind = port_kind(e["name"]) if e.get("cat") == "kernel" else None
        if kind:
            calls.setdefault(kind, []).append((n, e["dur"] * 1e-6))
        if "ssd_prep_kernel" in e["name"]:
            calls.setdefault("ssd_prep", []).append((n, e["dur"] * 1e-6))
    ranges: Dict[str, float] = {}
    for e in evs:
        if e.get("cat") == "gpu_user_annotation":
            ranges[e["name"]] = ranges.get(e["name"], 0.0) + e["dur"] * 1e-6
    top = sorted(by_name.items(), key=lambda x: -x[1])[:10]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6,
            "kernels": sum(e.get("cat") == "kernel" for e in dev),
            "calls": calls, "ranges": ranges,
            "device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in
                          sorted(idle.items(), key=lambda x: -x[1])[:10]]}


def expected(launched: Dict[str, int]) -> Dict[str, int]:
    return {"decode_attention": launched.get("decode_attention", 0)
            + launched.get("decode_attention_partial", 0),
            "monitor_combine": launched.get("monitor_combine", 0),
            "flash_attention": launched.get("flash_attention", 0),
            "ssd_scan": launched.get("ssd_scan", 0)}


def trace_steps(torch, run_steps: Callable[[int], object], steps: int,
                counts: Callable[[], Dict[str, int]]) -> dict:
    """Profile ``run_steps(n)`` (which ends on the host) over ``steps``
    steps, halving until the trace holds every counted launch of the
    port's kernels.  Returns the summary with ``steps``, ``complete``,
    ``launched`` (the counters) and ``seen`` (device events)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):   # the tracer's first session
        run_steps(1)
        torch.cuda.synchronize()
    res = {}
    for _ in range(TRIES):
        before = counts()
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                run_steps(steps)
                torch.cuda.synchronize()
        after = counts()
        launched = expected({k: after[k] - before.get(k, 0) for k in after})
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as fh:
                trace = json.load(fh)
        finally:
            os.unlink(path)
        del prof
        res = summarize(trace)
        del trace
        seen = {k: len(res["calls"].get(k, ())) for k in launched}
        res.update(steps=steps, launched=launched, seen=seen,
                   complete=seen == launched and res["busy_s"] > 0)
        if res["complete"]:
            return res
        print(f"[portbench] trace of {steps} steps incomplete: device "
              f"events {seen}, launches {launched}", file=sys.stderr,
              flush=True)
        steps = max(1, steps // 2)
        time.sleep(0.5)
    return res


def idle_share(prof: dict):
    """The share of a complete profiled sub-window in which nothing ran on
    the card, in %; None where the trace is incomplete or empty."""
    if not prof["complete"] or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
