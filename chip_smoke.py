#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N] [--profile]

Phases, each printing its own lines:

1. build   -- compile every CUDA kernel of the path from src/repro_torch/
              kernels/csrc (one nvcc per source, all at once).
2. kernels -- each kernel against its plain PyTorch version on the card,
              at the serving path's shapes (Granite-8B server and edge
              towers) plus edge cases; then each kernel's time, its plain
              version's, one PyTorch library call's where there is one,
              and the least time the card could take (its bound).
3. small   -- a SMOKE-size session on the card against the same session on
              the CPU through the plain versions.
4. serve   -- MonitorSession over a full-width granite-8b collaborative
              model (random weights from --seed) in sync and in scan mode,
              with a threshold calibrated to the paper's trigger rate;
              checks the protocol's invariants, counts each kernel's
              launches in that run, prints tokens/s, ms per step and peak
              memory.  --profile adds a torch.profiler breakdown of one
              sync and one scan run.

Then one JSON line of the kernels, the card's name and power limit, and a
last line {"ok": true, "device": {...}}.  Any failed check raises, so the
script exits non-zero and prints no result; it also does so without a GPU
or outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import copy
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
BF16_FLOPS = 989e12           # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12             # H100 SXM f32 outside the tensor cores
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# the serve cell: 8 streams, a 512-token cache, 64 monitored tokens each;
# the profile covers the first 8 steps (the profiler's per-event cost)
BATCH, MAX_LEN, STEPS, PROFILE_STEPS = 8, 512, 64, 8


def has_gqa_sdpa(torch) -> bool:
    """scaled_dot_product_attention takes enable_gqa from PyTorch 2.5."""
    return tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def time_ms(torch, fn, iters: int):
    """``fn(i)``'s time over ``iters`` calls, as (device ms, host ms).

    Device: CUDA events around the calls while a sleep kernel holds the
    stream, so the launches queue up and the events see only the card's
    work.  Host: wall time per call with the card waited for at the end,
    which is what a caller that launches one call at a time pays.
    """
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms at 1.98 GHz: covers the queueing
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    device = start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    torch.cuda.synchronize()
    return device, (time.perf_counter() - t0) * 1e3 / iters


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def within(a, b, tol: float) -> bool:
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= tol + tol * b.abs()).all())


# ---------------------------------------------------------------- phase 1
def phase_build():
    from repro_torch.kernels.build import build_all
    t0 = time.perf_counter()
    built = build_all()
    print(f"[build] {len(built)} sources in {time.perf_counter() - t0:.1f} s")
    for src, info in built.items():
        state = "cached" if info["cached"] else f"{info['seconds']:.1f} s"
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", info["log"])]
        spills = [int(w) for w in re.findall(r"(\d+) bytes spill stores",
                                             info["log"])]
        print(f"[build] {src}: {state}; {len(regs)} kernel instantiations, "
              f"registers max {max(regs, default=0)}, spill stores max "
              f"{max(spills, default=0)} bytes (ptxas -v)")


# ---------------------------------------------------------------- phase 2
def phase_kernels(torch, dev, seed: int, max_len: int, srv, edge):
    """Compare and time both kernels; returns the kernels' JSON records
    (without their main-path launch counts)."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_plain)
    from repro_torch.kernels.monitor_combine import (monitor_combine_cuda,
                                                     monitor_combine_plain)
    gen = torch.Generator(dev).manual_seed(seed)
    bf16 = torch.bfloat16
    records = {}

    # -- decode_attention: correctness at both towers' shapes -------------
    worst = 0.0
    for tower, (B, Hq, Hkv, D) in (("server", srv), ("edge", edge)):
        C = min(max_len, 1024) if tower == "edge" else max_len
        q = torch.randn((B, Hq, D), generator=gen, device=dev).to(bf16)
        k = torch.randn((B, C, Hkv, D), generator=gen, device=dev).to(bf16)
        v = torch.randn((B, C, Hkv, D), generator=gen, device=dev).to(bf16)
        ragged = torch.randint(0, 2 * C, (B,), generator=gen, device=dev)
        for case, pos in (("pos=0", 0), ("ragged pos vector", ragged),
                          (f"wrapped ring pos={2 * C + 5}", 2 * C + 5),
                          (f"full pos={C - 1}", C - 1)):
            out = decode_attention_cuda(q, k, v, pos)
            ref = decode_attention_plain(q, k, v, pos)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            worst = max(worst, err)
            print(f"[kernels] decode_attention {tower} B={B} Hq={Hq} "
                  f"Hkv={Hkv} D={D} C={C} {case}: "
                  f"max_abs_err={err:.3e} (bf16 tol {TOL['bfloat16']})")
            check(within(out, ref, TOL["bfloat16"]),
                  f"decode_attention {tower} {case}")

    # -- decode_attention: timing, cache cold as in a decode step ---------
    def time_decode(B, Hq, Hkv, D, C, pos_val, label, with_library):
        # enough cache copies to exceed the 50 MB L2: each launch reads
        # its K/V from device memory, as after a layer's weight reads
        per = 2 * B * C * Hkv * D * 2
        n_copies = max(2, math.ceil(200e6 / per))
        q = torch.randn((B, Hq, D), generator=gen, device=dev).to(bf16)
        ks = [torch.randn((B, C, Hkv, D), generator=gen, device=dev).to(bf16)
              for _ in range(n_copies)]
        vs = [torch.randn((B, C, Hkv, D), generator=gen, device=dev).to(bf16)
              for _ in range(n_copies)]
        pos = torch.full((B,), pos_val, dtype=torch.int32, device=dev)
        n_valid = min(pos_val + 1, C)
        ms, host = time_ms(torch, lambda i: decode_attention_cuda(
            q, ks[i % n_copies], vs[i % n_copies], pos), 100)
        plain, _ = time_ms(torch, lambda i: decode_attention_plain(
            q, ks[i % n_copies], vs[i % n_copies], pos), 20)
        lib = None
        if with_library and n_valid == C and has_gqa_sdpa(torch):
            # the same decode problem in one PyTorch call (never used by
            # the port): every cache entry valid, so no mask
            qs = q[:, :, None, :]
            lib, _ = time_ms(torch, lambda i: F.scaled_dot_product_attention(
                qs, ks[i % n_copies].transpose(1, 2),
                vs[i % n_copies].transpose(1, 2), enable_gqa=True), 100)
        n_bytes = (q.numel() * 2 + 2 * B * n_valid * Hkv * D * 2 + B * 4
                   + q.numel() * 2)
        n_ops = 4.0 * B * Hq * n_valid * D
        bms, by = bound_ms(n_bytes, n_ops, BF16_FLOPS)
        print(f"[kernels] decode_attention time {label} B={B} Hq={Hq} "
              f"Hkv={Hkv} D={D} C={C} pos={pos_val} (cache cold, "
              f"{n_copies} copies): kernel {ms * 1e3:.2f} us (host-bound "
              f"per call {host * 1e3:.2f} us), plain "
              f"{plain * 1e3:.2f} us, library "
              f"{'n/a' if lib is None else f'{lib * 1e3:.2f} us'}, bound "
              f"{bms * 1e3:.2f} us ({by}, {n_bytes / 1e6:.2f} MB); blocks "
              f"{B * Hkv} on 132 SMs")
        return ms, plain, lib, bms, by

    ms, plain, lib, bms, by = time_decode(*srv, max_len, max_len - 1,
                                          "server full cache", True)
    time_decode(*srv, max_len, 63, "server at the serve phase's last step",
                False)
    C_edge = min(max_len, 1024)
    time_decode(*edge, C_edge, C_edge - 1, "edge full cache", True)
    records["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:59",
        max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
        library_ms=lib)

    # -- monitor_combine ---------------------------------------------------
    worst = 0.0
    for n in (srv[0], 1000, 2**20):
        u, v = (torch.randn(n, generator=gen, device=dev) for _ in range(2))
        f = u + 0.1 * torch.randn(n, generator=gen, device=dev)
        got = monitor_combine_cuda(u, v, f, s=0.2, threshold=0.1, margin=0.25)
        want = monitor_combine_plain(u, v, f, s=0.2, threshold=0.1, margin=0.25)
        torch.cuda.synchronize()
        err = max_err(got[0], want[0])
        worst = max(worst, err)
        print(f"[kernels] monitor_combine N={n}: fhat max_abs_err={err:.3e} "
              f"(f32 tol {TOL['float32']}), mask equal "
              f"{bool(torch.equal(got[1], want[1]))}, counts "
              f"{got[2].tolist()} vs {want[2].tolist()}")
        check(within(got[0], want[0], TOL["float32"]),
              f"monitor_combine fhat N={n}")
        check(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]),
              f"monitor_combine mask/counts N={n}")
    n = srv[0]  # the serving path combines one score per stream
    u, v = (torch.randn(n, generator=gen, device=dev) for _ in range(2))
    ms, host = time_ms(torch, lambda i: monitor_combine_cuda(u, v, u, s=0.2),
                       200)
    plain, _ = time_ms(torch, lambda i: monitor_combine_plain(u, v, u, s=0.2),
                       100)
    bms, by = bound_ms(3 * n * 4 + 2 * n * 4 + 2 * 4, 8.0 * n, F32_FLOPS)
    print(f"[kernels] monitor_combine time N={n}: kernel {ms * 1e3:.2f} us "
          f"(host-bound per call {host * 1e3:.2f} us), "
          f"plain {plain * 1e3:.2f} us, bound {bms * 1e3:.5f} us ({by})")
    records["monitor_combine"] = dict(
        name="monitor_combine", route="cuda",
        source="src/repro_torch/kernels/csrc/monitor_combine.cu",
        replaces="src/repro/kernels/monitor_combine.py:52",
        max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
        library_ms=None)
    return records


# ---------------------------------------------------------------- phase 3
def phase_small(torch, dev, seed: int):
    """A SMOKE-size bf16 session on the card (kernels) against the same
    weights and tokens on the CPU (plain versions)."""
    from repro_torch.configs import granite_8b
    from repro_torch.core.decomposition import init_collab_lm
    from repro_torch.serving import MonitorSession, SessionConfig
    cfg = granite_8b.SMOKE.replace(dtype="bfloat16")
    cpu = torch.device("cpu")
    model_cpu = init_collab_lm(cfg, torch.Generator(cpu).manual_seed(seed), cpu)
    model_dev = copy.deepcopy(model_cpu).to(dev)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (4, 24))
    probe = MonitorSession.open(model_cpu, cfg, batch=4, max_len=32,
                                device=cpu, config=SessionConfig(mode="scan")
                                ).run(toks)
    thr = float(np.quantile(probe["u"], 0.85))
    conf = SessionConfig(threshold=thr, trigger_margin=0.0)
    a = MonitorSession.open(model_dev, cfg, batch=4, max_len=32, device=dev,
                            config=conf).run(toks)
    b = MonitorSession.open(model_cpu, cfg, batch=4, max_len=32, device=cpu,
                            config=conf).run(toks)
    tol = TOL["bfloat16"]
    ties = np.abs(b["u"] - thr) <= tol
    du = float(np.abs(a["u"] - b["u"]).max())
    df = float(np.abs(a["fhat"] - b["fhat"]).max())
    print(f"[small] granite-8b SMOKE bf16 sync, card vs CPU: max |du|={du:.3e}"
          f" max |dfhat|={df:.3e} (tol {tol}), triggers equal outside the "
          f"tie band ({int(ties.sum())} of {ties.size} in it)")
    check(np.allclose(a["u"], b["u"], atol=tol, rtol=tol), "small u")
    check(np.allclose(a["fhat"], b["fhat"], atol=tol, rtol=tol), "small fhat")
    check((a["triggered"] == b["triggered"])[~ties].all(), "small triggers")


# ---------------------------------------------------------------- phase 4
def phase_serve(torch, dev, args):
    from repro_torch import kernels
    from repro_torch.configs import granite_8b
    from repro_torch.configs.paper_synthetic import SERVING_TRIGGER_RATE
    from repro_torch.core.decomposition import init_collab_lm
    from repro_torch.serving import MonitorSession, SessionConfig
    cfg = granite_8b.FULL
    B, ML, S = BATCH, MAX_LEN, STEPS
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = init_collab_lm(cfg, torch.Generator(dev).manual_seed(args.seed), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.server.parameters())
    print(f"[serve] granite-8b: {cfg.n_layers} layers, d_model {cfg.d_model},"
          f" {cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {n_params / 1e9:.2f} B server parameters; "
          f"random init on the card in {time.perf_counter() - t0:.1f} s")
    toks = np.random.default_rng(args.seed).integers(0, cfg.vocab_size, (B, S))

    def session(mode, **kw):
        return MonitorSession.open(model, cfg, batch=B, max_len=ML, device=dev,
                                   config=SessionConfig(mode=mode, **kw))

    probe = session("scan").run(toks)
    thr = float(np.quantile(probe["u"], 1.0 - SERVING_TRIGGER_RATE))
    conf = dict(threshold=thr, trigger_margin=0.0)
    print(f"[serve] threshold {thr:.6f} calibrated from a probe scan to "
          f"trigger rate {SERVING_TRIGGER_RATE}")
    session("sync", **conf).run(toks[:, :4])   # warm-up: first launches
    torch.cuda.synchronize()

    kernels.reset_launch_counts()  # count the main path's launches only
    runs = {}
    for mode in ("sync", "scan"):
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        runs[mode] = r = session(mode, **conf).run(toks)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = {k: n - before[k] for k, n in kernels.launch_counts().items()}
        print(f"[serve] {mode}: {B * S / dt:.1f} tokens/s, "
              f"{dt / S * 1e3:.2f} ms/step over {S} steps x {B} streams; "
              f"trigger rate {r['comms']['trigger_rate']:.3f}, reduction "
              f"{r['comms']['reduction_x']:.2f}x; launches {launched}")
    counts = kernels.launch_counts()
    print(f"[serve] peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

    sync, scan = runs["sync"], runs["scan"]
    for mode, r in runs.items():
        for key in ("u", "fhat", "triggered"):
            check(r[key].shape == (B, S), f"{mode} {key} shape")
        check(np.isfinite(r["u"]).all() and np.isfinite(r["fhat"]).all(),
              f"{mode} finite")
        check((r["fhat"] <= r["u"]).all(), f"{mode} fhat <= u")
        per = r["comms"]["per_stream"]
        check(r["comms"]["bytes_sent"] <= r["comms"]["bytes_baseline"]
              and (per["bytes_sent"] <= per["bytes_baseline"]).all(),
              f"{mode} bytes_sent <= bytes_baseline")
    rate = sync["triggered"].mean()
    check(0.0 < rate < 1.0, f"mixed triggers (rate {rate})")
    check(np.array_equal(sync["u"], scan["u"]), "u sync == scan")
    check(np.array_equal(sync["triggered"], scan["triggered"]),
          "triggered sync == scan")
    check(np.array_equal(sync["comms"]["per_stream"]["bytes_sent"],
                         scan["comms"]["per_stream"]["bytes_sent"]),
          "per-stream bytes_sent sync == scan")
    dfhat = float(np.abs(sync["fhat"] - scan["fhat"]).max())
    check(dfhat <= 1e-6, f"fhat sync vs scan within 1e-6 (got {dfhat})")
    for name, n in counts.items():
        check(n > 0, f"kernel {name} launched in the serve phase")
    print(f"[serve] invariants hold: fhat <= u, u/triggered/bytes sync == "
          f"scan, max |fhat sync - scan| = {dfhat:.3e}, bytes_sent "
          f"{sync['comms']['bytes_sent']} <= baseline "
          f"{sync['comms']['bytes_baseline']}")
    if args.profile:
        profile(torch, session, conf, toks[:, :PROFILE_STEPS])
    return counts


def profile(torch, session, conf, toks):
    """Device time by kernel over one sync and one scan run of a few
    steps (the profiler's per-event cost makes whole runs slow)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof
    steps = toks.shape[1]
    for mode in ("sync", "scan"):
        torch.cuda.synchronize()
        with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            session(mode, **conf).run(toks)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = [e for e in p.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(_dev_us(e) for e in kern) / 1e3
        n = sum(e.count for e in kern)
        print(f"[profile] {mode}, {steps} steps: {busy:.1f} ms of kernels, "
              f"{n} launches ({n / steps:.0f} per step), wall {wall * 1e3:.1f} "
              f"ms under the profiler")
        groups = {}
        for e in kern:
            name = e.key
            g = ("decode_attention" if "decode_attention" in name else
                 "monitor_combine" if "monitor_combine" in name else
                 "matmul (cuBLAS)" if ("nvjet" in name or "gemm" in name
                                       or "gemv" in name or "cublas" in name)
                 else "other PyTorch kernels")
            groups[g] = groups.get(g, 0.0) + _dev_us(e) / 1e3
        for g, ms in sorted(groups.items(), key=lambda x: -x[1]):
            print(f"[profile]   {ms:8.2f} ms {ms / busy:6.1%} {g}")
        for e in sorted(kern, key=lambda e: -_dev_us(e))[:6]:
            print(f"[profile]     {_dev_us(e) / 1e3:8.2f} ms {e.count:6d}x "
                  f"{e.key[:80]}")


def _dev_us(event) -> float:
    """Self device time of a profiler row (renamed across PyTorch versions)."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    from repro_torch.configs import granite_8b
    from repro_torch.core.decomposition import edge_arch
    full = granite_8b.FULL
    ecfg = edge_arch(full)
    srv = (BATCH, full.n_heads, full.n_kv_heads, full.resolved_head_dim)
    edge = (BATCH, ecfg.n_heads, ecfg.n_kv_heads, ecfg.resolved_head_dim)

    phase_build()
    records = phase_kernels(torch, dev, args.seed, MAX_LEN, srv, edge)
    phase_small(torch, dev, args.seed)
    counts = phase_serve(torch, dev, args)
    for name, rec in records.items():
        rec["launches"] = counts[name]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys}
                                  for rec in records.values()]}))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
