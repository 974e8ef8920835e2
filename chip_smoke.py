#!/usr/bin/env python3
"""Drive the PyTorch port's paths, serving and training on the dense
granite-8b and on the zamba2-7b hybrid, on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--seed N] [--profile]

Phases, each printing its own lines:

1. build   -- compile every CUDA kernel from src/repro_torch/kernels/csrc
              (one nvcc per source, all at once).
2. kernels -- each kernel against its plain PyTorch version on the card,
              at its paths' shapes (Granite-8B server and edge towers,
              zamba2's shared block at head_dim 112 and its SSD scan)
              plus edge cases; then each kernel's time, its plain
              version's, one PyTorch library call's where there is one,
              and the least time the card could take (its bound).  The
              tensor-op backwards of flash attention and of the SSD scan
              are checked against autograd through the plain versions.
3. small   -- a SMOKE-size session, one SMOKE train step per config
              (granite-8b, paper SERVING, zamba2-7b) and a greedy
              generate per config, on the card against the same on the
              CPU through the plain versions.
4. serve   -- MonitorSession over a full-width collaborative model
              (random weights from --seed) in sync and in scan mode, with
              a threshold calibrated to the paper's trigger rate: granite-8b
              (36 layers), then zamba2-7b (all 81 layers); checks the
              protocol's invariants, counts each kernel's launches in that
              run, prints tokens/s, ms per step and peak memory.
5. train   -- train_collab_lm at full width, B=2 x S=4096, four AdamW
              steps: granite-8b with TRAIN_LAYERS of its 36 server layers
              (18 flash launches per step), then zamba2-7b with
              HYBRID_TRAIN_LAYERS of its 81 (two super-blocks and one tail
              layer: 26 ssd_scan and 6 flash launches per step); tokens/s
              and ms/step of steps 2-4, every step's loss parts, the
              launch counts (the phase raises unless they match the
              code), fhat <= u on the last batch, peak memory; then
              witnesses of the full-width gradient: for granite the same
              four steps at a tenth of the learning rate, and for both an
              f32 central-difference check per group of parameters.
6. paper   -- the paper's own experiments at their published widths
              (synthetic V = FC(1,16,32,64,100,1), financial
              V = FC(29,64,128,256,1)): paper_forward on the card against
              the CPU for every u_mode; 10 train_paper steps on the card
              against the CPU; the Prop-2-calibrated synthetic run (raises
              unless FN < 0.005 and L2 < 0.35); the Fig-4 financial pair
              (truncate-16 and FC(29,10,1)) with FN, L2, on-device size
              and comms reduction; µs per train step, peak memory.
7. generate -- ServeEngine.generate on the server tower: granite-8b (36
              layers, B=8, a 64-token prompt, 64 new tokens, max_len 512)
              and zamba2-7b (81 layers, 16 + 16 tokens); raises unless
              decode_attention launches once per attention layer per
              position, two greedy runs give the same tokens bitwise and
              every logit is finite; prefill and generate tokens/s, ms per
              step, peak memory.
8. async   -- MonitorSession in async mode, after the serve phases:
              granite-8b (36 layers, 32 of the serve cell's 64 steps) under the
              stream transport (a CUDA side stream) at max_staleness 0
              and 2, thread at 2, mock_remote at 4 (20-ms simulated round
              trip) and inproc at 0, each against the phase's own sync run
              (u, triggers, per-stream bytes, server_pos, the final server
              cache and the launch counts bitwise; fhat too at 0; fhat <=
              u; nothing in flight at close); each stream dispatch's host
              time against its catch-up's device time (CUDA events);
              witnesses that a dispatch does not wait for the side stream:
              the stream's launch queue depth, no synchronising CUDA runtime
              call inside any dispatch (profiler), and at SMOKE size a
              dispatch behind 1 s of device work on the side stream that
              returns well before its catch-up ends; Quantile and
              Budget threshold policies in sync and async (thresholds move,
              u bitwise, fhat <= u), FixedPolicy bitwise no policy; a traced
              sync and async run (bitwise untraced, the Chrome export
              validates, the span breakdown); the three-rung cascade over
              two engines.  zamba2-7b (81 layers, 16 of the 64 steps):
              one stream run at max_staleness 2 with the same checks.
              Per run: tokens/s, ms/step, stall, overlap ratio, peak
              memory.
9. serve-wire -- the serve cell (granite-8b, 36 layers) with the server
              half in a second process: a CorrectionServer at 16 slots
              started with multiprocessing's spawn, its weights from the
              same seed (a digest of them must match the client's).
              Against the phase's own sync runs (one before, one after):
              the wire transport at max_staleness 0 and 2, and two
              clients on one server interleaved at k = 2, one triggering
              every step; gates: u, triggers, server_pos and per-stream
              bytes equal to sync (the quiet client's to its run alone),
              fhat <= u, at k = 0 fhat within 2e-2 of sync, nothing in
              flight at close, both serve kernels launched by the server.
              Per run: tokens/s, ms/step, the RTT and its serialize /
              socket / queue / compute breakdown, wire bytes beside the
              modelled bytes, the server's replays and coalescing, each
              process's peak memory, the card's busy share (nvidia-smi's
              utilization.gpu).  Then ``python -m repro_torch.launch.server``
              itself at SMOKE size and a wire session against it.
10. fleet-shm -- the serve cell (granite-8b, 36 layers, 64 steps) with
              every server at slots == B: a CorrectionServer(shm=True)
              child, shm at max_staleness 0 and 2 and a wire session
              against it at 0 (u, triggers, server_pos, bytes bitwise the
              phase's own sync, fhat too at 0, fhat <= u, every shm reply
              over the rings, no arena file left); a FleetSupervisor of
              three ``launch.server --full`` subprocesses behind its
              router: a k = 2 fleet: session whose server is SIGKILLed
              after step 24 and a k = 0 session whose server is drained
              there, each finishing on a sibling (the same gates, fhat
              bitwise at 0, one failover, no stream dropped, the drained
              server retired) with the failover's timing; the launchers as
              subprocesses at SMOKE size (serve --engine step, --engine
              collab --transport shm against launch.server --transport
              shm, launch.fleet with a fleet: client, launch.train on
              granite-8b and zamba2-7b), each exiting 0; and the ungated
              serve step (launch/steps.py::make_serve_step) at full width
              beside the gated sync session: ms/step, tokens/s, launches
              per step.

--profile adds torch.profiler breakdowns of one sync and one scan run, of
one train step per model, of a train_paper step and of a generate step
per model, and the CUDA stream ids of the serve kernels in a short async
stream run per model (the phases run in the order 1-4, 8, 9, 10, 5-7).
Then
one JSON line of the kernels, the
card's name and power limit, and a last line {"ok": true, "device":
{...}}.  Any failed check raises, so the script exits non-zero and
prints no result; it also does so without a GPU or outside a checkout
of the repository.
f32 comparisons run in full f32: TF32 is switched off for matmuls and
cuDNN.
"""
from __future__ import annotations

import argparse
import copy
import gc
import json
import math
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
BF16_FLOPS = 989e12           # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12             # H100 SXM f32 outside the tensor cores
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
TOL_E2E = {"bfloat16": 2e-2, "float32": 1e-4}  # after a whole tower
# the serve cell: 8 streams, a 512-token cache, 64 monitored tokens each;
# the profile covers the first 8 steps (the profiler's per-event cost)
BATCH, MAX_LEN, STEPS, PROFILE_STEPS = 8, 512, 64, 8
# the train cell: 2 streams of 4096 tokens (the reference's train_4k
# sequence length), 4 AdamW steps, steps 2-4 timed.  Depth is cut to 8 of
# 36 server layers: a trained parameter costs 16 bytes (bf16 weight and
# gradient, f32 master and two f32 moments), 129 GB at 36 layers (8.05 B
# parameters), more than the card's 80 GB; 8 layers (1.95 B) take ~31 GB
# and leave room for activations and the optimizer's temporaries.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LAYERS = 2, 4096, 4, 8
TRAIN_LR = 3e-4
# a second run of the train cell at a tenth of the recipe's step size:
# a witness that the full-width gradient points downhill, whatever the
# recipe's first steps do from a random init at width 4096
WITNESS_LR = 3e-5
# the central-difference check of the full-width gradient: the largest step
# moves the f32 loss by about FD_DELTA; relative tolerance on each
# extrapolated directional derivative (granite's train cell read at most
# 1.8e-4 on the H100 without extrapolation; a dK 10% off reads 9e-2 at a
# small width on the CPU)
FD_DELTA, FD_TOL = 1e-2, 2e-3
# the hybrid train cell: zamba2-7b at full width, 13 of 81 layers: two
# super-blocks of 6 Mamba2 layers and the shared block, then 1 tail layer,
# the least depth that runs the shared block twice and the tail: 1.35 B
# trained parameters, ~21.6 GB at 16 bytes each (81 layers: ~6.6 B, 106 GB)
HYBRID_TRAIN_LAYERS = 13
# the SSD scan's tolerance (tests/test_kernels.py:89), absolute and relative
SSD_ATOL, SSD_RTOL = 5e-5, 5e-4
TF32_FLOPS = 495e12           # H100 SXM dense TF32 tensor-core peak
SERVE_KERNELS = ("decode_attention", "monitor_combine")
TRAIN_KERNELS = ("flash_attention", "ssd_scan")


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


def device_kernels(torch, fn, calls: int = 5) -> list:
    """The device kernels one call of ``fn`` runs, by name, as the profiler
    sees them over ``calls`` calls (raises if the counts differ).  A
    throwaway profiled call comes first: the tracer has dropped a device
    event of the first session it traced in a process."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]):
            fn()
            torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = [re.search(r"(\w+(?:<[^<>]*>)?)\(", e.name).group(1)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    check(len(names) % calls == 0 and len(names) > 0,
          f"profiler saw {len(names)} device kernels in {calls} calls")
    return names[:len(names) // calls]


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def within(a, b, tol: float) -> bool:
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= tol + tol * b.abs()).all())


def bf16_attention_bound(torch, plain, q, k, v, ref, window: int):
    """Per-entry bound on |kernel - plain| for bf16 attention outputs.

    Both round p to bf16 before the PV product, the kernel relative to its
    running max and the plain version after normalising, so their f32
    outputs differ by at most 2 * 2^-9 * (P|V|) for each entry; each then
    rounds to bf16, within an ulp of |ref| between them.  Bound:
    1.25 * 2^-8 * (P|V|) + 2 ulp(|ref|), the 1.25 covering f32 summation
    order.  P|V| is the plain version on f32 q, k and |v|."""
    pv = plain(q.float(), k.float(), v.float().abs(), window=window)[0]
    _, e = torch.frexp(ref.float())
    ulp = torch.ldexp(torch.ones_like(pv), e - 8)
    return 1.25 * 2.0 ** -8 * pv + 2 * ulp


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
        entry = None  # the instantiations that spill, by mangled name
        for line in info["log"].splitlines():
            found = re.search(r"Compiling entry function '(\S+)'", line)
            entry = found.group(1) if found else entry
            found = re.search(r"(\d+) bytes spill stores", line)
            if found and int(found.group(1)) and entry:
                print(f"[build]   {entry} spills {found.group(1)} bytes")


# ---------------------------------------------------------------- phase 2
def phase_kernels(torch, dev, seed: int, max_len: int, srv, edge, shared):
    """Compare and time both serve kernels (decode at the granite server
    and edge shapes and at zamba2's shared block, head_dim 112); returns
    the kernels' JSON records (without their main-path launch counts)."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (SPLITS,
                                                      decode_attention_cuda,
                                                      decode_attention_plain,
                                                      decode_attention_split,
                                                      decode_plan,
                                                      max_active_clusters)
    from repro_torch.kernels.monitor_combine import (MAX_BLOCKS,
                                                     ONE_BLOCK_MAX, THREADS,
                                                     combine_blocks,
                                                     launch_floor,
                                                     monitor_combine_blocks,
                                                     monitor_combine_cuda,
                                                     monitor_combine_plain)
    gen = torch.Generator(dev).manual_seed(seed)
    bf16 = torch.bfloat16
    records = {}

    # -- decode_attention: correctness at both towers' shapes -------------
    worst = 0.0
    for tower, (B, Hq, Hkv, D) in (("server", srv), ("edge", edge),
                                   ("zamba2 shared", shared)):
        C = min(max_len, 1024) if tower == "edge" else max_len
        q = torch.randn((B, Hq, D), generator=gen, device=dev).to(bf16)
        k = torch.randn((B, C, Hkv, D), generator=gen, device=dev).to(bf16)
        v = torch.randn((B, C, Hkv, D), generator=gen, device=dev).to(bf16)
        ragged = torch.randint(0, 2 * C, (B,), generator=gen, device=dev)
        short = torch.arange(B, device=dev) % 7  # 1..7 rows: empty splits
        for case, pos in (("pos=0", 0), ("ragged pos vector", ragged),
                          (f"wrapped ring pos={2 * C + 5}", 2 * C + 5),
                          (f"full pos={C - 1}", C - 1),
                          ("pos vector 0..6", short)):
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
        plan = decode_plan(B, Hkv, C)
        resident = max_active_clusters(D, Hq // Hkv, bf16, plan["splits"])
        print(f"[kernels] decode_attention time {label} B={B} Hq={Hq} "
              f"Hkv={Hkv} D={D} C={C} pos={pos_val} (cache cold, "
              f"{n_copies} copies): kernel {ms * 1e3:.2f} us (host-bound "
              f"per call {host * 1e3:.2f} us), plain "
              f"{plain * 1e3:.2f} us, library "
              f"{'n/a' if lib is None else f'{lib * 1e3:.2f} us'}, bound "
              f"{bms * 1e3:.2f} us ({by}, {n_bytes / 1e6:.2f} MB); grid "
              f"{plan['blocks']} blocks in {plan['clusters']} clusters of "
              f"{plan['splits']} splits on 132 SMs ({resident} clusters "
              f"resident at once)")
        return ms, plain, lib, bms, by

    ms, plain, lib, bms, by = time_decode(*srv, max_len, max_len - 1,
                                          "server full cache", True)
    # the split the plan picks against every other, at the server shape
    # and at zamba2's shared block
    for tower, (B, Hq, Hkv, D) in (("server", srv), ("zamba2 shared", shared)):
        q = torch.randn((B, Hq, D), generator=gen, device=dev).to(bf16)
        n_copies = max(2, math.ceil(200e6 / (2 * B * max_len * Hkv * D * 2)))
        ks, vs = ([torch.randn((B, max_len, Hkv, D), generator=gen,
                               device=dev).to(bf16) for _ in range(n_copies)]
                  for _ in range(2))
        planned = decode_plan(B, Hkv, max_len)["splits"]
        for pos_val in (max_len - 1, 63):
            pos = torch.full((B,), pos_val, dtype=torch.int32, device=dev)
            sweep = {n: time_ms(torch, lambda i: decode_attention_split(
                q, ks[i % n_copies], vs[i % n_copies], pos, n), 100)[0]
                * 1e3 for n in SPLITS}
            print(f"[kernels] decode_attention {tower} pos={pos_val} by "
                  f"split count (cache cold, planned {planned}): "
                  + ", ".join(f"{n}: {us:.2f} us" for n, us in sweep.items()))
        del ks, vs
    time_decode(*srv, max_len, 63, "server at the serve phase's last step",
                False)
    C_edge = min(max_len, 1024)
    time_decode(*edge, C_edge, C_edge - 1, "edge full cache", True)
    time_decode(*shared, max_len, max_len - 1, "zamba2 shared full cache",
                True)
    time_decode(*shared, max_len, 63,
                "zamba2 shared at the serve phase's last step", False)
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
        want = monitor_combine_plain(u, v, f, s=0.2, threshold=0.1, margin=0.25)
        for rep in range(2):  # twice on one stream: nothing carried over
            got = monitor_combine_cuda(u, v, f, s=0.2, threshold=0.1,
                                       margin=0.25)
            torch.cuda.synchronize()
            err = max_err(got[0], want[0])
            worst = max(worst, err)
            same = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
            print(f"[kernels] monitor_combine N={n} call {rep + 1} "
                  f"({combine_blocks(n)} blocks): fhat "
                  f"max_abs_err={err:.3e}, bitwise equal to the plain version "
                  f"fhat/mask/counts {same}, counts {got[2].tolist()}")
            check(all(same), f"monitor_combine bitwise N={n}")
    n = srv[0]  # the serving path combines one score per stream
    u, v = (torch.randn(n, generator=gen, device=dev) for _ in range(2))
    kinds = device_kernels(torch, lambda: monitor_combine_cuda(u, v, u, s=0.2))
    print(f"[kernels] monitor_combine N={n}: device kernels per call "
          f"{kinds} (profiler)")
    check(len(kinds) == 1, f"monitor_combine one device kernel at N={n}")
    ms, host = time_ms(torch, lambda i: monitor_combine_cuda(u, v, u, s=0.2),
                       200)
    floor, _ = time_ms(torch, lambda i: launch_floor(dev), 200)
    plain, _ = time_ms(torch, lambda i: monitor_combine_plain(u, v, u, s=0.2),
                       100)
    bms, by = bound_ms(3 * n * 4 + 2 * n * 4 + 2 * 4, 8.0 * n, F32_FLOPS)
    print(f"[kernels] monitor_combine time N={n}: kernel {ms * 1e3:.2f} us "
          f"(host-bound per call {host * 1e3:.2f} us), launch floor (an "
          f"empty one-warp kernel) {floor * 1e3:.2f} us, plain "
          f"{plain * 1e3:.2f} us, bound {bms * 1e3:.5f} us ({by})")
    # the one-block path against the grid, to place ONE_BLOCK_MAX
    sweep = []
    for n_s in (8, 256, 1024, 2048, 4096, 16384):
        us, vs = (torch.randn(n_s, generator=gen, device=dev)
                  for _ in range(2))
        grid = max(2, min(-(-n_s // THREADS), MAX_BLOCKS))
        one, _ = time_ms(torch, lambda i: monitor_combine_blocks(
            us, vs, us, 1, s=0.2), 100)
        many, _ = time_ms(torch, lambda i: monitor_combine_blocks(
            us, vs, us, grid, s=0.2), 100)
        sweep.append(f"N={n_s}: one block {one * 1e3:.2f} us, {grid} blocks "
                     f"{many * 1e3:.2f} us")
    print(f"[kernels] monitor_combine one block against the grid (planned "
          f"one block up to N={ONE_BLOCK_MAX}): " + "; ".join(sweep))
    records["monitor_combine"] = dict(
        name="monitor_combine", route="cuda",
        source="src/repro_torch/kernels/csrc/monitor_combine.cu",
        replaces="src/repro/kernels/monitor_combine.py:52",
        max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
        library_ms=None)
    return records


def attention_pairs(S: int, T: int, window: int) -> int:
    """(row, col) pairs a causal (sliding-window) attention computes."""
    return sum(min(r + 1, T) - (max(0, r - window + 1) if window else 0)
               for r in range(S))


def phase_flash(torch, dev, seed: int, shapes):
    """flash_attention against its plain version at the training path's
    shapes and edge cases, its backward against autograd through the
    plain version, then its times.  ``shapes``: {tower: (B, S, Hq, Hkv,
    D, window)}.  Returns the kernel's JSON record (without launches)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (flash_attention_backward,
                                                     flash_attention_cuda,
                                                     flash_attention_plain,
                                                     flash_plan)
    gen = torch.Generator(dev).manual_seed(seed)

    def qkv(B, S, Hq, Hkv, D, dtype):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for shape in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]

    cases = [(f"{tower} bf16", shp, torch.bfloat16)
             for tower, shp in shapes.items()]
    cases += [("SMOKE f32 ragged S=1000", (2, 1000, 4, 2, 64, 0), torch.float32),
              ("SMOKE f32 S=1", (2, 1, 4, 2, 64, 0), torch.float32),
              ("f32 window 100 < S=300, D=32", (2, 300, 4, 2, 32, 100),
               torch.float32),
              ("bf16 MQA window 37, D=128", (1, 333, 8, 1, 128, 37),
               torch.bfloat16),
              ("f32 D=112 ragged S=300, window 50", (2, 300, 4, 4, 112, 50),
               torch.float32)]
    worst = 0.0
    for label, (B, S, Hq, Hkv, D, window), dtype in cases:
        q, k, v = qkv(B, S, Hq, Hkv, D, dtype)
        o, lse = flash_attention_cuda(q, k, v, window=window)
        po, plse = flash_attention_plain(q, k, v, window=window)
        torch.cuda.synchronize()
        bf16 = dtype == torch.bfloat16
        tol = TOL["bfloat16" if bf16 else "float32"]
        err, lerr = max_err(o, po), max_err(lse, plse)
        worst = max(worst, err)
        scaled = ""
        if bf16:  # the flat tolerance is loose where |o| is small
            bound = bf16_attention_bound(torch, flash_attention_plain, q, k,
                                         v, po, window)
            ratio = float(((o.float() - po.float()).abs() / bound).max())
            scaled = (f", max |err| / rounding bound = {ratio:.3f} (bound "
                      f"median {float(bound.median()):.2e}, median |o| "
                      f"{float(po.float().abs().median()):.2e})")
            check(ratio <= 1.0, f"flash_attention {label} rounding bound")
        print(f"[kernels] flash_attention {label} B={B} S={S} Hq={Hq} "
              f"Hkv={Hkv} D={D} window={window}: max_abs_err={err:.3e} (tol "
              f"{tol}){scaled}, lse max_abs_err={lerr:.3e} (f32 tol "
              f"{TOL['float32']})")
        check(within(o, po, tol), f"flash_attention {label}")
        check(within(lse, plse, TOL["float32"]), f"flash_attention lse {label}")

    # backward: the Function (kernel forward, tensor-op backward) against
    # autograd through the plain version, f32, rel 1e-4 of the largest
    # entry, at both path shapes (16 and 2 row blocks) and a small window
    for B, S, Hq, Hkv, D, window in (*shapes.values(),
                                     (2, 300, 4, 2, 64, 100)):
        q, k, v = qkv(B, S, Hq, Hkv, D, torch.float32)
        do = torch.randn(q.shape, generator=gen, device=dev)
        grads = []
        for fn in (lambda a, b, c: ops.flash_attention(a, b, c, window=window),
                   lambda a, b, c: flash_attention_plain(a, b, c,
                                                         window=window)[0]):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            (fn(*leaves) * do).sum().backward()
            grads.append([t.grad for t in leaves])
            del leaves
        torch.cuda.synchronize()
        for name, a, b in zip("qkv", *grads):
            rel = max_err(a, b) / float(b.abs().max())
            print(f"[kernels] flash_attention backward d{name} B={B} S={S} "
                  f"Hq={Hq} Hkv={Hkv} D={D} window={window}: max_abs_err / "
                  f"max|grad| = {rel:.3e} (tol 1e-4)")
            check(rel <= 1e-4, f"flash backward d{name} window={window}")

    # times at the path's shapes
    times = {}
    for tower, (B, S, Hq, Hkv, D, window) in shapes.items():
        q, k, v = qkv(B, S, Hq, Hkv, D, torch.bfloat16)
        ms, host = time_ms(torch, lambda i: flash_attention_cuda(
            q, k, v, window=window), 10)
        plain, _ = time_ms(torch, lambda i: flash_attention_plain(
            q, k, v, window=window), 3)
        o, lse = flash_attention_cuda(q, k, v, window=window)
        do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        bwd, _ = time_ms(torch, lambda i: flash_attention_backward(
            q, k, v, o, lse, do, window=window), 3)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window:
            row = torch.arange(S, device=dev)[:, None]
            col = torch.arange(S, device=dev)[None, :]
            mask = (col <= row) & (col > row - window)
            lib, _ = time_ms(torch, lambda i: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=Hq != Hkv), 10)
        else:
            lib, _ = time_ms(torch, lambda i: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=Hq != Hkv), 10)
        n_ops = 4.0 * B * Hq * D * attention_pairs(S, S, window)
        n_bytes = 2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D) + 4 * B * Hq * S
        bms, by = bound_ms(n_bytes, n_ops, BF16_FLOPS)
        times[tower] = (ms, plain, lib, bms, by)
        plan = flash_plan(B, S, Hq, D, torch.bfloat16)
        print(f"[kernels] flash_attention time {tower} B={B} S={S} Hq={Hq} "
              f"Hkv={Hkv} D={D} window={window}: kernel {ms * 1e3:.1f} us "
              f"({n_ops / ms / 1e9:.1f} TFLOP/s), plain {plain * 1e3:.1f} "
              f"us, library {lib * 1e3:.1f} us (SDPA"
              f"{', boolean window mask' if window else ', is_causal'}), "
              f"bound {bms * 1e3:.2f} us ({by}: {n_ops:.3e} flop, "
              f"{n_bytes / 1e6:.2f} MB); backward (tensor ops) "
              f"{bwd * 1e3:.1f} us; grid {plan['blocks']} blocks of "
              f"{plan['threads']} threads ({plan['query_tiles']} query "
              f"tiles of {plan['block_q']} rows x {Hq} heads x {B}), K/V "
              f"tiles of {plan['block_k']} x {plan['box_cols']}, "
              f"{plan['smem_bytes']} bytes of shared memory")
    # the zero-filled columns at D = 112: the zamba2 shape at D = 128 does
    # the same products on whole boxes
    B, S, Hq, Hkv, D, window = shapes["zamba2 shared"]
    q, k, v = qkv(B, S, Hq, Hkv, 128, torch.bfloat16)
    ms128, _ = time_ms(torch, lambda i: flash_attention_cuda(
        q, k, v, window=window), 10)
    ms112 = times["zamba2 shared"][0]
    print(f"[kernels] flash_attention time zamba2 shared at D=128 instead of "
          f"{D}: kernel {ms128 * 1e3:.1f} us; D={D} takes "
          f"{ms112 / ms128:.3f} of it for {D / 128:.3f} of the useful work")
    ms, plain, lib, bms, by = times["server"]
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:73",
                max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib)


def ssd_flops(B: int, S: int, H: int, L: int, P: int, N: int) -> float:
    """Flops the SSD scan's inputs need in its lower-triangular form, chunk
    by chunk: C B^T over the n(n+1)/2 pairs s <= t of a chunk of n rows,
    once per (batch row, chunk), as B and C are shared by the heads; then
    per (batch row, head, chunk) G @ xdt over the same pairs and the
    carried state through C and the state update, n N P multiply-adds
    each."""
    total = 0.0
    for c0 in range(0, S, L):
        n = min(L, S - c0)
        total += B * n * (n + 1) * N
        total += B * H * (n * (n + 1) * P + 4.0 * n * N * P)
    return total


def phase_ssd(torch, dev, seed: int, shape):
    """ssd_scan against its plain version (y and h_final, atol 5e-5 and
    rtol 5e-4) at the hybrid train shape ``shape`` (B, S, H, P, N, chunk),
    the reference's test grid, S = 1 and a ragged S, and in every case
    against the plain form in f64 at the same tolerance; the SSDScan
    backward against autograd through the plain version in f32 and in f64
    at the full shape; then the device kernels a call (profiler), the time
    of every tile the plan could pick, and the kernel's, the plain
    version's and the backward's times, with the bound at the rate of the
    products the kernel runs (3xTF32).  Returns the kernel's JSON record
    (without launches)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssm_scan import (TILES, max_active_blocks,
                                              ssd_plan, ssd_scan_cuda,
                                              ssd_scan_plain, ssd_scan_tiled)
    gen = torch.Generator(dev).manual_seed(seed)

    def inputs(B, S, H, P, N, decays="zamba2"):
        # "zamba2": A = -linspace(1, 16), as zamba2's A_log gives, so la
        # reaches ~ -11 per step and the cumsum ~ -1400 over a chunk;
        # "test": tests/test_kernels.py:81-85, A = -exp(linspace(0, 1))
        scale = 0.5 if decays == "zamba2" else 0.3
        x = scale * torch.randn((B, S, H, P), generator=gen, device=dev)
        dt = torch.nn.functional.softplus(
            torch.randn((B, S, H), generator=gen, device=dev))
        A = (-torch.linspace(1.0, 16.0, H, device=dev) if decays == "zamba2"
             else -torch.exp(torch.linspace(0.0, 1.0, H, device=dev)))
        Bm, Cm = (0.5 * torch.randn((B, S, N), generator=gen, device=dev)
                  for _ in range(2))
        return x, dt, A, Bm, Cm

    def ratio(a, ref) -> float:
        """Largest |a - ref| / (atol + rtol |ref|): at most 1 passes."""
        return float(((a.double() - ref.double()).abs()
                      / (SSD_ATOL + SSD_RTOL * ref.double().abs())).max())

    B, S, H, P, N, chunk = shape
    # (label, shape, decays, held to the f32 plain version too)
    cases = [("zamba2 train shape", shape, "zamba2", True)]
    cases += [("reference grid", c, "test", True)
              for c in ((2, 256, 4, 32, 16, 64), (1, 128, 2, 64, 64, 128),
                        (2, 512, 8, 16, 32, 32))]
    cases += [("S=1", (B, 1, H, P, N, chunk), "zamba2", True),
              ("ragged S=300", (B, 300, H, P, N, chunk), "test", True),
              # the plain version takes one 300-row chunk here (the
              # reference's rule for a ragged S), whose f32 cumsum reaches
              # ~ -3000 under zamba2's decays: only the f64 form holds it
              ("ragged S=300, zamba2 decays", (B, 300, H, P, N, chunk),
               "zamba2", False)]
    worst = 0.0
    for label, (b, s, h, p, n, c), decays, vs_plain in cases:
        x, dt, A, Bm, Cm = inputs(b, s, h, p, n, decays)
        xdt, la = x * dt[..., None], dt * A
        y, hf = ssd_scan_cuda(xdt, la, Bm, Cm, chunk=c)
        py, ph = ssd_scan_plain(xdt, la, Bm, Cm, chunk=c)
        y64, h64 = ssd_scan_plain(*(t.double() for t in (xdt, la, Bm, Cm)),
                                  chunk=c)
        torch.cuda.synchronize()
        ey, eh = max_err(y, py), max_err(hf, ph)
        if vs_plain:
            worst = max(worst, ey, eh)
        r = {"y": (ratio(y, py), ratio(y, y64), ratio(py, y64)),
             "h_final": (ratio(hf, ph), ratio(hf, h64), ratio(ph, h64))}
        print(f"[kernels] ssd_scan {label} B={b} S={s} H={h} P={p} N={n} "
              f"chunk={c} ({decays} decays): against the plain version y "
              f"max_abs_err={ey:.3e} (max |y| {float(py.abs().max()):.3e}), "
              f"h_final {eh:.3e}; largest |err| / (atol {SSD_ATOL} + rtol "
              f"{SSD_RTOL} |ref|), y / h_final: kernel vs plain "
              f"{r['y'][0]:.3f} / {r['h_final'][0]:.3f}, kernel vs f64 "
              f"{r['y'][1]:.3f} / {r['h_final'][1]:.3f}, plain vs f64 "
              f"{r['y'][2]:.3f} / {r['h_final'][2]:.3f}")
        for out, (vp, v64, _) in r.items():
            check(v64 <= 1.0, f"ssd_scan {out} {label} against f64")
            if vs_plain:
                check(vp <= 1.0, f"ssd_scan {out} {label}")
        del x, dt, Bm, Cm, xdt, la, y, hf, py, ph, y64, h64

    # backward: the Function (kernel forward, plain-form backward) against
    # autograd through the plain version in f32, and against autograd
    # through the plain form in f64 (which shares no rounding with it),
    # rel 1e-4 of the largest entry each
    ins = inputs(B, S, H, P, N)
    dy = torch.randn(ins[0].shape, generator=gen, device=dev)
    dh = torch.randn((B, H, P, N), generator=gen, device=dev)

    def plain(x, dt, A, Bm, Cm):
        return ssd_scan_plain(x * dt[..., None], dt * A, Bm, Cm, chunk=chunk)

    grads = []
    for fn, dt64 in ((lambda *a: ops.ssd_scan(*a, chunk=chunk), False),
                     (plain, False), (plain, True)):
        cast = (lambda t: t.double()) if dt64 else (lambda t: t)
        leaves = [cast(t).clone().requires_grad_(True) for t in ins]
        y, hf = fn(*leaves)
        ((y * cast(dy)).sum() + (hf * cast(dh)).sum()).backward()
        grads.append([t.grad for t in leaves])
        del leaves, y, hf
    torch.cuda.synchronize()
    for name, a, b, b64 in zip(("x", "dt", "A", "Bm", "Cm"), *grads):
        rel = max_err(a, b) / float(b.abs().max())
        rel64 = max_err(a, b64) / float(b64.abs().max())
        print(f"[kernels] ssd_scan backward d{name} B={B} S={S} H={H} P={P} "
              f"N={N}: max_abs_err / max|grad| = {rel:.3e} against the f32 "
              f"plain version, {rel64:.3e} against f64 (tol 1e-4)")
        check(rel <= 1e-4, f"ssd_scan backward d{name}")
        check(rel64 <= 1e-4, f"ssd_scan backward d{name} against f64")
    del grads

    # times at the train shape
    x, dt, A, Bm, Cm = ins
    xdt, la = x * dt[..., None], dt * A
    plan = ssd_plan(B, S, H, P, N, chunk)
    kinds = device_kernels(torch, lambda: ssd_scan_cuda(xdt, la, Bm, Cm,
                                                        chunk=chunk))
    print(f"[kernels] ssd_scan B={B} S={S} H={H} P={P} N={N} chunk={chunk}: "
          f"device kernels per call {len(kinds)} (profiler: "
          f"{', '.join(kinds)})")
    check(len(kinds) == 2, "ssd_scan is two device kernels a call")
    ms, host = time_ms(torch, lambda i: ssd_scan_cuda(xdt, la, Bm, Cm,
                                                      chunk=chunk), 10)
    sweep = {pt: time_ms(torch, lambda i: ssd_scan_tiled(
        xdt, la, Bm, Cm, pt, chunk=chunk), 10)[0] * 1e3
        for pt in TILES if P % pt == 0}
    resident = {pt: max_active_blocks(pt, chunk, N) for pt in sweep}
    print(f"[kernels] ssd_scan by tile (columns of P a block; planned "
          f"{plan['pt']}: {plan['blocks']} blocks, {plan['smem_bytes']} "
          f"bytes of shared memory, {plan['resident']} blocks an SM, "
          f"{plan['rounds']} rounds on the busiest of 132 SMs, "
          f"{plan['idle']:.3f} of the last round idle): "
          + ", ".join(f"{pt}: {us:.1f} us ({resident[pt]} blocks an SM)"
                      for pt, us in sweep.items()))
    check(resident[plan["pt"]] == plan["resident"],
          "ssd_plan's blocks an SM are the card's")
    plain_ms, _ = time_ms(torch, lambda i: ssd_scan_plain(
        xdt, la, Bm, Cm, chunk=chunk), 3)
    leaves = [t.detach().requires_grad_(True) for t in (xdt, la, Bm, Cm)]

    def backward(i):  # what SSDScan.backward runs
        out = ssd_scan_plain(*leaves, chunk=chunk)
        torch.autograd.grad(out, leaves, (dy, dh))

    bwd, _ = time_ms(torch, backward, 3)
    n_bytes = 4.0 * (2 * xdt.numel() + la.numel() + Bm.numel() + Cm.numel()
                     + B * H * P * N)
    n_ops = ssd_flops(B, S, H, chunk, P, N)
    # the kernel's products run in 3xTF32: three TF32 products each
    bms, by = bound_ms(n_bytes, n_ops, TF32_FLOPS / 3)
    print(f"[kernels] ssd_scan time B={B} S={S} H={H} P={P} N={N} "
          f"chunk={chunk}: kernel {ms * 1e3:.1f} us ({n_ops / ms / 1e9:.2f} "
          f"TFLOP/s, host-bound per call {host * 1e3:.1f} us), plain "
          f"{plain_ms * 1e3:.1f} us, library none, bound {bms * 1e3:.1f} us "
          f"({by}, 3xTF32 products; {n_ops:.4e} flop, {n_bytes / 1e6:.1f} "
          f"MB: {n_ops / F32_FLOPS * 1e6:.1f} us at the f32 rate, "
          f"{n_ops / (TF32_FLOPS / 3) * 1e6:.1f} us at the 3xTF32 rate, "
          f"memory {n_bytes / HBM_BYTES_PER_S * 1e6:.1f} us); backward "
          f"(plain form under autograd) {bwd * 1e3:.1f} us")
    return dict(name="ssd_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssm_scan.py:53",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)


# ---------------------------------------------------------------- phase 3
def phase_small(torch, dev, seed: int):
    """A SMOKE-size bf16 session per model on the card (kernels) against
    the same weights and tokens on the CPU (plain versions)."""
    from repro_torch.configs import granite_8b, paper_synthetic, zamba2_7b
    small_session(torch, dev, seed, granite_8b.SMOKE.replace(dtype="bfloat16"),
                  flips=False)
    small_session(torch, dev, seed, zamba2_7b.SMOKE.replace(dtype="bfloat16"),
                  flips=True)
    for cfg in (granite_8b.SMOKE, paper_synthetic.SERVING, zamba2_7b.SMOKE):
        small_generate(torch, dev, seed, cfg.replace(dtype="bfloat16"))
    small_generate(torch, dev, seed, zamba2_7b.SMOKE)  # f32


def small_generate(torch, dev, seed: int, cfg):
    """Greedy generate on the card (decode kernel) against the CPU (plain
    version) from the same weights.  Tokens equal, row by row up to a
    row's first differing token, which is allowed only where the CPU's
    top-2 logit margin is inside the tie band (twice the dtype's
    end-to-end tolerance); a row is not compared past it.  The logits are
    held to that tolerance too, except for the hybrid in bf16: its
    recurrent state carries one-ulp bf16 differences from position to
    position (up to 3.3e-2 over 16 positions on the H100), so its logits
    are held in the f32 run, and its bf16 run is held to the token rule."""
    from repro_torch.models import api as model_api
    from repro_torch.serving.engine import ServeEngine
    cpu, tol = torch.device("cpu"), TOL_E2E[cfg.dtype]
    hold_logits = not (cfg.family == "hybrid" and cfg.dtype == "bfloat16")
    model_cpu = model_api.init_model(cfg, torch.Generator(cpu).manual_seed(seed),
                                     cpu)
    model_dev = copy.deepcopy(model_cpu).to(dev)
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size, (4, 8))
    runs = []
    for model, where in ((model_dev, dev), (model_cpu, cpu)):
        toks, logits = ServeEngine(model, cfg, 4, 32, where).generate(
            torch.as_tensor(prompt), 8, return_logits=True)
        runs.append((toks.cpu().numpy(), logits.float().cpu().numpy()))
    (ta, la), (tb, lb) = runs
    top2 = np.sort(lb, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    band = 2 * tol * (1 + np.abs(top2[..., 1]))
    ties, worst = 0, 0.0
    for b in range(ta.shape[0]):
        for j in range(ta.shape[1]):
            d = np.abs(la[b, j] - lb[b, j])
            worst = max(worst, float(d.max()))
            check(not hold_logits or bool((d <= tol + tol * np.abs(lb[b, j])
                                           ).all()),
                  f"{cfg.name} {cfg.dtype} generate logits row {b} step {j}")
            if ta[b, j] != tb[b, j]:
                check(margin[b, j] <= band[b, j],
                      f"{cfg.name} {cfg.dtype} generate token row {b} step "
                      f"{j} outside the tie band (margin {margin[b, j]})")
                ties += 1
                break
    print(f"[small] {cfg.name} SMOKE {cfg.dtype} greedy generate (8 + 8 "
          f"tokens x 4), card vs CPU: max |dlogit| {worst:.3e} "
          f"({'held to' if hold_logits else 'not held; token rule at'} tol "
          f"{tol}); tokens equal outside the tie band, {ties} of {ta.size} "
          f"positions in it")


def small_session(torch, dev, seed: int, cfg, flips: bool):
    """u within the bf16 tolerance everywhere; triggers equal outside the
    tie band |u - thr| <= tol.  fhat within the tolerance at every position
    where the two runs made the same trigger decision.  With ``flips`` a
    trigger may be decided the other way inside the band, and there fhat
    must differ by the whole correction s sigma(v), within the tolerance,
    read from a CPU run that triggers at every position; without it every
    fhat must agree, so no trigger may flip."""
    from repro_torch.core.decomposition import init_collab_lm
    from repro_torch.serving import MonitorSession, SessionConfig
    cpu = torch.device("cpu")
    model_cpu = init_collab_lm(cfg, torch.Generator(cpu).manual_seed(seed), cpu)
    model_dev = copy.deepcopy(model_cpu).to(dev)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (4, 24))

    def run(model, where, **conf):
        return MonitorSession.open(model, cfg, batch=4, max_len=32,
                                   device=where, config=SessionConfig(**conf)
                                   ).run(toks)

    thr = float(np.quantile(run(model_cpu, cpu, mode="scan")["u"], 0.85))
    a = run(model_dev, dev, threshold=thr, trigger_margin=0.0)
    b = run(model_cpu, cpu, threshold=thr, trigger_margin=0.0)
    tol = TOL["bfloat16"]
    ties = np.abs(b["u"] - thr) <= tol
    same = a["triggered"] == b["triggered"]
    du = float(np.abs(a["u"] - b["u"]).max())
    df = float(np.abs(a["fhat"] - b["fhat"])[same].max())
    print(f"[small] {cfg.name} SMOKE bf16 sync, card vs CPU: max |du|={du:.3e}"
          f" max |dfhat|={df:.3e} where the triggers agree (tol {tol}); "
          f"triggers equal outside the tie band ({int(ties.sum())} of "
          f"{ties.size} in it, {int((~same).sum())} decided otherwise)")
    check(np.allclose(a["u"], b["u"], atol=tol, rtol=tol), f"{cfg.name} u")
    check((a["triggered"] == b["triggered"])[~ties].all(),
          f"{cfg.name} triggers")
    if not flips:
        check(np.allclose(a["fhat"], b["fhat"], atol=tol, rtol=tol),
              f"{cfg.name} fhat")
        return
    check(np.allclose(a["fhat"][same], b["fhat"][same], atol=tol, rtol=tol),
          f"{cfg.name} fhat where the triggers agree")
    if same.all():
        return
    every = run(model_cpu, cpu, threshold=-1e30, trigger_margin=0.0)
    check(every["triggered"].all(), f"{cfg.name} every position triggers")
    jump = (every["u"] - every["fhat"])[~same]           # s sigma(v) on the CPU
    sign = np.where(a["triggered"], 1.0, -1.0)[~same]    # fhat_b - fhat_a
    got = sign * (b["fhat"] - a["fhat"])[~same]
    print(f"[small] {cfg.name} flipped triggers: fhat jump {got} against "
          f"s sigma(v) {jump} (tol {tol})")
    check(np.allclose(got, jump, atol=tol, rtol=tol),
          f"{cfg.name} fhat where the triggers flip")


def phase_small_train(torch, dev, seed: int):
    """One train step per SMOKE config on the card (flash kernel) against
    the same step from the same weights on the CPU (plain version): loss
    parts and grad norm within the dtype's end-to-end tolerance; f32
    masters within lr/10 (dense) or within lr/4 and all but 1e-4 of each
    leaf within lr/10 (zamba2, whose SSD scan sums in another order on the
    card than on the CPU); bf16 masters finite and at most 5% of each leaf beyond lr/10.  A
    first Adam step moves every entry by about lr, so gradient entries
    near 0 that take the other sign put the two masters ~2 lr apart: only
    the share of such entries can tell a fault from rounding."""
    from repro_torch import bridge
    from repro_torch.configs import granite_8b, paper_synthetic, zamba2_7b
    from repro_torch.core.decomposition import init_collab_lm
    from repro_torch.data.tokens import lm_batches
    from repro_torch.training.loop import make_train_step, to_device, trainable
    from repro_torch.training.optimizer import AdamW
    cpu, lr = torch.device("cpu"), 1e-3
    for label, cfg in (("granite-8b SMOKE f32", granite_8b.SMOKE),
                       ("paper SERVING bf16 remat", paper_synthetic.SERVING),
                       ("zamba2-7b SMOKE f32 remat",
                        zamba2_7b.SMOKE.replace(remat=True))):
        model_cpu = init_collab_lm(cfg, torch.Generator(cpu).manual_seed(seed),
                                   cpu)
        runs = {}
        for where, model, d in (("card", copy.deepcopy(model_cpu).to(dev), dev),
                                ("cpu", model_cpu, cpu)):
            opt = AdamW(lr=lr)
            state = opt.init(trainable(model))
            batch = to_device(next(lm_batches(seed, cfg, 2, 100)), d)
            m = make_train_step(cfg, opt)(model, state, batch)
            runs[where] = ({k: float(v) for k, v in m.items()},
                           bridge.collab_to_numpy(model, state))
        (ma, pa), (mb, pb) = runs["card"], runs["cpu"]
        tol = TOL_E2E[cfg.dtype]
        for key in ("total", "lm", "monitor", "safety", "grad_norm"):
            check(abs(ma[key] - mb[key]) <= tol + tol * abs(mb[key]),
                  f"small train {label} {key}: {ma[key]} vs {mb[key]}")
        worst, frac = 0.0, 0.0
        for a, b in zip(_leaves(pa), _leaves(pb)):
            check(np.isfinite(a).all(), f"{label} card masters finite")
            d = np.abs(a - b)
            worst, frac = max(worst, float(d.max())), max(
                frac, float((d > 0.1 * lr).mean()))
        bf16 = cfg.dtype == "bfloat16"
        print(f"[small] train step {label}, card vs CPU: loss "
              f"{ma['total']:.6f} vs {mb['total']:.6f}, grad norm "
              f"{ma['grad_norm']:.6f} vs {mb['grad_norm']:.6f} (tol {tol}); "
              f"masters max |diff| {worst / lr:.3f} lr, largest share of a "
              f"leaf beyond lr/10 {frac:.4f}")
        if bf16:
            check(frac <= 0.05, f"{label} masters beyond lr/10")
        elif cfg.family == "hybrid":
            check(frac <= 1e-4, f"{label} masters beyond lr/10")
            check(worst <= 0.25 * lr, f"{label} masters")
        else:
            check(worst <= 0.1 * lr, f"{label} masters")


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


# ---------------------------------------------------------------- phase 4
def phase_serve(torch, dev, args, cfg):
    """MonitorSession sync and scan over ``cfg`` at full width and depth;
    returns the kernels' launch counts in the two runs."""
    from repro_torch import kernels
    from repro_torch.configs.paper_synthetic import SERVING_TRIGGER_RATE
    from repro_torch.core.decomposition import init_collab_lm
    from repro_torch.serving import MonitorSession, SessionConfig
    B, ML, S = BATCH, MAX_LEN, STEPS
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = init_collab_lm(cfg, torch.Generator(dev).manual_seed(args.seed), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.server.parameters())
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model},"
          f" {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {n_params / 1e9:.2f} B server parameters; "
          f"random init on the card in {time.perf_counter() - t0:.1f} s")
    toks = np.random.default_rng(args.seed).integers(0, cfg.vocab_size, (B, S))

    def session(mode, **kw):
        return MonitorSession.open(model, cfg, batch=B, max_len=ML, device=dev,
                                   config=SessionConfig(mode=mode, **kw))

    probe = session("scan").run(toks)
    thr = float(np.quantile(probe["u"], 1.0 - SERVING_TRIGGER_RATE))
    conf = dict(threshold=thr, trigger_margin=0.0)
    print(f"[serve] {cfg.name} threshold {thr:.6f} calibrated from a probe "
          f"scan to "
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
        print(f"[serve] {cfg.name} {mode}: {B * S / dt:.1f} tokens/s, "
              f"{dt / S * 1e3:.2f} ms/step over {S} steps x {B} streams; "
              f"trigger rate {r['comms']['trigger_rate']:.3f}, reduction "
              f"{r['comms']['reduction_x']:.2f}x; launches {launched}")
    counts = kernels.launch_counts()
    print(f"[serve] {cfg.name} peak device memory "
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
    for name in SERVE_KERNELS:
        check(counts[name] > 0, f"kernel {name} launched in the serve phase")
    print(f"[serve] {cfg.name} invariants hold: fhat <= u, u/triggered/bytes "
          f"sync == "
          f"scan, max |fhat sync - scan| = {dfhat:.3e}, bytes_sent "
          f"{sync['comms']['bytes_sent']} <= baseline "
          f"{sync['comms']['bytes_baseline']}")
    if args.profile:
        profile(torch, session, conf, toks[:, :PROFILE_STEPS], cfg.name)
    del model, session
    return counts


# ---------------------------------------------------------------- phase 5
def train_launches_per_step(cfg) -> dict:
    """Kernel launches per train step as the code makes them: one flash
    per attention layer and one ssd_scan per Mamba2 layer in the forward,
    again in the recompute of each checkpointed server segment under remat
    (a hybrid super-block runs its k Mamba2 layers and the shared block);
    the edge tower (no remat) adds one flash per layer."""
    from repro_torch.core.decomposition import edge_arch
    from repro_torch.models import hybrid
    again = 2 if cfg.remat else 1
    edge = edge_arch(cfg).n_layers
    if cfg.family == "hybrid":
        n_super, k, tail = hybrid._layout(cfg)
        return {"flash_attention": n_super * again + edge,
                "ssd_scan": (n_super * k + tail) * again}
    return {"flash_attention": cfg.n_layers * again + edge, "ssd_scan": 0}


def phase_train(torch, dev, args, cfg, full_layers: int, lr_witness: bool):
    """train_collab_lm at full width, ``cfg.n_layers`` of ``full_layers``
    server layers deep; returns the kernels' launch counts in that run."""
    from repro_torch import kernels
    from repro_torch.core.decomposition import collab_forward
    from repro_torch.data.tokens import lm_batches
    from repro_torch.training.loop import to_device, train_collab_lm
    B, S, n = TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS
    seen = []

    def batches():
        for b in lm_batches(args.seed, cfg, B, S):
            seen.append(b)
            yield b

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()  # count the train path's launches only
    model, hist = train_collab_lm(
        torch.Generator(dev).manual_seed(args.seed), cfg, batches(), steps=n,
        lr=TRAIN_LR, log_every=1, device=dev,
        log_fn=lambda line: print(f"[train] {line}"))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    n_params = sum(p.numel() for p in model.parameters())
    dt = hist[-1]["wall_s"] - hist[0]["wall_s"]
    print(f"[train] {cfg.name} width, {cfg.n_layers} of {full_layers} server "
          f"layers, "
          f"{n_params / 1e9:.3f} B parameters (server, edge, heads), "
          f"B={B} x S={S}, AdamW lr {TRAIN_LR}: steps 2-{n}: "
          f"{(n - 1) * B * S / dt:.1f} tokens/s, {dt / (n - 1) * 1e3:.1f} "
          f"ms/step; step 1 {hist[0]['wall_s'] * 1e3:.1f} ms; launches "
          f"{counts}; peak device memory {peak / 2**30:.2f} GiB")
    for h in hist:
        print(f"[train] step {h['step'] + 1}: total {h['total']:.6f} lm "
              f"{h['lm']:.6f} monitor {h['monitor']:.6f} safety "
              f"{h['safety']:.6f} grad_norm {h['grad_norm']:.6f}")
        for key in ("total", "lm", "monitor", "safety", "grad_norm"):
            check(math.isfinite(h[key]), f"train step {h['step']} {key}")
    for name, per_step in train_launches_per_step(cfg).items():
        print(f"[train] {cfg.name} {name}: {counts[name]} launches, "
              f"{per_step} per step as the code makes them")
        check(counts[name] == per_step * n,
              f"{name} launches {counts[name]} == {per_step} x {n} steps")
    with torch.no_grad():
        out = collab_forward(model, cfg, to_device(seen[-1], dev))
    u, fhat = out["u"], out["fhat"]
    check(u.shape == (B, S) and fhat.shape == (B, S), "u/fhat shape")
    check(bool(torch.isfinite(u).all() and torch.isfinite(fhat).all()),
          "u/fhat finite")
    check(bool((fhat <= u).all()), "fhat <= u on the last batch")
    print(f"[train] last batch: fhat <= u at all {B * S} positions, u in "
          f"[{float(u.min()):.4f}, {float(u.max()):.4f}]")
    del model, out
    torch.cuda.empty_cache()
    if lr_witness:
        lr_witness_run(torch, dev, args, cfg, hist)
    gradient_witness(torch, dev, cfg, to_device(seen[0], dev), args.seed)
    if args.profile:
        profile_train(torch, dev, cfg, args.seed)
    return counts


def lr_witness_run(torch, dev, args, cfg, hist) -> None:
    """The train cell again at WITNESS_LR from the same init and batches."""
    from repro_torch.data.tokens import lm_batches
    from repro_torch.training.loop import train_collab_lm
    B, S, n = TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS
    _, whist = train_collab_lm(
        torch.Generator(dev).manual_seed(args.seed), cfg,
        lm_batches(args.seed, cfg, B, S), steps=n, lr=WITNESS_LR,
        log_every=1, device=dev, log_fn=lambda line: None)
    torch.cuda.empty_cache()
    for key in ("lm", "total"):
        print(f"[train] witness, lr {WITNESS_LR}, same init and batches: "
              f"{key} " + " -> ".join(f"{h[key]:.6f}" for h in whist)
              + f" (recipe lr {TRAIN_LR}: "
              + " -> ".join(f"{h[key]:.6f}" for h in hist) + ")")
    for h in whist:
        check(all(math.isfinite(h[key]) for key in ("total", "grad_norm")),
              f"witness step {h['step']} finite")


def gradient_witness(torch, dev, cfg, batch, seed: int) -> None:
    """The port's full-width gradient, without the reference: the train
    cell's model in f32 (same init), the joint loss's gradient g on the
    first batch, and for each group of parameters (``witness_group``:
    each attention projection of each tower across its layers; for the
    hybrid also each Mamba2 projection across its layers, A_log with
    dt_bias, and the shared block's MLP; then all the rest) the central
    difference of the loss along that group's g / |g|, at a step h that
    moves the loss by about FD_DELTA, at h / 2 and at h / 4, each divided
    by g times the step the f32 weights really took.  Each ratio r is
    1 + a h^2 + b h^4 + ... + the loss's rounding; the Mamba2 groups are
    curved enough at h to read r(h) ~ 0.95 at full width, so the check
    takes the Richardson extrapolation (64 r(h/4) - 20 r(h/2) + r(h)) / 45,
    which cancels the h^2 and h^4 terms, and holds it to 1 within FD_TOL.
    The wq / wk / wv groups read the flash backward's dQ / dK / dV at the
    path's shapes, the Mamba2 groups the SSD scan's backward; remat, the
    tied embedding and both towers are in the rest."""
    from repro_torch.core.decomposition import collab_forward, init_collab_lm
    from repro_torch.core.losses import collab_lm_loss
    from repro_torch.training.loop import trainable
    cfg32 = cfg.replace(dtype="float32")
    model = init_collab_lm(cfg32, torch.Generator(dev).manual_seed(seed), dev)
    trainable(model)
    named = list(model.named_parameters())

    def loss():
        return collab_lm_loss(collab_forward(model, cfg32, batch), batch)

    parts = loss()
    parts["total"].backward()
    groups = {}
    for name, p in named:
        groups.setdefault(witness_group(name), []).append(p)
    if cfg.family == "hybrid":
        for key in ("server mamba w_x", "server mamba A_log/dt_bias",
                    "server shared wq", "server shared mlp"):
            check(key in groups, f"gradient witness group {key}")
    print(f"[train] gradient witness, f32 at the same width, depth and init:"
          f" loss {float(parts['total'].detach()):.6f} (lm "
          f"{float(parts['lm'].detach()):.6f})")
    worst = 0.0
    for key, params in groups.items():
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        norm = float(torch.sqrt(sum(g.double().square().sum()
                                    for g in grads)))
        step = FD_DELTA / norm
        ratio = {}
        with torch.no_grad():
            orig = [p.detach().clone() for p in params]
            for h in (step, step / 2, step / 4):
                side, slope = {}, {}
                for sign in (1.0, -1.0):
                    torch._foreach_add_([p.data for p in params], grads,
                                        alpha=sign * h / norm)
                    # g . (the step the f32 weights really took): entries
                    # below half an ulp of their weight do not move
                    slope[sign] = float(sum(
                        ((p.data - o).double() * g.double()).sum()
                        for p, o, g in zip(params, orig, grads)))
                    side[sign] = float(loss()["total"].double())
                    torch._foreach_copy_([p.data for p in params], orig)
                ratio[h] = ((side[1.0] - side[-1.0])
                            / (slope[1.0] - slope[-1.0]))
            del orig
        r0, r1, r2 = ratio.values()
        rel = abs((64 * r2 - 20 * r1 + r0) / 45 - 1)
        worst = max(worst, rel)
        print(f"[train]   {key}: |g| {norm:.6f}; along g/|g|, loss "
              f"difference / (g . realised step) at steps "
              + ", ".join(f"{h:.3e}: {r:.6f}" for h, r in ratio.items())
              + f"; extrapolated, relative difference {rel:.3e}")
    print(f"[train] gradient witness: worst relative difference {worst:.3e}"
          f" (tol {FD_TOL})")
    check(worst <= FD_TOL, "full-width gradient against central differences")
    del model, named, groups, parts
    torch.cuda.empty_cache()


def witness_group(name: str) -> str:
    """The gradient witness's group of a parameter, from its path
    (``server.blocks.3.attn.wq.w``, ``server.mamba_blocks.0.1.mamba.w_z.w``,
    ``server.shared.mlp.w_up.w``, ...)."""
    parts = name.split(".")
    tower, owner, leaf = parts[0], parts[-2], parts[-1]
    shared = "shared " if "shared" in parts else ""
    if owner in ("wq", "wk", "wv", "wo"):
        return f"{tower} {shared}{owner}"
    if "mamba" in parts:
        if owner in ("w_z", "w_x", "w_B", "w_C", "w_dt", "out_proj"):
            return f"{tower} mamba {owner}"
        if leaf in ("A_log", "dt_bias"):
            return f"{tower} mamba A_log/dt_bias"
    if shared and "mlp" in parts:
        return f"{tower} shared mlp"
    return "the rest"


def profile_train(torch, dev, cfg, seed: int):
    """Device time of one train step (after one warm step) by kernel kind,
    with the flash backward and the optimizer as annotated ranges."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof
    from repro_torch.core.decomposition import init_collab_lm
    from repro_torch.data.tokens import lm_batches
    from repro_torch.training.loop import make_train_step, to_device, trainable
    from repro_torch.training.optimizer import AdamW
    model = init_collab_lm(cfg, torch.Generator(dev).manual_seed(seed), dev)
    opt = AdamW(lr=TRAIN_LR)
    state = opt.init(trainable(model))
    step = make_train_step(cfg, opt)
    batches = lm_batches(seed, cfg, TRAIN_BATCH, TRAIN_SEQ)
    step(model, state, to_device(next(batches), dev))
    batch = to_device(next(batches), dev)
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        step(model, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the ranges kernels/ops.py and training/optimizer.py open
    ranges = ("flash_attention_backward", "ssd_scan_backward", "adamw_update")
    events = [e for e in p.events() if e.device_type == DeviceType.CUDA]
    # a range shows on the device as an annotation spanning its kernels:
    # each kernel belongs to the range whose span holds its start
    spans = [e for e in events if e.name in ranges]
    kern = [e for e in events if e.name not in ranges]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    check(busy > 0, "the profiler saw device time")
    print(f"[profile] {cfg.name} train step: {busy:.1f} ms of kernels, "
          f"{len(kern)} "
          f"launches, wall {wall * 1e3:.1f} ms under the profiler (device "
          f"busy {busy / (wall * 1e3):.1%}); by range and kernel kind:")
    groups, outside = {}, {}
    for e in kern:
        start = e.time_range.start
        where = next((sp.name for sp in spans if sp.time_range.start <= start
                      < sp.time_range.end), "outside the ranges")
        key = (where, _train_kind(e.name))
        groups[key] = groups.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
        if where == "outside the ranges":
            outside[e.name] = (outside.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    for (where, kind), ms in sorted(groups.items(), key=lambda x: -x[1]):
        print(f"[profile]   {ms:8.2f} ms {ms / busy:6.1%} {where}: {kind}")
    for name in ranges:
        n = sum(sp.name == name for sp in spans)
        ms = sum(v for (w, _), v in groups.items() if w == name)
        print(f"[profile]   range {name}: {ms:.2f} ms ({ms / busy:.1%}) "
              f"over {n} calls")
    for name, ms in sorted(outside.items(), key=lambda x: -x[1])[:8]:
        print(f"[profile]     {ms:8.2f} ms outside the ranges: {name[:90]}")


def _train_kind(name: str) -> str:
    """The kind of a train-step kernel, from its name."""
    if "flash_attention_kernel" in name:
        return "flash_attention kernel"
    if "ssd_prep_kernel" in name or "ssd_chunk_kernel" in name:
        return "ssd_scan kernels"
    if "multi_tensor" in name or "foreach" in name:
        return "optimizer (foreach)"
    if any(w in name for w in ("gemm", "nvjet", "cutlass", "cublas")):
        if "sgemm" in name or "f32f32" in name:
            return "matmul f32 (cuBLAS)"
        return "matmul bf16 (cuBLAS)"
    return "other PyTorch kernels"


def profile(torch, session, conf, toks, label: str):
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
        print(f"[profile] {label} {mode}, {steps} steps: {busy:.1f} ms of "
              f"kernels, {n} launches ({n / steps:.0f} per step), wall "
              f"{wall * 1e3:.1f} ms under the profiler")
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


def profile_calls(torch, fn, calls: int, label: str) -> None:
    """Launches, device time and wall time per call of ``fn`` over
    ``calls`` calls after one warm call, and the device time by kernel
    kind: what a host-bound step spends its time on."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof
    fn()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    kern = [e for e in p.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(_dev_us(e) for e in kern) / 1e3 / calls
    n = sum(e.count for e in kern) / calls
    check(busy > 0, f"the profiler saw device time in {label}")
    groups = {}
    for e in kern:
        kind = ("decode_attention kernel" if "decode_attention" in e.key
                else _train_kind(e.key))
        groups[kind] = groups.get(kind, 0.0) + _dev_us(e) / 1e3 / calls
    print(f"[profile] {label}: {n:.0f} launches, {busy:.3f} ms of kernels "
          f"and {wall:.3f} ms of wall time a call under the profiler "
          f"(device busy {busy / wall:.1%}); "
          + ", ".join(f"{k} {ms:.3f} ms" for k, ms in
                      sorted(groups.items(), key=lambda x: -x[1])))


# ---------------------------------------------------------------- phase 6
# the Prop-2 run of tests/test_system.py::TestPaperPipelineEndToEnd: n of
# N_MODES cosines, t sampled, s = 2t, its steps, step size and hinge
PROP2_N, PROP2_MODES, PROP2_STEPS, PROP2_LR, PROP2_HINGE = 8, 24, 1500, 5e-3, 0.1
PAPER_CHECK_STEPS, PAPER_CHECK_LR = 10, 2e-3


def phase_paper(torch, dev, seed: int, with_profile: bool = False) -> None:
    """The paper-scale decomposition at the published widths (module
    docstring, phase 6).  No CUDA kernel of the port runs here: the nets
    are a few small matmuls a step, launched eagerly."""
    from repro_torch import bridge
    from repro_torch.bench.paper import FIG4_MONITORS, FIG4_STEPS, fig4_run
    from repro_torch.configs import paper_financial, paper_synthetic
    from repro_torch.core import safety, theory
    from repro_torch.core.decomposition import (U_MODES,
                                                init_paper_decomposition,
                                                paper_forward)
    from repro_torch.data.synthetic import (financial_series, financial_xy,
                                            paper_synthetic as syn_data,
                                            synthetic_residual)
    from repro_torch.training.loop import (make_paper_step, paper_batches,
                                           train_paper, trainable)
    from repro_torch.training.optimizer import AdamW
    cpu, tol = torch.device("cpu"), TOL["float32"]
    torch.cuda.reset_peak_memory_stats(dev)
    syn, fin = paper_synthetic.FULL, paper_financial.FULL
    data = {syn.name: syn_data(seed, 4096, rho=syn.rho, n_modes=PROP2_MODES),
            fin.name: financial_xy(financial_series(seed))}

    def pair(cfg, u_mode):
        kw = {"cosine": {"n_modes": 48},
              "independent": {"u_dims": (cfg.in_dim, 10, 1)}}.get(u_mode, {})
        m_cpu = init_paper_decomposition(
            cfg, torch.Generator(cpu).manual_seed(seed), u_mode=u_mode,
            device=cpu, **kw)
        return m_cpu, bridge.paper_from_numpy(bridge.paper_to_numpy(m_cpu),
                                              cfg, u_mode, dev)

    worst = 0.0
    for cfg in (syn, fin):
        x = torch.as_tensor(data[cfg.name][0])
        for u_mode in U_MODES:
            m_cpu, m_dev = pair(cfg, u_mode)
            with torch.no_grad():
                a = paper_forward(m_dev, x.to(dev), cfg, u_mode=u_mode)
                b = paper_forward(m_cpu, x, cfg, u_mode=u_mode)
            for k in ("u", "v", "corr", "fhat", "t"):
                worst = max(worst, max_err(a[k].cpu(), b[k]))
                check(within(a[k].cpu(), b[k], tol),
                      f"paper_forward {cfg.name} {u_mode} {k}")
    print(f"[paper] paper_forward card vs CPU, 3 u_modes x {syn.name} and "
          f"{fin.name} FULL: max |diff| {worst:.3e} (tol {tol})")

    lr = PAPER_CHECK_LR
    for cfg, u_mode, kw in (
            (syn, "cosine", dict(monitor_n=PROP2_N, s=0.5, freeze_t=True,
                                 safety_weight=PROP2_HINGE)),
            (fin, "truncated", dict(safety_weight=20.0)),
            (fin, "independent", dict(safety_weight=20.0))):
        x, f = data[cfg.name]
        idx = paper_batches(x.shape[0], steps=PAPER_CHECK_STEPS, batch=256,
                            seed=seed)
        trees = []
        for where, model in zip((dev, cpu), reversed(pair(cfg, u_mode))):
            opt = AdamW(lr=lr, clip_norm=0.0)
            state = opt.init(trainable(model))
            step = make_paper_step(cfg, opt, u_mode=u_mode, **kw)
            xd, fd = torch.as_tensor(x, device=where), torch.as_tensor(
                f, device=where)
            ix = torch.as_tensor(idx, device=where)
            for i in range(PAPER_CHECK_STEPS):
                step(model, state, xd[ix[i]], fd[ix[i]])
            trees.append(bridge.paper_to_numpy(model))
        d = max(float(np.abs(a - b).max())
                for a, b in zip(_leaves(trees[0]), _leaves(trees[1])))
        print(f"[paper] {PAPER_CHECK_STEPS} train_paper steps {cfg.name} "
              f"{u_mode}, card vs CPU: parameters max |diff| {d / lr:.4f} lr"
              f" (bound 0.1 lr)")
        check(d <= 0.1 * lr, f"paper steps {cfg.name} {u_mode}")

    x, f = data[syn.name]
    t = theory.t_of_n_sampled(lambda z: synthetic_residual(
        z, PROP2_N, rho=syn.rho, n_modes=PROP2_MODES), x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, res = train_paper(torch.Generator(dev).manual_seed(seed), syn, x, f,
                         u_mode="cosine", n_modes=PROP2_MODES,
                         monitor_n=PROP2_N, s=theory.s_rule(t), freeze_t=t,
                         steps=PROP2_STEPS, lr=PROP2_LR,
                         safety_weight=PROP2_HINGE, device=dev)
    torch.cuda.synchronize()
    us = (time.perf_counter() - t0) * 1e6 / PROP2_STEPS
    out, fd = res["out"], torch.as_tensor(f, device=dev)
    fn = float(safety.fn_rate(fd, out["u"], eps=0.05))
    l2 = float(safety.approx_error(fd, out["fhat"], 2.0))
    viol, vmax = (float(v) for v in safety.safety_violation(fd, out["u"]))
    print(f"[paper] {syn.name} FULL Prop-2 run (n={PROP2_N} of {PROP2_MODES} "
          f"cosines, t={t:.4f}, s=2t, {PROP2_STEPS} steps, lr {PROP2_LR}, "
          f"hinge {PROP2_HINGE}): FN {fn:.5f} (< 0.005), L2 {l2:.5f} "
          f"(< 0.35), u < f on {viol:.4f} of inputs by at most {vmax:.4f}; "
          f"{us:.1f} us/step")
    check(fn < 0.005, f"Prop-2 FN {fn}")
    check(l2 < 0.35, f"Prop-2 L2 {l2}")
    check(bool((out["fhat"] <= out["u"]).all()), "Prop-2 fhat <= u")

    if with_profile:
        model = init_paper_decomposition(
            syn, torch.Generator(dev).manual_seed(seed), u_mode="cosine",
            n_modes=PROP2_MODES, device=dev)
        opt = AdamW(lr=PROP2_LR, clip_norm=0.0)
        state = opt.init(trainable(model))
        step = make_paper_step(syn, opt, u_mode="cosine", monitor_n=PROP2_N,
                               s=theory.s_rule(t), freeze_t=True,
                               safety_weight=PROP2_HINGE)
        xd, fd = (torch.as_tensor(a, device=dev) for a in (x, f))
        ix = torch.as_tensor(paper_batches(x.shape[0], steps=1, batch=256,
                                           seed=seed)[0], device=dev)
        profile_calls(torch, lambda: step(model, state, xd[ix], fd[ix]), 20,
                      f"{syn.name} FULL train_paper step (Prop-2 run)")

    for mode, kw, udesc in FIG4_MONITORS:
        rep, ratio, meter, us, out = fig4_run(dev, mode, kw, seed=seed)
        check(bool(torch.isfinite(out["u"]).all()
                   and (out["fhat"] <= out["u"]).all()),
              f"Fig-4 {udesc} fhat <= u")
        print(f"[paper] Fig 4 {udesc} ({fin.name} FULL, {FIG4_STEPS} steps, "
              f"lr 2e-3, hinge 20): FN {float(rep['fn']):.5f}, L2 "
              f"{float(rep['l2']):.5f}, FP {float(rep['fp']):.5f}, corrected"
              f" FP {float(rep['corrected_fp']):.5f}; on-device size V/U "
              f"{ratio:.1f}x; comms reduction {meter.reduction:.1f}x at "
              f"trigger rate {meter.trigger_rate:.4f}; {us:.1f} us/step")
    print(f"[paper] fhat <= u at every output; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")


# ---------------------------------------------------------------- phase 7
GEN_BATCH, GEN_MAX_LEN = 8, 512
GEN_TOKENS = {"dense": (64, 64), "hybrid": (16, 16)}  # (prompt, new)


def attention_layers(cfg) -> int:
    """decode_attention launches per decode step: one per attention layer
    (a hybrid runs its shared block once per super-block)."""
    from repro_torch.models import hybrid
    return hybrid._layout(cfg)[0] if cfg.family == "hybrid" else cfg.n_layers


def phase_generate(torch, dev, args, cfg) -> dict:
    """ServeEngine.generate on ``cfg``'s server tower at full width and
    depth; returns the kernels' launch counts of one generate."""
    from repro_torch import kernels
    from repro_torch.models import api as model_api
    from repro_torch.serving.engine import ServeEngine
    B, ML = GEN_BATCH, GEN_MAX_LEN
    S0, n_new = GEN_TOKENS[cfg.family]
    torch.cuda.reset_peak_memory_stats(dev)
    model = model_api.init_model(cfg, torch.Generator(dev).manual_seed(
        args.seed), dev)
    prompt = torch.as_tensor(np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (B, S0)), device=dev)

    class Timed(ServeEngine):
        """Times its prefill inside generate, with one sync at its end."""

        def prefill(self, tokens):
            t0 = time.perf_counter()
            out = super().prefill(tokens)
            torch.cuda.synchronize()
            self.prefill_s = time.perf_counter() - t0
            return out

    def engine():
        return Timed(model, cfg, B, ML, dev, seed=args.seed)

    engine().generate(prompt[:, :2], 2)  # warm-up: first launches
    torch.cuda.synchronize()
    kernels.reset_launch_counts()  # count one generate's launches only
    eng = engine()
    t0 = time.perf_counter()
    toks, logits = eng.generate(prompt, n_new, return_logits=True)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    counts = kernels.launch_counts()
    again = engine().generate(prompt, n_new)
    per_pos = attention_layers(cfg)
    want = per_pos * (S0 + n_new)
    t_pre = eng.prefill_s
    t_dec = t_gen - t_pre
    print(f"[generate] {cfg.name}: {cfg.n_layers} layers, B={B}, prompt "
          f"{S0}, {n_new} new tokens, max_len {ML}: prefill "
          f"{B * S0 / t_pre:.1f} tokens/s ({t_pre / S0 * 1e3:.2f} ms a "
          f"position); generate {B * n_new / t_dec:.1f} tokens/s, "
          f"{t_dec / n_new * 1e3:.2f} ms/step (after the prefill; whole "
          f"generate {t_gen:.3f} s); launches {counts}; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    check(counts["decode_attention"] == want,
          f"decode_attention launches {counts['decode_attention']} == "
          f"{per_pos} attention layers x ({S0} + {n_new})")
    check(toks.shape == (B, n_new), "generated shape")
    check(torch.equal(toks, again), "two greedy runs give the same tokens")
    check(bool(torch.isfinite(logits).all()), "every logit finite")
    if args.profile:
        tok = eng.sample(logits[:, -1])
        profile_calls(torch, lambda: eng.sample(eng.decode(tok)[0]), 4,
                      f"{cfg.name} generate step (decode + argmax)")
    print(f"[generate] {cfg.name}: decode_attention {want} launches = "
          f"{per_pos} x ({S0} + {n_new}); two greedy runs bitwise equal; "
          f"all {logits.numel()} logits finite; first "
          f"row {toks[0, :8].tolist()}")
    del model
    return counts


# ---------------------------------------------------------------- phase 8
# the async runs of the granite serve cell: (transport, max_staleness);
# mock_remote keeps its 20-ms simulated round trip
ASYNC_RUNS = (("stream", 0), ("stream", 2), ("thread", 2),
              ("mock_remote", 4), ("inproc", 0))
# the threshold policies' targets (below the calibrated rate 0.15, so a
# stream's threshold has room to rise above the floor)
POLICY_TARGET = 0.05
# the side-stream witnesses: the device work queued on the worker's stream
# before a dispatch, and the profiled steps of the full-width session
WITNESS_SLEEP_S, WITNESS_STEPS = 1.0, 8
# zamba2's async run (and its own sync run) serves 16 of the serve cell's
# 64 steps: a zamba2 sync step costs ~3x granite's, and chip_smoke keeps
# within its time budget with the serve-wire phase (32 steps before it).
# granite's async runs serve 32 of the 64 (64 before the fleet-shm phase:
# on the H100 that phase takes ~150 s, and the granite async runs took
# ~270 s at 64 steps)
HYBRID_ASYNC_STEPS = 16
GRANITE_ASYNC_STEPS = 32


def sleep_cycles(torch, seconds: float) -> int:
    """Cycles of ``torch.cuda._sleep`` that keep the card busy for about
    ``seconds``, measured with CUDA events."""
    n = 10**8
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(n)
    end.record()
    end.synchronize()
    return int(n * seconds * 1e3 / start.elapsed_time(end))


def phase_async(torch, dev, args, cfg, full: bool) -> dict:
    """MonitorSession in async mode over ``cfg`` at full width and depth,
    each run against the phase's own sync run; returns the kernels' launch
    counts over the phase.  ``full`` (granite): every transport of
    ASYNC_RUNS, the side-stream witness, the threshold policies, a traced
    sync and async run, and the cascade; otherwise (zamba2) one ``stream``
    run at max_staleness 2."""
    from repro_torch import kernels
    from repro_torch.configs.paper_synthetic import SERVING_TRIGGER_RATE
    from repro_torch.core.decomposition import init_collab_lm
    from repro_torch.serving import MonitorSession, SessionConfig
    from repro_torch.serving.async_rpc import StreamWorker
    from repro_torch.serving.collaborative import CollaborativeEngine
    B, ML, S = BATCH, MAX_LEN, (GRANITE_ASYNC_STEPS if full
                                else HYBRID_ASYNC_STEPS)
    model = init_collab_lm(cfg, torch.Generator(dev).manual_seed(args.seed),
                           dev)
    toks = np.random.default_rng(args.seed).integers(0, cfg.vocab_size, (B, S))
    probe = MonitorSession.open(model, cfg, batch=B, max_len=ML, device=dev,
                                config=SessionConfig(mode="scan")).run(toks)
    thr = float(np.quantile(probe["u"], 1.0 - SERVING_TRIGGER_RATE))
    point = dict(threshold=thr, trigger_margin=0.0)
    cfg_thr = cfg.replace(monitor=cfg.monitor.__class__(
        **{**cfg.monitor.__dict__, **point}))
    label = f"[async] {cfg.name}"

    def engine():
        return CollaborativeEngine(model, cfg_thr, B, ML, device=dev)

    def serve(config, *, worker_of=None, steps=S, inspect=None):
        """One run from a fresh engine: (result, seconds, launches, peak
        GiB, worker).  ``worker_of(engine)`` builds the session's worker
        (the stream runs keep theirs, to read its timings);
        ``inspect(engine)`` reads the engine before it is dropped, so no
        run's peak memory holds an earlier run's caches."""
        gc.collect()
        eng = engine()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        worker = worker_of(eng) if worker_of is not None else None
        r = eng.session(config, worker=worker).run(toks[:, :steps])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out = (r, dt, kernels.launch_counts(),
               torch.cuda.max_memory_allocated(dev) / 2**30, worker)
        if inspect is not None:
            inspect(eng)
        return out

    def line(name, r, dt, peak, steps=S):
        a = r["comms"].get("async", {})
        return (f"{name}: {B * steps / dt:.1f} tokens/s, "
                f"{dt / steps * 1e3:.2f} ms/step, stall "
                f"{a.get('stall_s', 0.0):.4f} s, overlap "
                f"{a.get('overlap_ratio', float('nan')):.3f}, requests "
                f"{a.get('requests', 0)} ({a.get('merged_late', 0)} late), "
                f"inflight peak {a.get('inflight_peak', 0)}; trigger rate "
                f"{r['comms']['trigger_rate']:.3f}; peak device memory "
                f"{peak:.2f} GiB")

    # warm-up: first launches, and a stream's and a thread's first use
    for conf in ({}, dict(mode="async", transport="stream"),
                 dict(mode="async", transport="thread")):
        serve(SessionConfig(**conf), steps=4)
    base = {}

    def keep(eng):  # the sync run's final server state, on the host
        base["pos"] = eng.server_pos.copy()
        base["cache"] = {name: [x.cpu() for x in entry]
                         for name, entry in eng.server.cache.items()}
    sync, dt, sync_counts, peak, _ = serve(SessionConfig(), inspect=keep)
    print(f"{label} " + line("sync (this phase's own)", sync, dt, peak))
    check(0.0 < sync["triggered"].mean() < 1.0, "mixed triggers")
    total = dict.fromkeys(SERVE_KERNELS, 0)
    for name in SERVE_KERNELS:
        total[name] += sync_counts[name]
        check(sync_counts[name] > 0, f"{name} launched in the sync run")

    def check_run(name, r, counts, bitwise: bool):
        for key in ("u", "triggered") + (("fhat",) if bitwise else ()):
            check(np.array_equal(r[key], sync[key]),
                  f"{name}: {key} bitwise equal to sync")
        check((r["fhat"] <= r["u"]).all(), f"{name}: fhat <= u")
        per, per1 = r["comms"]["per_stream"], sync["comms"]["per_stream"]
        check(np.array_equal(per["bytes_sent"], per1["bytes_sent"])
              and (per["bytes_sent"] <= per["bytes_baseline"]).all(),
              f"{name}: per-stream bytes equal to sync and within baseline")
        check(r["comms"]["async"]["inflight_now"] == 0,
              f"{name}: nothing in flight at close")
        for k in SERVE_KERNELS:
            check(counts[k] == sync_counts[k] > 0,
                  f"{name}: {k} launches {counts[k]} == sync's "
                  f"{sync_counts[k]}")
            total[k] += counts[k]

    def check_state(name, eng):
        check(np.array_equal(eng.server_pos, base["pos"]),
              f"{name}: server_pos equal to sync")
        check(all(torch.equal(x.cpu(), y) for n in base["cache"]
                  for x, y in zip(eng.server.cache[n], base["cache"][n])),
              f"{name}: final server cache bitwise equal to sync")

    runs = ASYNC_RUNS if full else (("stream", 2),)
    for transport, k in runs:
        name = f"{transport} k={k}"
        worker_of = ((lambda e: StreamWorker(e._catchup_apply, e.params,
                                             e.server.cache))
                     if transport == "stream" else None)
        r, dt, counts, peak, worker = serve(
            SessionConfig(mode="async", transport=transport,
                          max_staleness=k), worker_of=worker_of,
            inspect=lambda e, name=name: check_state(name, e))
        check_run(name, r, counts, bitwise=(k == 0))
        print(f"{label} " + line(name, r, dt, peak))
        if worker is not None:
            tm = list(worker.timings)
            host = np.asarray([x.host_s * 1e3 for x in tm])
            devt = np.asarray([x.device_ms() for x in tm])
            pend = np.mean([x.pending_at_return for x in tm])
            print(f"{label} {name} dispatch: host {np.median(host):.2f} ms "
                  f"median ({host.min():.2f}-{host.max():.2f}), its "
                  f"catch-up on the side stream {np.median(devt):.2f} ms "
                  f"median ({devt.min():.2f}-{devt.max():.2f}) of device "
                  f"time (CUDA events); still running at return in "
                  f"{pend:.0%} of {len(tm)} dispatches")
        del worker  # it holds its engine's server cache
    # the host's speed drifts within a call: a second sync run brackets
    # the async runs, which are compared only within this phase
    again, dt, counts, peak, _ = serve(SessionConfig())
    check(np.array_equal(again["fhat"], sync["fhat"]), "sync run repeats")
    for k in SERVE_KERNELS:
        total[k] += counts[k]
    print(f"{label} " + line("sync again, after the async runs", again, dt,
                             peak))
    print(f"{label}: every async run has the sync run's u, triggers, "
          f"per-stream bytes, server_pos, final server cache and launches "
          f"bitwise ({ {k: sync_counts[k] for k in SERVE_KERNELS} }); fhat "
          f"bitwise at k=0, fhat <= u")
    if full:
        async_extras(torch, dev, model, cfg_thr, toks, sync, serve, line,
                     total, label)
    if args.profile:
        profile_streams(torch, engine, toks[:, :PROFILE_STEPS], label)
    del model
    return total


# runtime calls that make the host wait for the card (or may): none may
# run inside a StreamWorker dispatch
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
              "cudaMemset", "cudaMalloc", "cudaFree", "cudaMallocHost",
              "cudaHostAlloc", "cudaFreeHost", "cuCtxSynchronize",
              "cuStreamSynchronize", "cuEventSynchronize")


def launch_queue_depth(torch, dev, limit: int = 20000) -> int:
    """How many launches a stream queues behind busy device work before
    ``cudaLaunchKernel`` blocks: a 1-s sleep on a fresh stream, then tiny
    kernels until one launch takes over 0.2 s (``limit`` if none does)."""
    s = torch.cuda.Stream(dev)
    x = torch.zeros(1, device=dev)
    x.add_(1)  # the kernel loaded before the timed launches
    cycles = sleep_cycles(torch, 1.0)
    torch.cuda.synchronize()
    n = limit
    with torch.cuda.stream(s):
        torch.cuda._sleep(cycles)
        for i in range(limit):
            t0 = time.perf_counter()
            x.add_(1)
            if time.perf_counter() - t0 > 0.2:
                n = i
                break
    torch.cuda.synchronize()
    return n


def stream_witness(torch, dev, model, cfg, toks, label: str) -> None:
    """Three witnesses that a ``stream`` dispatch does not wait for the
    side stream: (1) the stream's launch queue depth; (2) at full width,
    the CUDA runtime calls inside every ``stream_dispatch`` profiler range
    of a session: none that synchronises; (3) at SMOKE size, where a
    catch-up's launches fit the queue, a dispatch queued behind
    WITNESS_SLEEP_S of device work on the side stream returns well before
    its catch-up ends."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import registry
    from repro_torch.core.decomposition import init_collab_lm
    from repro_torch.serving import SessionConfig
    from repro_torch.serving.async_rpc import StreamWorker
    from repro_torch.serving.collaborative import CollaborativeEngine

    depth = launch_queue_depth(torch, dev)
    print(f"{label} launch queue: a stream takes {depth} launches behind "
          f"busy device work before cudaLaunchKernel blocks")

    def session(model, cfg, B, ML):
        eng = CollaborativeEngine(model, cfg, B, ML, device=dev)
        w = StreamWorker(eng._catchup_apply, eng.params, eng.server.cache)
        return eng, w, eng.session(SessionConfig(
            mode="async", transport="stream", max_staleness=2), worker=w)

    warm = 4
    eng, w, sess = session(model, cfg, BATCH, MAX_LEN)
    for t in range(warm):
        sess.step(toks[:, t])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for t in range(warm, warm + WITNESS_STEPS):
            sess.step(toks[:, t])
    sess.close()
    events = prof.events()
    spans = [e.time_range for e in events if e.name == "stream_dispatch"]
    check(len(spans) > 0, "the witness session dispatched")
    calls, longest = {}, {}
    for e in events:
        if e.name.startswith("cu") and any(
                r.start <= e.time_range.start < r.end for r in spans):
            calls[e.name] = calls.get(e.name, 0) + 1
            longest[e.name] = max(longest.get(e.name, 0.0),
                                  e.time_range.elapsed_us() / 1e3)
    print(f"{label} runtime calls inside {len(spans)} stream dispatches "
          f"(granite full width): "
          + ", ".join(f"{k} {n}x (longest {longest[k]:.3f} ms)"
                      for k, n in sorted(calls.items())))
    syncs = sorted(set(calls) & set(SYNC_CALLS))
    check(not syncs, f"no synchronising runtime call in a dispatch: {syncs}")

    small = registry.get_smoke(cfg.name).replace(dtype="bfloat16")
    smodel = init_collab_lm(small, torch.Generator(dev).manual_seed(0), dev)
    eng, w, sess = session(smodel, small, 4, 32)
    eng._u_head = lambda p, h: torch.ones(h.shape[0], device=dev)
    stoks = np.random.default_rng(0).integers(0, small.vocab_size, (4, 16))
    for t in range(warm):  # every stream triggers every step
        sess.step(stoks[:, t])
    torch.cuda.synchronize()
    n_warm = len(w.timings)
    cycles = sleep_cycles(torch, WITNESS_SLEEP_S)
    slept_at = time.perf_counter()
    with torch.cuda.stream(w.stream):
        torch.cuda._sleep(cycles)
    sess.step(stoks[:, warm])
    last = w.timings[n_warm]
    returned = last.returned_at - slept_at
    sess.close()
    print(f"{label} side-stream witness ({cfg.name} SMOKE, whose catch-up "
          f"fits the launch queue): a dispatch queued behind "
          f"{WITNESS_SLEEP_S:.1f} s of device work took "
          f"{last.host_s * 1e3:.2f} ms of host time and returned "
          f"{returned:.3f} s after the work was queued, its catch-up still "
          f"queued ({last.pending_at_return}); the catch-up ran "
          f"{last.device_ms():.2f} ms on the card, ending at least "
          f"{WITNESS_SLEEP_S - returned:.3f} s after the dispatch returned")
    check(last.pending_at_return and returned < 0.25 * WITNESS_SLEEP_S,
          "a dispatch returns well before its catch-up ends")


def async_extras(torch, dev, model, cfg, toks, sync, serve, line, total,
                 label) -> dict:
    """The granite async phase's side-stream witness, policies, traced
    runs and cascade (see ``phase_async``); adds their launches to
    ``total``."""
    import tempfile
    from repro_torch import kernels
    from repro_torch.observability import breakdown_table, load_trace
    from repro_torch.serving import (BudgetPolicy, CascadeSession,
                                     FixedPolicy, QuantilePolicy,
                                     SessionConfig)
    from repro_torch.serving.async_rpc import StreamWorker
    from repro_torch.serving.collaborative import CollaborativeEngine

    def add(counts):
        for k in SERVE_KERNELS:
            total[k] += counts[k]

    # the side-stream witnesses (see stream_witness)
    stream_witness(torch, dev, model, cfg, toks, label)

    # threshold policies: FixedPolicy is no policy; Quantile and Budget in
    # sync and in async (thread, k=2) move their thresholds
    fixed, _, counts, _, _ = serve(SessionConfig(policy=FixedPolicy()))
    add(counts)
    for key in ("u", "fhat", "triggered"):
        check(np.array_equal(fixed[key], sync[key]),
              f"FixedPolicy: {key} bitwise equal to no policy")
    print(f"{label} FixedPolicy: u, fhat and triggers bitwise equal to the "
          f"session without a policy")
    for make in (QuantilePolicy, BudgetPolicy):
        us = {}
        for mode, conf in (("sync", {}), ("async thread k=2", dict(
                mode="async", transport="thread", max_staleness=2))):
            pol = make(POLICY_TARGET)
            taus = []
            update = pol.update

            def traced_update(*a, _update=update, _pol=pol, _taus=taus):
                _update(*a)
                _taus.append(_pol.step_thresholds().copy())
            pol.update = traced_update
            r, dt, counts, peak, _ = serve(SessionConfig(policy=pol,
                                                         **conf))
            add(counts)
            taus = np.stack(taus)
            moved = (taus > np.float32(pol.tau0)).any(axis=1)
            check(moved.any(), f"{pol.name} {mode}: the thresholds move")
            check((r["fhat"] <= r["u"]).all(),
                  f"{pol.name} {mode}: fhat <= u")
            us[mode] = r["u"]
            print(f"{label} " + line(f"{pol.name} policy, {mode}", r, dt,
                                     peak)
                  + f"; thresholds above the floor {pol.tau0:.4f} in "
                  f"{moved.mean():.0%} of steps, the largest "
                  f"{float(taus.max()):.4f}")
        check(np.array_equal(us["sync"], us["async thread k=2"]),
              f"{make.__name__}: u bitwise equal in sync and async")

    # traced runs: bitwise equal to untraced; the exports validate
    base_k2, _, counts, _, _ = serve(SessionConfig(
        mode="async", transport="inproc", max_staleness=2))
    add(counts)
    with tempfile.TemporaryDirectory() as tmp:
        for name, conf, base in (
                ("sync", {}, sync),
                ("async inproc k=2", dict(mode="async", transport="inproc",
                                          max_staleness=2), base_k2)):
            held = {}
            r, dt, counts, peak, _ = serve(
                SessionConfig(trace=True, **conf),
                inspect=lambda e: held.update(tracer=e._tracer))
            add(counts)
            for key in ("u", "fhat", "triggered"):
                check(np.array_equal(r[key], base[key]),
                      f"traced {name}: {key} bitwise equal to untraced")
            path = str(Path(tmp) / "trace.json")
            n = held["tracer"].export(path)
            load_trace(path)  # runs validate_chrome_trace: raises if bad
            print(f"{label} " + line(f"traced {name}", r, dt, peak)
                  + f"; bitwise equal to untraced, {n} spans exported, the "
                  f"Chrome trace validates")
            for row in breakdown_table(held["tracer"].spans()):
                print(f"{label}   {row}")

    # the cascade: two full-width engines on the same weights, inproc
    # tiers; escalate where the regional residual stays in the top 5%
    esc = float(np.quantile(sync["fhat"], 0.95))
    gc.collect()
    tiers = [CollaborativeEngine(model, cfg, BATCH, MAX_LEN, device=dev
                                 ).session(SessionConfig())
             for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = CascadeSession(*tiers, escalate_above=esc).run(toks)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    add(kernels.launch_counts())
    rep = out["comms"]
    for key in ("fhat", "fhat_tier1", "fhat_tier2"):
        check((out[key] <= out["u"]).all(), f"cascade: {key} <= u")
    check(np.array_equal(out["u"], sync["u"]), "cascade: u equal to sync")
    check(out["escalated"].any(), "cascade: some rows escalate")
    print(f"{label} cascade (edge -> regional -> central, inproc tiers, "
          f"escalate above {esc:.4f}): {BATCH * toks.shape[1] / dt:.1f} "
          f"tokens/s, {dt / toks.shape[1] * 1e3:.2f} ms/step; "
          f"{rep['escalated_steps']} "
          f"escalated stream-steps; tier-1 bytes {rep['tier1']['bytes_sent']}"
          f" of {rep['tier1']['bytes_baseline']}, tier-2 bytes "
          f"{rep['tier2']['bytes_sent']} of {rep['tier2']['bytes_baseline']};"
          f" fhat <= u at every rung; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return total


def profile_streams(torch, engine, toks, label: str) -> None:
    """The CUDA streams the serve kernels ran on in a short ``stream``
    session (max_staleness 2) under torch.profiler, read from its Chrome
    trace: the catch-up (decode_attention of the server tower and the
    combine) on the worker's stream, the edge decode on the default one."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile as prof
    from repro_torch.serving import SessionConfig
    eng = engine()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        eng.session(SessionConfig(mode="async", transport="stream",
                                  max_staleness=2)).run(toks)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "trace.json")
        p.export_chrome_trace(path)
        events = json.load(open(path))["traceEvents"]
    streams = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        kind = ("decode_attention" if "decode_attention" in e["name"] else
                "monitor_combine" if "monitor_combine" in e["name"] else
                "other")
        sid = e.get("args", {}).get("stream", e.get("tid"))
        streams.setdefault(kind, {}).setdefault(sid, 0)
        streams[kind][sid] += 1
    print(f"[profile] {label} stream k=2, {toks.shape[1]} steps: kernel "
          f"launches by CUDA stream id: {streams}")
    check(len(streams.get("monitor_combine", {})) == 1
          and len(streams.get("decode_attention", {})) >= 2
          and set(streams["monitor_combine"])
          <= set(streams["decode_attention"]),
          "the catch-up kernels ran on a stream of their own")


def _dev_us(event) -> float:
    """Self device time of a profiler row (renamed across PyTorch versions)."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


# ---------------------------------------------------------------- phase 9
# the serve-wire cell: the serve cell's model and traffic with the server
# half in a process of its own on the same card.  SERVER_SLOTS super-batch
# rows hold two clients of BATCH streams; the launcher's own run is SMOKE
# size (WIRE_SMOKE_BATCH streams, WIRE_SMOKE_STEPS steps)
SERVER_SLOTS = 16
WIRE_STALENESS = (0, 2)
WIRE_SMOKE_BATCH, WIRE_SMOKE_STEPS = 4, 16
SUN_PATH_MAX = 100  # a Unix socket's path must fit sockaddr_un (108 bytes)


def socket_path(tmp: str):
    """A Unix socket path in ``tmp``, or None (TCP on localhost) when the
    temporary directory's path is too long for one."""
    path = str(Path(tmp) / "s.sock")
    return path if len(path.encode()) < SUN_PATH_MAX else None


class AnyEvent:
    """Set when any of ``events`` is: a ``stop`` for ``serve_forever``
    that also returns when the client asks for a launch-count reset."""

    def __init__(self, *events):
        self.events = events

    def is_set(self) -> bool:
        return any(e.is_set() for e in self.events)


def wire_server_child(cfg, device: str, seed: int, slots: int, max_len: int,
                      uds, ready: str, stats: str, out: str, stop,
                      reset, shm: bool = False) -> None:
    """The serve-wire cell's correction server, in a process of its own
    (started with multiprocessing's spawn: fork is wrong once CUDA is
    initialised): ``cfg`` from the client's seed on ``device``, with the
    kernels phase_build compiled, loaded from _build/.  Writes the ready
    file (address and weights digest), a heartbeat every 0.1 s to
    ``stats`` and, at exit, its launch counts, stats and peak device
    memory to ``out``.  When ``reset`` is set (the client's warm-up is
    over) it zeroes its launch counts and clears ``reset``, so the counts
    cover the main path's runs only.  ``shm``: the server offers
    shared-memory arenas (the fleet-shm cell)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch import kernels
    from repro_torch.core.decomposition import init_collab_lm
    from repro_torch.launch.server import weights_digest, write_ready
    from repro_torch.serving.server import CorrectionServer
    from repro_torch.serving.tracker import JsonFileTracker
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    model = init_collab_lm(cfg, torch.Generator(dev).manual_seed(seed), dev)
    srv = CorrectionServer(cfg, model, slots=slots, max_len=max_len, uds=uds,
                           device=dev, tracker=JsonFileTracker(stats),
                           stats_interval_s=0.1, shm=shm)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    write_ready(ready, srv.address, weights_digest(model))
    try:
        while not stop.is_set():
            srv.serve_forever(stop=AnyEvent(stop, reset))
            if reset.is_set():
                kernels.reset_launch_counts()
                reset.clear()
    finally:
        peak = None
        if on_card:
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
        with open(out, "w") as fh:
            json.dump({"launches": kernels.launch_counts(),
                       "stats": srv.stats_snapshot(), "peak_gib": peak}, fh)
        srv.close()


class BusySampler:
    """The card's busy share while it runs: ``nvidia-smi``'s
    ``utilization.gpu`` (the share of each sample period in which a kernel
    of any process ran) every 100 ms.  ``mean`` is None when nvidia-smi
    gives no samples."""

    def __enter__(self):
        self._proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self._proc.terminate()
        try:
            text, _ = self._proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            text, _ = self._proc.communicate(timeout=10)
        vals = [float(x) for x in text.split() if x.strip().isdigit()]
        self.mean = sum(vals) / len(vals) if vals else None
        self.n = len(vals)

    def text(self) -> str:
        return ("not measured" if self.mean is None
                else f"{self.mean:.1f}% ({self.n} samples)")


def phase_wire(torch, dev, args, cfg) -> dict:
    """serve-wire: ``cfg`` (granite-8b FULL, 36 layers), the serve cell's
    traffic, with the correction server in a second process on the card
    (SERVER_SLOTS slots).  Against the phase's own sync runs (one before,
    one after): the wire transport at max_staleness 0 and 2, and two
    clients on one server stepped interleaved at k = 2, one triggering
    every step.  Then the launcher itself at SMOKE size.  Returns the
    launch counts of both processes."""
    import multiprocessing
    import os
    import shutil
    import tempfile
    from repro_torch import kernels
    from repro_torch.configs.paper_synthetic import SERVING_TRIGGER_RATE
    from repro_torch.core.decomposition import init_collab_lm
    from repro_torch.launch import server as launcher
    from repro_torch.serving import MonitorSession, SessionConfig
    from repro_torch.serving.collaborative import CollaborativeEngine
    from repro_torch.serving.tracker import read_stats
    B, ML, S = BATCH, MAX_LEN, STEPS
    label = f"[serve-wire] {cfg.name}"
    tmp = tempfile.mkdtemp(prefix="wire_")
    uds = socket_path(tmp)
    ready, stats, out = (os.path.join(tmp, n)
                         for n in ("ready", "stats.json", "server.json"))
    ctx = multiprocessing.get_context("spawn")
    stop, reset = ctx.Event(), ctx.Event()
    child = ctx.Process(target=wire_server_child,
                        args=(cfg, str(dev), args.seed, SERVER_SLOTS, ML, uds,
                              ready, stats, out, stop, reset))
    t_start = time.perf_counter()
    child.start()
    total = dict.fromkeys(SERVE_KERNELS, 0)
    try:
        # the client's model and threshold while the server starts
        model = init_collab_lm(cfg, torch.Generator(dev).manual_seed(
            args.seed), dev)
        toks = np.random.default_rng(args.seed).integers(
            0, cfg.vocab_size, (B, S))
        probe = MonitorSession.open(model, cfg, batch=B, max_len=ML,
                                    device=dev,
                                    config=SessionConfig(mode="scan")
                                    ).run(toks)
        thr = float(np.quantile(probe["u"], 1.0 - SERVING_TRIGGER_RATE))
        cfg_thr = cfg.replace(monitor=cfg.monitor.__class__(
            **{**cfg.monitor.__dict__, "threshold": thr,
               "trigger_margin": 0.0}))
        deadline = time.monotonic() + 600
        while not os.path.exists(ready):
            check(child.is_alive(), "the server process is alive")
            check(time.monotonic() < deadline,
                  "the server process listens within 600 s")
            time.sleep(0.1)
        address, digest = launcher.read_ready(ready)
        mine = launcher.weights_digest(model)
        check(digest == mine, f"weights digests equal (server {digest}, "
              f"client {mine})")
        print(f"{label}: server process ready in "
              f"{time.perf_counter() - t_start:.1f} s at {address}, "
              f"{SERVER_SLOTS} slots; weights digest {digest} on both sides")
        wire = f"wire:{address}"

        def server_stats() -> dict:
            time.sleep(0.3)  # the heartbeat's period is 0.1 s
            return read_stats(stats) or {}

        def serve(config, *, steps=S, cfg_run=cfg_thr):
            """One run from a fresh engine: (result, seconds, peak GiB, the
            engine's final server_pos and RTT histograms, busy sampler,
            server stats delta).  The engine itself is dropped, so no
            run's peak memory holds an earlier run's caches."""
            gc.collect()
            eng = CollaborativeEngine(model, cfg_run, B, ML, device=dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            s0 = server_stats()
            with BusySampler() as busy:
                t0 = time.perf_counter()
                r = eng.session(config).run(toks[:, :steps])
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            s1 = server_stats()
            delta = {k: s1.get(k, 0) - s0.get(k, 0)
                     for k in ("replays", "requests", "coalesced")}
            n0, n1 = s0.get("replay_s_n", 0), s1.get("replay_s_n", 0)
            delta["replay_ms"] = ((s1.get("replay_s_mean", 0) * n1
                                   - s0.get("replay_s_mean", 0) * n0)
                                  / max(n1 - n0, 1) * 1e3)
            return (r, dt, torch.cuda.max_memory_allocated(dev) / 2**30,
                    (eng.server_pos.copy(), eng.metrics.hists), busy, delta)

        def line(name, r, dt, peak, busy, steps=S):
            a = r["comms"].get("async", {})
            return (f"{label} {name}: {B * steps / dt:.1f} tokens/s, "
                    f"{dt / steps * 1e3:.2f} ms/step, stall "
                    f"{a.get('stall_s', 0.0):.4f} s, overlap "
                    f"{a.get('overlap_ratio', float('nan')):.3f}, requests "
                    f"{a.get('requests', 0)} ({a.get('merged_late', 0)} "
                    f"late); trigger rate {r['comms']['trigger_rate']:.3f}; "
                    f"client peak device memory {peak:.2f} GiB; card busy "
                    f"{busy.text()}")

        def wire_lines(name, r, hists, delta):
            w, rep = r["comms"]["wire"], r["comms"]

            def mean_ms(h):
                h = hists.get(h)
                return (h.total / h.n * 1e3) if h is not None and h.n else \
                    float("nan")
            print(f"{label} {name} RTT: mean {w['rtt_mean_s'] * 1e3:.2f} ms, "
                  f"max {w['rtt_max_s'] * 1e3:.2f} ms over {w['replies']} "
                  f"replies; breakdown means serialize "
                  f"{mean_ms('rtt_serialize_s'):.3f} / socket "
                  f"{mean_ms('rtt_socket_s'):.3f} / queue "
                  f"{mean_ms('rtt_queue_s'):.3f} / compute "
                  f"{mean_ms('rtt_compute_s'):.3f} ms; wire tx "
                  f"{w['tx_bytes']} B, rx {w['rx_bytes']} B beside the "
                  f"CommsMeter's modelled bytes_sent {rep['bytes_sent']} B; "
                  f"server: {delta['replays']} replays of "
                  f"{delta['requests']} requests ({delta['coalesced']} "
                  f"coalesced, coalesce_width "
                  f"{delta['requests'] / max(delta['replays'], 1):.2f}), "
                  f"replay {delta['replay_ms']:.2f} ms mean")

        def check_wire(name, r, pos, ref, ref_pos, fhat_tol=None):
            for key in ("u", "triggered"):
                check(np.array_equal(r[key], ref[key]),
                      f"{name}: {key} bitwise equal to sync")
            check((r["fhat"] <= r["u"]).all(), f"{name}: fhat <= u")
            check(np.array_equal(pos, ref_pos),
                  f"{name}: server_pos equal to sync")
            per, per1 = r["comms"]["per_stream"], ref["comms"]["per_stream"]
            check(np.array_equal(per["bytes_sent"], per1["bytes_sent"]),
                  f"{name}: per-stream bytes equal to sync")
            check(r["comms"]["async"]["inflight_now"] == 0,
                  f"{name}: nothing in flight at close")
            if fhat_tol is not None:
                d = float(np.abs(r["fhat"] - ref["fhat"]).max())
                check(d <= fhat_tol, f"{name}: fhat within {fhat_tol} of "
                      f"sync (max |diff| {d:.3e})")
                print(f"{label} {name}: fhat max |diff| from sync {d:.3e} "
                      f"({'bitwise' if d == 0.0 else 'not bitwise'}; the "
                      f"server replays at batch {SERVER_SLOTS}, the sync "
                      f"engine at {B})")

        # warm-up: the server's first replay, the client's first launches
        serve(SessionConfig(mode="async", transport=wire, max_staleness=2),
              steps=4)
        # count the main path's runs only, in both processes: the server
        # clears ``reset`` once its counts are zero
        kernels.reset_launch_counts()
        reset.set()
        deadline = time.monotonic() + 60
        while reset.is_set():
            check(child.is_alive(), "the server process is alive")
            check(time.monotonic() < deadline,
                  "the server process resets its launch counts within 60 s")
            time.sleep(0.01)
        sync, dt, peak, (sync_pos, _), busy, _ = serve(SessionConfig())
        print(line("sync (this phase's own)", sync, dt, peak, busy))
        check(0.0 < sync["triggered"].mean() < 1.0, "mixed triggers")
        alone = None
        for k in WIRE_STALENESS:
            name = f"wire k={k}"
            r, dt, peak, (pos, hists), busy, delta = serve(SessionConfig(
                mode="async", transport=wire, max_staleness=k))
            check_wire(name, r, pos, sync, sync_pos,
                       fhat_tol=TOL["bfloat16"] if k == 0 else None)
            print(line(name, r, dt, peak, busy))
            wire_lines(name, r, hists, delta)
            if k == 2:
                alone = r
        # two clients on one server, interleaved at k = 2; the loud one
        # triggers every step
        loud_cfg = cfg_thr.replace(monitor=cfg_thr.monitor.__class__(
            **{**cfg_thr.monitor.__dict__, "threshold": -1e9}))
        conf = SessionConfig(mode="async", transport=wire, max_staleness=2)
        gc.collect()
        engines = [CollaborativeEngine(model, c, B, ML, device=dev)
                   for c in (loud_cfg, cfg_thr)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        s0 = server_stats()
        sessions = [e.session(conf).__enter__() for e in engines]
        outs = ([], [])
        try:
            with BusySampler() as busy:
                t0 = time.perf_counter()
                for t in range(S):
                    for sess, o in zip(sessions, outs):
                        o.append(sess.step(toks[:, t]))
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
        finally:
            for sess in sessions:
                sess.close()
        s1 = server_stats()
        loud, quiet = ({k: np.stack([x[k] for x in o], 1)
                        for k in ("u", "fhat", "triggered")} for o in outs)
        check(loud["triggered"].all(), "two clients: the loud one triggers "
              "every step")
        for key in ("u", "triggered"):
            check(np.array_equal(quiet[key], alone[key]),
                  f"two clients: the quiet client's {key} equals its run "
                  "alone")
        check((quiet["fhat"] <= quiet["u"]).all()
              and (loud["fhat"] <= loud["u"]).all(), "two clients: fhat <= u")
        check(np.array_equal(engines[1].server_pos, sync_pos),
              "two clients: the quiet client's server_pos equals its run "
              "alone")
        rep = engines[1].comms.report()
        check(np.array_equal(rep["per_stream"]["bytes_sent"],
                             alone["comms"]["per_stream"]["bytes_sent"]),
              "two clients: the quiet client's bytes equal its run alone")
        check(rep["async"]["inflight_now"] == 0
              and engines[0].comms.report()["async"]["inflight_now"] == 0,
              "two clients: nothing in flight at close")
        replays = s1.get("replays", 0) - s0.get("replays", 0)
        requests = s1.get("requests", 0) - s0.get("requests", 0)
        print(f"{label} two clients k=2 (one triggering every step): "
              f"{2 * B * S / dt:.1f} tokens/s over both, {dt / S * 1e3:.2f} "
              f"ms per step of both; quiet client RTT mean "
              f"{rep['wire']['rtt_mean_s'] * 1e3:.2f} ms; server: {replays} "
              f"replays of {requests} requests (coalesce_width "
              f"{requests / max(replays, 1):.2f}); client peak device "
              f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
              f"GiB; card busy {busy.text()}")
        del engines, sessions, sess  # their caches
        again, dt, peak, _, busy, _ = serve(SessionConfig())
        check(np.array_equal(again["fhat"], sync["fhat"]), "sync run repeats")
        print(line("sync again, after the wire runs", again, dt, peak, busy))
        client = kernels.launch_counts()
        for k in SERVE_KERNELS:
            total[k] += client[k]
        print(f"{label}: client process launches "
              f"{ {k: client[k] for k in SERVE_KERNELS} }")
        del model
    finally:
        stop.set()
        child.join(timeout=120)
        if child.is_alive():
            child.terminate()
            child.join(timeout=30)
            if child.is_alive():
                child.kill()
                child.join(timeout=30)
    check(child.exitcode == 0, f"the server process exits cleanly "
          f"(exit code {child.exitcode})")
    with open(out) as fh:
        srv = json.load(fh)
    st = srv["stats"]
    for k in SERVE_KERNELS:
        check(srv["launches"][k] > 0, f"the server process launched {k}")
        total[k] += srv["launches"][k]
    print(f"{label}: server process launches in the main path's runs "
          f"{ {k: srv['launches'][k] for k in SERVE_KERNELS} }; over all "
          f"its runs, the warm-up included: {st['sessions']} sessions, {st['requests']} requests in "
          f"{st['replays']} replays ({st['coalesced']} coalesced, "
          f"coalesce_width mean {st['coalesce_width_mean']:.2f} max "
          f"{st['coalesce_width_max']:.0f}), replay "
          f"{st['replay_s_mean'] * 1e3:.2f} ms mean, queue wait "
          f"{st['queue_wait_s_mean'] * 1e3:.3f} ms mean; rx "
          f"{st['bytes_rx']} B, tx {st['bytes_tx']} B in {st['tx_flushes']} "
          f"flushes; server peak device memory {srv['peak_gib'] or 0:.2f} "
          "GiB")
    # the server's stats (not its launch counts) include the warm-up: the
    # warm-up, one per staleness, the two clients
    check(st["sessions"] == len(WIRE_STALENESS) + 3,
          f"the server served every session ({st['sessions']})")
    shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    wire_launcher_smoke(torch, dev)
    return total


def wire_launcher_smoke(torch, dev) -> None:
    """``python -m repro_torch.launch.server`` on the card at SMOKE size
    (granite-8b, seed 0, as the launcher inits) and a wire session
    against it from this process: u and triggers bitwise the client's own
    sync, fhat <= u, server_pos equal, the weights digests equal."""
    import os
    import shutil
    import tempfile
    from repro_torch.configs import registry
    from repro_torch.core.decomposition import init_collab_lm
    from repro_torch.launch import server as launcher
    from repro_torch.serving import MonitorSession, SessionConfig
    cfg, B, S = registry.get_smoke("granite-8b"), WIRE_SMOKE_BATCH, \
        WIRE_SMOKE_STEPS
    label = f"[serve-wire] launcher, {cfg.name} SMOKE"
    model = init_collab_lm(cfg, torch.Generator(dev).manual_seed(0), dev)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))

    def session(**kw):
        return MonitorSession.open(model, cfg, batch=B, max_len=32,
                                   device=dev, config=SessionConfig(**kw))
    probe = session(mode="scan").run(toks)
    conf = dict(threshold=float(np.quantile(probe["u"], 0.7)),
                trigger_margin=0.0)
    tmp = tempfile.mkdtemp(prefix="wire_")
    ready = os.path.join(tmp, "ready")
    t0 = time.perf_counter()
    proc = launcher.spawn_subprocess(
        "granite-8b", uds=socket_path(tmp), slots=B, max_len=32,
        ready_file=ready, timeout_s=300,
        extra_args=("--device", str(dev), "--idle-exit-s", "60"))
    try:
        address, digest = launcher.read_ready(ready)
        check(digest == launcher.weights_digest(model),
              "launcher: weights digests equal")
        startup = time.perf_counter() - t0
        s1 = session(**conf)
        r1 = s1.run(toks)
        s = session(**conf, mode="async", transport=f"wire:{address}",
                    max_staleness=2)
        r = s.run(toks)
        for key in ("u", "triggered"):
            check(np.array_equal(r[key], r1[key]),
                  f"launcher: {key} bitwise equal to sync")
        check(0.0 < r1["triggered"].mean() < 1.0, "launcher: mixed triggers")
        check((r["fhat"] <= r["u"]).all(), "launcher: fhat <= u")
        check(np.array_equal(s.engine.server_pos, s1.engine.server_pos),
              "launcher: server_pos equal to sync")
        w = r["comms"]["wire"]
        print(f"{label}: started and ready in {startup:.1f} s (weights "
              f"digest {digest} on both sides); k=2 over the wire: u and "
              f"triggers bitwise the client's sync, fhat <= u, {w['replies']}"
              f" replies, RTT mean {w['rtt_mean_s'] * 1e3:.2f} ms")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- phase 10
# the fleet-shm cell: the serve cell's model and traffic (granite-8b, 36
# layers) with the server half on shared-memory rings and behind a fleet
# router.  Every server leases exactly BATCH rows (slots == B), so a replay
# has the sync engine's shapes and the runs are held bitwise to sync
SHM_STALENESS = (0, 2)
FLEET_SERVERS = 3        # one killed, one drained, one to finish on
FAILOVER_STEP = 24       # the SIGKILL (k = 2) and the drain (k = 0) follow it
FLEET_WARMUP_STEPS = 4
LAUNCHER_TRAIN_STEPS = 3
FLEET_SERVER_ARGS = ("--full",)   # the launcher serves FULL on request
SHORT_PATH = 70          # socket paths below sockaddr_un's 108 bytes


def short_tmpdir(tag: str) -> str:
    """A fresh directory whose socket paths fit sockaddr_un: under the
    temporary directory, else under the checkout."""
    import tempfile
    for base in (None, str(ROOT)):
        path = tempfile.mkdtemp(prefix=tag, dir=base)
        if len(path.encode()) < SHORT_PATH:
            return path
        Path(path).rmdir()
    raise RuntimeError("no directory with a short enough path for sockets")


def phase_fleet_shm(torch, dev, args, cfg) -> dict:
    """fleet-shm: ``cfg`` (granite-8b FULL), the serve cell's traffic.
    (1) A CorrectionServer(shm=True) child at slots == B: shm at k = 0 and
    2 and a wire session against the same server at k = 0, held to the
    phase's own sync run (u, triggers, server_pos, bytes bitwise; fhat
    bitwise at k = 0; fhat <= u), no arena left.  (2) FleetSupervisor with
    FLEET_SERVERS ``launch.server`` subprocesses (--full, slots == B, no
    respawn): a k = 2 fleet: session whose server is SIGKILLed after
    FAILOVER_STEP, then a k = 0 session whose server is drained there; each
    finishes on a sibling.  (3) the launchers at SMOKE size.  (4) the
    ungated serve step (make_serve_step) at full width beside the gated
    sync session.  Returns the launch counts of every process's main-path
    runs."""
    import multiprocessing
    import os
    import shutil
    from repro_torch import kernels
    from repro_torch.configs.paper_synthetic import SERVING_TRIGGER_RATE
    from repro_torch.core.decomposition import init_collab_lm
    from repro_torch.launch import server as launcher
    from repro_torch.serving import MonitorSession, SessionConfig, shm
    from repro_torch.serving.collaborative import CollaborativeEngine
    from repro_torch.serving.fleet import FleetSupervisor
    B, ML, S = BATCH, MAX_LEN, STEPS
    label = f"[fleet-shm] {cfg.name}"
    total = dict.fromkeys(SERVE_KERNELS, 0)
    tmp = short_tmpdir("fs_")
    # the launcher's servers init from seed 0: the client does too
    seed = 0
    ready, stats, out = (os.path.join(tmp, n)
                         for n in ("ready", "stats.json", "server.json"))
    ctx = multiprocessing.get_context("spawn")
    stop, reset = ctx.Event(), ctx.Event()
    child = ctx.Process(target=wire_server_child,
                        args=(cfg, str(dev), seed, B, ML,
                              os.path.join(tmp, "s.sock"), ready, stats, out,
                              stop, reset, True))
    t_start = time.perf_counter()
    child.start()
    model = init_collab_lm(cfg, torch.Generator(dev).manual_seed(seed), dev)
    toks = np.random.default_rng(args.seed).integers(0, cfg.vocab_size,
                                                     (B, S))
    probe = MonitorSession.open(model, cfg, batch=B, max_len=ML, device=dev,
                                config=SessionConfig(mode="scan")).run(toks)
    thr = float(np.quantile(probe["u"], 1.0 - SERVING_TRIGGER_RATE))
    cfg_thr = cfg.replace(monitor=cfg.monitor.__class__(
        **{**cfg.monitor.__dict__, "threshold": thr, "trigger_margin": 0.0}))
    s_max = cfg.monitor.s

    def serve(config, steps=S, at=None):
        """One run from a fresh engine, step by step: (result, seconds,
        the engine's server_pos, per-step seconds).  ``at[i](engine)``
        runs after step i."""
        gc.collect()
        eng = CollaborativeEngine(model, cfg_thr, B, ML, device=dev)
        torch.cuda.synchronize()
        times, outs = [], []
        t0 = time.perf_counter()
        with eng.session(config) as sess:
            for i in range(steps):
                t1 = time.perf_counter()
                outs.append(sess.step(toks[:, i]))
                times.append(time.perf_counter() - t1)
                if at is not None and i in at:
                    at[i](eng)
        rep = sess.report()   # after the close drained the pipeline
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        r = {k: np.stack([o[k] for o in outs], 1)
             for k in ("u", "fhat", "triggered")}
        r["comms"] = rep
        return r, dt, eng.server_pos.copy(), times

    def tokens_line(name, r, dt, steps=S):
        return (f"{label} {name}: {B * steps / dt:.1f} tokens/s, "
                f"{dt / steps * 1e3:.2f} ms/step; trigger rate "
                f"{r['comms']['trigger_rate']:.3f}")

    def check_like_sync(name, r, pos, fhat_bitwise):
        check(r["u"].shape == (B, S), f"{name}: every stream served every "
              "step (no stream dropped)")
        for key in ("u", "triggered") + (("fhat",) if fhat_bitwise else ()):
            check(np.array_equal(r[key], sync[key]),
                  f"{name}: {key} bitwise equal to sync")
        check((r["fhat"] <= r["u"]).all(), f"{name}: fhat <= u")
        corr = r["u"] - r["fhat"]
        check(((corr >= 0) & (corr <= s_max)).all(),
              f"{name}: every correction in [0, s]")
        check(np.array_equal(pos, sync_pos),
              f"{name}: server_pos equal to sync")
        check(np.array_equal(r["comms"]["per_stream"]["bytes_sent"],
                             sync["comms"]["per_stream"]["bytes_sent"]),
              f"{name}: per-stream bytes equal to sync")
        check(r["comms"]["async"]["inflight_now"] == 0,
              f"{name}: nothing in flight at close")

    def rtt_line(name, r, plane):
        p = r["comms"][plane]
        return (f"{label} {name} {plane} RTT: mean "
                f"{p['rtt_mean_s'] * 1e3:.2f} ms, max "
                f"{p['rtt_max_s'] * 1e3:.2f} ms over {p['replies']} replies; "
                f"{plane} tx {p['tx_bytes']} B, rx {p['rx_bytes']} B")

    # -- (1) shm against a child server -------------------------------------
    try:
        deadline = time.monotonic() + 600
        while not os.path.exists(ready):
            check(child.is_alive(), "the shm server process is alive")
            check(time.monotonic() < deadline,
                  "the shm server process listens within 600 s")
            time.sleep(0.1)
        address, digest = launcher.read_ready(ready)
        check(digest == launcher.weights_digest(model),
              "shm server: weights digests equal")
        print(f"{label}: shm server process ready in "
              f"{time.perf_counter() - t_start:.1f} s at {address}, {B} "
              f"slots (= B)")
        serve(SessionConfig(mode="async", transport=f"shm:{address}",
                            max_staleness=2), steps=4)   # warm-up
        kernels.reset_launch_counts()
        reset.set()
        deadline = time.monotonic() + 60
        while reset.is_set():
            check(child.is_alive() and time.monotonic() < deadline,
                  "the shm server resets its launch counts within 60 s")
            time.sleep(0.01)
        sync, dt, sync_pos, _ = serve(SessionConfig())
        sync_ms = dt / S * 1e3
        sync_counts = kernels.launch_counts()
        print(tokens_line("sync (this phase's own)", sync, dt)
              + f"; launches per step "
              f"{ {k: sync_counts[k] / S for k in SERVE_KERNELS} }")
        check(0.0 < sync["triggered"].mean() < 1.0, "mixed triggers")
        for kind, k in (("shm", 0), ("wire", 0), ("shm", 2)):
            name = f"{kind} k={k}"
            r, dt, pos, _ = serve(SessionConfig(
                mode="async", transport=f"{kind}:{address}", max_staleness=k))
            check_like_sync(name, r, pos, fhat_bitwise=k == 0)
            if kind == "shm":
                check(r["comms"]["shm"]["replies"]
                      == r["comms"]["async"]["requests"] > 0,
                      f"{name}: every reply over the rings")
                check(r["comms"]["wire"]["replies"] == 0,
                      f"{name}: no reply over the socket")
            else:
                check("shm" not in r["comms"],
                      f"{name}: a wire client of an shm server stays plain")
            print(tokens_line(name, r, dt))
            print(rtt_line(name, r, kind))
        for key, n in kernels.launch_counts().items():
            if key in total:
                total[key] += n
    finally:
        stop.set()
        child.join(timeout=120)
        if child.is_alive():
            child.kill()
            child.join(timeout=30)
    check(child.exitcode == 0, f"the shm server process exits cleanly "
          f"(exit code {child.exitcode})")
    with open(out) as fh:
        srv = json.load(fh)
    st = srv["stats"]
    for key in SERVE_KERNELS:
        check(srv["launches"][key] > 0, f"the shm server launched {key}")
        total[key] += srv["launches"][key]
    check(st["shm_sessions"] == 3, f"the shm server's shm sessions "
          f"({st['shm_sessions']}: the warm-up and two runs)")
    print(f"{label}: shm server process launches in the main path's runs "
          f"{ {k: srv['launches'][k] for k in SERVE_KERNELS} }; "
          f"{st['shm_sessions']} shm sessions, ring rx "
          f"{st['shm_bytes_rx']} B, tx {st['shm_bytes_tx']} B, socket rx "
          f"{st['bytes_rx']} B, tx {st['bytes_tx']} B; replay "
          f"{st['replay_s_mean'] * 1e3:.2f} ms mean; peak device memory "
          f"{srv['peak_gib'] or 0:.2f} GiB")
    check(shm.stray_arenas() == [], "no arena file left after close")
    gc.collect()
    torch.cuda.empty_cache()

    # -- (2) a fleet of launcher subprocesses, kill and drain ------------------
    root = short_tmpdir("fl_")
    t0 = time.perf_counter()
    sup = FleetSupervisor(
        cfg.name, n_servers=FLEET_SERVERS, slots=B, max_len=ML,
        backend="subprocess", root=root, respawn=False,
        heartbeat_timeout_s=120.0, device=str(dev),
        server_args=FLEET_SERVER_ARGS, spawn_timeout_s=600.0)
    beat = threading.Event()
    ticker = threading.Thread(target=sup.run_forever, args=(beat,),
                              daemon=True)
    fleet = f"fleet:{sup.router_address}"

    def launches(h):
        # the supervisor's last scrape of the server's heartbeat: it
        # outlives the process (a drained server removes its file at exit)
        return dict(h.stats.get("kernel_launches", {}))

    try:
        sup.start(wait=True)
        ticker.start()
        deadline = time.monotonic() + 120
        while len(sup.live_servers()) < FLEET_SERVERS:
            check(time.monotonic() < deadline,
                  f"{FLEET_SERVERS} fleet servers live within 120 s")
            time.sleep(0.05)
        for h in sup.servers.values():
            check(launcher.read_ready(h.ready_file)[1]
                  == launcher.weights_digest(model),
                  f"fleet server {h.name}: weights digests equal")
        print(f"{label}: {FLEET_SERVERS} launcher subprocesses (--full, "
              f"{B} slots) live behind the router in "
              f"{time.perf_counter() - t0:.1f} s, weights digests equal")
        for h in sup.servers.values():   # a direct warm-up of each server
            serve(SessionConfig(mode="async", transport=f"wire:{h.address}",
                                max_staleness=2), steps=FLEET_WARMUP_STEPS)
        time.sleep(1.0)   # a heartbeat after the warm-ups, scraped
        base = {h.name: launches(h) for h in sup.servers.values()}
        gone = {}

        def victim(eng):
            return next(h for h in sup.servers.values()
                        if h.address == eng._worker.server_address)

        marks = {}

        def timed(worker):
            """Stamp the failover's start and end and the first reply
            after it (the worker's own methods, wrapped on the instance)."""
            failover, to_reply = worker._failover, worker._to_reply

            def _failover(why):
                marks["start"] = time.perf_counter()
                failover(why)
                marks["end"] = time.perf_counter()

            def _to_reply(msg):
                if "end" in marks and "reply" not in marks:
                    marks["reply"] = time.perf_counter()
                return to_reply(msg)
            worker._failover, worker._to_reply = _failover, _to_reply

        def kill(eng):
            marks.clear()
            timed(eng._worker)
            gone["kill"] = victim(eng).name
            marks["act"] = time.perf_counter()
            victim(eng).kill()           # SIGKILL: no GOAWAY, no BYE

        def drain(eng):
            marks.clear()
            timed(eng._worker)
            gone["drain"] = victim(eng).name
            marks["act"] = time.perf_counter()
            sup.drain(gone["drain"])     # SIGUSR1: GOAWAY, then exit
        runs = (("fleet k=2, SIGKILL", 2, kill, False),
                ("fleet k=0, drain", 0, drain, True))
        for name, k, act, bitwise in runs:
            r, dt, pos, times = serve(
                SessionConfig(mode="async", transport=fleet,
                              max_staleness=k), at={FAILOVER_STEP: act})
            check_like_sync(name, r, pos, fhat_bitwise=bitwise)
            fo = r["comms"].get("failover", {})
            check(fo.get("failovers") == 1, f"{name}: one failover")
            check(all(k in marks for k in ("act", "start", "end", "reply")),
                  f"{name}: the failover ran and a reply followed it")
            print(tokens_line(name, r, dt) + f"; failover: "
                  f"{fo['replay_requests']} replay and "
                  f"{fo['resent_requests']} resent requests, "
                  f"{fo['replayed_tokens']} tokens replayed, tx "
                  f"{fo['tx_bytes']} B, rx {fo['rx_bytes']} B; it began "
                  f"{(marks['start'] - marks['act']) * 1e3:.2f} ms after "
                  f"the {name.split(', ')[1]}, re-HELLO and replay sent in "
                  f"{(marks['end'] - marks['start']) * 1e3:.2f} ms, first "
                  f"reply {(marks['reply'] - marks['end']) * 1e3:.2f} ms "
                  f"later ({(marks['reply'] - marks['act']) * 1e3:.2f} ms "
                  f"in all); median step {float(np.median(times)) * 1e3:.2f}"
                  f" ms, slowest {max(times) * 1e3:.2f} ms")
            print(rtt_line(name, r, "wire"))
        h = sup.servers[gone["drain"]]
        deadline = time.monotonic() + 120
        while h.state != "stopped":
            check(time.monotonic() < deadline, f"the drained server retires "
                  f"(state {h.state})")
            time.sleep(0.05)
        check(sup.stats["retired"] == 1 and sup.stats["respawns"] == 0,
              "the drained server is retired, not replaced")
        time.sleep(1.0)   # the survivors' last heartbeats, scraped
        for h in sup.servers.values():
            now = launches(h)
            for key in SERVE_KERNELS:
                total[key] += now.get(key, 0) - base[h.name].get(key, 0)
        print(f"{label}: fleet stats {sup.stats}; server states "
              f"{ {h.name: h.state for h in sup.servers.values()} }")
    finally:
        beat.set()
        if ticker.is_alive():
            ticker.join(timeout=60)
        sup.close()
    shutil.rmtree(root, ignore_errors=True)
    check(shm.stray_arenas() == [], "no arena file left after the fleet")

    # -- (4) the ungated serve step at full width ------------------------------
    from repro_torch.core.decomposition import edge_arch
    from repro_torch.launch.steps import EDGE_CACHE_LEN, make_serve_step
    from repro_torch.models import api as model_api
    step = make_serve_step(cfg_thr)
    stream = torch.as_tensor(toks, device=dev)
    for rep_i in range(2):   # a warm-up pass, then the timed pass
        server_cache = model_api.init_cache(cfg_thr, B, ML, dev)
        edge_cache = model_api.init_cache(edge_arch(cfg_thr), B,
                                          min(ML, EDGE_CACHE_LEN), dev)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masks, fhats, us = [], [], []
        for t in range(S if rep_i else 4):
            o = step(model, server_cache, edge_cache, stream[:, t], t)
            masks.append(o["mask"])
            fhats.append(o["fhat"])
            us.append(o["u"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = kernels.launch_counts()
    for key in SERVE_KERNELS:
        total[key] += counts[key]
    u = torch.stack(us, 1).cpu().numpy()
    fhat = torch.stack(fhats, 1).cpu().numpy()
    mask = torch.stack(masks, 1).cpu().numpy() > 0
    du = float(np.abs(u - sync["u"]).max())
    check(du <= TOL_E2E["bfloat16"], f"ungated step: u within 2e-2 of the "
          f"gated session's (the same edge tower and head; {du:.3e})")
    band = np.abs(sync["u"] - thr) <= TOL_E2E["bfloat16"]
    check(np.array_equal(mask[~band], sync["triggered"][~band]),
          "ungated step: the mask is the gated session's trigger trace "
          "outside the tie band")
    check((fhat <= u).all() and np.isfinite(fhat).all(),
          "ungated step: fhat <= u, finite")
    check(counts["monitor_combine"] == S, "ungated step: one monitor_combine "
          "launch a step")
    print(f"{label} ungated serve step (make_serve_step: the server decodes "
          f"every token): {B * S / dt:.1f} tokens/s, {dt / S * 1e3:.2f} "
          f"ms/step; launches per step "
          f"{ {k: counts[k] / S for k in SERVE_KERNELS} }; beside the gated "
          f"sync session's {sync_ms:.2f} ms/step and launches per step "
          f"{ {k: sync_counts[k] / S for k in SERVE_KERNELS} }; u max |diff| "
          f"from the session's {du:.3e}, {int(band.sum())} of {band.size} "
          "entries in the tie band")
    del model, step, server_cache, edge_cache
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    launcher_smoke(str(dev))
    print(f"{label}: this phase's main-path launches over every process "
          f"(the shm server's, the fleet servers' from their heartbeats, "
          f"the client's) {total}")
    return total


def launcher_smoke(dev: str) -> None:
    """The launchers as a user runs them on ``dev``, at SMOKE size:
    ``launch.serve --engine step``; ``--engine collab --transport shm``
    against ``launch.server --transport shm``; ``launch.fleet`` with a
    ``fleet:`` client; ``launch.train`` for LAUNCHER_TRAIN_STEPS steps with
    a checkpoint, on granite-8b and on zamba2-7b.  Each must exit 0 and
    print what the reference prints."""
    import os
    import shutil
    import signal
    from repro_torch.launch import server as launcher
    tmp = short_tmpdir("ls_")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    label = "[fleet-shm] launchers"

    def start(module, *argv):
        return subprocess.Popen(
            [sys.executable, "-m", f"repro_torch.launch.{module}", *argv,
             "--device", dev],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)

    def finish(proc, what, want, timeout=600):
        try:
            stdout, stderr = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate(timeout=30)
        check(proc.returncode == 0, f"{what} exits 0 (exit code "
              f"{proc.returncode}; {stderr[-1500:]})")
        for text in want:
            check(text in stdout, f"{what} prints {text!r}")
        tail = [x for x in stdout.splitlines() if x.strip()][-3:]
        print(f"{label}: {what}: exit 0; " + " | ".join(tail))
        return stdout

    uds, ready = os.path.join(tmp, "s.sock"), os.path.join(tmp, "ready")
    t0 = time.perf_counter()
    srv = launcher.spawn_subprocess(
        "granite-8b", uds=uds, slots=4, max_len=80, ready_file=ready,
        wait=False, extra_args=("--transport", "shm", "--idle-exit-s", "60",
                                "--device", dev))
    fleet_ready = os.path.join(tmp, "fleet.ready")
    fleet = start("fleet", "--arch", "granite-8b", "--n-servers", "2",
                  "--slots", "4", "--max-len", "80", "--root", tmp,
                  "--ready-file", fleet_ready, "--log-interval-s", "600")
    step = start("serve", "--arch", "granite-8b", "--engine", "step")
    trains = {arch: start("train", "--arch", arch, "--smoke", "--steps",
                          str(LAUNCHER_TRAIN_STEPS), "--batch", "2",
                          "--ckpt-dir", os.path.join(tmp, f"ck_{arch}"))
              for arch in ("granite-8b", "zamba2-7b")}
    try:
        finish(step, "launch.serve --engine step",
               ("64 steps x batch 4:", "ms/step", "trigger rate"))
        for arch, proc in trains.items():
            finish(proc, f"launch.train --arch {arch}",
                   (f"arch {arch}", "step     0  loss",
                    f"step     {LAUNCHER_TRAIN_STEPS - 1}  loss",
                    "checkpoint -> "))
            check(os.path.exists(os.path.join(tmp, f"ck_{arch}",
                                              "params.npz")),
                  f"launch.train --arch {arch} wrote its checkpoint")
        launcher.wait_ready(srv, ready, 600)
        finish(start("serve", "--arch", "granite-8b", "--engine", "collab",
                     "--mode", "async", "--transport", "shm", "--address",
                     uds, "--max-staleness", "2"),
               "launch.serve --engine collab --transport shm",
               ("async collab engine: 64 steps x batch 4:",
                "shm rings (measured):"))
        deadline = time.monotonic() + 600
        while not os.path.exists(fleet_ready):
            check(fleet.poll() is None and time.monotonic() < deadline,
                  "launch.fleet is up within 600 s")
            time.sleep(0.1)
        router = open(fleet_ready).read().strip()
        finish(start("serve", "--arch", "granite-8b", "--engine", "collab",
                     "--mode", "async", "--transport", "wire", "--address",
                     f"fleet:{router}"),
               "launch.serve over fleet:", ("wire (measured):",))
        fleet.send_signal(signal.SIGTERM)
        finish(fleet, "launch.fleet (SIGTERM)",
               ("fleet: all 2 servers ready", "fleet summary:"))
    finally:
        for proc in (srv, fleet, step, *trains.values()):
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"{label}: all exit 0 in {time.perf_counter() - t0:.1f} s")


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

    from repro_torch.configs import granite_8b, zamba2_7b
    from repro_torch.core.decomposition import edge_arch
    from repro_torch.nn.ssm import ssm_dims
    full, zfull = granite_8b.FULL, zamba2_7b.FULL
    ecfg = edge_arch(full)
    srv = (BATCH, full.n_heads, full.n_kv_heads, full.resolved_head_dim)
    edge = (BATCH, ecfg.n_heads, ecfg.n_kv_heads, ecfg.resolved_head_dim)
    shared = (BATCH, zfull.n_heads, zfull.n_kv_heads, zfull.resolved_head_dim)
    _, H, P, N = ssm_dims(zfull.d_model, zfull.ssm_expand, zfull.ssm_state)
    ssd_shape = (TRAIN_BATCH, TRAIN_SEQ, H, P, N, zfull.ssm_chunk)

    ecfg_train = edge_arch(full.replace(n_layers=TRAIN_LAYERS))
    flash_shapes = {
        "server": (TRAIN_BATCH, TRAIN_SEQ, full.n_heads, full.n_kv_heads,
                   full.resolved_head_dim, full.sliding_window),
        "edge": (TRAIN_BATCH, TRAIN_SEQ, ecfg_train.n_heads,
                 ecfg_train.n_kv_heads, ecfg_train.resolved_head_dim,
                 ecfg_train.sliding_window),
        # zamba2's shared attention block: 32/32 heads of 112, causal
        "zamba2 shared": (TRAIN_BATCH, TRAIN_SEQ, zfull.n_heads,
                          zfull.n_kv_heads, zfull.resolved_head_dim, 0)}

    lap = [time.perf_counter()]

    def took(name):
        now = time.perf_counter()
        print(f"[time] {name}: {now - lap[0]:.1f} s")
        lap[0] = now
    phase_build()
    took("build")
    records = phase_kernels(torch, dev, args.seed, MAX_LEN, srv, edge,
                            shared)
    records["flash_attention"] = phase_flash(torch, dev, args.seed,
                                             flash_shapes)
    records["ssd_scan"] = phase_ssd(torch, dev, args.seed, ssd_shape)
    gc.collect()
    torch.cuda.empty_cache()
    took("kernels")
    phase_small(torch, dev, args.seed)
    phase_small_train(torch, dev, args.seed)
    took("small")
    # launches on the main paths: each path's run counts from 0, and a
    # kernel's count is the sum over the paths that run it
    counts = dict.fromkeys(records, 0)
    for cfg in (full, zfull):
        run = phase_serve(torch, dev, args, cfg)
        for name in SERVE_KERNELS:
            counts[name] += run[name]
        gc.collect()  # the serve phase's model and sessions are gone
        torch.cuda.empty_cache()
    took("serve")
    for cfg, every_run in ((full, True), (zfull, False)):
        run = phase_async(torch, dev, args, cfg, every_run)
        for name in SERVE_KERNELS:
            counts[name] += run[name]
        gc.collect()
        torch.cuda.empty_cache()
    took("async")
    run = phase_wire(torch, dev, args, full)
    for name in SERVE_KERNELS:
        counts[name] += run[name]
    gc.collect()
    torch.cuda.empty_cache()
    took("serve-wire")
    run = phase_fleet_shm(torch, dev, args, full)
    for name in SERVE_KERNELS:
        counts[name] += run[name]
    gc.collect()
    torch.cuda.empty_cache()
    took("fleet-shm")
    for cfg, n_full, lr_witness in (
            (full.replace(n_layers=TRAIN_LAYERS), full.n_layers, True),
            (zfull.replace(n_layers=HYBRID_TRAIN_LAYERS), zfull.n_layers,
             False)):
        run = phase_train(torch, dev, args, cfg, n_full, lr_witness)
        for name in TRAIN_KERNELS:
            counts[name] += run[name]
        gc.collect()
        torch.cuda.empty_cache()
    took("train")
    phase_paper(torch, dev, args.seed, args.profile)
    took("paper")
    for cfg in (full, zfull):
        counts["decode_attention"] += phase_generate(
            torch, dev, args, cfg)["decode_attention"]
        gc.collect()
        torch.cuda.empty_cache()
    took("generate")
    for name, rec in records.items():
        check(counts[name] > 0, f"kernel {name} launched on a main path")
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
