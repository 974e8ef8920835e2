"""The training step: ``make_train_step`` with ``AdamW`` on the seeded
collaborative model, fresh batches every step.

Set-up builds the one step object (model, optimizer state, step) and
drives it from the seed through the checked steps, which warm it up too,
reading each step's loss, each leaf's first gradient from the optimizer's
first moment after step 1 (m = (1 - b1) g), and after the last checked
step each leaf's change from its seeded value (its f32 master where it
has one).  The window runs the same object on for ``seconds`` and ends in
a synchronize; then, traced, a short profiled sub-window.  The check
frees the program and runs the reference's checked steps on the same
batches."""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch

from portbench import counts, judge, port, profiling, spec, traffic, weights
from portbench.reference import train as ref_train


def _to_device(batch: dict, dev) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if dev.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(dev, non_blocking=True)
    return out


def _deltas(model, state, seed: int, p: dict) -> Dict[str, float]:
    """Each leaf's |w - w0|: the f32 master where there is one."""
    named = list(model.named_parameters())
    idx = {n: i for i, (n, _) in enumerate(named)}
    out = {}
    with torch.no_grad():
        for g, leaves in spec.groups(p).items():
            dev = named[idx[leaves[0][0]]][1].device
            w0 = weights.draw_group(seed, g, leaves, p, dev)
            for name, x in w0.items():
                i = idx[name]
                w = state.master[i] if state.master[i] is not None \
                    else named[i][1]
                out[name] = float((w.float() - x.float()).norm())
    return out


def run(ctx) -> dict:
    from repro_torch import kernels
    from repro_torch.training.loop import make_train_step, trainable
    from repro_torch.training.optimizer import AdamW, keeps_masters
    p, mix, dev, seed = ctx.p, ctx.mix, ctx.device, ctx.seed
    B, S, o = mix["batch"], mix["seq"], mix["optimizer"]
    cfg, model = port.collab_model(p, seed, dev)
    params = trainable(model)
    names = [n for n, _ in model.named_parameters()]
    opt = AdamW(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                weight_decay=o["weight_decay"], clip_norm=o["clip_norm"])
    state = opt.init(params, masters=keeps_masters(cfg))
    step = make_train_step(cfg, opt, **mix["loss"])
    batches = traffic.lm_batches(seed, p["vocab_size"], B, S, mix["data"])
    checked, prog = [], {"losses": []}
    for i in range(mix["checked_steps"]):
        b = next(batches)
        checked.append(b)
        parts = step(model, state, _to_device(b, dev))
        prog["losses"].append({k: float(v) for k, v in parts.items()})
        if i == 0:
            # m = (1 - b1) * scale * g after one step, scale the clip
            norms = torch.stack(torch._foreach_norm(state.m, 2))
            g = norms / (1.0 - o["b1"])
            gn = float(parts["grad_norm"])
            scale = min(1.0, o["clip_norm"] / gn) if o["clip_norm"] else 1.0
            prog["first_grad"] = dict(zip(names, g.tolist()))
            prog["first_grad_raw"] = dict(zip(names, (g / scale).tolist()))
    prog["delta"] = _deltas(model, state, seed, p)
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start
    ctx.reset_peak()
    n = 0
    t0 = time.perf_counter()
    while True:
        step(model, state, _to_device(next(batches), dev))
        n += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    ctx.sync()
    window_s = time.perf_counter() - t0
    peak = ctx.peak()
    out = {"attempted": n, "failed": 0, "memory_peak_bytes": peak,
           "metrics": {"setup_s": setup_s,
                       "train_tokens_per_s": n * B * S / window_s},
           "diag": {"setup_s": setup_s, "window_s": window_s, "steps": n,
                    "losses": [x["total"] for x in prog["losses"]]}}
    if ctx.trace:
        # what the per-layer readers read
        run_ = SimpleNamespace(p=p, mix=mix, peak_bytes=peak)
        run_.window_s, run_.steps = window_s, n
        run_.step_flops = counts.train_flops(p, B, S)

        def steps(k):
            for _ in range(k):
                step(model, state, _to_device(next(batches), dev))

        prof = profiling.trace_steps(torch, steps, mix["profile_steps"],
                                     kernels.launch_counts)
        run_.profile = prof
        out["run"] = run_
    del model, state, params, step, opt
    gc.collect()
    ctx.free()
    t1 = time.perf_counter()
    ref = ref_train.run(seed, p, checked, o, mix["loss"], ctx.device)
    out["numbers"] = judge.train_numbers(prog, ref)
    out["diag"]["ref_losses"] = [x["total"] for x in ref["losses"]]
    keep = list(ref["first_grad"])
    for key in ("first_grad", "delta"):
        gaps = judge.leaf_gaps(prog[key], ref[key], keep)
        worst = sorted(gaps, key=gaps.get)[-3:]
        out["diag"][f"worst_{key}"] = [
            (k, gaps[k], prog[key][k], ref[key][k]) for k in worst]
    out["diag"]["check_s"] = time.perf_counter() - t1
    if ctx.control:
        # the reference in float8 in the program's place, and the
        # reference fed half of each batch (the mean over the rest)
        half = [{k: v[:B // 2] for k, v in b.items()} for b in checked]
        for name, batches_, prec in (("control", checked, "fp8"),
                                     ("half_batch", half, "f32")):
            gc.collect()
            ctx.free()
            other = ref_train.run(seed, p, batches_, o, mix["loss"],
                                  ctx.device, prec)
            ctx.readings[name] = judge.train_numbers(other, ref)
    return out
