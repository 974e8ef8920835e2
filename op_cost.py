#!/usr/bin/env python3
"""Time the kernels' registered ops against the direct kernel wrappers on
one card.

The four kernels are ``torch.library.custom_op``s (``kernels/ops.py``):
a call goes through torch's dispatcher to the kernel's wrapper.  This
script measures what that dispatch costs, two ways, in one process:

- granite-8b FULL's sync serve cell (``chip_smoke.phase_serve``'s:
  B = 8, a 512-token cache, 32 steps, the threshold calibrated to the
  paper's trigger rate) timed with the call sites going through the
  custom ops, straight to the wrappers, through ops registered with the
  lower-level ``torch.library.Library`` define/impl, and through the
  custom ops with the signature notes off (``analysis/recompile.py``);
  three rounds, interleaved; every run bitwise the first;
- the host time of one call of decode_attention (granite's server
  shape) and monitor_combine (N = 8) each way, 400 calls queued behind a
  sleep kernel, the median of three.

    python3 op_cost.py

Needs one CUDA card; run from the repository's root.
"""
import sys
import time

import numpy as np

sys.path.insert(0, "src")
sys.path.insert(0, ".")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("op_cost: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as c
    from repro_torch import kernels
    from repro_torch.analysis import recompile
    from repro_torch.configs import granite_8b
    from repro_torch.configs.paper_synthetic import SERVING_TRIGGER_RATE
    from repro_torch.core.decomposition import init_collab_lm
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.monitor_combine import monitor_combine_cuda
    from repro_torch.serving import MonitorSession, SessionConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    c.phase_build()

    def combine(u, v, f, s, t, m):
        return monitor_combine_cuda(u, v, f, s=s, threshold=t, margin=m)
    lib = torch.library.Library("repro_torch_cost", "DEF")
    lib.define("decode_attention(Tensor q, Tensor k, Tensor v, Tensor pos)"
               " -> Tensor")
    lib.define("monitor_combine(Tensor u, Tensor v, Tensor f, float s, "
               "float threshold, float margin) -> (Tensor, Tensor, Tensor)")
    lib.impl("decode_attention", decode_attention_cuda, "CUDA")
    lib.impl("monitor_combine", combine, "CUDA")
    variants = {
        "custom_op": (ops._decode, ops._combine),
        "direct": (decode_attention_cuda, combine),
        "library": (torch.ops.repro_torch_cost.decode_attention.default,
                    torch.ops.repro_torch_cost.monitor_combine.default)}
    note = recompile.SignaturePath.note

    cfg = granite_8b.FULL
    model = init_collab_lm(cfg, torch.Generator(dev).manual_seed(0), dev)
    B, ML, S = c.BATCH, c.MAX_LEN, c.STEPS
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))

    def session(mode, **kw):
        return MonitorSession.open(model, cfg, batch=B, max_len=ML,
                                   device=dev,
                                   config=SessionConfig(mode=mode, **kw))
    probe = session("scan").run(toks)
    thr = float(np.quantile(probe["u"], 1.0 - SERVING_TRIGGER_RATE))
    conf = dict(threshold=thr, trigger_margin=0.0)
    session("sync", **conf).run(toks[:, :4])   # warm-up
    res, ref = {}, None
    try:
        for _ in range(3):
            for name in ("custom_op", "direct", "library",
                         "custom_op_nonote"):
                ops._decode, ops._combine = variants[
                    name.replace("_nonote", "")]
                recompile.SignaturePath.note = (
                    (lambda self, *a, **k: None)
                    if name.endswith("nonote") else note)
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                r = session("sync", **conf).run(toks)
                torch.cuda.synchronize()
                res.setdefault(name, []).append(
                    (time.perf_counter() - t0) / S * 1e3)
                ref = r if ref is None else ref
                c.check(all(np.array_equal(r[k], ref[k])
                            for k in ("u", "fhat", "triggered")),
                        f"{name} run bitwise the first")
    finally:
        ops._decode, ops._combine = variants["custom_op"]
        recompile.SignaturePath.note = note
    launched = kernels.launch_counts()
    for name, xs in res.items():
        print(f"[cost] granite-8b sync {name}: "
              f"{[round(x, 2) for x in xs]} ms/step, median "
              f"{np.median(xs):.2f}; launches {launched}")

    g = torch.Generator(dev).manual_seed(0)
    D = cfg.resolved_head_dim
    q = torch.randn((B, cfg.n_heads, D), device=dev, generator=g,
                    dtype=torch.bfloat16)
    kc, vc = (torch.randn((B, ML, cfg.n_kv_heads, D), device=dev,
                          generator=g, dtype=torch.bfloat16)
              for _ in range(2))
    pos = torch.full((B,), ML - 1, dtype=torch.int32, device=dev)
    u = torch.randn(B, device=dev, generator=g)
    with torch.inference_mode():
        for name, (dec, cmb) in variants.items():
            for label, fn in (("decode", lambda: dec(q, kc, vc, pos)),
                              ("combine",
                               lambda: cmb(u, u, u, 0.2, 0.0, 0.25))):
                xs = []
                for _ in range(3):
                    fn()
                    torch.cuda.synchronize()
                    torch.cuda._sleep(200_000_000)  # calls only queue
                    t0 = time.perf_counter()
                    for _ in range(400):
                        fn()
                    xs.append((time.perf_counter() - t0) / 400 * 1e6)
                    torch.cuda.synchronize()
                print(f"[cost] {label} via {name}: {np.median(xs):.2f} "
                      f"us/call host ({[round(x, 2) for x in xs]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
