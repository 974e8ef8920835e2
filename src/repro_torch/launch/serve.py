"""Serving launcher: batched collaborative monitoring over token streams.

Two engines:

  * the default serve step (``--engine step``): server decode and
    corrector, edge decode and monitor, the gated combine, for every token
    (``launch/steps.py::make_serve_step``, the ungated step the paper's
    gated loop is compared against).
  * ``--engine collab``: the trigger-gated collaborative engine, served
    through the ``MonitorSession`` API: one ``SessionConfig`` describes
    the mode (sync / async), the transport, the staleness and the address
    (``--transport``, ``--max-staleness``, ``--latency-ms``, ``--address``;
    ``shm`` and ``fleet:<router>`` addresses included).

Run:  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
          --device cpu --tokens 64 --batch 4
      PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
          --device cpu --engine collab --mode async --transport thread \\
          --latency-ms 20 --max-staleness 8

Without ``--device`` it runs on the card (and fails without one).
``--smoke`` is ``store_true`` with ``default=True``, as in the reference:
the command line always serves the SMOKE config.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import decomposition as deco
from repro_torch.data import tokens as tok
from repro_torch.launch.steps import EDGE_CACHE_LEN, make_serve_step
from repro_torch.models import api as model_api


def run_collab(args, cfg, params, device=None) -> None:
    """Trigger-gated collaborative serving through the MonitorSession API
    (sync or async, over any transport, the real wire included), on
    ``device`` (``None``: the card)."""
    from repro_torch.serving import SessionConfig, TransportSpec
    from repro_torch.serving.collaborative import CollaborativeEngine

    B, S = args.batch, args.tokens
    stream = next(tok.lm_batches(5, cfg, B, S))["tokens"]
    eng = CollaborativeEngine(params, cfg, batch=B, max_len=S + 8,
                              device=device)
    if args.transport in ("wire", "shm") and not args.address:
        raise SystemExit(f"--transport {args.transport} needs --address "
                         "(start: python -m repro_torch.launch.server)")
    latency_s = (None if args.latency_ms is None or args.transport in
                 ("inproc", "wire", "shm") else args.latency_ms * 1e-3)
    # one config describes the whole session: mode="sync" over the wire is
    # the strict max_staleness=0 boundary (every trigger pays the measured
    # round trip); plain sync uses the blocking in-process path
    spec = (TransportSpec(args.transport, address=args.address,
                          latency_s=latency_s)
            if (args.mode == "async" or args.transport in ("wire", "shm"))
            else TransportSpec())
    config = SessionConfig(mode=args.mode, transport=spec,
                           max_staleness=args.max_staleness,
                           trace=args.trace is not None)
    t0 = time.time()
    with eng.session(config) as session:
        res = session.run(stream)
        if args.trace is not None:
            n = session.export_trace(args.trace)
            print(f"trace: {n} spans -> {args.trace} "
                  "(load in Perfetto / chrome://tracing)")
            from repro_torch.observability.report import breakdown_table
            for line in breakdown_table(session.tracer.spans()):
                print(line)
    dt = (time.time() - t0) / S
    print(f"{args.mode} collab engine: {S} steps x batch {B}:  "
          f"{dt * 1e3:.1f} ms/step  ({B / dt:.1f} tok/s)")
    for b in range(B):
        print(f"  stream {b}: "
              + "".join("!" if x else "." for x in res["triggered"][b]))
    rep = res["comms"]
    print(f"trigger rate {rep['trigger_rate']:.3f}  |  "
          f"reduction {rep['reduction_x']:.1f}x")
    if "async" in rep:
        a = rep["async"]
        print(f"async: {a['requests']} requests, {a['merged_late']} merged "
              f"late, overlap {a['overlap_ratio']:.2f}, "
              f"stall {a['stall_s'] * 1e3:.0f} ms")
    if "wire" in rep:
        w = rep["wire"]
        print(f"wire (measured): {w['tx_bytes']:,}B tx / "
              f"{w['rx_bytes']:,}B rx, RTT mean "
              f"{w['rtt_mean_s'] * 1e3:.2f} ms / max "
              f"{w['rtt_max_s'] * 1e3:.2f} ms over {w['replies']} replies")
    if "shm" in rep:
        s = rep["shm"]
        print(f"shm rings (measured): {s['tx_bytes']:,}B tx / "
              f"{s['rx_bytes']:,}B rx, RTT mean "
              f"{s['rtt_mean_s'] * 1e3:.2f} ms / max "
              f"{s['rtt_max_s'] * 1e3:.2f} ms over {s['replies']} replies")


def run_step(args, cfg, params, device) -> np.ndarray:
    """The ungated serve step over ``args.tokens`` steps of a batch of
    ``args.batch`` streams; prints ms/step and the trigger traces and
    returns them ((B, tokens) bool).  The masks stay on the device until
    the end: one copy to the host."""
    B, cap = args.batch, args.tokens + 8
    ecfg = deco.edge_arch(cfg)
    server_cache = model_api.init_cache(cfg, B, cap, device)
    edge_cache = model_api.init_cache(ecfg, B, min(cap, EDGE_CACHE_LEN),
                                      device)
    serve_step = make_serve_step(cfg)
    stream = torch.as_tensor(
        next(tok.lm_batches(5, cfg, B, args.tokens))["tokens"],
        device=device)
    masks = []
    t0 = time.time()
    for t in range(args.tokens):
        out = serve_step(params, server_cache, edge_cache, stream[:, t], t)
        server_cache, edge_cache = out["server_cache"], out["edge_cache"]
        masks.append(out["mask"])
    trig = (torch.stack(masks, 1) > 0).cpu().numpy()
    dt = (time.time() - t0) / args.tokens
    print(f"{args.tokens} steps x batch {B}:  {dt*1e3:.1f} ms/step  "
          f"({B/dt:.1f} tok/s)")
    for b in range(B):
        print(f"  stream {b}: " + "".join("!" if x else "." for x in trig[b]))
    print(f"trigger rate {trig.mean():.3f}")
    return trig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.names())
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--engine", choices=("step", "collab"), default="step")
    ap.add_argument("--mode", choices=("sync", "async"), default="sync")
    ap.add_argument("--transport", default="stream",
                    choices=("inproc", "stream", "thread", "mock_remote",
                             "wire", "shm"))
    ap.add_argument("--address", default=None,
                    help="wire/shm transport: correction server UDS path "
                         "or host:port (python -m repro_torch.launch."
                         "server; shm needs a UDS on the same host), or "
                         "fleet:<router> (python -m repro_torch.launch."
                         "fleet)")
    ap.add_argument("--max-staleness", type=int, default=8)
    ap.add_argument("--latency-ms", type=float, default=None,
                    help="simulated RTT; default keeps the transport's own")
    ap.add_argument("--mesh", default=None, metavar="SPEC",
                    help="collab engine only: mesh-sharded per-stream "
                         "state; not ported yet (raises)")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="collab engine only: trace the session "
                         "(SessionConfig(trace=True)) and export Perfetto "
                         "JSON to FILE, printing the critical-path "
                         "breakdown")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "on the host)")
    args = ap.parse_args(argv)
    if args.trace is not None and args.engine != "collab":
        ap.error("--trace serves the collab engine (use --engine collab)")
    if args.mesh is not None:
        if args.engine != "collab":
            ap.error("--mesh serves the collab engine (use --engine collab)")
        from repro_torch.serving.api import _later
        raise _later("mesh-sharded serving", "8 (mesh + analysis)")

    from repro_torch.core.decomposition import init_collab_lm
    from repro_torch.nn.module import resolve_device

    dev = resolve_device(args.device)
    cfg = (registry.get_smoke(args.arch) if args.smoke
           else registry.get_full(args.arch))
    params = init_collab_lm(cfg, torch.Generator(dev).manual_seed(0), dev)
    if args.ckpt_dir:
        from repro_torch.training import checkpoint
        checkpoint.load(args.ckpt_dir, params)
        print(f"restored {args.ckpt_dir}")

    if args.engine == "collab":
        run_collab(args, cfg, params, dev)
        return
    run_step(args, cfg, params, dev)


if __name__ == "__main__":
    main()
