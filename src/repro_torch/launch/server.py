"""Correction-server launcher: run the server half of the collaborative
protocol as its own process (``serving/server.py``), listening on a
Unix-domain or TCP socket for ``wire`` sessions of either package.

Client and server must agree on the model: both build the same config
and the same seeded init (the port's ``init_collab_lm`` from
``torch.Generator(device).manual_seed(0)``, on the same device type), or
both restore the same checkpoint (``--ckpt-dir``, in the JAX package's
layout, so a JAX client and this server share one).  Parameters never
cross the wire, only protocol bytes do.  The ready file holds the
server's address and a digest of its weights (``weights_digest``), so a
client can check the agreement.

Run:  PYTHONPATH=src python -m repro_torch.launch.server \\
          --arch paper-synthetic-serving --device cpu \\
          --uds /tmp/corr.sock --slots 16 --max-len 128

then serve against it with
``SessionConfig(mode="async", transport="wire:/tmp/corr.sock")``.
Without ``--device`` the server runs on the card, and raises without one.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import signal
import sys
import threading
import time
from typing import Optional, Tuple

import torch

from repro_torch.configs import registry


def resolve_config(name: str, smoke: bool = True):
    """Registry archs plus the paper-synthetic serving preset (which lives
    outside the registry)."""
    if name == "paper-synthetic-serving":
        from repro_torch.configs.paper_synthetic import SERVING
        return SERVING
    return registry.get_smoke(name) if smoke else registry.get_full(name)


def config_names():
    return registry.names() + ["paper-synthetic-serving"]


def weights_digest(model) -> str:
    """A digest of the first 256 values of every parameter (f32, in the
    module's parameter order): equal digests mean two processes built the
    same weights.  One copy to the host."""
    head = torch.cat([p.detach().reshape(-1)[:256].float()
                      for p in model.parameters()])
    return hashlib.sha256(head.cpu().numpy().tobytes()).hexdigest()[:16]


def write_ready(path: str, address: str, digest: str) -> None:
    """The ready file, written atomically: the address, then the weights'
    digest."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        fh.write(f"{address}\nweights {digest}\n")
    os.replace(tmp, path)


def read_ready(path: str) -> Tuple[str, str]:
    """(address, weights digest) from a ready file."""
    address, weights = open(path).read().splitlines()[:2]
    return address, weights.split()[1]


def spawn_subprocess(arch: str, *, uds: Optional[str], slots: int,
                     max_len: int,
                     ready_file: str, ckpt_dir: Optional[str] = None,
                     extra_args: Tuple[str, ...] = (), quiet: bool = True,
                     timeout_s: Optional[float] = None,
                     wait: bool = True) -> "subprocess.Popen":
    """Start ``python -m repro_torch.launch.server`` as a subprocess and
    block until it is listening (the ready file appears) or ``timeout_s``
    passes (``None``: ``REPRO_SPAWN_DEADLINE_S``, default 240 s).
    ``uds=None`` listens on an ephemeral TCP port instead (the ready file
    names it).  Pass ``--device`` in ``extra_args`` to run it elsewhere
    than the card.  ``wait=False`` returns the Popen at once (see
    ``wait_ready``)."""
    import subprocess

    if timeout_s is None:
        timeout_s = float(os.environ.get("REPRO_SPAWN_DEADLINE_S", "240"))
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "repro_torch.launch.server", "--arch", arch,
           *(("--uds", uds) if uds is not None else ("--port", "0")),
           "--slots", str(slots), "--max-len", str(max_len),
           "--ready-file", ready_file]
    if ckpt_dir:
        cmd += ["--ckpt-dir", ckpt_dir]
    cmd += list(extra_args)
    pipe = subprocess.PIPE if quiet else None
    proc = subprocess.Popen(cmd, env=env, stdout=pipe, stderr=pipe,
                            text=quiet or None)
    if wait:
        wait_ready(proc, ready_file, timeout_s, quiet=quiet)
    return proc


def wait_ready(proc: "subprocess.Popen", ready_file: str,
               timeout_s: float, *, quiet: bool = True) -> None:
    """Block until ``ready_file`` exists, or raise when the process dies
    or the time runs out (the process is then terminated)."""
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(ready_file):
        if proc.poll() is not None:
            err = proc.stderr.read()[-2000:] if quiet else ""
            raise RuntimeError(f"correction server died: {err}")
        if time.monotonic() > deadline:
            proc.terminate()
            raise RuntimeError("correction server startup timed out")
        time.sleep(0.05)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=config_names())
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--uds", default=None, help="Unix-domain socket path")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=None,
                    help="TCP port (0 = ephemeral); default is UDS")
    ap.add_argument("--slots", type=int, default=16,
                    help="super-batch rows leased to client sessions")
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--no-coalesce", action="store_true",
                    help="disable request coalescing server-wide "
                         "(per-request replays)")
    ap.add_argument("--transport", choices=("wire", "shm"), default="wire",
                    help="'shm' (shared-memory rings) is not ported yet: "
                         "the server raises")
    ap.add_argument("--mesh", default=None, metavar="SPEC",
                    help="a mesh-sharded super-batch; not ported yet: the "
                         "server raises")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore weights from a checkpoint in the JAX "
                         "package's layout")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "on the host)")
    ap.add_argument("--ready-file", default=None,
                    help="write the address and the weights' digest here "
                         "once listening (subprocess sync)")
    ap.add_argument("--idle-exit-s", type=float, default=None,
                    help="exit after all sessions have been gone this long")
    ap.add_argument("--stats-file", default=None,
                    help="heartbeat: rewrite this JSON file with a stats "
                         "snapshot every --stats-interval-s")
    ap.add_argument("--stats-interval-s", type=float, default=0.5)
    ap.add_argument("--trace-file", default=None,
                    help="record server-side spans (queue wait, replay) "
                         "and export Perfetto JSON here on shutdown")
    args = ap.parse_args(argv)

    if (args.uds is None) == (args.port is None):
        ap.error("exactly one of --uds / --port is required")

    from repro_torch.core.decomposition import init_collab_lm
    from repro_torch.nn.module import resolve_device
    from repro_torch.serving.server import CorrectionServer
    from repro_torch.serving.tracker import JsonFileTracker

    dev = resolve_device(args.device)
    cfg = resolve_config(args.arch, args.smoke)
    params = init_collab_lm(cfg, torch.Generator(dev).manual_seed(0), dev)
    if args.ckpt_dir:
        from repro_torch.training import checkpoint
        checkpoint.load(args.ckpt_dir, params)
        print(f"restored {args.ckpt_dir}", flush=True)
    tracker = (JsonFileTracker(args.stats_file)
               if args.stats_file else None)
    tracer = None
    if args.trace_file:
        from repro_torch.observability import Tracer
        tracer = Tracer()
    srv = CorrectionServer(cfg, params, slots=args.slots,
                           max_len=args.max_len, uds=args.uds,
                           host=args.host,
                           port=args.port if args.port is not None else 0,
                           coalesce=not args.no_coalesce, mesh=args.mesh,
                           tracker=tracker, tracer=tracer,
                           stats_interval_s=args.stats_interval_s,
                           shm=args.transport == "shm", device=dev)
    print(f"correction server: arch={args.arch} slots={args.slots} "
          f"max_len={args.max_len} coalesce={not args.no_coalesce} "
          f"device={dev} listening on {srv.address}", flush=True)
    if args.ready_file:
        write_ready(args.ready_file, srv.address, weights_digest(params))

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except ValueError:
            pass  # not the main thread
    try:
        # SIGUSR1 = drain: GOAWAY the sessions, refuse new HELLOs, exit
        # once empty
        signal.signal(signal.SIGUSR1, lambda *_: srv.request_drain())
    except (ValueError, AttributeError):
        pass
    try:
        srv.serve_forever(stop=stop, idle_exit_s=args.idle_exit_s)
    finally:
        st = srv.stats
        if tracker is not None:
            tracker.log_summary(srv.stats_snapshot())
        if tracer is not None:
            n = tracer.export(args.trace_file)
            print(f"trace: {n} spans -> {args.trace_file}", flush=True)
        print(f"served {st['sessions']} sessions, {st['requests']} requests "
              f"in {st['replays']} replays ({st['coalesced']} coalesced), "
              f"{st['attaches']} attaches / {st['detaches']} detaches, "
              f"{st['defrags']} lease defrags "
              f"(lease_fragmentation={srv.fragmentation():.3f}), "
              f"rx {st['bytes_rx']:,}B tx {st['bytes_tx']:,}B", flush=True)
        srv.close()


if __name__ == "__main__":
    main()
