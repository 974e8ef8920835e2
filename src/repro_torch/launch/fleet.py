"""Fleet launcher: run a supervised fleet of correction servers behind a
least-loaded router (``serving/fleet.py``).

The supervisor spawns N ``repro_torch.launch.server`` subprocesses (each
with a JSON heartbeat file), opens the routing endpoint, and then loops:
route HELLOs to the least-loaded live server, scrape heartbeats, reap
dead servers (respawning unless ``--no-respawn``), retire drained ones.

Run:  PYTHONPATH=src python -m repro_torch.launch.fleet \\
          --arch paper-synthetic-serving --device cpu --n-servers 2 \\
          --slots 64 --max-len 64 --router-uds /tmp/fleet.sock

then point clients at the router with a ``fleet:`` address:

      TransportSpec.parse("fleet:/tmp/fleet.sock")

Without ``--device`` the servers run on the card (and fail without one).

Signals: SIGTERM/SIGINT shut the fleet down (servers terminated, a final
aggregated summary printed); SIGUSR1 drains server 0, to exercise a
failover by hand.
"""
from __future__ import annotations

import argparse
import json
import signal
import threading
import time


def main(argv=None) -> None:
    from repro_torch.launch.server import config_names
    from repro_torch.serving.fleet import FleetSupervisor
    from repro_torch.serving.tracker import LogTracker

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=config_names())
    ap.add_argument("--n-servers", type=int, default=2)
    ap.add_argument("--slots", type=int, default=16,
                    help="super-batch rows per server")
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--root", default=None,
                    help="directory for per-server sockets/heartbeats "
                         "(default: a fresh tempdir)")
    ap.add_argument("--router-uds", default=None,
                    help="router listen path (default <root>/router.sock)")
    ap.add_argument("--router-port", type=int, default=None,
                    help="TCP router instead of UDS (0 = ephemeral)")
    ap.add_argument("--heartbeat-timeout-s", type=float, default=5.0)
    ap.add_argument("--no-respawn", action="store_true",
                    help="do not replace dead servers")
    ap.add_argument("--no-coalesce", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="the servers' torch device (default: the card; "
                         "'cpu' to run on the host)")
    ap.add_argument("--ready-file", default=None,
                    help="write the router address here once every "
                         "server is up (subprocess sync)")
    ap.add_argument("--log-interval-s", type=float, default=5.0,
                    help="aggregated fleet summary print interval")
    args = ap.parse_args(argv)

    sup = FleetSupervisor(
        args.arch, n_servers=args.n_servers, slots=args.slots,
        max_len=args.max_len, backend="subprocess", root=args.root,
        router_uds=args.router_uds, router_port=args.router_port,
        heartbeat_timeout_s=args.heartbeat_timeout_s,
        respawn=not args.no_respawn, ckpt_dir=args.ckpt_dir,
        coalesce=not args.no_coalesce, device=args.device)
    print(f"fleet: {args.n_servers} x {args.arch} (slots={args.slots}) "
          f"router on {sup.router_address} — waiting for servers",
          flush=True)
    sup.start(wait=True)
    print(f"fleet: all {args.n_servers} servers ready", flush=True)
    if args.ready_file:
        with open(args.ready_file, "w") as fh:
            fh.write(sup.router_address + "\n")

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except ValueError:
            pass
    try:
        signal.signal(signal.SIGUSR1,
                      lambda *_: sup.drain(next(iter(sup.servers))))
    except (ValueError, AttributeError):
        pass

    log = LogTracker(prefix="fleet")
    last = 0.0
    try:
        while not stop.is_set():
            sup.tick(0.05)
            now = time.monotonic()
            if now - last >= args.log_interval_s:
                last = now
                agg = sup.aggregate()
                log.log({"n_live": agg["totals"].get("n_live"),
                         "routed": agg["totals"].get("routed"),
                         "leased_rows": agg["totals"].get("leased_rows", 0),
                         "respawns": agg["totals"].get("respawns"),
                         # fleet-wide worst-case latency percentiles (max
                         # over live servers; None until observed)
                         "replay_s_p99": agg["totals"].get("replay_s_p99"),
                         "queue_wait_s_p99":
                             agg["totals"].get("queue_wait_s_p99")})
    finally:
        agg = sup.aggregate()
        sup.close()
        print("fleet summary: " + json.dumps(agg["totals"], default=str),
              flush=True)


if __name__ == "__main__":
    main()
