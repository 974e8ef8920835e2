"""Static verifier of the port's serving stack: every ``analysis`` rule
against every registered arch, printed as a report table.

* ``sign-safety``: interval/sign certificates over exported graphs,
  ``corr >= 0`` and ``fhat <= u`` on the training forward AND the
  serving catch-up, per arch x sigma kind (a counterexample chain on
  failure);
* ``collective-free`` / ``no-host-transfer`` / ``no-dynamic-shapes``:
  per-node rules over each arch's exported monitor path;
* ``recompile-once``: a guarded churn episode on the paper serving
  config (no path sees a new call signature after warmup);
* the mutation self-test: one seeded violation per rule (sign flips, an
  injected all_reduce, an ``.item()``, a symbolic size, a new signature),
  each of which must fire.

Usage::

    python -m repro_torch.analysis [--strict] [--arch NAME ...]
        [--no-selftest] [--no-recompile] [--verbose] [--device cpu|cuda]

Models are SMOKE size: the certificates' on the meta device (no
memory), the graph rules' and the churn episode's from seeded weights on
``--device`` (the card by default).  ``--strict`` exits nonzero on any failed rule or non-firing
mutation.
"""
from __future__ import annotations

import argparse
import sys
import time


def _parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--strict", action="store_true",
                    help="exit nonzero on any failure")
    ap.add_argument("--arch", nargs="*", default=None,
                    help="restrict to these registry archs")
    ap.add_argument("--no-selftest", action="store_true",
                    help="skip the mutation self-test")
    ap.add_argument("--no-recompile", action="store_true",
                    help="skip the churn signature guard")
    ap.add_argument("--verbose", action="store_true",
                    help="print rule details even on pass")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse_args(argv)
    from repro_torch.analysis import rules
    from repro_torch.nn.module import resolve_device
    device = resolve_device(args.device)

    t0 = time.time()
    results = []
    results += rules.run_sign_rules(args.arch)
    results += rules.run_graph_rules(args.arch, device=device)
    if not args.no_recompile:
        results += rules.run_recompile_rule(device=device)
    if not args.no_selftest:
        selftest = rules.mutation_selftest()
        for r in selftest:
            r.rule = "selftest/" + r.rule
        results += selftest

    print(rules.format_report(results, verbose=args.verbose))
    print(f"({time.time() - t0:.1f}s)")
    n_fail = sum(not r.ok for r in results)
    if n_fail and args.strict:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
