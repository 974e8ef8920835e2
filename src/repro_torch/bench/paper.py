"""The paper's own experiments on the port: Fig 2 (loss / FN / FP /
corrected-FP over the (n, s) grid on the §4.1 synthetic data), Fig 3
(approximation error against the corrector scale s, with the theory's
s ~ rho^n/(1-rho)), Fig 4 (the §4.2 financial monitor: FN, on-device
size and communication reduction for the truncate-16 and FC(29,10,1)
monitors) and the quickstart (Prop-2 calibration, FN ~ 0).  Same
constants, seeds and row fields as the JAX package's
``benchmarks/bench_paper_fig{2,3,4}.py`` and ``examples/quickstart.py``;
the second field of a row is the wall time per train step in µs.

    python -m repro_torch.bench.paper [--fig 2|3|4|quickstart] [--device cpu]

Without ``--device`` it runs on the card (and raises without one).
"""
from __future__ import annotations

import argparse
import time
from typing import List

import numpy as np
import torch

from repro_torch.configs.paper_financial import FULL as FIN
from repro_torch.configs.paper_synthetic import FULL as SYN
from repro_torch.core import safety, theory
from repro_torch.core.gating import CommsMeter, trigger_mask
from repro_torch.data.synthetic import (financial_series, financial_xy,
                                        paper_synthetic, synthetic_residual)
from repro_torch.nn.module import resolve_device
from repro_torch.training.loop import train_paper

# Fig 2
N_GRID = (2, 6, 12, 24)
S_GRID = (0.05, 0.2, 0.5, 1.5)
N_MODES = 48  # the 100-mode target truncated as in the reference; rho matches
EPS = 0.05
STEPS = 900
# Fig 3
N_LIST = (6, 10, 14)
S_SWEEP = (0.01, 0.05, 0.1, 0.3, 0.8, 2.0)
FIG3_STEPS = 700
# Fig 4
FIG4_STEPS = 2500


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_train(device, seed: int, *args, steps: int, **kw):
    """train_paper from a generator seeded ``seed`` on ``device``:
    (model, result, µs per step)."""
    gen = torch.Generator(device).manual_seed(seed)
    _sync(device)
    t0 = time.perf_counter()
    model, res = train_paper(gen, *args, steps=steps, device=device, **kw)
    _sync(device)
    return model, res, (time.perf_counter() - t0) * 1e6 / steps


def fig2(csv: List[str], device) -> None:
    x, f = paper_synthetic(0, 4096, rho=SYN.rho, n_modes=N_MODES)
    fd = torch.as_tensor(f, device=device)
    for n in N_GRID:
        t = theory.t_of_n_sampled(
            lambda z: synthetic_residual(z, n, rho=SYN.rho, n_modes=N_MODES),
            x)
        for s in S_GRID:
            _, res, wall = _timed_train(device, 0, SYN, x, f, u_mode="cosine",
                                        n_modes=N_MODES, monitor_n=n, s=s,
                                        freeze_t=t, steps=STEPS, lr=5e-3)
            out = res["out"]
            rep = safety.metrics_report(fd, out["u"], out["fhat"], eps=EPS)
            csv.append(
                f"paper_fig2/n={n}/s={s},{wall:.1f},"
                f"l2={float(rep['l2']):.4f};fn={float(rep['fn']):.4f};"
                f"fp={float(rep['fp']):.4f};"
                f"corr_fp={float(rep['corrected_fp']):.4f};"
                f"t={t:.4f};s_rule={theory.s_rule(t):.4f}")
            print(csv[-1], flush=True)


def fig3(csv: List[str], device) -> None:
    x, f = paper_synthetic(1, 4096, rho=SYN.rho, n_modes=N_MODES)
    fd = torch.as_tensor(f, device=device)
    for n in N_LIST:
        s_theory = theory.exp_decay_s(SYN.rho, n)
        t = theory.t_of_n_sampled(
            lambda z: synthetic_residual(z, n, rho=SYN.rho, n_modes=N_MODES),
            x)
        errs = {}
        for s in sorted(set(S_SWEEP + (round(s_theory, 4),))):
            _, res, wall = _timed_train(device, 1, SYN, x, f, u_mode="cosine",
                                        n_modes=N_MODES, monitor_n=n, s=s,
                                        freeze_t=t, steps=FIG3_STEPS, lr=5e-3)
            errs[s] = float(safety.approx_error(fd, res["out"]["fhat"], 2.0))
            csv.append(f"paper_fig3/n={n}/s={s},{wall:.1f},l2={errs[s]:.4f};"
                       f"s_theory={s_theory:.4f}")
            print(csv[-1], flush=True)
        best = min(errs, key=errs.get)
        csv.append(f"paper_fig3/n={n}/summary,0.0,"
                   f"best_s={best};theory_s={s_theory:.4f};"
                   f"err_at_theory={errs[round(s_theory, 4)]:.4f};"
                   f"err_best={errs[best]:.4f}")
        print(csv[-1], flush=True)


def mlp_params(dims) -> int:
    return sum(dims[i] * dims[i + 1] + dims[i + 1]
               for i in range(len(dims) - 1))


FIG4_MONITORS = (("truncated", {}, "truncate-16"),
                 ("independent", {"u_dims": (29, 10, 1)}, "FC(29,10,1)"))


def fig4_run(device, mode: str, kw, seed: int = 2):
    """One Fig-4 monitor: (report, on-device size ratio V/U, comms meter,
    µs per step, the model's outputs on the whole panel)."""
    x, f = financial_xy(financial_series(0))
    thr, margin = FIN.threshold, 0.05
    model, res, wall = _timed_train(device, seed, FIN, x, f, u_mode=mode,
                                    steps=FIG4_STEPS, lr=2e-3,
                                    safety_weight=20.0, **kw)
    out = res["out"]
    rep = safety.metrics_report(torch.as_tensor(f, device=device), out["u"],
                                out["fhat"], eps=0.01, threshold=thr)
    # on-device size: the monitor head (or u_net) against the server net V
    v_size = sum(p.numel() for p in model.v.parameters())
    if mode == "truncated":
        u_size = FIN.monitor_n + 1 + mlp_params(
            (FIN.in_dim,) + tuple(FIN.hidden[:-1]) + (FIN.monitor_n,))
    else:
        u_size = sum(p.numel() for p in model.u_net.parameters()) + 1
    # communication: the server is consulted only when u > thr - margin
    mask = trigger_mask(out["u"], thr, margin).cpu().numpy()
    meter = CommsMeter(bytes_per_request=29 * 4)
    meter.update(int(mask.sum()), mask.size)
    return rep, v_size / u_size, meter, wall, out


def fig4(csv: List[str], device) -> None:
    for mode, kw, udesc in FIG4_MONITORS:
        rep, ratio, meter, wall, _ = fig4_run(device, mode, kw)
        csv.append(
            f"paper_fig4/{udesc},{wall:.1f},"
            f"l2={float(rep['l2']):.5f};fn={float(rep['fn']):.5f};"
            f"fp={float(rep['fp']):.5f};"
            f"corr_fp={float(rep['corrected_fp']):.5f};"
            f"compression={ratio:.1f}x;"
            f"comms_reduction={meter.reduction:.1f}x;"
            f"trigger_rate={meter.trigger_rate:.4f}")
        print(csv[-1], flush=True)


def quickstart(csv: List[str], device) -> None:
    """The paper's pipeline end to end: calibrate t(n) and s = 2 t(n)
    (Props 2+3), train, report the §2.3 metrics; raises unless FN ~ 0."""
    n, n_modes = 12, 48
    x, f = paper_synthetic(0, 4096, rho=SYN.rho, n_modes=n_modes)
    t = theory.t_of_n_sampled(
        lambda z: synthetic_residual(z, n, rho=SYN.rho, n_modes=n_modes), x)
    s = theory.s_rule(t)
    print(f"monitor truncation n={n}:  t(n)={t:.4f}  ->  s=2t={s:.4f}")
    print(f"(closed form for exp decay: s ~ rho^n/(1-rho) = "
          f"{theory.exp_decay_s(SYN.rho, n):.4f})")
    _, res, wall = _timed_train(device, 0, SYN, x, f, u_mode="cosine",
                                n_modes=n_modes, monitor_n=n, s=s, freeze_t=t,
                                steps=1500, lr=5e-3, log_fn=print)
    out = res["out"]
    rep = safety.metrics_report(torch.as_tensor(f, device=device), out["u"],
                                out["fhat"], eps=0.05)
    print("\n=== paper §2.3 metrics ===")
    for k, v in rep.items():
        print(f"  {k:24s} {float(v):.5f}")
    if not float(rep["fn"]) < 0.005:
        raise RuntimeError(f"safety broken: FN rate {float(rep['fn'])}")
    csv.append(f"paper_quickstart/n={n},{wall:.1f},"
               f"l2={float(rep['l2']):.4f};fn={float(rep['fn']):.4f}")
    print(f"\nOK: on-device monitor is SAFE (FN ~ 0) at {n}/{n_modes} of "
          "the basis complexity.")


FIGS = {"2": fig2, "3": fig3, "4": fig4, "quickstart": quickstart}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fig", choices=sorted(FIGS), action="append",
                    help="experiments to run (default: all)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rows: List[str] = []
    for name in args.fig or ("2", "3", "4", "quickstart"):
        FIGS[name](rows, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
