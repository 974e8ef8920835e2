"""Static-verification rule registry, report and mutation self-test (the
counterpart of the JAX package's ``analysis/rules.py``).

``python -m repro_torch.analysis`` drives these:

* ``sign-safety``: ``analysis.signs`` certificates (``corr >= 0``, ``fhat
  <= u``) for every registry arch x sigma kind, on both the training
  forward and the serving catch-up.
* ``collective-free`` / ``no-host-transfer`` / ``no-dynamic-shapes``:
  ``analysis.graph`` rules over every arch's exported monitor path.
* ``recompile-once``: a real churn episode on the paper serving config
  with a ``RecompileGuard`` armed after warmup.

The mutation self-test seeds one violation per rule (the corrector's
sign flipped in the forward, and in the catch-up at a policy's
always-trigger extreme; an injected ``funcol.all_reduce``; an ``.item()``
on the path; an export with a ``torch.export.Dim``; a forced new
signature) and asserts the rule FIRES: a rule that cannot catch its own
seeded violation is reported as broken.

Every model here is SMOKE size: the certificates' on the meta device
(shapes only, as the dry run builds its steps: the proofs read no
weight's value), the graph rules' and the churn episode's from seeded
weights on ``device`` (the CPU by default).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.analysis import graph as agraph
from repro_torch.analysis import signs
from repro_torch.analysis.recompile import RecompileGuard, SignaturePath


@dataclasses.dataclass
class RuleResult:
    rule: str
    target: str
    ok: bool
    detail: str = ""


def engine_for(cfg, batch: int = 2, max_len: int = 8, device="cpu"):
    """A ``CollaborativeEngine`` over seeded weights of ``cfg`` on
    ``device``."""
    from repro_torch.serving.collaborative import CollaborativeEngine
    return CollaborativeEngine(signs._model(cfg, device), cfg, batch,
                               max_len, device=device)


def run_sign_rules(arch_names: Optional[Sequence[str]] = None
                   ) -> List[RuleResult]:
    from repro_torch.configs import registry
    names = list(arch_names) if arch_names else registry.names()
    out = []
    for name in names:
        cfg = registry.get_smoke(name)
        for cert in signs.verify_arch(cfg, arch=name):
            out.append(RuleResult(
                "sign-safety", f"{name}/{cert.target}[{cert.sigma}]",
                cert.ok, "" if cert.ok else cert.detail))
    return out


def run_graph_rules(arch_names: Optional[Sequence[str]] = None,
                    device="cpu") -> List[RuleResult]:
    from repro_torch.configs import registry
    names = list(arch_names) if arch_names else registry.names()
    out = []
    for name in names:
        eng = engine_for(registry.get_smoke(name), device=device)
        for step, rule, hits in agraph.check_monitor_path(eng):
            out.append(RuleResult(
                rule, f"{name}/{step}", not hits,
                "" if not hits else "\n".join(h.brief() for h in hits[:8])))
    return out


def run_recompile_rule(device="cpu") -> List[RuleResult]:
    """Arm a guard over a REAL churn episode (attach/detach on the paper
    serving config, threshold forced low so every step triggers the
    catch-up) and assert no path sees a new call signature after a warmup
    that covers the uniform and the ragged pool."""
    from repro_torch.configs.paper_synthetic import SERVING
    from repro_torch.data import tokens as tok
    cfg = SERVING.replace(monitor=SERVING.monitor.__class__(
        **{**SERVING.monitor.__dict__, "threshold": -1e9,
           "trigger_margin": 0.0}))
    stream = next(tok.lm_batches(0, cfg, 3, 16))["tokens"]
    eng = engine_for(cfg, batch=3, max_len=32, device=device)
    session = eng.session(streams=["a", "b", "c"])

    def step(t, sids):
        session.step({sid: stream[i % 3, t] for i, sid in enumerate(sids)})

    # warmup: the uniform pool, then a ragged one
    for t in range(2):
        step(t, ("a", "b", "c"))
    session.detach("b")
    step(2, ("a", "c"))
    session.attach("d")
    step(3, ("a", "c", "d"))

    guard = session.arm_recompile_guard()
    # the churn episode under guard: more steps, another detach/attach
    step(4, ("a", "c", "d"))
    session.detach("d")
    step(5, ("a", "c"))
    session.attach("e")
    for t in range(6, 10):
        step(t, ("a", "c", "e"))
    bad = guard.violations()
    return [RuleResult(
        "recompile-once", "paper-synthetic-serving/churn", not bad,
        "" if not bad else "; ".join(bad))]


# ---------------------------------------------------------------------------
# Mutation self-test: each rule must catch its seeded violation
# ---------------------------------------------------------------------------


def _mutate_sign() -> RuleResult:
    from repro_torch.configs import registry
    cfg = registry.get_smoke("granite-8b")
    cert = signs.verify_forward(cfg, arch="granite-8b",
                                s=-abs(cfg.monitor.s))
    fired = not cert.ok
    return RuleResult("sign-safety", "mutation: corrector sign flipped",
                      fired, "" if fired else
                      "flipped-sign corrector was NOT refuted")


def _mutate_policy_sign() -> RuleResult:
    """A runaway threshold policy can at most drive every stream to the
    always-trigger extreme (thresholds only select WHEN the server is
    consulted), so the certificate that must hold there is still the
    corrector's sign.  Verify the catch-up at that operating point with
    the sign flipped: the rule must refute it."""
    from repro_torch.configs import registry
    cfg = registry.get_smoke("granite-8b")
    mon = cfg.monitor
    cfg = cfg.replace(monitor=mon.__class__(
        **{**mon.__dict__, "threshold": -1e9, "trigger_margin": 0.0}))
    cert = signs.verify_catchup(cfg, arch="granite-8b", s=-abs(mon.s))
    fired = not cert.ok
    return RuleResult("sign-safety",
                      "mutation: sign flipped at policy always-trigger",
                      fired, "" if fired else
                      "flipped-sign catch-up at the policy extreme was "
                      "NOT refuted")


class _AllReduce(torch.nn.Module):
    def __init__(self, group):
        super().__init__()
        self.group = group

    def forward(self, x):
        import torch.distributed._functional_collectives as funcol
        return funcol.all_reduce(x, "sum", self.group) + 1.0


def _synthetic_collective_graph() -> torch.fx.Graph:
    """A graph with one all_reduce and its wait, built node by node."""
    g = torch.fx.Graph()
    x = g.placeholder("x")
    ar = g.call_function(torch.ops._c10d_functional.all_reduce.default,
                         (x, "sum", "0"))
    w = g.call_function(torch.ops._c10d_functional.wait_tensor.default,
                        (ar,))
    g.output(w)
    return g


def _mutate_collective() -> RuleResult:
    import torch.distributed as dist
    own = False
    try:
        if dist.is_available() and not dist.is_initialized():
            dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                    world_size=1)
            own = True
        group = dist.group.WORLD if dist.is_initialized() else None
        if group is None:
            raise RuntimeError("no process group")
        g = signs.export_graph(_AllReduce(group), (torch.zeros(4),))
        src = "injected funcol.all_reduce (one-rank gloo group)"
    except Exception:  # no gloo here: the reference's synthetic fallback
        g = _synthetic_collective_graph()
        src = "synthetic all_reduce graph (no process group)"
    finally:
        if own:
            dist.destroy_process_group()
    hits = agraph.collective_nodes(g)
    fired = bool(hits)
    return RuleResult("collective-free", f"mutation: {src}", fired,
                      "" if fired else "injected collective NOT flagged")


class _Item(torch.nn.Module):
    def forward(self, x):
        return x * x.sum().item()


def _mutate_host_transfer() -> RuleResult:
    g = signs.export_graph(_Item(), (torch.ones(4),))
    hits = agraph.host_transfer_nodes(g)
    fired = bool(hits)
    return RuleResult("no-host-transfer", "mutation: .item() on path",
                      fired, "" if fired else ".item() NOT flagged")


class _Double(torch.nn.Module):
    def forward(self, x):
        return x + x


def _mutate_dynamic_shape() -> RuleResult:
    n = torch.export.Dim("n", min=2, max=64)
    g = signs.export_graph(_Double(), (torch.zeros(8),),
                      dynamic_shapes={"x": {0: n}})
    hits = agraph.dynamic_shape_nodes(g)
    fired = bool(hits)
    return RuleResult("no-dynamic-shapes",
                      "mutation: export with a torch.export.Dim", fired,
                      "" if fired else "symbolic size NOT flagged")


def _mutate_retrace() -> RuleResult:
    f = SignaturePath("f", lambda x: x * 2.0)
    f(torch.zeros(2))  # warmup
    guard = RecompileGuard({"f": f}, track_global=False).arm()
    f(torch.zeros(3))  # a new shape: a new signature
    fired = bool(guard.violations())
    return RuleResult("recompile-once", "mutation: forced new signature",
                      fired, "" if fired else "new signature NOT detected")


def mutation_selftest() -> List[RuleResult]:
    """Seed one violation per rule; ``ok`` means the rule FIRED."""
    return [_mutate_sign(), _mutate_policy_sign(),
            _mutate_collective(), _mutate_host_transfer(),
            _mutate_dynamic_shape(), _mutate_retrace()]


# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------


def format_report(results: List[RuleResult], *, verbose: bool = False) -> str:
    w_rule = max([len(r.rule) for r in results] + [4])
    w_tgt = max([len(r.target) for r in results] + [6])
    lines = [f"{'RULE':<{w_rule}}  {'TARGET':<{w_tgt}}  STATUS",
             "-" * (w_rule + w_tgt + 10)]
    for r in results:
        lines.append(f"{r.rule:<{w_rule}}  {r.target:<{w_tgt}}  "
                     f"{'pass' if r.ok else 'FAIL'}")
        if r.detail and (verbose or not r.ok):
            lines += ["    " + d for d in r.detail.splitlines()[:12]]
    n_fail = sum(not r.ok for r in results)
    lines.append(f"{len(results)} checks, {n_fail} failed")
    return "\n".join(lines)


def summarize(results: List[RuleResult]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for r in results:
        key = r.rule + ("" if r.ok else ":failed")
        out[key] = out.get(key, 0) + 1
    return out
