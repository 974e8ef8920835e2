"""The port's static verifier (``repro_torch.analysis``) on the CPU: the
interval domain against the reference's own functions, the interpreter
over exported graphs (``tests/test_analysis.py::TestInterpreter``
re-expressed in torch), the graph rules (the counterparts of
``TestHloRules``), the signature guard (the counterparts of
``tests/test_churn.py::test_recompile_exactly_once_per_signature`` and
``tests/test_policy.py::test_zero_retraces_under_moving_policy``), the
mutation self-test and the report.

Where the reference's case is green, the port's intervals are compared
with its intervals one for one.  The reference's interpreter reads
``jax.core.Literal``, which the installed JAX keeps only as
``jax.extend.core.Literal``: the comparison runs it with that alias set
for the test's span (``_literal`` below; nothing of the reference is
edited).  Three of its cases are red in the reference's own suite: the
port is held to the verdicts their tests assert.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import signs as jsigns
from repro_torch.analysis import graph as agraph
from repro_torch.analysis import recompile as arc
from repro_torch.analysis import rules
from repro_torch.analysis import signs
from repro_torch.analysis.signs import Interval
from repro_torch.configs import registry
from repro_torch.core import decomposition as deco
from repro_torch.serving import QuantilePolicy, SessionConfig
from repro_torch.serving.collaborative import CollaborativeEngine

INF = math.inf


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Interval domain against the reference's functions
# ---------------------------------------------------------------------------

_EDGES = [0.0, -0.0, 1.0, -1.0, 2.5, -3.25, 1e-300, -1e300, INF, -INF,
          float("nan")]


def _grid(n=80, seed=0):
    rng = np.random.default_rng(seed)
    pts = list(_EDGES) + list(rng.normal(0, 10, n)) + list(
        rng.choice([0.0, INF, -INF, float("nan")], n // 4))
    out = []
    for _ in range(400):
        a, b, c, d = (pts[i] for i in rng.integers(0, len(pts), 4))
        out.append(((a, b), (c, d)))
    return out


def _same(p, r):
    return (p.lo, p.hi) == (r.lo, r.hi)


@pytest.mark.parametrize("fn", ["iadd", "isub", "imul", "idiv"])
def test_interval_arithmetic_matches_the_reference(fn):
    """Every operation on a seeded grid of endpoints with 0, +-inf and NaN
    gives the reference's interval exactly (NaN and crossed endpoints
    widen to top in both)."""
    pf, rf = getattr(signs, fn), getattr(jsigns, fn)
    for (a, b), (c, d) in _grid():
        p = pf(Interval(a, b), Interval(c, d))
        r = rf(jsigns.Interval(a, b), jsigns.Interval(c, d))
        assert _same(p, r), (fn, a, b, c, d, p, r)
    assert _same(signs.TOP, jsigns.TOP)
    assert _same(Interval(float("nan"), 1.0), jsigns.Interval(
        float("nan"), 1.0))


def test_interval_reference_cases():
    """tests/test_analysis.py::TestInterval on the port's domain."""
    a, b = Interval(-1.0, 2.0), Interval(3.0, 4.0)
    assert signs.iadd(a, b) == Interval(2.0, 6.0)
    assert signs.isub(b, a) == Interval(1.0, 5.0)
    assert signs.imul(a, b) == Interval(-4.0, 8.0)
    assert signs.imul(Interval(0.0, INF), Interval(0.0, 1.0)) \
        == Interval(0.0, INF)
    assert signs.imul(Interval(0.0, INF), Interval(-1.0, 0.0)) \
        == Interval(-INF, 0.0)
    assert signs.idiv(Interval(1.0, 2.0), Interval(2.0, 4.0)) \
        == Interval(0.25, 1.0)
    assert signs.idiv(Interval(1.0, 2.0), Interval(-1.0, 1.0)) == signs.TOP


# ---------------------------------------------------------------------------
# The interpreter (TestInterpreter in torch)
# ---------------------------------------------------------------------------


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *xs):
        return self.fn(*xs)


def _out(fn, *examples, in_intervals=None):
    ep = signs.export_graph(_Fn(fn), examples)
    return signs.analyze_graph(ep, in_intervals).out_nodes


@pytest.fixture
def _literal(monkeypatch):
    from jax.extend import core as jcore
    monkeypatch.setattr(jax.core, "Literal", jcore.Literal, raising=False)


def _ref_out(fn, *avals, in_intervals=None):
    closed = jax.make_jaxpr(fn)(*avals)
    return jsigns.analyze_jaxpr(closed, in_intervals).out_nodes


F4 = jax.ShapeDtypeStruct((4,), jnp.float32)
B4 = jax.ShapeDtypeStruct((4,), jnp.bool_)


def test_sigmoid_bounded(_literal):
    (node,) = _out(torch.sigmoid, torch.zeros(4))
    (ref,) = _ref_out(jax.nn.sigmoid, F4)
    assert node.ival.lo >= 0.0 and node.ival.hi <= 1.0
    assert _same(node.ival, ref.ival)


def test_scaled_sigmoid_nonneg(_literal):
    (node,) = _out(lambda x: 0.2 * torch.sigmoid(x), torch.zeros(4))
    (ref,) = _ref_out(lambda x: 0.2 * jax.nn.sigmoid(x), F4)
    assert signs.prove_nonneg(node)[0]
    assert _same(node.ival, ref.ival)


def test_negative_scale_refuted_with_chain(_literal):
    (node,) = _out(lambda x: -0.2 * torch.sigmoid(x), torch.zeros(4))
    (ref,) = _ref_out(lambda x: -0.2 * jax.nn.sigmoid(x), F4)
    ok, chain = signs.prove_nonneg(node)
    assert not ok and any("mul" in c for c in chain)
    assert _same(node.ival, ref.ival)
    assert "test_torch_analysis.py" in chain[0]   # the file:line


def test_where_upper_bound(_literal):
    def f(u, v, trig):
        return torch.where(trig, u - 0.2 * torch.sigmoid(v), u), u
    fhat, u = _out(f, torch.zeros(4), torch.zeros(4),
                   torch.zeros(4, dtype=torch.bool))
    rf, ru = _ref_out(lambda u, v, t: (jnp.where(
        t, u - 0.2 * jax.nn.sigmoid(v), u), u), F4, F4, B4)
    assert signs.prove_le(fhat, u)[0]
    assert jsigns.prove_le(rf, ru)[0]
    assert _same(fhat.ival, rf.ival) and _same(u.ival, ru.ival)


def test_add_positive_refutes_upper_bound():
    """Red in the reference (a Literal in its jaxpr): the verdict its
    test asserts."""
    fhat, u = _out(lambda u, v: (u + torch.sigmoid(v), u), torch.zeros(4),
                   torch.zeros(4))
    assert not signs.prove_le(fhat, u)[0]


def test_loop_carry_is_top_but_sound():
    """Red in the reference: a ``while_loop`` (the counterpart of its
    ``fori_loop``) joins the body's [0, 1] with the top initial carry, as
    the test asserts; the same loop unrolled (as the port's catch-up
    unrolls its rounds) is exact and holds every value it computes."""
    from torch._higher_order_ops.while_loop import while_loop

    def looped(x):
        i = torch.zeros((), dtype=torch.int64)
        return while_loop(lambda i, c: i < 3,
                          lambda i, c: (i + 1, torch.sigmoid(c)), (i, x))[1]

    def unrolled(x):
        for _ in range(3):
            x = torch.sigmoid(x)
        return x
    (node,) = _out(looped, torch.zeros(()))
    assert node.ival == signs.TOP or node.ival.lo <= 0.0
    (node,) = _out(unrolled, torch.zeros(()))
    # the domain works in exact reals: sample in f64
    xs = torch.tensor([-INF, -1e4, -1.0, 0.0, 1.0, 1e4, INF],
                      dtype=torch.float64)
    ys = unrolled(xs)
    assert UNIT_OK(node.ival) and bool((ys >= node.ival.lo).all()
                                       and (ys <= node.ival.hi).all())


def UNIT_OK(iv):
    return 0.0 <= iv.lo <= iv.hi <= 1.0


def test_input_refinement():
    """Red in the reference: a refined input interval flows through."""
    (node,) = _out(lambda x: x * 2.0, torch.zeros(4),
                   in_intervals=[Interval(0.0, 1.0)])
    assert node.ival == Interval(0.0, 2.0)


def test_bool_and_integer_inputs_refined_by_dtype():
    b, i = _out(lambda b, i: (b.clone(), i.clone()),
                torch.zeros(4, dtype=torch.bool),
                torch.zeros(4, dtype=torch.int32))
    assert b.ival == Interval(0.0, 1.0)
    assert i.ival == Interval(-2.0 ** 31, 2.0 ** 31 - 1)


def test_kernel_nodes_are_inlined():
    """A monitor_combine node is analysed through its plain version: the
    outer u is the same producer inside it, so fhat <= u proves, and the
    flipped sign refutes at the kernel module's line."""
    from repro_torch.kernels import ops

    def f(u, v, s):
        return ops.monitor_combine(u, v, u, s=s)[0], u
    for s, want in ((0.2, True), (-0.2, False)):
        fhat, u = _out(lambda a, b: f(a, b, s), torch.zeros(8),
                       torch.zeros(8))
        ok, chain = signs.prove_le(fhat, u)
        assert ok is want, chain
        if not want:
            assert any("mul" in c and "monitor_combine.py" in c
                       for c in chain), chain


# ---------------------------------------------------------------------------
# Graph rules (TestHloRules in torch)
# ---------------------------------------------------------------------------


class _AllReduceLike(torch.nn.Module):
    """A benign step whose source mentions a collective."""

    def forward(self, x):
        all_reduce_like = x + 1.0
        return all_reduce_like


def test_benign_name_is_not_a_collective():
    """Only a node's TARGET trips the rule: a node named all_reduce, made
    by a line that names all_reduce_like, is not a collective."""
    ep = signs.export_graph(_AllReduceLike(), (torch.zeros(4),))
    node = [n for n in ep.graph.nodes if n.op == "call_function"][0]
    node.name = "all_reduce"
    assert "all_reduce_like" in node.meta["stack_trace"]
    assert agraph.collective_nodes(ep) == []
    agraph.assert_collective_free(ep, "benign name")


def test_real_collective_flagged_and_the_recorder_shares_the_list():
    from repro_torch.serving import mesh
    hits = agraph.collective_nodes(rules._synthetic_collective_graph())
    assert [h.target for h in hits] == [
        "_c10d_functional.all_reduce.default",
        "_c10d_functional.wait_tensor.default"]
    with pytest.raises(AssertionError, match="collective"):
        agraph.assert_collective_free(rules._synthetic_collective_graph(),
                                      "probe")
    assert mesh.C10D_NAMESPACES is agraph.COLLECTIVE_NAMESPACES
    r = rules._mutate_collective()
    assert r.ok, r


def test_host_transfer_rule():
    ep = signs.export_graph(rules._Item(), (torch.ones(4),))
    hits = agraph.host_transfer_nodes(ep)
    assert [h.target for h in hits] in (["aten.item.default"],
                                        ["aten._local_scalar_dense.default"])
    with pytest.raises(AssertionError, match="host"):
        agraph.assert_no_host_transfer(ep, "item probe")
    nz = signs.export_graph(_Fn(lambda x: torch.nonzero(x)),
                            (torch.ones(4),))
    assert any("nonzero" in h.target
               for h in agraph.host_transfer_nodes(nz))
    # a copy onto the CPU counts only in a graph that holds CUDA tensors
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        xc = torch.empty(4, device="cuda")
        xh = torch.empty(4)
    g = torch.fx.Graph()
    x = g.placeholder("x")
    x.meta["val"] = xc
    y = g.call_function(torch.ops.aten._to_copy.default, (x,),
                        {"device": torch.device("cpu")})
    y.meta["val"] = xh
    z = g.call_function(math.sqrt, (2.0,))       # outside aten: denied
    g.output((y, z))
    hits = agraph.host_transfer_nodes(g)
    assert [h.reason for h in hits] == ["copies onto the CPU", (
        "call outside ['aten', 'prims', 'repro_torch']")]
    # the same copy in a CPU graph is not a host transfer
    x.meta["val"] = xh
    assert len(agraph.host_transfer_nodes(g)) == 1


def test_dynamic_shape_rule():
    ep = signs.export_graph(rules._Double(), (torch.zeros(8),),
                            dynamic_shapes={"x": {0: torch.export.Dim(
                                "n", min=2, max=64)}})
    assert agraph.dynamic_shape_nodes(ep)
    static = signs.export_graph(rules._Double(), (torch.zeros(8),))
    assert agraph.dynamic_shape_nodes(static) == []


def test_unsharded_monitor_path_passes_all_rules():
    eng = rules.engine_for(registry.get_smoke("granite-8b"))
    results = agraph.check_monitor_path(eng)
    assert {"decode_at", "decode_masked", "u_head", "record_at",
            "catchup"} <= {k for k, _, _ in results}
    for step, rule, hits in results:
        assert not hits, (step, rule, [h.brief() for h in hits])
    graphs = agraph.monitor_path_graphs(eng, include_catchup=False)
    # the kernels stand as nodes: the edge's decode attention
    targets = [str(n.target) for n in graphs["decode_at"].graph.nodes]
    assert targets.count("repro_torch.decode_attention.default") \
        == eng.edge.cfg.n_layers


# ---------------------------------------------------------------------------
# The signature guard
# ---------------------------------------------------------------------------


def test_guard_stable_and_violation():
    f = arc.SignaturePath("f", lambda x: x * 2.0)
    f(torch.zeros(2))
    guard = arc.RecompileGuard({"f": f}, track_global=False).arm()
    f(torch.ones(2))            # same signature
    assert guard.violations() == []
    guard.assert_stable()
    f(torch.zeros(3))           # a new shape: a new signature
    assert guard.violations()
    with pytest.raises(arc.RecompileError, match="f: 1 -> 2"):
        guard.assert_stable()
    with pytest.raises(arc.RecompileError):
        with arc.RecompileGuard({"f": f}, track_global=False):
            f(torch.zeros(5))
    with pytest.raises(RuntimeError, match="not armed"):
        arc.RecompileGuard({}, track_global=False).violations()


def test_global_counter_sees_exports():
    g = arc.RecompileGuard({}, track_global=True).arm()
    signs.export_graph(rules._Double(), (torch.zeros(3),))
    assert g.global_compiles() >= 1
    with pytest.raises(arc.RecompileError, match="exports"):
        g.assert_stable(allow_global=0)


def _churn_cfg(threshold):
    cfg = registry.get_smoke("granite-8b")
    return cfg.replace(monitor=cfg.monitor.__class__(
        **{**cfg.monitor.__dict__, "threshold": threshold,
           "trigger_margin": 0.0}))


def test_engine_jitted_paths_enumeration():
    eng = rules.engine_for(registry.get_smoke("granite-8b"))
    paths = eng.jitted_paths()
    for expected in ("catchup", "u_head", "record_at", "edge.step_masked",
                     "server.step_masked", "edge.prefill",
                     "edge.step_at[with_logits=False]"):
        assert expected in paths, sorted(paths)


def test_churn_keeps_one_signature_per_monitor_path():
    """tests/test_churn.py's strong form: every step triggers the
    catch-up, a full churn episode under the armed guard adds no
    signature, the catch-up holds at most two (the reference: scalar-t
    and vector-t) and every monitor path exactly one."""
    cfg = _churn_cfg(-1e9)
    model = deco.init_collab_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    stream = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 12))
    eng = CollaborativeEngine(model, cfg, 3, 32, device="cpu")
    with eng.session(streams=["a", "b", "c"]) as s:
        for t in range(4):
            s.step({sid: stream[i, t] for i, sid in enumerate("abc")})
        s.detach("b")
        for t in range(4, 6):
            s.step({"a": stream[0, t], "c": stream[2, t]})
        assert s.attach("d") == 1
        guard = s.arm_recompile_guard(track_global=False)
        for t in range(6, 12):
            s.step({"a": stream[0, t], "c": stream[2, t],
                    "d": stream[1, t - 6]})
        guard.assert_stable()
    sizes = {n: f._cache_size() for n, f in eng.jitted_paths().items()}
    assert 1 <= sizes["catchup"] <= 2, sizes
    assert sizes["edge.step_at[with_logits=False]"] == 1, sizes
    assert sizes["u_head"] == 1, sizes
    assert sizes["record_at"] == 1, sizes


def test_zero_new_signatures_under_moving_policy():
    """Thresholds are data: a QuantilePolicy moving every stream's tau
    adds no signature after warmup."""
    cfg = _churn_cfg(0.1)
    model = deco.init_collab_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    stream = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 16))
    eng = CollaborativeEngine(model, cfg, 3, 16, device="cpu")
    pol = QuantilePolicy(0.3, window=4, min_samples=2)
    with eng.session(SessionConfig(mode="sync", policy=pol)) as sess:
        for t in range(4):
            sess.step(stream[:, t])
        guard = sess.arm_recompile_guard()
        for t in range(4, 16):
            sess.step(stream[:, t])
        guard.assert_stable(allow_global=0)
    assert (pol.state()["tau"] != pol.state()["tau0"]).any()


def test_recompile_rule_passes():
    (r,) = rules.run_recompile_rule()
    assert r.ok, r.detail


# ---------------------------------------------------------------------------
# Mutation self-test and report
# ---------------------------------------------------------------------------


def test_all_rules_fire():
    for r in rules.mutation_selftest():
        assert r.ok, f"{r.rule} did not fire: {r.target} {r.detail}"


def test_report_formatting():
    rep = rules.format_report([rules.RuleResult("r", "t", True),
                               rules.RuleResult("r", "t2", False, "boom")])
    assert "FAIL" in rep and "boom" in rep and "1 failed" in rep
    assert rules.summarize([rules.RuleResult("r", "t", True),
                            rules.RuleResult("r", "t2", False)]) == {
        "r": 1, "r:failed": 1}
