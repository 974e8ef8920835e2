"""Per-node rules over exported graphs (``torch.export``), the port's
counterpart of the JAX package's ``analysis/hlo.py``, which parses
compiled HLO text.  The port's graphs are FX graphs of aten ops and the
port's kernel ops, so the rules match each node's TARGET (its op
namespace and overload), never its name or stack trace: a benign node
whose name or source mentions ``all_reduce`` cannot trip the
collective-free rule, while a real collective anywhere in the graph
does.

Rules (each with an explicit allowlist):

* ``collective-free``: no node in a ``torch.distributed`` collective
  namespace (``_c10d_functional.*``, ``c10d.*``, ``funcol``'s
  ``wait_tensor`` included) and no DTensor redistribution.  The paper's
  device-locality guarantee: the monitor path must decide without the
  server, hence without the mesh.
* ``no-host-transfer``: no ``aten._local_scalar_dense`` or ``item`` (a
  host sync), no copy onto the CPU inside a graph that holds CUDA
  tensors, no op whose output size depends on the data (``nonzero``: the
  host must read it), and no ``call_function`` outside the ``aten``,
  ``prims`` and ``repro_torch`` namespaces but the allowlisted ones: deny
  by default, as the reference denies unknown custom-call targets.
* ``no-dynamic-shapes``: no symbolic size (``SymInt``) in any node's
  value: the serving paths run at static shapes.

``monitor_path_graphs(engine)`` exports the monitor-path steps of a
``CollaborativeEngine``: the per-element edge decode the step runs
(``decode_at``), the dense masked decode (``decode_masked``), the u head,
the history record, and one catch-up round, for an unsharded engine and
for each lane of a data-sharded one.  ``check_monitor_path`` runs the
rules over them.  ``COLLECTIVE_NAMESPACES`` is also the list
``serving/mesh.py``'s op recorder checks a sharded engine's ops against.
"""
from __future__ import annotations

import dataclasses
import operator
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.signs import export_graph, where_of

# op namespaces of torch.distributed's collectives (funcol's wait_tensor
# and DTensor's redistribution lower into them)
COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional",
                         "_c10d_functional_autograd", "_dtensor")

# op namespaces a monitor-path graph may call: aten, its primitives, and
# the port's kernels (``kernels/ops.py``)
ALLOWED_NAMESPACES = frozenset({"aten", "prims", "repro_torch"})

# callables outside those namespaces that are pure graph plumbing, not
# host work (deny by default: anything not listed fails no-host-transfer)
DEFAULT_CALL_ALLOW = frozenset({"_operator.getitem"})

# ops that read a device value on the host
HOST_SYNC_OPS = frozenset({"_local_scalar_dense", "item"})

# ops whose output size is read from the data (the host must wait for it)
DATA_DEPENDENT_OPS = frozenset({"nonzero", "nonzero_numpy", "argwhere",
                                "masked_select", "unique", "_unique",
                                "_unique2", "unique_dim",
                                "unique_consecutive"})

# copies (their output's device is checked)
COPY_OPS = frozenset({"to", "_to_copy", "copy", "copy_", "_copy_from",
                      "_to_cpu"})


@dataclasses.dataclass(frozen=True)
class GraphHit:
    """One flagged node: its name, target, the rule's reason and where
    the code that made it lives."""

    name: str
    target: str
    reason: str
    where: str = ""

    def brief(self) -> str:
        at = f" at {self.where}" if self.where else ""
        return f"{self.name} = {self.target}: {self.reason}{at}"


def target_name(node) -> Tuple[str, str, str]:
    """(namespace, overload packet, qualified name) of a call_function
    node's target."""
    t = node.target
    if isinstance(t, torch._ops.OpOverload):
        return (t.namespace, t._overloadpacket.__name__,
                f"{t.namespace}.{t._overloadpacket.__name__}."
                f"{t._overloadname}")
    if isinstance(t, torch._ops.OpOverloadPacket):
        ns = t._qualified_op_name.split("::")[0]
        return ns, t.__name__, f"{ns}.{t.__name__}"
    if isinstance(t, torch._ops.HigherOrderOperator):
        return "higher_order", t.name(), f"higher_order.{t.name()}"
    mod = getattr(t, "__module__", "") or ""
    name = getattr(t, "__name__", str(t))
    if t is operator.getitem:
        mod = "_operator"
    return mod, name, f"{mod}.{name}"


def _graph(g):
    """The FX graph of an ``ExportedProgram``, a ``GraphModule`` or a
    graph."""
    if hasattr(g, "graph_module"):
        return g.graph_module.graph
    if hasattr(g, "graph") and not isinstance(g, torch.fx.Graph):
        return g.graph
    return g


def _calls(g):
    return [n for n in _graph(g).nodes if n.op == "call_function"]


def _hit(node, reason: str) -> GraphHit:
    return GraphHit(node.name, target_name(node)[2], reason, where_of(node))


def _vals(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _vals(y)]
    return []


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------


def collective_nodes(g, allow: Iterable[str] = ()) -> List[GraphHit]:
    """Nodes whose TARGET is a collective (names and stack traces cannot
    trip this).  ``allow``: node names to exempt."""
    allowed = frozenset(allow)
    hits = []
    for n in _calls(g):
        ns, packet, qual = target_name(n)
        if n.name in allowed:
            continue
        if ns in COLLECTIVE_NAMESPACES or "redistribute" in packet:
            hits.append(_hit(n, "collective"))
    return hits


def _holds_cuda(g) -> bool:
    return any(t.device.type == "cuda" for n in _graph(g).nodes
               for t in _vals(n.meta.get("val")))


def host_transfer_nodes(g, allow_calls: Iterable[str] = DEFAULT_CALL_ALLOW
                        ) -> List[GraphHit]:
    """Host syncs, copies onto the CPU in a graph that holds CUDA tensors,
    data-dependent sizes, and calls outside the allowed namespaces."""
    allowed = frozenset(allow_calls)
    cuda = _holds_cuda(g)
    hits = []
    for n in _calls(g):
        ns, packet, qual = target_name(n)
        if qual in allowed:
            continue
        if ns not in ALLOWED_NAMESPACES:
            hits.append(_hit(n, f"call outside {sorted(ALLOWED_NAMESPACES)}"))
        elif packet in HOST_SYNC_OPS:
            hits.append(_hit(n, "reads a device value on the host"))
        elif cuda and packet in COPY_OPS and any(
                t.device.type == "cpu" for t in _vals(n.meta.get("val"))):
            hits.append(_hit(n, "copies onto the CPU"))
        elif packet in DATA_DEPENDENT_OPS or (
                isinstance(n.target, torch._ops.OpOverload)
                and torch.Tag.dynamic_output_shape in n.target.tags
                and _symbolic(n.meta.get("val"))):
            hits.append(_hit(n, "output size read from the data"))
        elif isinstance(n.target, torch._ops.OpOverload) \
                and torch.Tag.data_dependent_output in n.target.tags:
            hits.append(_hit(n, "output value read on the host"))
    return hits


def _symbolic(val) -> bool:
    for t in _vals(val):
        if any(isinstance(d, torch.SymInt) for d in t.shape):
            return True
    return isinstance(val, (torch.SymInt, torch.SymFloat))


def dynamic_shape_nodes(g, allow: Iterable[str] = ()) -> List[GraphHit]:
    """Nodes (placeholders included) with a symbolic size."""
    allowed = frozenset(allow)
    return [GraphHit(n.name, target_name(n)[2] if n.op == "call_function"
                     else n.op, "symbolic size", where_of(n))
            for n in _graph(g).nodes
            if n.name not in allowed and _symbolic(n.meta.get("val"))]


def _assert(hits: List[GraphHit], what: str, message: str) -> None:
    if hits:
        raise AssertionError(f"{what} graph {message}:\n  "
                             + "\n  ".join(h.brief() for h in hits))


def assert_collective_free(g, what: str = "edge step",
                           allow: Iterable[str] = ()) -> None:
    """The paper's device-locality guarantee, checked per node on an
    exported graph: the monitor path must not communicate across
    devices."""
    _assert(collective_nodes(g, allow), what,
            "contains cross-device collectives (the monitor path must be "
            "collective-free)")


def assert_no_host_transfer(g, what: str = "edge step",
                            allow_calls: Iterable[str] = DEFAULT_CALL_ALLOW
                            ) -> None:
    _assert(host_transfer_nodes(g, allow_calls), what,
            "contains host transfers (the monitor path must stay on the "
            "device)")


# ---------------------------------------------------------------------------
# Monitor-path exports
# ---------------------------------------------------------------------------


class _DecodeAt(torch.nn.Module):
    def __init__(self, tower):
        super().__init__()
        self.params, self.cfg = tower.params, tower.cfg

    def forward(self, cache, tokens, pos, active):
        from repro_torch.serving.engine import step_at
        return step_at(self.params, self.cfg, cache, tokens, pos, active,
                       with_logits=False)[1]


class _DecodeMasked(torch.nn.Module):
    def __init__(self, tower, pos: int):
        super().__init__()
        self.params, self.cfg, self.pos = tower.params, tower.cfg, pos

    def forward(self, cache, tokens, mask):
        from repro_torch.serving.engine import step_masked
        return step_masked(self.params, self.cfg, cache, tokens, self.pos,
                           mask, with_logits=False)[1]


class _UHead(torch.nn.Module):
    def __init__(self, engine, params):
        super().__init__()
        self.params, self.engine = params, engine

    def forward(self, hidden):
        return self.engine._u_head(self.params, hidden)


class _RecordAt(torch.nn.Module):
    def forward(self, history, tokens, idx, active):
        from repro_torch.serving.collaborative import record_history
        record_history(history, tokens, idx, active)
        return history


class _CatchupRound(torch.nn.Module):
    def __init__(self, engine, lane):
        super().__init__()
        self.engine, self.lane, self.params = engine, lane, lane.params

    def forward(self, cache, tokens, pos, active, triggered, u):
        from repro_torch.serving.async_rpc import Backlog
        e = self.engine
        v = e._lane_catchup_v(self.lane, cache,
                              Backlog(tokens, pos, active, triggered))
        return v, e._fuse(u, v, triggered)


def monitor_path_graphs(engine, include_catchup: bool = True
                        ) -> Dict[str, object]:
    """Exports of the monitor-path steps of a ``CollaborativeEngine``:
    ``decode_at``, ``decode_masked``, ``u_head``, ``record_at`` and one
    catch-up round, each on an engine's lane (its rows, device, parameter
    replica, caches and history): the engine itself, or each shard of a
    sharded engine (names ``<step>[shard i]``).  The caches and the
    history are inputs written in place; nothing is run."""
    out: Dict[str, object] = {}
    for i, ln in enumerate(engine._lanes()):
        tag = f"[shard {i}]" if engine.shards is not None else ""
        d, b = ln.device, ln.batch
        tokens = torch.zeros((b,) + engine.tok_tail, dtype=torch.long,
                             device=d)
        pos = torch.zeros(b, dtype=torch.int32, device=d)
        mask = torch.zeros(b, dtype=torch.bool, device=d)
        hidden = torch.zeros((b, engine.edge.cfg.d_model),
                             dtype=torch.float32, device=d)
        out["decode_at" + tag] = export_graph(
            _DecodeAt(ln.edge), (ln.edge.cache, tokens, pos, mask))
        out["decode_masked" + tag] = export_graph(
            _DecodeMasked(ln.edge, 0), (ln.edge.cache, tokens, mask))
        out["u_head" + tag] = export_graph(_UHead(engine, ln.params),
                                           (hidden,))
        out["record_at" + tag] = export_graph(_RecordAt(), (
            ln._history, tokens, torch.zeros(b, dtype=torch.long, device=d),
            mask))
        if include_catchup:
            bl = engine._lane_backlog(ln, np.zeros(b, np.int64),
                                      np.zeros(b, np.int64),
                                      np.ones(b, bool), None)
            u = torch.zeros(b, dtype=torch.float32, device=d)
            out["catchup" + tag] = export_graph(_CatchupRound(engine, ln), (
                ln.server.cache, bl.tokens, bl.pos, bl.active, bl.triggered,
                u))
    return out


# rules the EDGE steps must satisfy even on a sharded engine; the
# catch-up is exempt from collective-free there (its rounds are the
# server's work, which the reference's sharded program may gather)
EDGE_STEPS = ("decode_at", "decode_masked", "u_head", "record_at")


def check_monitor_path(engine, *, include_catchup: bool = True,
                       sharded: Optional[bool] = None
                       ) -> List[Tuple[str, str, List[GraphHit]]]:
    """Run every graph rule over the monitor path; returns ``(step, rule,
    hits)`` triples: empty hits mean the rule passed."""
    if sharded is None:
        sharded = getattr(engine, "mesh_spec", None) is not None
    results = []
    for name, ep in monitor_path_graphs(
            engine, include_catchup=include_catchup).items():
        if name.split("[")[0] in EDGE_STEPS or not sharded:
            results.append((name, "collective-free", collective_nodes(ep)))
        results.append((name, "no-host-transfer", host_transfer_nodes(ep)))
        results.append((name, "no-dynamic-shapes", dynamic_shape_nodes(ep)))
    return results
