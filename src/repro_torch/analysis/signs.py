"""Sign and interval abstract interpretation over ``torch.export`` graphs
(the counterpart of the JAX package's ``analysis/signs.py``, which works
over closed jaxprs).

Proves the paper's safety inequality on the graph the port runs: the
corrector ``corr = s * sigma(v)`` is elementwise nonnegative (``sigma``
maps into [0, 1] and ``s >= 0``), hence ``fhat = u - corr <= u``: the
edge monitor's score is a safe upper bound on the corrected score, for
every registered arch and every ``sigma`` kind, on both the training
forward (``core.decomposition.collab_forward``) and the serving engine's
catch-up (``CollaborativeEngine._catchup_apply``).

Two cooperating provers over one producer graph, built from an
``ExportedProgram``'s FX graph:

* an **interval domain**: every tensor is abstracted by one scalar
  interval ``[lo, hi]`` covering all its elements.  Transfer functions
  are keyed by aten overload packet (``sigmoid -> [0, 1]``, ``tanh ->
  [-1, 1]``, interval arithmetic for ``add``/``sub``/``mul``/``div``,
  scaled sums for ``sum`` and the contractions, join for ``where`` and
  ``cat``, ...); an unknown target gives ``[-inf, inf]`` (always sound,
  never unsound: precision is the only casualty).  Parameters and
  buffers are top, as the reference's abstract parameters are; bool and
  integer values are clamped to their dtype's range.  An op that writes
  in place (a cache write) widens every value that shares the written
  storage.  A ``repro_torch.*`` node (a hand-written kernel) is INLINED:
  it is analysed through an export of the kernel's plain version at the
  node's shapes, cached by op and shapes, with the caller's nodes bound
  to its inputs, as the reference inlines ``pjit`` and
  ``custom_jvp_call``.  The proof then covers the function each kernel
  is held to on the card.
* a **structural upper-bound prover**: the interval domain is
  non-relational (it cannot see that ``u - corr`` and ``u`` share the
  same ``u``), so ``fhat <= u`` is proved by walking ``fhat``'s producer
  chain: ``sub(a, b)`` proves when ``a <= u`` and ``interval(b) >= 0``;
  ``where`` proves when every branch does; ``minimum`` when either
  operand does; value-preserving nodes (views, exact conversions) are
  looked through.  Because kernels are inlined, the ``u`` inside
  ``monitor_combine``'s plain version IS the outer ``u``.

A failed proof yields the offending producer chain, each step naming its
node, aten target and the ``file:line`` of the code that made it.

The catch-up certificate runs over an export at R = 2 rounds, where the
engine replays a backlog of R rounds in a Python loop (the reference's
``lax.scan``).  That covers every R: v enters ``_fuse`` only through
``sigma``, whose interval is [0, 1] whatever v is, so ``corr = s *
sigma(v)`` is in [0, s] and ``fhat <= u`` follows for any number of
rounds; the rounds only change v.
"""
from __future__ import annotations

import dataclasses
import math
import operator
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

INF = math.inf

# ---------------------------------------------------------------------------
# Interval domain
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Interval:
    """One scalar interval abstracting every element of a tensor.
    NaN endpoints widen to +-inf (top) so the domain stays sound."""

    lo: float
    hi: float

    def __post_init__(self):
        lo, hi = float(self.lo), float(self.hi)
        if math.isnan(lo) or math.isnan(hi) or lo > hi:
            lo, hi = -INF, INF
        object.__setattr__(self, "lo", lo)
        object.__setattr__(self, "hi", hi)

    def __str__(self) -> str:
        return f"[{self.lo:.6g}, {self.hi:.6g}]"

    @property
    def nonneg(self) -> bool:
        return self.lo >= 0.0

    @property
    def nonpos(self) -> bool:
        return self.hi <= 0.0

    def join(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi))


TOP = Interval(-INF, INF)
UNIT = Interval(0.0, 1.0)


def _xmul(x: float, y: float) -> float:
    # extended-real product with the 0 * inf := 0 convention (standard in
    # interval arithmetic: finite products never exceed the cross bounds)
    if x == 0.0 or y == 0.0:
        return 0.0
    return x * y


def iadd(a: Interval, b: Interval) -> Interval:
    return Interval(a.lo + b.lo, a.hi + b.hi)


def isub(a: Interval, b: Interval) -> Interval:
    return Interval(a.lo - b.hi, a.hi - b.lo)


def imul(a: Interval, b: Interval) -> Interval:
    c = [_xmul(x, y) for x in (a.lo, a.hi) for y in (b.lo, b.hi)]
    return Interval(min(c), max(c))


def idiv(a: Interval, b: Interval) -> Interval:
    if b.lo > 0.0 or b.hi < 0.0:  # 0 excluded: monotone in 1/b
        return imul(a, Interval(1.0 / b.hi, 1.0 / b.lo))
    return TOP


def _monotone(fn: Callable[[float], float]) -> Callable[[Interval], Interval]:
    def rule(a: Interval) -> Interval:
        return Interval(fn(a.lo), fn(a.hi))
    return rule


def _sigmoid(x: float) -> float:
    if x >= 0:
        return 1.0 / (1.0 + math.exp(-min(x, 700.0)))
    e = math.exp(max(x, -700.0))
    return e / (1.0 + e)


def _exp(x: float) -> float:
    return math.exp(x) if x < 700.0 else INF


def _log(x: float) -> float:
    if x <= 0.0:
        return -INF
    return math.log(x) if math.isfinite(x) else INF


def _log1p(x: float) -> float:
    if x <= -1.0:
        return -INF
    return math.log1p(x) if math.isfinite(x) else INF


def _sqrt(x: float) -> float:
    return math.sqrt(x) if 0.0 <= x < INF else (INF if x == INF else 0.0)


def _tanh(a: Interval) -> Interval:
    return Interval(math.tanh(max(a.lo, -20.0)) if a.lo > -INF else -1.0,
                    math.tanh(min(a.hi, 20.0)) if a.hi < INF else 1.0)


# ---------------------------------------------------------------------------
# Producer graph
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class Node:
    """One value in the (inlined) producer graph: its interval, the op
    that made it (``prim``: the aten overload packet, or ``input``,
    ``param``, ``const``), its operand nodes, and where it came from."""

    ival: Interval
    prim: str
    operands: Tuple["Node", ...] = ()
    target: str = ""          # e.g. aten.sub.Tensor
    name: str = ""            # the FX node's name
    aval: str = ""            # dtype[shape]
    where: str = ""           # file:line of the code that made it
    exact: bool = True        # a conversion that cannot round upward

    def describe(self) -> str:
        at = f" at {self.where}" if self.where else ""
        tgt = self.target or self.prim
        return f"{tgt} {self.name} {self.aval}: {self.ival}{at}"


_FRAME_RE = re.compile(r'File "([^"]+)", line (\d+)')
_anchored: set = set()


def anchor_port_code() -> None:
    """Make exports record the port's own frames in ``stack_trace``.
    Non-strict export keeps only frames of functions named ``forward``
    unless a function is registered as an anchor; every function and
    method of the loaded ``repro_torch`` modules is registered, where the
    installed torch offers the hook (else the traces keep the forward
    frames alone)."""
    import inspect
    import sys
    register = getattr(torch.fx.proxy, "_register_stack_trace_anchor", None)
    if register is None:
        return
    for name, mod in list(sys.modules.items()):
        if not name.startswith("repro_torch") or name in _anchored \
                or mod is None:
            continue
        _anchored.add(name)
        for obj in list(vars(mod).values()):
            fns = [obj] if inspect.isfunction(obj) else (
                [f for f in vars(obj).values() if inspect.isfunction(f)]
                if inspect.isclass(obj) else [])
            for fn in fns:
                if getattr(fn, "__module__", None) == name:
                    register(fn)


def export_graph(module: torch.nn.Module, args: Tuple, **kw):
    """``torch.export.export`` of ``module`` at ``args`` under ``no_grad``,
    with the port's frames in every node's ``stack_trace``; counted in the
    signature guard's global signal."""
    from repro_torch.analysis import recompile
    anchor_port_code()
    with torch.no_grad():
        ep = torch.export.export(module, args, **kw)
    recompile.count_export()
    return ep


def where_of(fx_node) -> str:
    """``file:line`` of the innermost frame of the node's stack trace
    (the path from its package directory on)."""
    frames = _FRAME_RE.findall(fx_node.meta.get("stack_trace") or "")
    if not frames:
        return ""
    path, line = frames[-1]
    for mark in ("/src/", "/site-packages/"):
        if mark in path:
            path = path.split(mark, 1)[1]
            break
    return f"{path}:{line}"


def _aval(val) -> str:
    if isinstance(val, torch.Tensor):
        return f"{str(val.dtype).replace('torch.', '')}{list(val.shape)}"
    return type(val).__name__


_FLOAT_BITS = {torch.bfloat16: 8, torch.float16: 11, torch.float32: 24,
               torch.float64: 53}
_SMALL_INTS = (torch.bool, torch.int8, torch.uint8, torch.int16)


def _conversion_exact(src: Optional[torch.dtype],
                      dst: Optional[torch.dtype]) -> bool:
    """True when converting ``src`` to ``dst`` cannot round a value up:
    the same dtype, a float to a same-or-wider float, or a small integer
    to a float."""
    if src is None or dst is None or src == dst:
        return src == dst
    if dst in _FLOAT_BITS and src in _FLOAT_BITS:
        return _FLOAT_BITS[dst] >= _FLOAT_BITS[src]
    return dst in (torch.float32, torch.float64) and src in _SMALL_INTS


def _refine_dtype(iv: Interval, dtype) -> Interval:
    """Clamp to the values ``dtype`` can hold: [0, 1] for bool, the
    integer range for integer dtypes."""
    if dtype is None:
        return iv
    if dtype == torch.bool:
        return Interval(max(iv.lo, 0.0), min(iv.hi, 1.0))
    if not dtype.is_floating_point and not dtype.is_complex:
        info = torch.iinfo(dtype)
        return Interval(max(iv.lo, float(info.min)),
                        min(iv.hi, float(info.max)))
    return iv


def _value_interval(t) -> Interval:
    try:
        arr = np.asarray(t.detach().cpu().double() if isinstance(
            t, torch.Tensor) else t, dtype=np.float64)
        if arr.size == 0:
            return Interval(0.0, 0.0)
        return Interval(float(arr.min()), float(arr.max()))
    except (TypeError, ValueError, OverflowError, RuntimeError):
        return TOP


def _dtype_of(val):
    return val.dtype if isinstance(val, torch.Tensor) else None


def _shape_of(val) -> Tuple[int, ...]:
    return tuple(int(d) for d in val.shape) \
        if isinstance(val, torch.Tensor) else ()


# ops whose output holds exactly the elements of their first operand
# (or a subset, in another layout): transparent to both provers
IDENTITY_PRIMS = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "expand_as", "slice",
    "select", "index", "index_select", "gather", "embedding", "permute",
    "transpose", "t", "numpy_T", "unsqueeze", "squeeze", "flatten",
    "unflatten", "contiguous", "clone", "alias", "detach", "lift_fresh_copy",
    "repeat", "narrow", "roll", "flip", "movedim", "as_strided", "view_as",
    "reshape_as", "_reshape_alias", "diagonal", "take_along_dim",
    "repeat_interleave", "masked_select", "dropout",
})
# conversions: value-preserving where exact (``Node.exact``)
CONVERT_PRIMS = frozenset({"to", "_to_copy", "type_as", "_to_dtype"})
# ops that return their first operand's elements in several outputs
_SPLIT_PRIMS = frozenset({"split", "split_with_sizes", "chunk", "unbind",
                          "tensor_split"})
# ops that emit nothing the analysis reads
_NO_VALUE = frozenset({"_assert_tensor_metadata", "_assert_scalar",
                       "sym_constrain_range_for_size", "_assert_async",
                       "sym_constrain_range"})


def _iv(x) -> Optional[Interval]:
    """The interval of an argument: a node's, a number's, None otherwise."""
    if isinstance(x, Node):
        return x.ival
    if isinstance(x, bool):
        return Interval(float(x), float(x))
    if isinstance(x, (int, float)):
        return Interval(float(x), float(x))
    return None


def _scaled_sum(a: Interval, n: int) -> Interval:
    """Sum of n elements each in ``a``: exactly [n*lo, n*hi]."""
    return Interval(_xmul(float(n), a.lo), _xmul(float(n), a.hi))


def _count(shape: Sequence[int], dims) -> int:
    if dims is None or dims == [] or dims == ():
        dims = range(len(shape))
    if isinstance(dims, int):
        dims = [dims]
    n = 1
    for d in dims:
        n *= shape[d] if shape else 1
    return max(n, 1)


def _ipow(x: float, y: int) -> float:
    if not math.isfinite(x):
        return x if y % 2 == 1 or x > 0 else INF
    try:
        return float(x) ** y
    except OverflowError:
        return INF if (x > 0 or y % 2 == 0) else -INF


def _int_pow(a: Interval, y: int) -> Interval:
    if y == 0:
        return Interval(1.0, 1.0)
    if y < 0:
        return idiv(Interval(1.0, 1.0), _int_pow(a, -y))
    c = [_ipow(a.lo, y), _ipow(a.hi, y)]
    lo, hi = min(c), max(c)
    if y % 2 == 0:
        lo = 0.0 if a.lo <= 0.0 <= a.hi else max(lo, 0.0)
    return Interval(lo, hi)


def _rule_pow(args, kw, ins, outs) -> Interval:
    b, ex = _iv(args[0]), args[1]
    if isinstance(ex, (int, float)) and float(ex).is_integer():
        return _int_pow(b, int(ex))
    if b is not None and b.lo >= 0.0:
        if isinstance(ex, (int, float)) and ex > 0 and b.hi < INF:
            return Interval(b.lo ** ex, b.hi ** ex)
        return Interval(0.0, INF)
    return TOP


def _rule_square(a: Interval) -> Interval:
    return _int_pow(a, 2)


def _rule_abs(a: Interval) -> Interval:
    return Interval(0.0 if a.lo <= 0.0 <= a.hi else min(abs(a.lo),
                                                        abs(a.hi)),
                    max(abs(a.lo), abs(a.hi)))


def _rule_rsqrt(a: Interval) -> Interval:
    if a.lo > 0.0:
        return Interval(1.0 / _sqrt(a.hi) if a.hi < INF else 0.0,
                        1.0 / math.sqrt(a.lo))
    return Interval(0.0, INF) if a.lo >= 0.0 else TOP


def _rule_add(args, kw, ins, outs) -> Interval:
    alpha = kw.get("alpha", args[2] if len(args) > 2 else 1)
    return iadd(_iv(args[0]), imul(_iv(args[1]), _iv(alpha)))


def _rule_sub(args, kw, ins, outs) -> Interval:
    alpha = kw.get("alpha", args[2] if len(args) > 2 else 1)
    return isub(_iv(args[0]), imul(_iv(args[1]), _iv(alpha)))


def _rule_div(args, kw, ins, outs) -> Interval:
    q = idiv(_iv(args[0]), _iv(args[1]))
    if kw.get("rounding_mode") is not None:
        return Interval(q.lo - 1.0, q.hi + 1.0)
    return q


def _rule_where(args, kw, ins, outs) -> Interval:
    return _iv(args[1]).join(_iv(args[2]))


def _rule_clamp(args, kw, ins, outs) -> Interval:
    x = _iv(args[0])
    lo = kw.get("min", args[1] if len(args) > 1 else None)
    hi = kw.get("max", args[2] if len(args) > 2 else None)
    lo_i, hi_i = _iv(lo), _iv(hi)
    if lo_i is not None:
        x = Interval(max(x.lo, lo_i.lo), max(x.hi, lo_i.hi))
    if hi_i is not None:
        x = Interval(min(x.lo, hi_i.hi), min(x.hi, hi_i.hi))
    return x


def _rule_clamp_min(args, kw, ins, outs) -> Interval:
    x, lo = _iv(args[0]), _iv(args[1])
    return Interval(max(x.lo, lo.lo), max(x.hi, lo.hi))


def _rule_clamp_max(args, kw, ins, outs) -> Interval:
    x, hi = _iv(args[0]), _iv(args[1])
    return Interval(min(x.lo, hi.lo), min(x.hi, hi.hi))


def _rule_max2(args, kw, ins, outs) -> Interval:
    a, b = _iv(args[0]), _iv(args[1])
    return Interval(max(a.lo, b.lo), max(a.hi, b.hi))


def _rule_min2(args, kw, ins, outs) -> Interval:
    a, b = _iv(args[0]), _iv(args[1])
    return Interval(min(a.lo, b.lo), min(a.hi, b.hi))


def _contraction(args, ins) -> int:
    """The contraction length of a matmul-like op: the first operand's
    last dim."""
    shape = _shape_of(ins[0])
    return shape[-1] if shape else 1


def _rule_matmul(args, kw, ins, outs) -> Interval:
    return _scaled_sum(imul(_iv(args[0]), _iv(args[1])),
                       _contraction(args, ins))


def _rule_linear(args, kw, ins, outs) -> Interval:
    out = _scaled_sum(imul(_iv(args[0]), _iv(args[1])),
                      _contraction(args, ins))
    bias = args[2] if len(args) > 2 else kw.get("bias")
    return iadd(out, _iv(bias)) if bias is not None else out


def _rule_addmm(args, kw, ins, outs) -> Interval:
    beta = _iv(kw.get("beta", 1))
    alpha = _iv(kw.get("alpha", 1))
    prod = _scaled_sum(imul(_iv(args[1]), _iv(args[2])),
                       _shape_of(ins[1])[-1])
    return iadd(imul(beta, _iv(args[0])), imul(alpha, prod))


def _rule_einsum(args, kw, ins, outs) -> Interval:
    eq, operands = args[0].replace(" ", ""), list(args[1])
    lhs, _, rhs = eq.partition("->")
    terms = lhs.split(",")
    if "->" not in eq or "." in eq or len(terms) != len(operands):
        return TOP
    sizes: Dict[str, int] = {}
    for term, op in zip(terms, operands):
        shape = _shape_of(op.val) if isinstance(op, _Arg) else ()
        for ch, d in zip(term, shape):
            sizes.setdefault(ch, d)
    iv = Interval(1.0, 1.0)
    for op in operands:
        iv = imul(iv, op.node.ival if isinstance(op, _Arg) else TOP)
    n = 1
    for ch in set("".join(terms)) - set(rhs):
        n *= sizes.get(ch, 1)
    return _scaled_sum(iv, max(n, 1))


def _rule_sum(args, kw, ins, outs) -> Interval:
    dims = kw.get("dim", args[1] if len(args) > 1 else None)
    return _scaled_sum(_iv(args[0]), _count(_shape_of(ins[0]), dims))


def _rule_cumsum(args, kw, ins, outs) -> Interval:
    a = _iv(args[0])
    shape = _shape_of(ins[0])
    dim = kw.get("dim", args[1] if len(args) > 1 else 0)
    n = shape[dim] if shape else 1
    return Interval(min(_xmul(n, a.lo), a.lo), max(_xmul(n, a.hi), a.hi))


def _join_all(items) -> Interval:
    iv = None
    for x in items:
        xi = _iv(x)
        iv = xi if iv is None else iv.join(xi)
    return iv if iv is not None else TOP


def _rule_cat(args, kw, ins, outs) -> Interval:
    return _join_all(args[0])


def _rule_arange(args, kw, ins, outs) -> Interval:
    nums = [a for a in args if isinstance(a, (int, float))]
    if len(nums) == 1:
        start, end, step = 0.0, float(nums[0]), 1.0
    elif len(nums) >= 2:
        start, end = float(nums[0]), float(nums[1])
        step = float(nums[2]) if len(nums) > 2 else float(kw.get("step", 1))
    else:
        return TOP
    if (end - start) * step <= 0:
        return Interval(0.0, 0.0)
    return Interval(min(start, end - step), max(start, end - step))


def _rule_full(args, kw, ins, outs) -> Interval:
    v = kw.get("fill_value", args[1] if len(args) > 1 else None)
    return _iv(v) or TOP


def _rule_put(args, kw, ins, outs) -> Interval:
    """index_put / scatter / masked_fill style: the old elements or the
    written ones."""
    src = args[2] if len(args) > 2 else kw.get("values", kw.get("src"))
    iv = _iv(src)
    return _iv(args[0]).join(iv) if iv is not None else TOP


def _rule_scatter_to(args, kw, ins, outs) -> Interval:
    """slice_scatter / select_scatter / copy(self, src)."""
    return _iv(args[0]).join(_iv(args[1]))


def _rule_tril(args, kw, ins, outs) -> Interval:
    return _iv(args[0]).join(Interval(0.0, 0.0))


def _simple(fn):
    return lambda args, kw, ins, outs: fn(*[_iv(a) for a in args
                                            if isinstance(a, Node)])


def _first(args, kw, ins, outs) -> Interval:
    return _iv(args[0])


def _const(iv: Interval):
    return lambda args, kw, ins, outs: iv


def _top(args, kw, ins, outs) -> Interval:
    return TOP


_RULES: Dict[str, Callable] = {
    "add": _rule_add, "sub": _rule_sub, "rsub": lambda a, k, i, o: isub(
        _iv(a[1]), imul(_iv(a[0]), _iv(k.get("alpha", 1)))),
    "mul": lambda a, k, i, o: imul(_iv(a[0]), _iv(a[1])),
    "div": _rule_div,
    "neg": _simple(lambda a: Interval(-a.hi, -a.lo)),
    "abs": _simple(_rule_abs),
    "sign": _const(Interval(-1.0, 1.0)),
    "square": _simple(_rule_square),
    "pow": _rule_pow,
    "reciprocal": _simple(lambda a: idiv(Interval(1.0, 1.0), a)),
    "rsqrt": _simple(_rule_rsqrt),
    "sqrt": _simple(_monotone(_sqrt)),
    "exp": _simple(_monotone(_exp)),
    "log": _simple(_monotone(_log)),
    "log1p": _simple(_monotone(_log1p)),
    "sigmoid": _simple(lambda a: Interval(max(_sigmoid(a.lo), 0.0),
                                          min(_sigmoid(a.hi), 1.0))),
    "tanh": _simple(_tanh),
    "sin": _const(Interval(-1.0, 1.0)), "cos": _const(Interval(-1.0, 1.0)),
    "erf": _const(Interval(-1.0, 1.0)),
    "where": _rule_where,
    "clamp": _rule_clamp,
    "clamp_min": _rule_clamp_min, "clamp_max": _rule_clamp_max,
    "maximum": _rule_max2, "minimum": _rule_min2,
    "mm": _rule_matmul, "bmm": _rule_matmul, "matmul": _rule_matmul,
    "linear": _rule_linear, "addmm": _rule_addmm, "einsum": _rule_einsum,
    "sum": _rule_sum, "mean": _first, "amax": _first, "amin": _first,
    "cumsum": _rule_cumsum, "cummax": _first, "cummin": _first,
    "softmax": _const(UNIT), "_softmax": _const(UNIT),
    "cat": _rule_cat, "stack": _rule_cat,
    "index_put": _rule_put, "index_put_": _rule_put,
    "index_copy": _rule_put, "index_copy_": _rule_put,
    "scatter": _rule_put, "scatter_": _rule_put,
    "masked_fill": _rule_put, "masked_fill_": _rule_put,
    "slice_scatter": _rule_scatter_to, "select_scatter": _rule_scatter_to,
    "copy": _rule_scatter_to, "copy_": lambda a, k, i, o: _iv(a[1]),
    "tril": _rule_tril, "triu": _rule_tril,
    "arange": _rule_arange,
    "zeros": _const(Interval(0.0, 0.0)),
    "zeros_like": _const(Interval(0.0, 0.0)),
    "new_zeros": _const(Interval(0.0, 0.0)),
    "ones": _const(Interval(1.0, 1.0)), "ones_like": _const(Interval(1.0, 1.0)),
    "new_ones": _const(Interval(1.0, 1.0)),
    "full": _rule_full, "new_full": _rule_full,
    "full_like": _rule_full,
    "scalar_tensor": lambda a, k, i, o: _iv(a[0]) or TOP,
    "floor": _simple(lambda a: Interval(a.lo - 1.0, a.hi)),
    "ceil": _simple(lambda a: Interval(a.lo, a.hi + 1.0)),
    "round": _simple(lambda a: Interval(a.lo - 1.0, a.hi + 1.0)),
    "remainder": _top, "fmod": _top, "empty": _top, "empty_like": _top,
    # max.other / min.other elementwise; max.default / min.default reduce
    "max": lambda a, k, i, o: _rule_max2(a, k, i, o) if len(a) > 1
    else _iv(a[0]),
    "min": lambda a, k, i, o: _rule_min2(a, k, i, o) if len(a) > 1
    else _iv(a[0]),
}
for _p in IDENTITY_PRIMS | CONVERT_PRIMS:
    _RULES.setdefault(_p, _first)

# multi-output ops: one interval per output
_MULTI_RULES: Dict[str, Callable] = {
    "max": lambda args, ins: [_iv(args[0]), Interval(
        0.0, float(max(_shape_of(ins[0])[args[1]] - 1, 0))
        if len(args) > 1 and _shape_of(ins[0]) else INF)],
    "min": lambda args, ins: [_iv(args[0]), Interval(
        0.0, float(max(_shape_of(ins[0])[args[1]] - 1, 0))
        if len(args) > 1 and _shape_of(ins[0]) else INF)],
    "sort": lambda args, ins: [_iv(args[0]), Interval(0.0, INF)],
    "topk": lambda args, ins: [_iv(args[0]), Interval(0.0, INF)],
}


@dataclasses.dataclass
class _Arg:
    """A tensor argument of an op: its node and its example value."""

    node: Node
    val: Any


def _packet(target) -> Tuple[str, str, str]:
    """(namespace, overload packet name, qualified name) of a
    call_function target."""
    if isinstance(target, torch._ops.OpOverload):
        return (target.namespace, target._overloadpacket.__name__,
                f"{target.namespace}.{target._overloadpacket.__name__}."
                f"{target._overloadname}")
    mod = getattr(target, "__module__", "") or ""
    name = getattr(target, "__name__", str(target))
    return mod, name, f"{mod}.{name}"


# ---------------------------------------------------------------------------
# Kernels inlined through their plain versions
# ---------------------------------------------------------------------------


def _plain_fns() -> Dict[str, Callable]:
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import monitor_combine as mc
    from repro_torch.kernels import ssm_scan as ss
    return {
        "decode_attention": lambda q, k, v, pos: da.decode_attention_plain(
            q, k, v, pos),
        "decode_attention_partial": lambda q, k, v, pos, base:
        da.decode_attention_partial_plain(q, k, v, pos, base),
        "monitor_combine": lambda u, v, f, s, thr, margin:
        mc.monitor_combine_plain(u, v, f, s=s, threshold=thr, margin=margin),
        "flash_attention_fwd": lambda q, k, v, window:
        fa.flash_attention_plain(q, k, v, window=window),
        "ssd_scan_fwd": lambda xdt, la, Bm, Cm, chunk:
        ss.ssd_scan_plain(xdt, la, Bm, Cm, chunk=chunk),
    }


_PLAIN_EXPORTS: Dict[Tuple, Any] = {}


class _Plain(torch.nn.Module):
    def __init__(self, fn, statics):
        super().__init__()
        self.fn, self.statics = fn, statics

    def forward(self, *tensors):
        it = iter(tensors)
        args = [next(it) if s is None else s for s in self.statics]
        return self.fn(*args)


def plain_export(op_name: str, args: Sequence[Any]):
    """The export of kernel ``op_name``'s plain version at ``args``'
    shapes and dtypes (tensors: example values or fakes; the rest as
    given), cached by op, shapes and non-tensor arguments.  Built on the
    meta device: no memory, no arithmetic."""
    statics = tuple(None if isinstance(a, torch.Tensor) else a
                    for a in args)
    specs = tuple((tuple(a.shape), a.dtype) for a in args
                  if isinstance(a, torch.Tensor))
    key = (op_name, specs, statics)
    ep = _PLAIN_EXPORTS.get(key)
    if ep is None:
        examples = tuple(torch.zeros(shape, dtype=dt, device="meta")
                         for shape, dt in specs)
        ep = export_graph(_Plain(_plain_fns()[op_name], statics), examples)
        _PLAIN_EXPORTS[key] = ep
    return ep


# ---------------------------------------------------------------------------
# The interpreter
# ---------------------------------------------------------------------------


class SignAnalysis:
    """Abstract interpretation of one ``ExportedProgram``.
    ``in_intervals`` (optional, one per user input, flattened) refines the
    user inputs; the default is top.  ``in_nodes`` are the user inputs'
    nodes, ``out_nodes`` the user outputs'."""

    def __init__(self, ep, in_intervals: Optional[Sequence[Interval]] = None):
        self.ep = ep
        from torch.export.graph_signature import InputKind, OutputKind
        sig = ep.graph_signature
        kinds = {spec.arg.name: spec for spec in sig.input_specs
                 if hasattr(spec.arg, "name")}
        placeholders = [n for n in ep.graph.nodes if n.op == "placeholder"]
        user = [n for n in placeholders
                if kinds.get(n.name) is None
                or kinds[n.name].kind == InputKind.USER_INPUT]
        if in_intervals is None:
            in_intervals = [TOP] * len(user)
        user_iv = dict(zip((n.name for n in user), in_intervals))
        args: Dict[str, Node] = {}
        for n in placeholders:
            spec = kinds.get(n.name)
            val = n.meta.get("val")
            if spec is not None and spec.kind == InputKind.CONSTANT_TENSOR:
                iv, prim = _value_interval(ep.constants[spec.target]), "const"
            elif spec is not None and spec.kind != InputKind.USER_INPUT:
                iv, prim = TOP, "param"
            else:
                iv, prim = user_iv.get(n.name, TOP), "input"
            args[n.name] = Node(_refine_dtype(iv, _dtype_of(val)), prim,
                                name=n.name, aval=_aval(val),
                                target=spec.target if spec is not None
                                and spec.target else prim)
        self.in_nodes = [args[n.name] for n in user]
        outs = self._eval(ep.graph, args)
        kinds_out = [spec.kind for spec in sig.output_specs]
        self.out_nodes = [o for o, k in zip(outs, kinds_out)
                          if k == OutputKind.USER_OUTPUT]

    # -- evaluation ---------------------------------------------------------

    def _eval(self, graph, bound: Dict[str, Node]) -> List[Any]:
        """Evaluate ``graph`` with placeholders bound by name; returns the
        output node's values (Nodes, or lists of Nodes)."""
        env: Dict[Any, Any] = {}
        roots: Dict[Any, Any] = {}     # fx node -> fx node of its storage
        members: Dict[Any, List[Any]] = {}
        for n in graph.nodes:
            if n.op == "placeholder":
                env[n] = bound[n.name]
                roots[n] = n
                members.setdefault(n, []).append(n)
            elif n.op == "get_attr":
                val = getattr(graph.owning_module, n.target, None)
                env[n] = Node(_value_interval(val) if isinstance(
                    val, torch.Tensor) else TOP, "const", name=n.name)
            elif n.op == "call_function":
                env[n] = self._eval_call(n, env)
                self._track_aliases(n, env, roots, members)
            elif n.op == "output":
                return [self._read(a, env) for a in n.args[0]]
        return []

    def _read(self, a, env):
        if isinstance(a, torch.fx.Node):
            return env[a]
        if isinstance(a, (list, tuple)):
            return type(a)(self._read(x, env) for x in a)
        return a

    def _track_aliases(self, n, env, roots, members) -> None:
        """Views share their base's storage; an op that writes in place
        widens every value of the storage it wrote."""
        target = n.target
        if not isinstance(target, torch._ops.OpOverload):
            return
        schema = target._schema
        base = None
        for arg, sa in zip(n.args, schema.arguments):
            if isinstance(arg, torch.fx.Node) and sa.alias_info is not None:
                base = arg
                if sa.alias_info.is_write:
                    self._widen(roots.get(arg, arg), env[n] if isinstance(
                        env[n], Node) else None, env, members)
        if base is not None and (target.is_view or schema.is_mutable):
            root = roots.get(base, base)
            roots[n] = root
            members.setdefault(root, []).append(n)
        else:
            roots[n] = n
            members.setdefault(n, []).append(n)

    @staticmethod
    def _widen(root, written: Optional[Node], env, members) -> None:
        if written is None:
            return
        for m in members.get(root, [root]):
            node = env.get(m)
            if isinstance(node, Node) and node is not written:
                node.ival = node.ival.join(written.ival)

    def _eval_call(self, n, env):
        target = n.target
        if target is operator.getitem:
            seq, i = env[n.args[0]], n.args[1]
            return seq[i] if isinstance(seq, (list, tuple)) else seq
        ns, prim, qual = _packet(target)
        val = n.meta.get("val")
        f32 = isinstance(val, torch.Tensor) and val.dtype in (
            torch.float32, torch.bfloat16, torch.float16)
        args = _scalars_as(self._read(n.args, env), f32)
        kw = {k: _scalars_as(self._read(v, env), f32)
              for k, v in n.kwargs.items()}
        ins = [a.meta.get("val") if isinstance(a, torch.fx.Node) else None
               for a in n.args]
        operands = tuple(x for x in _flat(args) + _flat(list(kw.values()))
                         if isinstance(x, Node))
        where = where_of(n)
        if ns == "repro_torch":
            return self._inline(n, prim, args, operands, where)
        if target is getattr(torch.ops.higher_order, "while_loop", None):
            return self._eval_while(n, args)

        def mk(iv: Interval, v) -> Node:
            exact = True
            if prim in CONVERT_PRIMS and ins and isinstance(ins[0],
                                                            torch.Tensor):
                exact = _conversion_exact(ins[0].dtype, _dtype_of(v))
            return Node(_refine_dtype(iv, _dtype_of(v)), prim, operands,
                        target=qual, name=n.name, aval=_aval(v),
                        where=where, exact=exact)

        if prim in _NO_VALUE:
            return Node(TOP, prim, operands, target=qual, name=n.name)
        if isinstance(val, (list, tuple)):
            if prim in _SPLIT_PRIMS:
                ivs = [_iv(args[0])] * len(val)
            elif prim in _MULTI_RULES:
                ivs = _MULTI_RULES[prim](args, ins)
            else:
                ivs = [TOP] * len(val)
            return [mk(iv, v) for iv, v in zip(ivs, val)]
        rule = _RULES.get(prim)
        if rule is None:
            return mk(TOP, val)
        if prim == "einsum":
            wrapped = [_Arg(x, v) for x, v in zip(
                args[1], [a.meta.get("val") for a in n.args[1]])]
            iv = rule([args[0], wrapped], kw, ins, val)
        else:
            try:
                iv = rule(args, kw, ins, val)
            except (TypeError, IndexError, AttributeError, ValueError,
                    ZeroDivisionError, OverflowError):
                iv = TOP
        return mk(iv if iv is not None else TOP, val)

    def _eval_while(self, n, args) -> List[Node]:
        """``while_loop(cond, body, carries, extra)``: the body evaluated
        once with top carries (a sound post-fixpoint, every transfer
        function being monotone), each carry out joined with its initial
        value (covering zero iterations), as the reference's ``while``."""
        body = getattr(n.graph.owning_module, n.args[1].target)
        carries, extra = list(args[2]), list(args[3])
        ph = [p for p in body.graph.nodes if p.op == "placeholder"]
        bound = {}
        for p, init in zip(ph, carries + extra):
            bound[p.name] = Node(TOP, "loop_carry", name=p.name) \
                if len(bound) < len(carries) else init
        outs = self._eval(body.graph, bound)
        return [Node(o.ival.join(c.ival), "while_loop", tuple(args[2]),
                     target="higher_order.while_loop", name=n.name,
                     where=where_of(n))
                for o, c in zip(_flat(outs), carries)]

    def _inline(self, n, prim, args, operands, where):
        """A kernel node through its plain version's export, the caller's
        nodes bound to its inputs."""
        vals = [a.meta.get("val") if isinstance(a, torch.fx.Node) else a
                for a in n.args]
        ep = plain_export(prim, vals)
        inner_ph = [p for p in ep.graph.nodes if p.op == "placeholder"]
        from torch.export.graph_signature import InputKind
        specs = {s.arg.name: s for s in ep.graph_signature.input_specs}
        tensors = iter(a for a in args if isinstance(a, Node))
        bound = {}
        for p in inner_ph:
            spec = specs[p.name]
            if spec.kind == InputKind.USER_INPUT:
                bound[p.name] = next(tensors)
            elif spec.kind == InputKind.CONSTANT_TENSOR:
                bound[p.name] = Node(_value_interval(
                    ep.constants[spec.target]), "const", name=p.name)
            else:
                bound[p.name] = Node(TOP, "param", name=p.name)
        outs = self._eval(ep.graph, bound)
        val = n.meta.get("val")
        if not isinstance(val, (list, tuple)):
            return outs[0]
        return list(outs)


def _scalars_as(x, f32: bool):
    """Python floats as the op computes with them: rounded to float32
    where the op computes in float32 (bf16 and f16 ops too)."""
    if not f32:
        return x
    if isinstance(x, float):
        return float(np.float32(x))
    if isinstance(x, (list, tuple)):
        return type(x)(_scalars_as(y, f32) for y in x)
    return x


def _flat(x) -> List[Any]:
    if isinstance(x, (list, tuple)):
        out = []
        for y in x:
            out += _flat(y)
        return out
    return [x]


def analyze_graph(ep, in_intervals=None) -> SignAnalysis:
    """Run the abstract interpreter over an ``ExportedProgram``; returns
    the analysis (``.in_nodes``, ``.out_nodes`` hold the producer
    graph)."""
    return SignAnalysis(ep, in_intervals)


# ---------------------------------------------------------------------------
# Structural prover + counterexample chains
# ---------------------------------------------------------------------------


def _transparent(node: Node) -> bool:
    """A node whose elements are exactly (some of) its first operand's."""
    if not node.operands:
        return False
    if node.prim in IDENTITY_PRIMS:
        return True
    return node.prim in CONVERT_PRIMS and node.exact


def prove_nonneg(node: Node) -> Tuple[bool, List[str]]:
    """Interval proof of ``node >= 0`` elementwise; on failure, the
    producer chain that introduced the negative range."""
    if node.ival.nonneg:
        return True, [f"proved: {node.describe()} (interval nonnegative)"]
    return False, _blame_chain(node)


def _blame_chain(node: Node, depth: int = 14) -> List[str]:
    chain = [node.describe()]
    cur = node
    while depth > 0 and cur.operands:
        nxt = None
        for op in cur.operands:  # follow the operand that can go negative
            if not op.ival.nonneg:
                nxt = op
                break
        if nxt is None:
            break
        chain.append(nxt.describe())
        cur = nxt
        depth -= 1
    return chain


def prove_le(f: Node, u: Node, depth: int = 64) -> Tuple[bool, List[str]]:
    """Structural proof of ``f <= u`` elementwise.  Returns (ok, chain):
    the proof steps on success, the refuting producer path on failure."""
    return _prove_le(f, u, depth)


def _prove_le(f: Node, u: Node, depth: int) -> Tuple[bool, List[str]]:
    here = f.describe()
    if f is u:
        return True, [f"{here} == u (same producer)"]
    if depth <= 0:
        return False, [f"{here}: proof depth exhausted"]
    # numeric fallback: intervals alone can settle it
    if f.ival.hi <= u.ival.lo:
        return True, [f"{here} <= {u.ival} numerically"]
    # look through exact value-preserving producers of u, then of f
    if _transparent(u):
        return _prove_le(f, u.operands[0], depth - 1)
    if _transparent(f):
        return _prove_le(f.operands[0], u, depth - 1)
    if f.prim == "sub" and len(f.operands) == 2:
        a, b = f.operands
        ok, sub_chain = _prove_le(a, u, depth - 1)
        if ok and b.ival.nonneg:
            return True, [f"{here} = a - b with b {b.ival} >= 0"] + sub_chain
        if ok:
            return False, [f"{here}: subtrahend may be negative"] + \
                _blame_chain(b)
        return False, [f"{here}: minuend does not prove"] + sub_chain
    if f.prim == "add" and len(f.operands) == 2:
        a, b = f.operands
        for x, y in ((a, b), (b, a)):
            if y.ival.nonpos:
                ok, sub_chain = _prove_le(x, u, depth - 1)
                if ok:
                    return True, [f"{here} = x + y with y {y.ival} <= 0"] + \
                        sub_chain
        return False, [f"{here}: no nonpositive addend"]
    if (f.prim in ("minimum", "min") and len(f.operands) == 2) or (
            f.prim == "clamp_max" and f.operands):
        fails: List[str] = []
        for op in f.operands:
            ok, sub_chain = _prove_le(op, u, depth - 1)
            if ok:
                return True, [f"{here} = min(...), one operand proves"] + \
                    sub_chain
            fails = sub_chain
        return False, [f"{here}: no min operand proves"] + fails
    if f.prim in ("maximum", "max") and len(f.operands) == 2:
        chains = [f"{here} = max(...), all operands must prove"]
        for op in f.operands:
            ok, sub_chain = _prove_le(op, u, depth - 1)
            if not ok:
                return False, [f"{here}: max operand fails"] + sub_chain
            chains += sub_chain
        return True, chains
    if f.prim == "where" and len(f.operands) == 3:
        chains = [f"{here} = where, every branch must prove"]
        for op in f.operands[1:]:
            ok, sub_chain = _prove_le(op, u, depth - 1)
            if not ok:
                return False, [f"{here}: where branch fails"] + sub_chain
            chains += sub_chain
        return True, chains
    return False, [f"{here}: no structural rule applies "
                   f"(u is {u.describe()})"]


# ---------------------------------------------------------------------------
# Certificates for the serving stack
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SignCertificate:
    """Per-(target, arch, sigma) result of the safety proof."""

    target: str           # "collab_forward" | "catchup"
    arch: str
    sigma: str
    ok: bool
    corr_interval: Optional[Interval]
    detail: str           # proof summary or counterexample chain

    def __str__(self) -> str:
        verdict = "PROVED" if self.ok else "REFUTED"
        corr = f" corr={self.corr_interval}" if self.corr_interval else ""
        return (f"[{verdict}] {self.target} arch={self.arch} "
                f"sigma={self.sigma}{corr}")


def with_sigma(cfg, sigma: Optional[str] = None, s: Optional[float] = None):
    """``cfg`` with its monitor's sigma kind and/or scale replaced."""
    mon = cfg.monitor
    kw = dict(mon.__dict__)
    if sigma is not None:
        kw["sigma"] = sigma
    if s is not None:
        kw["s"] = s
    return cfg.replace(monitor=mon.__class__(**kw))


def _model(cfg, device, seed: int = 0):
    """The collaborative LM of ``cfg`` on ``device``: on the meta device
    shapes only (no memory, whatever the width), elsewhere seeded
    weights."""
    from repro_torch.core import decomposition as deco
    from repro_torch.nn.module import resolve_device
    device = resolve_device(device)
    if device.type == "meta":
        return deco.CollabLM(cfg, device)
    return deco.init_collab_lm(cfg, torch.Generator(device).manual_seed(seed),
                               device)


class _Forward(torch.nn.Module):
    def __init__(self, model, cfg):
        super().__init__()
        self.model, self.cfg = model, cfg

    def forward(self, batch):
        from repro_torch.core import decomposition as deco
        out = deco.collab_forward(self.model, self.cfg, batch)
        return out["corr"], out["fhat"], out["u"]


def export_forward(model, cfg, batch):
    """The export of ``collab_forward`` returning (corr, fhat, u)."""
    return export_graph(_Forward(model, cfg), (batch,))


def forward_batch(cfg, batch: int, length: int, device):
    """A token batch of ``lm_batches`` seed 0 on ``device``."""
    from repro_torch.data import tokens as tok
    b = next(tok.lm_batches(0, cfg, batch, length))
    return {k: torch.as_tensor(v, device=device) for k, v in b.items()}


def verify_forward(cfg, arch: str = "?", sigma: Optional[str] = None,
                   s: Optional[float] = None, batch: int = 2,
                   length: int = 4, device="meta",
                   model=None) -> SignCertificate:
    """Prove ``corr >= 0`` and ``fhat <= u`` on the exported training-time
    ``collab_forward`` (parameters top).  ``model``: the model to export
    (default: built on ``device``, by default the meta device, so a
    FULL-width certificate allocates nothing; the proof reads no weight's
    value)."""
    cfg = with_sigma(cfg, sigma, s)
    if model is None:
        model = _model(cfg, device)
    ep = export_forward(model, cfg, forward_batch(cfg, batch, length,
                                                  device))
    return certify_forward(ep, arch, cfg.monitor.sigma)


def certify_forward(ep, arch: str, sigma_kind: str) -> SignCertificate:
    """The forward certificate over an export returning (corr, fhat, u)."""
    analysis = analyze_graph(ep)
    corr_node, fhat_node, u_node = analysis.out_nodes
    ok_corr, corr_chain = prove_nonneg(corr_node)
    ok_le, le_chain = prove_le(fhat_node, u_node)
    lines: List[str] = []
    if not ok_corr:
        lines.append("corr >= 0 REFUTED; producer chain:")
        lines += ["  " + c for c in corr_chain]
    else:
        lines.append(f"corr >= 0: interval {corr_node.ival}")
    if not ok_le:
        lines.append("fhat <= u REFUTED; producer chain:")
        lines += ["  " + c for c in le_chain]
    else:
        lines.append("fhat <= u: " + le_chain[0])
    return SignCertificate("collab_forward", arch, sigma_kind,
                           ok_corr and ok_le, corr_node.ival,
                           "\n".join(lines))


class CatchupGraph(torch.nn.Module):
    """``CollaborativeEngine._catchup_apply`` as a module: the server
    cache and a backlog's tensors in, (v, fhat) out; the cache is a user
    input written in place."""

    def __init__(self, engine):
        super().__init__()
        self.params = engine.params
        self.engine = engine

    def forward(self, cache, tokens, pos, active, triggered, u):
        from repro_torch.serving.async_rpc import Backlog
        return self.engine._catchup_apply(
            self.params, cache, Backlog(tokens, pos, active, triggered), u)


def catchup_inputs(engine, rounds: int = 2, u=None):
    """Inputs of ``CatchupGraph``: the engine's server cache and a backlog
    of ``rounds`` rounds with every stream triggered from position 0."""
    B = engine.batch
    bl = engine._backlog(np.zeros(B, np.int64),
                         np.full(B, rounds - 1, np.int64), np.ones(B, bool))
    if u is None:
        u = torch.zeros(B, dtype=torch.float32, device=engine.device)
    return (engine.server.cache, bl.tokens, bl.pos, bl.active,
            bl.triggered, u)


def export_catchup(engine, rounds: int = 2, args=None):
    """The export of one catch-up of ``rounds`` rounds plus the fuse."""
    args = catchup_inputs(engine, rounds) if args is None else args
    return export_graph(CatchupGraph(engine), args)


def verify_catchup(cfg, arch: str = "?", sigma: Optional[str] = None,
                   s: Optional[float] = None, batch: int = 2,
                   max_len: int = 8, rounds: int = 2, device="meta",
                   model=None) -> SignCertificate:
    """Prove ``fhat <= u`` on the serving engine's catch-up
    (``CollaborativeEngine._catchup_apply``: the rounds and the fuse every
    trigger runs), exported at ``rounds`` rounds, on an engine built on
    ``device`` (by default the meta device: no memory)."""
    from repro_torch.serving.collaborative import CollaborativeEngine
    cfg = with_sigma(cfg, sigma, s)
    if model is None:
        model = _model(cfg, device)
    eng = CollaborativeEngine(model, cfg, batch, max_len, device=device)
    return certify_catchup(export_catchup(eng, rounds), arch,
                           cfg.monitor.sigma)


def certify_catchup(ep, arch: str, sigma_kind: str) -> SignCertificate:
    """The catch-up certificate over an export of ``CatchupGraph``: the
    user output fhat against the user input u."""
    analysis = analyze_graph(ep)
    _, fhat_node = analysis.out_nodes
    u_node = analysis.in_nodes[-1]
    ok, chain = prove_le(fhat_node, u_node)
    corr_iv = _find_corr_interval(fhat_node)
    head = "fhat <= u: " if ok else "fhat <= u REFUTED; producer chain:"
    detail = "\n".join([head] + ["  " + c for c in chain])
    return SignCertificate("catchup", arch, sigma_kind, ok, corr_iv, detail)


def _find_corr_interval(fhat_node: Node,
                        depth: int = 24) -> Optional[Interval]:
    """Walk fhat's producers for the first ``sub`` and report the
    subtrahend's interval: the corrector term the proof hinged on."""
    stack, seen = [(fhat_node, depth)], set()
    while stack:
        node, d = stack.pop()
        if d <= 0 or id(node) in seen:
            continue
        seen.add(id(node))
        if node.prim == "sub" and len(node.operands) == 2:
            return node.operands[1].ival
        stack.extend((op, d - 1) for op in node.operands)
    return None


SIGMA_KINDS = ("sigmoid", "tanh01")


def verify_arch(cfg, arch: str = "?",
                sigma_kinds: Sequence[str] = SIGMA_KINDS,
                include_catchup: bool = True,
                device="meta") -> List[SignCertificate]:
    """The full sign-safety sweep for one arch: training forward and
    serving catch-up, under every sigma kind (one model on ``device``,
    by default the meta device: the proof reads no weight's value)."""
    model = _model(cfg, device)
    certs = []
    for kind in sigma_kinds:
        certs.append(verify_forward(cfg, arch=arch, sigma=kind,
                                    device=device, model=model))
        if include_catchup:
            certs.append(verify_catchup(cfg, arch=arch, sigma=kind,
                                        device=device, model=model))
    return certs
