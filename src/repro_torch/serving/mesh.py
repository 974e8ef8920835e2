"""Mesh-sharded serving: the per-stream state of a collaborative engine
split over the data axis of a device mesh, and a monitor path checked to
run without cross-shard traffic (the reference's ``serving/mesh.py``).

At production scale one corrector serves thousands of streams, and the
per-stream server state (the catch-up cache, the token history) no longer
fits one device.  ``shard_engine`` splits a ``CollaborativeEngine`` (and,
through it, a ``CorrectionServer``'s super-batch) into N shards of B/N
rows, N the mesh's data size (a ``pod`` axis widens it):

  * parameters: replicated, one copy per distinct device;
  * per-stream state: each shard holds its rows of the edge and server
    caches, of the token history, and of every (B,) protocol vector that
    reaches the device (positions, masks, scores, thresholds);
  * work: each shard's edge decode, u head, history record, catch-up
    rounds and fused combine run on its own rows, on its own device.

The reference compiles the shards into one SPMD program; here one process
drives them in turn, a single controller, as the reference's single
``jit`` is.  Torch's launches are asynchronous, so shards on distinct
cards overlap; each step's host reads come after every shard's launches.

The protocol is elementwise across streams, so shard i of a data:N
engine computes exactly what an unsharded engine of B/N rows fed shard
i's streams computes.  Two steps are not per shard:

  * the offline scan's compaction (``core.gating.compact_correction``)
    picks ``capacity`` rows across the whole batch.  Where the capacity
    binds, the shards' u and server hiddens are gathered onto the first
    shard's device, compacted there and each shard's rows handed back:
    one counted cross-shard step a scan step
    (``CollaborativeEngine._scan``); a per-shard compaction would be a
    different result.  Where it does not bind, every shard compacts its
    own rows, which is the same result.
  * the correction server's lease defrag moves rows, with their
    sessions, across shards (``permute_rows``), one counted step a
    defrag.

The engine runs every path over its lanes (``CollaborativeEngine._lanes``):
the shards of a sharded engine, or the engine itself as one lane.  The
server's row helpers here (``permute_rows``, ``fuse_rows``) take the same
lanes, so a sharded and an unsharded server share one code path.

``cross_shard_steps()`` counts what this module moves between shards.
It reads 0 over any number of sync or async steps: the catch-up's
``n_rounds``, the one scalar reduction of the reference's replay, is
computed on the host from host arrays (``CollaborativeEngine._backlog``).

The collective-free check (``edge_ops`` / ``assert_collective_free``) is
the reference's HLO check made for eager PyTorch (the graph rule of
``analysis/graph.py`` checks the exported monitor path; both take one
list of collective namespaces from there): it records every op of
the monitor path (``decode_at``, which the engine's step runs,
``decode_masked``, ``u_head``, ``record_at``) under a
``TorchDispatchMode`` and asserts no ``c10d`` op, no copy between devices
(a host upload excepted), and no op that reads the data of two shards.
The kernels launched through ctypes are single opaque calls to it: their
operands are checked where torch ops make them.

Entry points: ``MeshSpec.parse("data:8")`` (``SessionConfig(mesh=...)``,
``CollaborativeEngine(mesh=...)``, ``CorrectionServer(mesh=...)``,
``--mesh`` on the launchers), ``MeshSpec.build(devices=None)``,
``shard_engine`` / ``ensure_sharded``, ``bytes_per_device``.
"""
from __future__ import annotations

import collections
import contextlib
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.analysis.graph import COLLECTIVE_NAMESPACES
from repro_torch.core import decomposition as deco
from repro_torch.distributed.sharding import Mesh, data_axes
from repro_torch.nn.module import resolve_device
from repro_torch.serving.async_rpc import Sharded, parts_of
from repro_torch.serving.engine import (CACHE_BATCH_AXIS, ServeEngine,
                                        _entries, zero_cache_rows)

_AXIS_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")

# ops namespaces of torch.distributed's collectives: the graph rule's
# list (``analysis/graph.py``), so the op recorder and the rule agree
C10D_NAMESPACES = COLLECTIVE_NAMESPACES

# what this module moves between shards, by kind (``cross_shard_steps``)
_CROSS: collections.Counter = collections.Counter()


def cross_shard_steps() -> Dict[str, int]:
    """Cross-shard steps this module has made since the last reset:
    ``scan_gather`` (one a scan step where the capacity binds) and
    ``defrag`` (one a lease defrag that moves rows across shards)."""
    return dict(_CROSS)


def reset_cross_shard_steps() -> None:
    _CROSS.clear()


def count_cross_shard(kind: str) -> None:
    _CROSS[kind] += 1


@dataclass(frozen=True)
class MeshSpec:
    """A parsed, validated mesh description, ``"data:8"`` style.

    ``axes`` is an ordered tuple of (name, size) pairs.  Serving splits
    per-stream state over the ``data`` axis (a ``pod`` axis widens it, as
    ``distributed.sharding.data_axes`` does); any other axis is legal in
    the spec but idle on the serving path (parameters replicate).
    """

    axes: Tuple[Tuple[str, int], ...] = (("data", 1),)

    def __post_init__(self):
        if not self.axes:
            raise ValueError("empty mesh spec")
        names = [n for n, _ in self.axes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate mesh axis in {names}")
        for name, size in self.axes:
            if not _AXIS_RE.match(name):
                raise ValueError(f"bad mesh axis name {name!r}")
            if not isinstance(size, int) or size < 1:
                raise ValueError(
                    f"mesh axis {name!r} needs a positive integer size, "
                    f"got {size!r}")
        if "data" not in names:
            raise ValueError(
                "serving meshes shard per-stream state over a 'data' axis: "
                f"spec {self} has none (e.g. use 'data:8')")

    @classmethod
    def parse(cls, spec: Union[str, "MeshSpec"]) -> "MeshSpec":
        """``"data:8"`` / ``"pod:2,data:4"`` -> MeshSpec; a MeshSpec
        passes through unchanged.  Round-trips: ``MeshSpec.parse(str(s))
        == s``."""
        if isinstance(spec, cls):
            return spec
        axes = []
        for part in str(spec).split(","):
            name, sep, size = part.partition(":")
            if not sep:
                raise ValueError(
                    f"mesh axis {part!r} must be 'name:size' (e.g. 'data:8')")
            try:
                n = int(size)
            except ValueError:
                raise ValueError(f"mesh axis size {size!r} is not an integer")
            axes.append((name.strip(), n))
        return cls(tuple(axes))

    @classmethod
    def of(cls, mesh: Mesh) -> "MeshSpec":
        return cls(tuple(zip(mesh.axis_names, mesh.axis_sizes)))

    def __str__(self) -> str:
        return ",".join(f"{n}:{s}" for n, s in self.axes)

    @property
    def n_devices(self) -> int:
        n = 1
        for _, s in self.axes:
            n *= s
        return n

    @property
    def data_size(self) -> int:
        """Ways the batch axis splits (product of pod+data sizes)."""
        n = 1
        for name, s in self.axes:
            if name in ("pod", "data"):
                n *= s
        return n

    def build(self, devices: Optional[Sequence] = None) -> Mesh:
        """Place the mesh: its positions, row-major over the axes, on
        ``devices`` (``None``: the first ``n_devices`` CUDA devices, and
        a ValueError when the host has fewer).  ``devices`` may repeat a
        device: ``[torch.device("cpu")] * 8`` is a virtual 8-shard mesh,
        the counterpart of the reference's forced host device count."""
        if devices is None:
            have = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            if have < self.n_devices:
                raise ValueError(
                    f"mesh {self} needs {self.n_devices} devices, host has "
                    f"{have} CUDA devices: pass devices= (e.g. "
                    f"[torch.device('cpu')] * {self.n_devices} for virtual "
                    "shards), or run on a host with enough cards")
            devices = [torch.device("cuda", i) for i in range(self.n_devices)]
        devices = [resolve_device(d) for d in devices]
        if len(devices) != self.n_devices:
            raise ValueError(f"mesh {self} has {self.n_devices} positions, "
                             f"got {len(devices)} devices")
        return Mesh(tuple(n for n, _ in self.axes),
                    tuple(s for _, s in self.axes), tuple(devices))


def data_devices(mesh: Mesh) -> List[torch.device]:
    """The device of each data shard, in data-index order (pod-major):
    the position whose other coordinates are all 0."""
    daxes = data_axes(mesh)
    out = {}
    for flat in range(mesh.size):
        c = mesh.coords(flat)
        if any(c[a] for a in mesh.axis_names if a not in daxes):
            continue
        idx = 0
        for a in daxes:
            idx = idx * mesh.shape[a] + c[a]
        out[idx] = mesh.devices[flat]
    return [out[i] for i in range(len(out))]


def virtual_devices(spec: Union[str, MeshSpec], device) -> Optional[list]:
    """The launchers' placement: ``None`` (the first cards) where the
    host has as many CUDA devices as ``spec`` asks and ``device`` is one,
    else every position on ``device`` (printed), as the reference's
    launchers force a host device count on the CPU."""
    spec = MeshSpec.parse(spec)
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= spec.n_devices:
        return None
    print(f"mesh {spec}: {spec.n_devices} virtual devices on {device} "
          "(the host has fewer)", flush=True)
    return [device] * spec.n_devices


# ---------------------------------------------------------------------------
# Shards
# ---------------------------------------------------------------------------


@dataclass
class Shard:
    """One data shard of a sharded engine: rows ``lo:hi``, its device, its
    parameter replica, its edge and server towers over its rows, and its
    rows of the token history (the attribute names of the engine's own
    lane, ``CollaborativeEngine._lanes``)."""

    index: int
    lo: int
    hi: int
    device: torch.device
    params: Any
    edge: ServeEngine
    server: ServeEngine
    _history: torch.Tensor

    @property
    def batch(self) -> int:
        return self.hi - self.lo


class ShardedServe:
    """The shards' towers of one kind (edge or server) behind the one
    attribute the engine reads: ``cache`` is ``Sharded`` (one cache a
    shard) and ``zero_rows`` resets rows only on the shards that own
    them."""

    def __init__(self, engines: Sequence[ServeEngine]):
        self.engines = list(engines)
        self.cfg = self.engines[0].cfg
        self.max_len = self.engines[0].max_len
        self.batch = sum(e.batch for e in self.engines)
        self.pos = 0

    @property
    def cache(self) -> Sharded:
        return Sharded(e.cache for e in self.engines)

    @cache.setter
    def cache(self, caches) -> None:
        for e, c in zip(self.engines, caches):
            e.cache = c

    def zero_rows(self, rows, cache=None) -> None:
        rows = np.asarray(rows, bool)
        caches = self.cache if cache is None else cache
        lo = 0
        for e, c in zip(self.engines, caches):
            part = rows[lo:lo + e.batch]
            lo += e.batch
            if part.any():
                zero_cache_rows(c, torch.as_tensor(part, device=e.device))


def _replica(params, cfg, device: torch.device):
    """A copy of the collaborative LM on ``device``, built on the meta
    device and filled from ``params``: no second copy on the source."""
    model = deco.CollabLM(cfg, "meta")
    model.load_state_dict({k: v.to(device)
                           for k, v in params.state_dict().items()},
                          assign=True)
    return model


def _copy_rows(dst_cache, src_cache, lo: int, n: int) -> None:
    """Rows ``lo:lo+n`` of every leaf of ``src_cache`` into ``dst_cache``
    (values untouched; across devices where they differ)."""
    for dst, src in zip(_entries(dst_cache), _entries(src_cache)):
        axis = CACHE_BATCH_AXIS[type(dst)]
        for a, b in zip(dst, src):
            a.copy_(b.narrow(axis, lo, n))


def shard_engine(engine, spec_or_mesh: Union[str, MeshSpec, Mesh]):
    """Shard a ``CollaborativeEngine`` over a mesh IN PLACE and return it:
    replicate the parameters (one copy per distinct device), split every
    per-stream buffer (edge and server caches, token history) into the
    data shards' rows, and from then on run each shard's device work on
    its own rows and device.  ``spec_or_mesh``: a spec (built on the
    first cards) or a built ``Mesh``.

    Values are untouched, so the state carries over.  Idempotent for an
    equal spec; a different spec, an engine with an open async session
    (its worker owns the server cache) and a batch the data size does not
    divide are refused.  The monitor path then runs once under the op
    recorder and is asserted collective-free."""
    mesh = spec_or_mesh if isinstance(spec_or_mesh, Mesh) else None
    spec = MeshSpec.of(mesh) if mesh is not None \
        else MeshSpec.parse(spec_or_mesh)
    current = getattr(engine, "mesh_spec", None)
    if current == spec:
        return engine
    if current is not None:
        raise ValueError(
            f"engine is already sharded over {current}; re-sharding over "
            f"{spec} mid-life is not supported: build a fresh engine")
    if engine._dispatcher is not None:
        raise RuntimeError(
            "cannot shard an engine with an open async session (the "
            "worker owns the server cache); close the session first")
    if engine.batch % spec.data_size != 0:
        raise ValueError(
            f"batch {engine.batch} not divisible by the mesh data size "
            f"{spec.data_size} ({spec})")
    if mesh is None:
        mesh = spec.build()
    devices = data_devices(mesh)
    b = engine.batch // len(devices)
    cfg, ecfg = engine.cfg, deco.edge_arch(engine.cfg)
    replicas = {engine.device: engine.params}
    shards = []
    # no_grad, not inference_mode: the caches are written in place later,
    # outside inference mode too (a slot reset)
    with torch.no_grad():
        for i, dev in enumerate(devices):
            if dev not in replicas:
                replicas[dev] = _replica(engine.params, cfg, dev)
            p = replicas[dev]
            lo = i * b
            edge = ServeEngine(p.edge, ecfg, b, engine.max_len, dev)
            server = ServeEngine(p.server, cfg, b, engine.max_len, dev)
            _copy_rows(edge.cache, engine.edge.cache, lo, b)
            _copy_rows(server.cache, engine.server.cache, lo, b)
            hist = engine._history[lo:lo + b].to(dev).clone()
            shards.append(Shard(i, lo, lo + b, dev, p, edge, server, hist))
    pos = engine.server.pos
    engine.shards = shards
    engine.edge = ShardedServe([s.edge for s in shards])
    engine.server = ShardedServe([s.server for s in shards])
    engine.server.pos = pos
    engine._history = None   # each shard holds its rows
    engine.mesh = mesh
    engine.mesh_spec = spec
    for name, records in edge_ops(engine).items():
        assert_collective_free(records, f"monitor path [{name}]")
    return engine


def ensure_sharded(engine, spec: Union[str, MeshSpec, None]):
    """Session-open hook: a no-op for ``spec=None`` (whatever the engine
    already is), otherwise ``shard_engine`` (idempotent for an equal
    spec, loud on a mismatch)."""
    if spec is None:
        return engine
    return shard_engine(engine, spec)


def _tree_bytes(tree) -> int:
    if tree is None:
        return 0
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return sum(_tree_bytes(v) for v in tree)


def bytes_per_device(tree: Any) -> int:
    """Bytes one mesh position holds of a (possibly sharded) tree: the
    largest shard's of ``Sharded`` parts, else the whole tree's.  Shards
    placed virtually on one device count apart, as positions."""
    if isinstance(tree, Sharded):
        return max(_tree_bytes(p) for p in tree)
    return _tree_bytes(tree)


# ---------------------------------------------------------------------------
# The correction server's rows over the lanes (the defrag, the fused replies)
# ---------------------------------------------------------------------------


def permute_rows(engine, cache, perm: np.ndarray) -> None:
    """Row ``i`` of the super-batch ``cache`` (one part a lane) takes old
    row ``perm[i]``, in place (the correction server's lease defrag, the
    reference's ``jnp.take`` over the batch axes): each lane gathers its
    new rows from whichever lanes hold them, one counted cross-shard step
    where a row changes shard.  Every new row is read before any is
    written."""
    lanes, caches = engine._lanes(), parts_of(cache)
    perm = np.asarray(perm)
    moved = False
    staged = []
    for ln, c in zip(lanes, caches):
        src = perm[ln.lo:ln.hi]
        for ei, entry in enumerate(_entries(c)):
            axis = CACHE_BATCH_AXIS[type(entry)]
            for li, leaf in enumerate(entry):
                new = torch.empty_like(leaf)
                for lj, cj in zip(lanes, caches):
                    mask = (src >= lj.lo) & (src < lj.hi)
                    if not mask.any():
                        continue
                    moved |= lj is not ln
                    old = _entries(cj)[ei][li]
                    rows = old.index_select(axis, torch.as_tensor(
                        src[mask] - lj.lo, device=lj.device))
                    new.index_copy_(axis, torch.as_tensor(
                        np.flatnonzero(mask), device=ln.device),
                        rows.to(ln.device))
                staged.append((leaf, new))
    for leaf, new in staged:
        leaf.copy_(new)
    if moved:
        count_cross_shard("defrag")


def fuse_rows(engine, v, rows: np.ndarray, u: np.ndarray,
              trig: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The correction server's replies from one replay: v (one part a
    lane) and, per entry j, fhat from ``u[j]``, the v of super-batch row
    ``rows[j]`` and ``trig[j]``, fused on the lane that owns that row (one
    ``monitor_combine`` a lane that has any).  Returns (v, fhat) on the
    host, one copy a lane."""
    v_np = np.empty(engine.batch, np.float32)
    fhat = np.empty(len(rows), np.float32)
    blocks = []
    for ln, vs in zip(engine._lanes(), parts_of(v)):
        sel = np.flatnonzero((rows >= ln.lo) & (rows < ln.hi))
        d = ln.device
        f = engine._fuse(torch.as_tensor(u[sel], device=d),
                         vs[torch.as_tensor(rows[sel] - ln.lo, device=d)],
                         torch.as_tensor(trig[sel], device=d)) \
            if len(sel) else vs[:0]
        blocks.append((ln, sel, torch.cat((vs, f))))
    for ln, sel, block in blocks:
        out = block.cpu().numpy()
        v_np[ln.lo:ln.hi] = out[:ln.batch]
        fhat[sel] = out[ln.batch:]
    return v_np, fhat


# ---------------------------------------------------------------------------
# The collective-free check
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OpRecord:
    """One op of a recorded path: its name (``aten.add.Tensor``), its ops
    namespace, the devices its inputs and outputs are on, whether it
    copies between devices (a host upload aside), and the shards whose
    data it read or wrote."""

    name: str
    namespace: str
    devices: Tuple[str, ...]
    cross_device: bool
    shards: Tuple[int, ...]

    def brief(self) -> str:
        return (f"{self.name} devices={list(self.devices)} "
                f"shards={list(self.shards)}")


def _recorder(taint, shard_devices, records):
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            out = func(*args, **kwargs)
            outs = [t for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor)]
            seen = frozenset()
            for t in ins:
                seen |= taint.get(t, frozenset())
            for t in outs:
                taint[t] = seen | taint.get(t, frozenset())
            src = {str(t.device) for t in ins}
            dst = {str(t.device) for t in outs}
            name = str(func)
            cross = "copy" in name and any(
                a != b and (a != "cpu" or "cpu" in shard_devices)
                for a in src for b in dst)
            records.append(OpRecord(
                name, getattr(func, "namespace", ""),
                tuple(sorted(src | dst)), cross, tuple(sorted(seen))))
            return out

    return Recorder()


@contextlib.contextmanager
def record_ops(engine):
    """Record every op run in the block (a list of ``OpRecord``), with
    each shard's state (parameter replica unless shared, caches, history)
    marked as its own and the marks carried through the ops' outputs."""
    from torch.utils.weak import WeakTensorKeyDictionary
    taint = WeakTensorKeyDictionary()
    owners: Dict[int, set] = collections.defaultdict(set)
    for sh in engine.shards:
        for p in sh.params.parameters():
            owners[id(p)].add(sh.index)
    for sh in engine.shards:
        mine = frozenset([sh.index])
        for p in sh.params.parameters():
            if len(owners[id(p)]) == 1:  # a replica shared is replicated
                taint[p] = mine
        for tower in (sh.edge, sh.server):
            for entry in _entries(tower.cache):
                for leaf in entry:
                    taint[leaf] = mine
        taint[sh._history] = mine
    records: List[OpRecord] = []
    shard_devices = {str(sh.device) for sh in engine.shards}
    with _recorder(taint, shard_devices, records):
        yield records


def edge_ops(engine) -> Dict[str, List[OpRecord]]:
    """The ops of the monitor path of a SHARDED engine, per kernel, over
    all shards: ``decode_at`` (the per-element edge decode the step runs),
    ``decode_masked`` (the dense masked decode), ``u_head`` and
    ``record_at``.  Run with every row inactive, so no state changes."""
    if getattr(engine, "mesh_spec", None) is None:
        raise ValueError("engine is not mesh-sharded (use shard_engine)")
    out: Dict[str, List[OpRecord]] = {
        "decode_at": [], "decode_masked": [], "u_head": [], "record_at": []}
    tail = engine.tok_tail
    with torch.inference_mode():
        for sh in engine.shards:
            d, b = sh.device, sh.batch
            tok = torch.zeros((b,) + tail, dtype=torch.long, device=d)
            pos = torch.zeros(b, dtype=torch.int32, device=d)
            off = torch.zeros(b, dtype=torch.bool, device=d)
            with record_ops(engine) as rec:
                _, hidden = sh.edge.decode_at(tok, pos, off,
                                              with_logits=False)
            out["decode_at"] += rec
            with record_ops(engine) as rec:
                sh.edge.decode_masked(tok, 0, off, with_logits=False)
            out["decode_masked"] += rec
            with record_ops(engine) as rec:
                engine._u_head(sh.params, hidden)
            out["u_head"] += rec
            with record_ops(engine) as rec:
                engine._record_at(sh, tok, np.zeros(b, np.int64),
                                  np.zeros(b, bool))
            out["record_at"] += rec
    return out


def collective_ops(records: Sequence[OpRecord]) -> Tuple[str, ...]:
    """The recorded ops that communicate: a ``c10d`` collective, a copy
    between devices, or an op over two shards' data."""
    return tuple(r.brief() for r in records
                 if r.namespace in C10D_NAMESPACES or r.cross_device
                 or len(r.shards) > 1)


def assert_collective_free(records: Sequence[OpRecord],
                           what: str = "edge step") -> None:
    """The paper's device-locality guarantee, checked on the recorded
    ops: the monitor path must not communicate across shards."""
    bad = collective_ops(records)
    if bad:
        raise AssertionError(
            f"{what} communicates across shards ({len(bad)} ops): "
            + "; ".join(bad[:5]))
