"""One call site per kernel: each kernel is a ``torch.library`` op in the
``repro_torch`` namespace, and torch's dispatcher picks its
implementation by where the tensors lie.

Each op has four implementations:

- **CPU**: the kernel's plain PyTorch version.
- **CUDA**: the wrapper of the hand-written kernel, which raises on
  anything it does not take: there is no global switch and no fallback.
  The wrapper counts its launches.
- **fake** (a ``FakeTensor`` or a meta tensor: the dry run,
  ``launch/dryrun.py``, and graph capture): the kernel's shape function,
  outputs of the kernel's shapes and dtypes, and the kernel's FLOPs and
  bytes (the counts behind PERF.md's bounds) recorded into every active
  ``shape_counters`` entry.  Nothing launches, and no plain version runs.
- **autograd** (``flash_attention_fwd`` and ``ssd_scan_fwd``): the
  backward in tensor ops that the reference's XLA gradient computes.

A captured graph (``torch.export``) therefore holds each kernel call as
one node, ``repro_torch.<op>``, as a jaxpr holds one ``pallas_call``,
and the exported program runs the kernel (or the plain version) on its
own inputs.  Non-tensor arguments are op arguments; a scalar decode
position becomes a (B,) tensor (``pos_vector``) before the op.

One more kind of operand, found by one explicit check: a **DTensor** (a
step on a ``DeviceMesh``, ``distributed/sharding.py``).
``flash_attention``, ``ssd_scan``, ``decode_attention`` and
``monitor_combine`` run in a ``local_map`` region that states their
operands' placements: batch rows over the data axes, heads over
``model`` where the heads divide it, or, for a decode cache split on its
time axis, each rank's slice of the cache (flash-decode: the partial
entry and ``combine_partials``).  Inside, the op sees this rank's local
tensors.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch import Tensor

from repro_torch.distributed.sharding import is_dtensor, row_placements
from repro_torch.kernels.decode_attention import (
    combine_partials, decode_attention_cuda, decode_attention_partial_cuda,
    decode_attention_partial_plain, decode_attention_plain, pos_vector)
from repro_torch.kernels.flash_attention import (flash_attention_backward,
                                                 flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.monitor_combine import (monitor_combine_cuda,
                                                 monitor_combine_plain)
from repro_torch.kernels.ssm_scan import (ssd_flops, ssd_scan_cuda,
                                          ssd_scan_plain)
from repro_torch.observability.trace import span

# The dry run's counters: each is a dict kernel name -> {"calls", "flops",
# "bytes"} that the shape functions add to (``launch/dryrun.py`` pushes
# one for the span of a step).
shape_counters: List[Dict[str, Dict[str, float]]] = []

NAMESPACE = "repro_torch"


def _record(name: str, flops: float, n_bytes: float) -> None:
    for c in shape_counters:
        e = c.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        e["calls"] += 1
        e["flops"] += float(flops)
        e["bytes"] += float(n_bytes)


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def attention_pairs(S: int, T: int, window: int) -> int:
    """(row, col) pairs a causal (sliding-window) attention computes: row
    r reads cols max(0, r - window + 1) .. min(r, T - 1)."""
    full = S * (S + 1) // 2 if S <= T else T * (T + 1) // 2 + (S - T) * T
    m = max(0, S - window) if window else 0
    return full - m * (m + 1) // 2


# ---------------------------------------------------------------------------
# Shape functions (the ops' fake implementations)
# ---------------------------------------------------------------------------


def decode_attention_shape(q, k_cache, v_cache, pos):
    """decode_attention's output and counts (every cache slot read: the
    positions are data)."""
    B, Hq, D = q.shape
    C, Hkv = k_cache.shape[1], k_cache.shape[2]
    o = torch.empty_like(q)
    _record("decode_attention", 4.0 * B * Hq * C * D,
            2 * _nbytes(q) + 2 * B * C * Hkv * D * k_cache.element_size()
            + 4 * B)
    return o


def decode_attention_partial_shape(q, k_slice, v_slice, pos, base):
    """The partial entry's (o, lse) and counts (every slot of the slice
    read)."""
    B, Hq, D = q.shape
    Cl, Hkv = k_slice.shape[1], k_slice.shape[2]
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
    _record("decode_attention_partial", 4.0 * B * Hq * Cl * D,
            _nbytes(q, o, lse) + 2 * B * Cl * Hkv * D * k_slice.element_size()
            + 4 * B)
    return o, lse


def monitor_combine_shape(u, v, f, s, threshold, margin):
    n = u.shape[0]
    fhat = torch.empty(n, dtype=torch.float32, device=u.device)
    mask = torch.empty(n, dtype=torch.float32, device=u.device)
    counts = torch.empty(2, dtype=torch.float32, device=u.device)
    _record("monitor_combine", 8.0 * n, 3 * 4 * n + 2 * 4 * n + 8)
    return fhat, mask, counts


def flash_attention_shape(q, k, v, window):
    """flash_attention's (o, lse) and counts."""
    B, S, Hq, Dqk = q.shape
    T, Dv = k.shape[1], v.shape[3]
    o = torch.empty((B, S, Hq, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    _record("flash_attention",
            2.0 * B * Hq * (Dqk + Dv) * attention_pairs(S, T, window),
            _nbytes(q, k, v, o, lse))
    return o, lse


def ssd_scan_shape(xdt, la, Bm, Cm, chunk):
    """ssd_scan's (y, h_final) and counts."""
    B, S, H, P = xdt.shape
    N = Bm.shape[-1]
    y = torch.empty_like(xdt)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=xdt.device)
    _record("ssd_scan", ssd_flops(B, S, H, chunk, P, N),
            _nbytes(xdt, la, Bm, Cm, y, h))
    return y, h


# ---------------------------------------------------------------------------
# The ops: CPU = plain version, CUDA = the kernel's wrapper, fake = shape
# ---------------------------------------------------------------------------


def _op(name: str, cpu, cuda, fake):
    """Register ``repro_torch::<name>`` (schema from ``cpu``'s
    annotations) with its three implementations; returns the op."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", cpu,
                                 mutates_args=(), device_types="cpu")
    op.register_kernel("cuda")(cuda)
    op.register_fake(fake)
    return op


def _dense(*ts):
    """The plain version's outputs laid out as the kernel's (contiguous,
    the strides the shape function states); the values are unchanged."""
    return tuple(t.contiguous() for t in ts)


def _decode_cpu(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                pos: Tensor) -> Tensor:
    return decode_attention_plain(q, k_cache, v_cache, pos).contiguous()


def _partial_cpu(q: Tensor, k_slice: Tensor, v_slice: Tensor, pos: Tensor,
                 base: int) -> Tuple[Tensor, Tensor]:
    return _dense(*decode_attention_partial_plain(q, k_slice, v_slice, pos,
                                                  base))


def _combine_cpu(u: Tensor, v: Tensor, f: Tensor, s: float, threshold: float,
                 margin: float) -> Tuple[Tensor, Tensor, Tensor]:
    return _dense(*monitor_combine_plain(u, v, f, s=s, threshold=threshold,
                                         margin=margin))


def _combine_cuda(u, v, f, s, threshold, margin):
    return monitor_combine_cuda(u, v, f, s=s, threshold=threshold,
                                margin=margin)


def _flash_cpu(q: Tensor, k: Tensor, v: Tensor,
               window: int) -> Tuple[Tensor, Tensor]:
    return _dense(*flash_attention_plain(q, k, v, window=window))


def _flash_cuda(q, k, v, window):
    return flash_attention_cuda(q, k, v, window=window)


def _ssd_cpu(xdt: Tensor, la: Tensor, Bm: Tensor, Cm: Tensor,
             chunk: int) -> Tuple[Tensor, Tensor]:
    return _dense(*ssd_scan_plain(xdt, la, Bm, Cm, chunk=chunk))


def _ssd_cuda(xdt, la, Bm, Cm, chunk):
    return ssd_scan_cuda(xdt, la, Bm, Cm, chunk=chunk)


_op("decode_attention", _decode_cpu, decode_attention_cuda,
    decode_attention_shape)
_op("decode_attention_partial", _partial_cpu, decode_attention_partial_cuda,
    decode_attention_partial_shape)
_op("monitor_combine", _combine_cpu, _combine_cuda, monitor_combine_shape)
FLASH = _op("flash_attention_fwd", _flash_cpu, _flash_cuda,
            flash_attention_shape)
SSD = _op("ssd_scan_fwd", _ssd_cpu, _ssd_cuda, ssd_scan_shape)


def _flash_setup(ctx, inputs, output):
    q, k, v, window = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.window = window


def _flash_backward(ctx, do, dlse):
    """Backward in tensor ops from the saved output and log-sum-exp
    (``flash_attention_backward``: the reference differentiates this
    attention with XLA, outside any kernel).  Under
    ``torch.utils.checkpoint`` the forward runs again in the backward pass
    and saves a fresh ``lse``."""
    q, k, v, o, lse = ctx.saved_tensors
    with span("flash_attention_backward"):
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do,
                                              window=ctx.window)
    return dq, dk, dv, None


def _ssd_setup(ctx, inputs, output):
    *ins, chunk = inputs
    ctx.save_for_backward(*ins)
    ctx.chunk = chunk


def _ssd_backward(ctx, dy, dh):
    """The reference has no backward kernel and trains through XLA's
    gradient of ``ssd_chunked``, so the backward recomputes the plain
    chunked form from the saved inputs and differentiates it with
    autograd.  Under ``torch.utils.checkpoint`` the forward runs again in
    the backward pass."""
    with span("ssd_scan_backward"), torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        y, h = ssd_scan_plain(*ins, chunk=ctx.chunk)
        grads = torch.autograd.grad((y, h), ins, (dy, dh))
    return (*grads, None)


FLASH.register_autograd(_flash_backward, setup_context=_flash_setup)
SSD.register_autograd(_ssd_backward, setup_context=_ssd_setup)

# what the call sites call: the ops' overloads, one dispatch each
_decode = torch.ops.repro_torch.decode_attention.default
_partial = torch.ops.repro_torch.decode_attention_partial.default
_combine = torch.ops.repro_torch.monitor_combine.default
_flash = torch.ops.repro_torch.flash_attention_fwd.default
_ssd = torch.ops.repro_torch.ssd_scan_fwd.default

# every op this module registers, by name (``analysis/graph.py`` allows
# their namespace; ``analysis/signs.py`` inlines their plain versions)
OPS = {"decode_attention": _decode, "decode_attention_partial": _partial,
       "monitor_combine": _combine, "flash_attention_fwd": _flash,
       "ssd_scan_fwd": _ssd}


# ---------------------------------------------------------------------------
# Call sites
# ---------------------------------------------------------------------------


def decode_attention(q, k_cache, v_cache, pos):
    """q: (B, Hq, D); caches: (B, C, Hkv, D); pos: scalar or (B,) -> (B,
    Hq, D) in q's dtype.  DTensor caches: ``_decode_region``."""
    if is_dtensor(k_cache):
        return _decode_region(q, k_cache, v_cache, pos)
    return _decode(q, k_cache, v_cache, pos_vector(pos, q.shape[0], q.device))


def decode_attention_partial(q, k_slice, v_slice, pos, base: int):
    """One time slice's (o f32, lse f32) of a cache split over ranks, its
    rows global ``base .. base + Cl - 1`` (``kernels/decode_attention.py``)."""
    return _partial(q, k_slice, v_slice,
                    pos_vector(pos, q.shape[0], q.device), int(base))


def monitor_combine(u, v, f, *, s: float, threshold: float = 0.0,
                    margin: float = 0.25):
    """(fhat, mask, counts) of (N,) scores.  DTensors: ``_combine_region``."""
    if is_dtensor(u):
        return _combine_region(u, v, f, s=s, threshold=threshold,
                               margin=margin)
    return _combine(u, v, f, float(s), float(threshold), float(margin))


def flash_attention_fwd(q, k, v, *, window: int = 0):
    """Causal (o, lse), not differentiated (``flash_attention`` is)."""
    return _flash(q, k, v, int(window))


def flash_attention(q, k, v, *, window: int = 0):
    """q: (B, S, Hq, D); k: (B, T, Hkv, D); v: (B, T, Hkv, Dv) -> (B, S,
    Hq, Dv), causal, differentiable.  DTensor operands: ``_flash_region``."""
    if is_dtensor(q):
        return _flash_region(q, k, v, window)
    return _flash(q, k, v, int(window))[0]


# ---------------------------------------------------------------------------
# local_map regions of a step on a DeviceMesh
# ---------------------------------------------------------------------------


def on_model(pls: List[Any], mesh, placement) -> Tuple[Any, ...]:
    """Placements ``pls`` (one per mesh dim) with ``placement`` on the
    ``model`` dim, where the mesh has one."""
    names = list(mesh.mesh_dim_names)
    out = list(pls)
    if "model" in names:
        out[names.index("model")] = placement
    return tuple(out)


def model_size(mesh) -> int:
    """The size of the mesh's ``model`` dim (1 without one)."""
    names = list(mesh.mesh_dim_names)
    return mesh.size(names.index("model")) if "model" in names else 1


def kv_heads_for(rank: int, model: int, Hq: int, Hkv: int) -> List[int]:
    """The kv head of each of the q heads ``rank`` of ``model`` holds (q
    heads split evenly over ``model``; q head h reads kv head
    h // (Hq // Hkv))."""
    n, G = Hq // model, Hq // Hkv
    return [(rank * n + j) // G for j in range(n)]


def _flash_region(q, k, v, window: int):
    """flash_attention on a DeviceMesh: q's heads split over ``model``
    where they divide it (else whole), batch rows over the data axes.  k
    and v split alike when their heads divide ``model`` too (a rank's q
    heads then read exactly its kv heads); otherwise they come whole (one
    gather, as GSPMD gathers them) and each rank takes the kv heads its q
    heads read: with granite's 8 kv heads at model 16, two ranks share
    each kv head.  Their gradients are then partial sums over ``model``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    M = model_size(mesh)
    Hq, Hkv = q.shape[2], k.shape[2]
    q_split = Hq % M == 0
    kv_split = q_split and Hkv % M == 0
    qp = on_model(row_placements(q), mesh,
                  Shard(2) if q_split else Replicate())
    kvp = on_model(row_placements(q), mesh,
                   Shard(2) if kv_split else Replicate())
    kv_grad = kvp if kv_split or not q_split else on_model(
        row_placements(q), mesh, Partial())

    def body(ql, kl, vl):
        if q_split and not kv_split:
            kl, vl = _kv_heads(kl, vl, kv_heads_for(
                mesh.get_local_rank("model"), M, Hq, Hkv))
        return _flash(ql, kl, vl, int(window))[0]

    qp, kvp, kv_grad = list(qp), list(kvp), list(kv_grad)
    return local_map(body, out_placements=qp, in_placements=(qp, kvp, kvp),
                     in_grad_placements=(qp, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def as_dtensor(t, mesh):
    """A plain tensor as a DTensor replicated on ``mesh`` (what
    ``implicit_replication`` takes it for); a DTensor as it is."""
    if is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def time_split(t) -> bool:
    """Whether the DTensor cache ``t`` (B, C, ...) has its time axis (dim
    1) split over a ``model`` dim wider than 1."""
    from torch.distributed.tensor import Shard
    names = list(t.device_mesh.mesh_dim_names)
    return "model" in names and model_size(t.device_mesh) > 1 \
        and t.placements[names.index("model")] == Shard(1)


def model_placement(t):
    """The DTensor ``t``'s placement on the ``model`` dim (Replicate where
    the mesh has none)."""
    from torch.distributed.tensor import Replicate
    names = list(t.device_mesh.mesh_dim_names)
    return t.placements[names.index("model")] if "model" in names \
        else Replicate()


def _decode_region(q, k, v, pos):
    """decode_attention on a DeviceMesh: batch rows over the data axes, as
    the cache's.  A cache split on its time axis over ``model``
    (``cache_specs(mode="time")``): q comes whole on ``model`` (one
    all-gather of a (B, Hq, D) row), each rank runs the partial entry on
    its slice (``base = rank * C / M``), and ``combine_partials`` joins
    them with two all-reduces over ``model``; the output is whole on
    ``model`` and q's dtype.  Otherwise (``"heads"``, or a cache whole on
    ``model``): the kernel runs on the rank's q heads where q's heads are
    split (a cache split on its kv heads gives each rank exactly the kv
    heads its q heads read; a cache split on head_dim comes whole, one
    gather, as GSPMD gathers it; a whole cache gives each rank the kv
    heads of ``kv_heads_for``), else on every head.  At ``model`` = 1
    each operand keeps its placement and the whole kernel runs: no
    partial, no collective."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = k.device_mesh
    M = model_size(mesh)
    B, Hq = q.shape[:2]
    Hkv = k.shape[2]
    q = as_dtensor(q, mesh)
    pos = as_dtensor(pos_vector(pos, B, k.to_local().device), mesh)
    rows = row_placements(k)
    if time_split(k):
        qp = on_model(rows, mesh, Replicate())
        kp = on_model(rows, mesh, Shard(1))
        group = mesh.get_group("model")

        def body(ql, kl, vl, pl):
            base = mesh.get_local_rank("model") * kl.shape[1]
            o, lse = decode_attention_partial(ql.contiguous(), kl, vl, pl,
                                              base)
            return combine_partials(o, lse, group).to(ql.dtype)
    elif M == 1:
        qp = on_model(rows, mesh, model_placement(q))
        kp = on_model(rows, mesh, model_placement(k))

        def body(ql, kl, vl, pl):
            return decode_attention(ql, kl, vl, pl)
    else:
        kv_split = model_placement(k) == Shard(2)
        q_split = kv_split or (model_placement(q) == Shard(1)
                               and Hq % M == 0)
        qp = on_model(rows, mesh, Shard(1) if q_split else Replicate())
        kp = on_model(rows, mesh, Shard(2) if kv_split else Replicate())

        def body(ql, kl, vl, pl):
            if q_split and not kv_split:
                kl, vl = _kv_heads(kl, vl, kv_heads_for(
                    mesh.get_local_rank("model"), M, Hq, Hkv))
            return decode_attention(ql.contiguous(), kl, vl, pl)
    pp = list(rows)
    qp, kp = list(qp), list(kp)
    return local_map(body, out_placements=qp,
                     in_placements=(qp, kp, kp, pp), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v, pos)


def _combine_region(u, v, f, *, s: float, threshold: float, margin: float):
    """monitor_combine on a DeviceMesh: each rank combines its own rows
    (split over the data axes, whole on ``model``); fhat and the mask come
    back split as the rows, the two counts as partial sums over the data
    axes that split the rows."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    mesh = u.device_mesh
    rows = list(row_placements(u))
    counts = [Partial() if pl.is_shard() else pl for pl in rows]
    return local_map(
        lambda a, b, c: monitor_combine(a, b, c, s=s, threshold=threshold,
                                        margin=margin),
        out_placements=(rows, rows, counts), in_placements=(rows,) * 3,
        device_mesh=mesh, redistribute_inputs=True)(
        u, as_dtensor(v, mesh), as_dtensor(f, mesh))


def _kv_heads(kl, vl, heads: List[int]):
    """The kv heads ``heads`` (one a q head, in q-head order) of local
    caches (B, T, Hkv, D): a contiguous run of kv heads where each repeats
    equally often (the rank's q heads then read them as groups), else one
    kv head a q head."""
    uniq = sorted(set(heads))
    per = len(heads) // len(uniq)
    if heads == [u for u in uniq for _ in range(per)]:
        return (kl.narrow(2, uniq[0], len(uniq)).contiguous(),
                vl.narrow(2, uniq[0], len(uniq)).contiguous())
    idx = torch.tensor(heads, device=kl.device)
    return kl.index_select(2, idx), vl.index_select(2, idx)


def ssd_scan_fwd(xdt, la, Bm, Cm, *, chunk: int = 128):
    """(y, h_final) of the ``ssd_scan_fwd`` op: xdt (B, S, H, P), la (B, S,
    H), Bm, Cm (B, S, N), f32; differentiable."""
    return _ssd(xdt, la, Bm, Cm, int(chunk))


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 128, h0=None):
    """The reference's call site (``repro/kernels/ops.py:56``), with the
    signature of ``ssd_chunked``: x (B, S, H, P), dt (B, S, H), A (H,),
    Bm, Cm (B, S, N) -> (y (B, S, H, P), h_final (B, H, P, N)), f32,
    differentiable.  xdt = x * dt and la = dt * A are formed here in f32
    tensor ops, so autograd carries x, dt and A to them."""
    if h0 is not None:
        raise ValueError("ssd_scan takes no initial state: every path "
                         "starts from h0 = 0")
    dtf = dt.float()
    xdt = x.float() * dtf[..., None]
    la = dtf * A.float()[None, None, :]
    args = (xdt.contiguous(), la.contiguous(), Bm.float().contiguous(),
            Cm.float().contiguous())
    if is_dtensor(xdt):
        return _ssd_region(*args, chunk)
    return _ssd(*args, int(chunk))


def _ssd_region(xdt, la, Bm, Cm, chunk: int):
    """ssd_scan on a DeviceMesh: heads over ``model`` where they divide it,
    batch rows over the data axes; B and C whole on ``model`` (every head
    reads them), so their gradients are partial sums over ``model``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = xdt.device_mesh
    split = xdt.shape[2] % model_size(mesh) == 0
    base = row_placements(xdt)
    hp = on_model(base, mesh, Shard(2) if split else Replicate())
    bc = on_model(base, mesh, Replicate())
    bc_grad = on_model(base, mesh, Partial()) if split else bc
    hp, bc, bc_grad = list(hp), list(bc), list(bc_grad)
    yp = hp
    h_p = list(on_model(base, mesh, Shard(1) if split else Replicate()))
    return local_map(lambda a, b, c, d: _ssd(a, b, c, d, int(chunk)),
                     out_placements=(yp, h_p),
                     in_placements=(hp, hp, bc, bc),
                     in_grad_placements=(hp, hp, bc_grad, bc_grad),
                     device_mesh=mesh, redistribute_inputs=True)(
        xdt, la, Bm, Cm)
