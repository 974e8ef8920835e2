"""Mixture of experts: a top-k router and static-capacity dispatch
(``nn/moe.py``, the ``dense`` dispatch ``moe_apply``).

As in the reference, each expert takes at most ``capacity`` tokens: the
assignments to an expert are ranked in token order and those past the
capacity are dropped (they fall through on the residual stream).  The
kept tokens are gathered into one (E, C, d) buffer and the experts'
SwiGLU is three stacked products over it, plain ``torch.bmm`` as the
reference's einsums are plain XLA products outside any Pallas kernel.

Routing groups.  The reference's static capacity makes the output depend
on which tokens are routed together, and its call sites differ: its
training forward routes all B*S tokens at once, and so does its batched
decode (``decode_masked`` and the scan path), but its per-element catch-up
(``engine.make_step_at``) vmaps singleton decodes, so each row is routed
alone.  ``moe_apply(..., groups=n)`` routes n equal runs of consecutive
tokens each on its own, with the capacity of one run; ``groups=B`` on a
decode step is the reference's per-row routing in one dispatch.

The buffer.  Whatever the groups, the kept tokens go into one buffer in
token order, expert by expert: slot ``e * Cb + i`` holds the i-th kept
token of expert e, with ``Cb = min(T, groups * C)`` (an expert takes at
most one assignment per token).  With one group this is the reference's
layout with its padding past T cut off; where no token is dropped (a
decode of B <= 8 rows: C >= 8), per-row and batched routing fill the same
buffer of the same shape, so the expert products see the same operands.

The combine is deterministic: each token sums its top-k contributions,
gathered from the expert outputs, in ascending expert order (the order of
the reference's scatter-add over slots) in f32, one add a choice, where an
``index_add_`` on CUDA would order the adds by atomics.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn.module import Linear, linear, normal_, param


class SharedExpert(nn.Module):
    """The always-on expert(s): ``w_gate``/``w_up`` (d, n_shared*f) and
    ``w_down`` (n_shared*f, d), bare weights as in the reference's tree."""

    def __init__(self, d_model: int, d_ff: int, *, dtype, device=None):
        super().__init__()
        self.w_gate = param((d_model, d_ff), dtype, device)
        self.w_up = param((d_model, d_ff), dtype, device)
        self.w_down = param((d_ff, d_model), dtype, device)


class MoE(nn.Module):
    """``router`` (f32 whatever the dtypes, as in the reference),
    ``w_gate``/``w_up`` (E, d, f) and ``w_down`` (E, f, d) in the compute
    dtype, and an optional ``shared`` expert."""

    def __init__(self, d_model: int, moe_d_ff: int, n_experts: int, *,
                 n_shared: int = 0, dtype=torch.float32, device=None):
        super().__init__()
        E, d, f = n_experts, d_model, moe_d_ff
        self.router = Linear(d, E, dtype=torch.float32, device=device)
        self.w_gate = param((E, d, f), dtype, device)
        self.w_up = param((E, d, f), dtype, device)
        self.w_down = param((E, f, d), dtype, device)
        self.shared = SharedExpert(d, n_shared * f, dtype=dtype,
                                   device=device) if n_shared else None

    def init_(self, gen: torch.Generator):
        d, f = self.w_gate.shape[1], self.w_gate.shape[2]
        self.router.init_(gen)
        for w, sd in ((self.w_gate, d), (self.w_up, d), (self.w_down, f)):
            normal_(w, gen, 1.0 / math.sqrt(sd))
        if self.shared is not None:
            for w in (self.shared.w_gate, self.shared.w_up):
                normal_(w, gen, 1.0 / math.sqrt(d))
            normal_(self.shared.w_down, gen, 1.0 / math.sqrt(f))


def expert_capacity(n_tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    c = int(math.ceil(n_tokens * top_k / n_experts * capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def _route_parts(p: MoE, xf: torch.Tensor, n_experts: int, top_k: int):
    """Router in f32 -> (top_p, top_i (T, k), me, ce): the mean router
    probability and the share of assignments of each expert."""
    T = xf.shape[0]
    probs = torch.softmax(linear(p.router, xf.float()), dim=-1)  # (T, E)
    top_p, top_i = torch.topk(probs, top_k, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    me = probs.mean(dim=0)
    # a count per expert (``bincount`` with a static shape: the dry run's
    # fake tensors cannot take an output sized by the data)
    idx = top_i.reshape(-1).long()
    ce = torch.zeros(n_experts, dtype=torch.int64, device=idx.device
                     ).scatter_add_(0, idx, torch.ones_like(idx)).float() \
        / (T * top_k)
    return top_p, top_i, me, ce


def _route(p: MoE, xf: torch.Tensor, n_experts: int, top_k: int):
    """Router in f32 -> (top_p, top_i (T, k), aux).  ``aux`` is the
    Switch/GShard load-balance loss over all T tokens."""
    top_p, top_i, me, ce = _route_parts(p, xf, n_experts, top_k)
    return top_p, top_i, n_experts * torch.sum(me * ce)


def _exclusive_rank(onehot: torch.Tensor, groups: int) -> torch.Tensor:
    """onehot (T, E) int: for each (token, expert), how many earlier tokens
    of the same group chose that expert."""
    T, E = onehot.shape
    g = onehot.reshape(groups, T // groups, E)
    return (torch.cumsum(g, dim=1) - g).reshape(T, E)


def _slot_table(top_i: torch.Tensor, *, n_experts: int, C: int,
                groups: int = 1, e_lo: int = 0, e_sel: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(slot_tok (e_sel*Cb,), slot_of (T, k), Cb).

    An assignment (token t, choice j) to expert e is kept when fewer than
    ``C`` earlier tokens of t's group chose e (the reference's stable
    sort ranks them so); a kept one goes to slot ``(e - e_lo)*Cb + i``, i
    its rank among all kept assignments to e (token order), when e is one
    of this table's experts ``e_lo .. e_lo + e_sel - 1`` (all of them by
    default; an expert-parallel rank's own otherwise).  ``slot_of[t, j]``
    is that slot, or the sentinel ``e_sel*Cb`` when dropped or another
    rank's; ``slot_tok[s]`` the token in slot s, or the sentinel T when
    empty.  Integer work only, so it is deterministic on every device."""
    T, k = top_i.shape
    E = n_experts
    e_sel = E if e_sel is None else e_sel
    idx = top_i.long()
    onehot = torch.zeros((T, E), dtype=torch.int32, device=idx.device)
    onehot.scatter_(1, idx, 1)
    keep = torch.gather(_exclusive_rank(onehot, groups), 1, idx) < C
    kept = torch.zeros_like(onehot).scatter_(1, idx, keep.to(torch.int32))
    rank = torch.gather(_exclusive_rank(kept, 1), 1, idx)
    Cb = min(T, groups * C)
    if e_sel != E:
        keep = keep & (idx >= e_lo) & (idx < e_lo + e_sel)
    slot_of = torch.where(keep, (idx - e_lo) * Cb + rank, e_sel * Cb)
    tok = torch.arange(T, device=idx.device)[:, None].expand(T, k)
    slot_tok = torch.full((e_sel * Cb + 1,), T, dtype=torch.long,
                          device=idx.device)
    slot_tok.scatter_(0, slot_of.reshape(-1),
                      torch.where(keep, tok, T).reshape(-1))
    return slot_tok[:e_sel * Cb], slot_of, Cb


def _expert_ffn(xf, slot_tok, wg, wu, wd, *, n_experts: int, Cb: int,
                compute_dtype) -> torch.Tensor:
    """Gather the kept tokens -> stacked expert SwiGLU: (E*Cb, d) outputs
    in the compute dtype."""
    T, d = xf.shape
    xpad = torch.cat([xf.to(compute_dtype),
                      torch.zeros((1, d), dtype=compute_dtype,
                                  device=xf.device)], dim=0)
    h = xpad[slot_tok].reshape(n_experts, Cb, d)
    g = torch.bmm(h, wg.to(compute_dtype))
    u = torch.bmm(h, wu.to(compute_dtype))
    eo = torch.bmm(F.silu(g) * u, wd.to(compute_dtype))
    return eo.reshape(n_experts * Cb, d)


def _combine(eo: torch.Tensor, slot_of: torch.Tensor, top_i: torch.Tensor,
             top_p: torch.Tensor) -> torch.Tensor:
    """y[t] = sum_j w[t, j] * eo[slot_of[t, j]] in f32, choices in
    ascending expert order, each product rounded to eo's dtype first as
    the reference's ``contrib``; dropped choices read a zero row."""
    T, k = slot_of.shape
    eo = torch.cat([eo, torch.zeros((1, eo.shape[1]), dtype=eo.dtype,
                                    device=eo.device)], dim=0)
    order = torch.argsort(top_i, dim=1)
    slots = torch.gather(slot_of, 1, order)
    w = torch.gather(top_p, 1, order).to(eo.dtype)
    y = torch.zeros((T, eo.shape[1]), dtype=torch.float32, device=eo.device)
    for j in range(k):
        y = y + (eo[slots[:, j]] * w[:, j, None]).float()
    return y


def _shared_ffn(p: SharedExpert, xf: torch.Tensor, compute_dtype):
    x = xf.to(compute_dtype)
    g = x @ p.w_gate.to(compute_dtype)
    u = x @ p.w_up.to(compute_dtype)
    return ((F.silu(g) * u) @ p.w_down.to(compute_dtype)).float()


def moe_apply(p: MoE, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25, compute_dtype=torch.bfloat16,
              groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d) in x's dtype, aux_loss f32).  The
    B*S tokens are routed in ``groups`` equal runs of consecutive tokens,
    each with the capacity of a run (see the module note)."""
    B, S, d = x.shape
    T = B * S
    if T % groups:
        raise ValueError(f"{T} tokens do not split into {groups} groups")
    xf = x.reshape(T, d)
    top_p, top_i, aux = _route(p, xf, n_experts, top_k)
    C = expert_capacity(T // groups, n_experts, top_k, capacity_factor)
    slot_tok, slot_of, Cb = _slot_table(top_i, n_experts=n_experts, C=C,
                                        groups=groups)
    eo = _expert_ffn(xf, slot_tok, p.w_gate, p.w_up, p.w_down,
                     n_experts=n_experts, Cb=Cb, compute_dtype=compute_dtype)
    y = _combine(eo, slot_of, top_i, top_p)
    if p.shared is not None:
        y = y + _shared_ffn(p.shared, xf, compute_dtype)
    return y.reshape(B, S, d).to(x.dtype), aux



# ---------------------------------------------------------------------------
# Expert-parallel dispatch (the reference's shard_map ``moe_apply_ep``).
#
# Under the ambient DeviceMesh (``distributed.sharding.use_mesh``) each
# data rank routes only its own tokens, at the capacity of its own token
# count; activations are replicated over ``model``, so no token moves.
# Each model rank holds E/model experts (E % model == 0: deepseek-v3's 256)
# or a d_ff slice of every expert (mixtral's 8 on a wider axis), cut from
# the whole weights by ``local_moe`` under the partition rules, applies
# them, and the partials combine with ONE all_reduce over ``model`` a
# layer.  The shared expert is cut by the same rules and its partial joins
# that one sum.
# ---------------------------------------------------------------------------


def local_moe(p: MoE, device_mesh) -> MoE:
    """This rank's block of ``p`` under ``distributed.sharding``'s rules on
    ``device_mesh``: the router whole, the experts and the shared expert
    cut by ``local_shard`` (views of ``p``'s weights).  The result carries
    the specs it was cut with, which ``moe_apply_ep`` reads."""
    from repro_torch.distributed import sharding as shd
    specs = shd.param_specs({"moe": shd.param_shapes(p)}, device_mesh)["moe"]
    coords = shd.mesh_coords(device_mesh)
    out = MoE.__new__(MoE)
    nn.Module.__init__(out)

    def cut(t: torch.Tensor, spec) -> nn.Parameter:
        return nn.Parameter(shd.local_shard(t.data, spec, device_mesh, coords),
                            requires_grad=t.requires_grad)

    out.router = p.router
    for name in ("w_gate", "w_up", "w_down"):
        setattr(out, name, cut(getattr(p, name), specs[name]))
    out.shared = None
    if p.shared is not None:
        out.shared = SharedExpert.__new__(SharedExpert)
        nn.Module.__init__(out.shared)
        for name in ("w_gate", "w_up", "w_down"):
            setattr(out.shared, name, cut(getattr(p.shared, name),
                                          specs["shared"][name]))
    out.specs = specs
    return out


def _model_split(spec) -> bool:
    return any(ax == "model" or (isinstance(ax, tuple) and "model" in ax)
               for ax in spec)


def ep_applicable(n_experts: int) -> bool:
    """True when a DeviceMesh with a ``model`` dim wider than 1 is current
    (``distributed.sharding.use_mesh``).  E % model == 0 selects
    expert-parallel, otherwise the d_ff dim is split; both dispatch each
    data rank's tokens locally."""
    from repro_torch.distributed import sharding as shd
    mesh = shd.current_mesh()
    return mesh is not None and shd.mesh_sizes(mesh).get("model", 1) > 1


def moe_apply_ep(p: MoE, x: torch.Tensor, *, n_experts: int, top_k: int,
                 capacity_factor: float = 1.25, compute_dtype=torch.bfloat16,
                 groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_apply``'s math, dispatched on this rank of the current
    DeviceMesh: ``x`` (B_local, S, d) is this data rank's tokens, ``p`` its
    block (``local_moe``).  The router and the slot table run on the local
    tokens at the local capacity; the experts this rank holds (or its d_ff
    slice of every expert) and its shared-expert slice give a partial
    output, summed over ``model`` by one ``all_reduce`` (its backward is
    the identity, and the inputs' gradients are summed over ``model`` on
    the way back, megatron's ``g`` and ``f``).  aux is the load-balance
    loss of the global batch (the mean router probability and assignment
    share of each expert averaged over the data ranks first), the
    reference's when every data rank holds as many tokens.  With a model
    dim of 1 this is ``moe_apply`` bit for bit."""
    from repro_torch.distributed import sharding as shd
    mesh = shd.current_mesh()
    if mesh is None:
        raise ValueError("moe_apply_ep needs a current DeviceMesh "
                         "(distributed.sharding.use_mesh)")
    specs = getattr(p, "specs", None)
    if specs is None:
        raise ValueError("moe_apply_ep takes this rank's block of the MoE "
                         "weights: cut them with nn.moe.local_moe")
    sizes = shd.mesh_sizes(mesh)
    coords = shd.mesh_coords(mesh)
    model = sizes.get("model", 1)
    mgroup = mesh.get_group("model") if "model" in sizes else None
    B, S, d = x.shape
    T = B * S
    if T % groups:
        raise ValueError(f"{T} tokens do not split into {groups} groups")
    xf = x.reshape(T, d)
    top_p, top_i, me, ce = _route_parts(p, xf, n_experts, top_k)
    dsize = 1
    for ax in shd.data_axes(mesh):
        if sizes[ax] > 1:
            me = shd.reduce_from(me, mesh.get_group(ax))
            ce = shd.reduce_from(ce, mesh.get_group(ax))
            dsize *= sizes[ax]
    aux = n_experts * torch.sum(me * ce) if dsize == 1 else \
        n_experts * torch.sum((me / dsize) * (ce / dsize))
    expert_parallel = specs["w_gate"] and specs["w_gate"][0] == "model"
    e_sel = p.w_gate.shape[0]
    e_lo = coords["model"] * e_sel if expert_parallel else 0
    C = expert_capacity(T // groups, n_experts, top_k, capacity_factor)
    slot_tok, slot_of, Cb = _slot_table(top_i, n_experts=n_experts, C=C,
                                        groups=groups, e_lo=e_lo, e_sel=e_sel)
    split = mgroup is not None and model > 1
    xr = shd.copy_to(xf, mgroup) if split else xf
    pr = shd.copy_to(top_p, mgroup) if split else top_p
    eo = _expert_ffn(xr, slot_tok, p.w_gate, p.w_up, p.w_down,
                     n_experts=e_sel, Cb=Cb, compute_dtype=compute_dtype)
    y = _combine(eo, slot_of, top_i, pr)
    whole = None    # parts every model rank computes in full
    if not _model_split(specs["w_gate"]) and split:
        whole, y = y, torch.zeros_like(y)
    if p.shared is not None:
        ys = _shared_ffn(p.shared, xr, compute_dtype)
        if _model_split(specs["shared"]["w_gate"]) or not split:
            y = y + ys
        else:
            whole = ys if whole is None else whole + ys
    if mgroup is not None:
        y = shd.reduce_from(y, mgroup)   # the layer's one all_reduce
    if whole is not None:
        y = y + whole
    return y.reshape(B, S, d).to(x.dtype), aux


def moe_dispatch(p: MoE, x: torch.Tensor, *, n_experts: int, top_k: int,
                 capacity_factor: float = 1.25, compute_dtype=torch.bfloat16,
                 groups: int = 1, impl: str = "auto"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``impl``: ``dense`` (``moe_apply``), ``ep`` (``moe_apply_ep``) or
    ``auto`` (ep when a DeviceMesh with a model dim wider than 1 is
    current, or when ``x`` is a DTensor: ``_moe_region``).  With no mesh
    current this is ``moe_apply`` exactly."""
    if impl not in ("dense", "ep", "auto"):
        raise ValueError(f"unknown MoE dispatch {impl!r}: dense, ep or auto")
    from repro_torch.distributed.sharding import is_dtensor
    if impl != "dense" and is_dtensor(x):
        return _moe_region(p, x, n_experts=n_experts, top_k=top_k,
                           capacity_factor=capacity_factor,
                           compute_dtype=compute_dtype, groups=groups)
    if impl == "ep" or (impl == "auto" and ep_applicable(n_experts)):
        return moe_apply_ep(p, x, n_experts=n_experts, top_k=top_k,
                            capacity_factor=capacity_factor,
                            compute_dtype=compute_dtype, groups=groups)
    return moe_apply(p, x, n_experts=n_experts, top_k=top_k,
                     capacity_factor=capacity_factor,
                     compute_dtype=compute_dtype, groups=groups)


def _moe_region(p: MoE, x, *, n_experts: int, top_k: int,
                capacity_factor: float, compute_dtype, groups: int):
    """The MoE of a step on a DeviceMesh (DTensor parameters and tokens):
    ``moe_apply_ep`` on this rank's local blocks, its tokens whole over
    ``model`` and split over the data axes.  Each data rank routes its own
    tokens at the capacity of its own token count: where the capacity
    drops tokens this differs from the reference's program, which routes
    the global batch (with a capacity that drops nothing the two agree).
    The load-balance loss is the global batch's.  A
    parameter whole on a data axis gets its gradient there as a partial
    sum over the data ranks (each saw only its tokens)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from repro_torch.distributed import sharding as shd
    mesh = x.device_mesh
    names = list(mesh.mesh_dim_names)
    data = set(shd.data_axes(mesh))

    def local(t):
        gp = [Partial() if n in data and isinstance(pl, Replicate) else pl
              for n, pl in zip(names, t.placements)]
        return t.to_local(grad_placements=gp)

    def block(mod, names):
        return SimpleNamespace(**{n: local(getattr(mod, n)) for n in names})

    out = block(p, ("w_gate", "w_up", "w_down"))
    out.router = SimpleNamespace(w=local(p.router.w), b=None if p.router.b
                                 is None else local(p.router.b))
    out.shared = None if p.shared is None else block(
        p.shared, ("w_gate", "w_up", "w_down"))
    out.specs = shd.param_specs({"moe": shd.param_shapes(p)}, mesh)["moe"]
    xp = shd.row_placements(x)
    xl = x.redistribute(mesh, xp).to_local()
    with shd.use_mesh(mesh):
        y, aux = moe_apply_ep(out, xl, n_experts=n_experts, top_k=top_k,
                              capacity_factor=capacity_factor,
                              compute_dtype=compute_dtype, groups=groups)
    rep = [Replicate()] * len(names)
    return (DTensor.from_local(y, mesh, xp, run_check=False,
                               shape=x.shape, stride=x.stride()),
            DTensor.from_local(aux, mesh, rep, run_check=False))
