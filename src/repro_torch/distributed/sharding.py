"""Partition rules: a regex over parameter-tree paths -> a partition spec.

A spec is a tuple with one entry per leading dim of a leaf: an axis name,
a tuple of axis names (the dim splits over their product, row-major), or
``None`` (the dim is whole on every mesh position); dims past the tuple's
end are whole too, and ``()`` replicates the leaf.  The rules are the
reference's ``distributed/sharding.py`` data, copied verbatim: candidate
specs aligned to a leaf's TRAILING dims (a layer-stacked leaf's leading
axes are padded with ``None``); the first candidate whose named axes
divide the dims wins, otherwise the leaf replicates.  So MoE experts go
expert-parallel where E % model == 0 (deepseek-v3, 256) and fall back to
d_ff tensor-parallel where not (mixtral, 8).  The monitor tower (the
``edge``, ``u_head`` and ``v_head`` subtrees) always replicates: the edge
path must not need a model-axis collective.

The paths are the reference's (``server/blocks/attn/wq/w``): the port's
modules are walked in the layout ``bridge.collab_to_numpy`` writes
(``param_shapes``), so a spec here can be held leaf for leaf against the
reference's.  No device is needed: a ``Mesh`` is axis names and sizes,
with devices only once ``serving.mesh.MeshSpec.build`` places one.

``local_shard`` cuts a whole leaf to the block one mesh position holds.
``use_mesh`` makes a ``torch.distributed.device_mesh.DeviceMesh`` (dims
named ``data``/``pod`` and ``model``) current for the MoE dispatch, the
counterpart of the reference's ``with mesh:``; ``reduce_from`` and
``copy_to`` are the two collectives of a tensor-parallel region.
"""
from __future__ import annotations

import contextlib
import math
import re
from dataclasses import dataclass
from typing import (Any, Dict, Iterator, List, Mapping, Optional, Sequence,
                    Tuple)

import torch

Spec = Tuple[Any, ...]

# Candidate trailing-dim specs per path regex (first match wins; within a
# match, first divisible candidate wins).  "model" is the tensor axis;
# batch axes are handled by activation/batch specs, not these rules.
_RULES: List[Tuple[str, List[Tuple[Optional[str], ...]]]] = [
    # --- paper monitor tower: strictly replicated ---------------------------
    (r"(^|/)(edge|u_head|v_head)(/|$)", [()]),
    # --- embeddings ----------------------------------------------------------
    (r"embed/table$", [("model", None), (None, "model", None)]),
    # --- MoE (E, d, ff) / (E, ff, d): expert-parallel first, else TP on ff ---
    (r"moe/w_(gate|up)$", [("model", None, None), (None, None, "model")]),
    (r"moe/w_down$", [("model", None, None), (None, "model", None)]),
    (r"moe/shared/w_(gate|up)$", [(None, "model")]),
    (r"moe/shared/w_down$", [("model", None)]),
    (r"moe/router/", [()]),
    # --- attention: column-parallel in, row-parallel out ---------------------
    (r"(wq|wk|wv|wq_a|wq_b|wkv_b)/w$", [(None, "model")]),
    (r"(wq|wk|wv)/b$", [("model",)]),
    (r"wkv_a/w$", [()]),  # MLA latent proj output is tiny (kv_lora+rope)
    (r"(wo|w_out)/w$", [("model", None)]),
    # --- dense MLP -----------------------------------------------------------
    (r"mlp/w_(gate|up)/w$", [(None, "model")]),
    (r"mlp/w_down/w$", [("model", None)]),
    # --- Mamba2 split streams -------------------------------------------------
    (r"(w_z|w_x)/w$", [(None, "model")]),
    (r"(w_B|w_C)/w$", [()]),
    (r"w_dt/w$", [(None, "model")]),
    (r"conv_x/w$", [(None, "model")]),
    (r"conv_x/b$", [("model",)]),
    (r"conv_[BC]/", [()]),
    (r"(A_log|D|dt_bias)$", [("model",)]),
    (r"mamba/norm_scale$", [("model",)]),
    (r"out_proj/w$", [("model", None)]),
    # --- xLSTM ----------------------------------------------------------------
    (r"(w_i|w_f|w_o|w_z)/w$", [(None, "model")]),
    (r"r_[zifo]$", [()]),
    # --- everything else (norms, gates, scalars): replicate --------------------
    (r".*", [()]),
]


@dataclass(frozen=True)
class Mesh:
    """Named mesh axes with their sizes, and (once placed) the devices of
    its positions in row-major order over the axes."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Optional[Tuple[torch.device, ...]] = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def coords(self, flat: int) -> Dict[str, int]:
        """The axis coordinates of position ``flat`` (row-major)."""
        out = {}
        for name, size in zip(reversed(self.axis_names),
                              reversed(self.axis_sizes)):
            flat, out[name] = divmod(flat, size)
        return {n: out[n] for n in self.axis_names}


def abstract_mesh(axis_sizes: Sequence[int],
                  axis_names: Sequence[str]) -> Mesh:
    """A device-free mesh (the reference's ``AbstractMesh``)."""
    return Mesh(tuple(axis_names), tuple(int(s) for s in axis_sizes))


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``Mesh`` or a torch ``DeviceMesh``."""
    if isinstance(mesh, Mesh):
        return mesh.shape
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


def _choose(shape: Tuple[int, ...], candidates, mesh: Mesh) -> Spec:
    sizes = mesh_sizes(mesh)
    for cand in candidates:
        if len(cand) > len(shape):
            continue
        if not any(ax is not None for ax in cand):
            return ()  # canonical replication
        spec = (None,) * (len(shape) - len(cand)) + tuple(cand)
        ok = True
        for dim, ax in zip(shape, spec):
            if ax is not None and dim % sizes[ax] != 0:
                ok = False
                break
        if ok:
            return spec
    return ()


# ---------------------------------------------------------------------------
# Trees: nested dicts (the reference's layout), NamedTuple cache entries
# ---------------------------------------------------------------------------


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a nested dict, keeping its structure."""
    if isinstance(tree, Mapping):
        return {k: map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def iter_paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """("a/b/c", leaf) pairs in the reference's order: dict keys sorted,
    a NamedTuple's fields by name, a list's items by index; ``None`` is an
    empty subtree."""
    if tree is None:
        return
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from iter_paths(tree[k], f"{prefix}/{k}" if prefix else k)
    elif hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from iter_paths(getattr(tree, k),
                                  f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from iter_paths(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def param_shapes(module: torch.nn.Module) -> Dict[str, Any]:
    """A module's parameter shapes as the reference's tree: nested dicts
    in ``bridge.collab_to_numpy``'s layout, a ``ModuleList``'s layers
    stacked on a leading axis.  Works on the meta device, so a FULL config
    needs no memory."""
    from repro_torch import bridge
    tree: Dict[str, Any] = {}
    for key, p in module.named_parameters(recurse=False):
        tree[key] = tuple(p.shape)
    for key, child in module.named_children():
        tree[key] = (bridge._shapes(child)
                     if isinstance(child, torch.nn.ModuleList)
                     else param_shapes(child))
    return tree


def _as_tree(tree):
    return param_shapes(tree) if isinstance(tree, torch.nn.Module) else tree


def param_specs(tree: Any, mesh) -> Any:
    """A parameter tree (a module, or nested dicts of tensors, arrays or
    shape tuples) -> the same dicts of specs."""

    def assign(path: str, leaf) -> Spec:
        if leaf is None:
            return ()
        for pattern, candidates in _RULES:
            if re.search(pattern, path):
                return _choose(_shape(leaf), candidates, mesh)
        return ()

    return map_with_path(assign, _as_tree(tree))


# ---------------------------------------------------------------------------
# Batch / cache / optimizer specs
# ---------------------------------------------------------------------------


def data_axes(mesh) -> Tuple[str, ...]:
    sizes = mesh_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def _data_total(mesh) -> int:
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for a in data_axes(mesh))


def batch_spec(mesh, leaf_shape: Tuple[int, ...], batch_size: int) -> Spec:
    """Dim 0 (the batch) over pod+data where divisible; else data alone;
    else replicated (batch 1)."""
    axes = data_axes(mesh)
    sizes = mesh_sizes(mesh)
    if batch_size % _data_total(mesh) == 0 and axes:
        first = axes if len(axes) > 1 else axes[0]
        return (first,) + (None,) * (len(leaf_shape) - 1)
    if "data" in sizes and batch_size % sizes["data"] == 0:
        return ("data",) + (None,) * (len(leaf_shape) - 1)
    return ()


def _map_cache(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: _map_cache(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_cache(fn, v) for v in tree))
    return fn(tree)


def cache_specs(cache_tree: Any, mesh, batch: int, *,
                use_model: bool = True, mode: str = "heads",
                batch_axis: Optional[int] = None) -> Any:
    """KV/SSM cache specs, the reference's rule: the batch axis (the first
    axis whose size is ``batch``) over the data axes; with a model axis,
    ``mode="heads"`` puts it on the last trailing dim (>= 2 past the
    batch axis, so the cache-time axis stays whole) that it divides, and
    ``mode="time"`` on the cache-time axis (batch axis + 1).
    ``batch_axis`` names the batch axis of every leaf instead of the
    search, which takes a layer axis as long as the batch for it."""
    sizes = mesh_sizes(mesh)
    model = sizes.get("model", 1)
    # a mesh without a model axis must never emit a "model" entry
    use_model = use_model and "model" in sizes
    daxes = data_axes(mesh)
    dtotal = _data_total(mesh)

    def assign(leaf) -> Spec:
        shape = _shape(leaf)
        ndim = len(shape)
        if ndim < 2:
            return ()
        spec: List[Any] = [None] * ndim
        try:
            baxis = batch_axis if batch_axis is not None else next(
                i for i in range(ndim - 1) if shape[i] == batch)
        except StopIteration:
            return ()
        if batch % dtotal == 0 and daxes:
            spec[baxis] = daxes if len(daxes) > 1 else daxes[0]
        elif "data" in sizes and batch % sizes["data"] == 0:
            spec[baxis] = "data"
        if use_model and mode == "time":
            taxis = baxis + 1
            if taxis < ndim and shape[taxis] % model == 0 \
                    and shape[taxis] >= model:
                spec[taxis] = "model"
            return tuple(spec)
        if use_model:
            for ax in range(ndim - 1, baxis + 1, -1):
                if shape[ax] % model == 0 and shape[ax] >= model:
                    spec[ax] = "model"
                    break
        return tuple(spec)

    return _map_cache(assign, cache_tree)


def replicated(mesh) -> Spec:
    return ()


def opt_specs(tree: Any, mesh, *, zero1: bool = False) -> Any:
    """Optimizer-moment specs.  ``zero1=False``: the parameters' own.
    ``zero1=True``: each moment leaf also splits over the data axes on its
    first free dim they divide (ZeRO-1 state partitioning)."""
    tree = _as_tree(tree)
    specs = param_specs(tree, mesh)
    if not zero1:
        return specs
    daxes = data_axes(mesh)
    dtotal = _data_total(mesh)
    dname = daxes if len(daxes) > 1 else (daxes[0] if daxes else None)
    if dname is None or dtotal == 1:
        return specs

    def widen(leaf, spec: Spec) -> Spec:
        if leaf is None:
            return spec
        shape = _shape(leaf)
        if not shape:
            return spec
        s = list(spec) + [None] * (len(shape) - len(spec))
        for ax, dim in enumerate(shape):
            if s[ax] is None and dim % dtotal == 0 and dim >= dtotal:
                s[ax] = dname
                return tuple(s)
        return spec

    def walk(t, s):
        if isinstance(t, Mapping):
            return {k: walk(t[k], s[k]) for k in t}
        return widen(t, s)

    return walk(tree, specs)


# ---------------------------------------------------------------------------
# Cutting a leaf to one mesh position's block
# ---------------------------------------------------------------------------


def local_shard(tensor: torch.Tensor, spec: Spec, mesh,
                coords: Mapping[str, int]) -> torch.Tensor:
    """The block of ``tensor`` that the mesh position at ``coords`` (axis
    name -> index) holds under ``spec``: each named dim is cut into the
    product of its axes' sizes and the block at the position's row-major
    index over those axes is kept.  A view where the cuts allow."""
    sizes = mesh_sizes(mesh)
    out = tensor
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        n, idx = 1, 0
        for a in axes:
            n *= sizes[a]
            idx = idx * sizes[a] + int(coords[a])
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(tensor.shape)} does not "
                             f"split {n} ways ({spec})")
        step = out.shape[dim] // n
        out = out.narrow(dim, idx * step, step)
    return out


# ---------------------------------------------------------------------------
# The ambient DeviceMesh (the reference's ``with mesh:``) and the two
# collectives of a tensor-parallel region
# ---------------------------------------------------------------------------

_MESHES: List[Any] = []


@contextlib.contextmanager
def use_mesh(device_mesh):
    """Make a ``torch.distributed.device_mesh.DeviceMesh`` (dims named from
    ``pod``/``data``/``model``) current for the block: ``nn.moe``'s
    ``moe_dispatch(impl="auto")`` dispatches expert-parallel under it."""
    _MESHES.append(device_mesh)
    try:
        yield device_mesh
    finally:
        _MESHES.pop()


def current_mesh():
    """The innermost ``use_mesh`` DeviceMesh, or None."""
    return _MESHES[-1] if _MESHES else None


def mesh_coords(device_mesh) -> Dict[str, int]:
    """This rank's coordinate on every dim of ``device_mesh``."""
    return {n: device_mesh.get_local_rank(n)
            for n in device_mesh.mesh_dim_names}


class _ReduceFrom(torch.autograd.Function):
    """Sum over a group forward; the identity backward: each rank's
    cotangent of the (replicated) sum is already the whole gradient of
    its partial."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyTo(torch.autograd.Function):
    """The identity forward; a sum over the group backward: a replicated
    input feeds every rank's partial, so its gradient is their sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Combine the partials of a tensor-parallel region (megatron's
    ``g``): an ``all_reduce`` sum over ``group``."""
    return _ReduceFrom.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Enter a tensor-parallel region (megatron's ``f``): the identity,
    whose backward sums the gradient over ``group``."""
    return _CopyTo.apply(x, group)


# ---------------------------------------------------------------------------
# DTensor placement: the counterpart of the reference's ``jit(...,
# in_shardings=...)``.  Parameters, optimizer moments and the batch become
# ``torch.distributed.tensor.DTensor``s placed by the specs above; the
# model code runs on them unchanged and DTensor's propagation inserts the
# collectives, as GSPMD does for the reference.  Hand-written kernels run
# in ``local_map`` regions (``kernels/ops.py``, ``nn/moe.py``).
# ---------------------------------------------------------------------------


def is_dtensor(t) -> bool:
    """Whether ``t`` is a ``torch.distributed.tensor.DTensor`` (imports
    the DTensor package only once one can exist)."""
    if not isinstance(t, torch.Tensor) or type(t) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def placements(spec: Spec, device_mesh) -> Tuple[Any, ...]:
    """A spec -> the DTensor placements on ``device_mesh`` (one per mesh
    dim): ``Shard(d)`` on each mesh dim that dim ``d`` names, Replicate
    elsewhere.  A dim named by a tuple of axes takes one ``Shard(d)`` on
    each of them; DTensor orders such shards by mesh dim, which is the
    row-major order ``local_shard`` cuts in, so the tuple must name them
    in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(device_mesh.mesh_dim_names)
    out: List[Any] = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: mesh dim {names[i]} "
                                 f"named twice")
            out[i] = Shard(dim)
    return tuple(out)


def _stacked_spec(specs, name: str) -> Spec:
    """The spec of the parameter ``name`` (a module path, e.g.
    ``server.blocks.3.attn.wq.w``) from the stacked tree of specs: its
    reference path's spec without the leading layer axes (one per layer
    index in the path)."""
    node, n_layer = specs, 0
    for part in name.split("."):
        if part.isdigit():
            n_layer += 1
            continue
        node = node[part]
    return tuple(node)[n_layer:] if node else ()


def named_specs(model: torch.nn.Module, mesh, *,
                zero1: Optional[bool] = None) -> Dict[str, Spec]:
    """Parameter name -> the spec of that (per-layer) parameter: the
    partition rules' spec of its stacked leaf, layer axes dropped.  With
    ``zero1`` given: the optimizer moments' specs (``opt_specs``), where
    ZeRO-1's data split goes on the per-layer parameter's own first free
    dim it divides (the reference's stacked moment may take the layer
    axis instead; the bytes a device holds are the same)."""
    specs = param_specs(model, mesh)
    out = {name: _stacked_spec(specs, name)
           for name, _ in model.named_parameters()}
    if not zero1:
        return out
    daxes = data_axes(mesh)
    dtotal = _data_total(mesh)
    dname = daxes if len(daxes) > 1 else (daxes[0] if daxes else None)
    if dname is None or dtotal == 1:
        return out
    for name, p in model.named_parameters():
        s = list(out[name]) + [None] * (p.dim() - len(out[name]))
        for ax, dim in enumerate(p.shape):
            if s[ax] is None and dim % dtotal == 0 and dim >= dtotal:
                s[ax] = dname
                out[name] = tuple(s)
                break
    return out


def set_param(model: torch.nn.Module, name: str, value) -> None:
    """Replace the parameter ``name`` (a module path) of ``model``."""
    owner, _, leaf = name.rpartition(".")
    mod = model.get_submodule(owner) if owner else model
    mod._parameters[leaf] = value


def opt_placements(model: torch.nn.Module, device_mesh, *,
                   zero1: bool = False) -> List[Tuple]:
    """The optimizer moments' placements (``opt_specs(zero1=zero1)``), in
    ``model.parameters()`` order: what ``training.optimizer.AdamW.init``
    takes as ``placements``."""
    ospecs = named_specs(model, device_mesh, zero1=zero1)
    return [placements(ospecs[name], device_mesh)
            for name, _ in model.named_parameters()]


def distribute_collab(model: torch.nn.Module, device_mesh, *,
                      zero1: bool = False) -> List[Tuple]:
    """Place every parameter of ``model`` on ``device_mesh`` by the
    partition rules, in place: each becomes a ``DTensor`` parameter whose
    local block is ``local_shard``'s (every rank holds the same whole
    weights; no collective moves them).  Returns ``opt_placements``."""
    from torch.distributed.tensor import distribute_tensor
    pspecs = named_specs(model, device_mesh)
    for name, p in list(model.named_parameters()):
        if is_dtensor(p):
            raise ValueError(f"{name} is placed already")
        dt = distribute_tensor(p.data, device_mesh,
                               placements(pspecs[name], device_mesh),
                               src_data_rank=None)
        set_param(model, name, torch.nn.Parameter(
            dt, requires_grad=p.requires_grad))
    return opt_placements(model, device_mesh, zero1=zero1)


def init_placed(model: torch.nn.Module, init, device, device_mesh) -> None:
    """Run ``init()`` (the in-place draws of ``model.init_``) on ``model``,
    built on the meta device, and place each parameter on ``device_mesh``
    as its draw lands: the in-place op runs on the whole leaf made on
    ``device``, and a copy of this rank's block (``local_shard``) becomes
    the DTensor parameter.  The draws are an unplaced init's with the same
    generator, and a card holds its blocks and one whole leaf at a time.
    Raises if the init leaves a parameter undrawn or draws one twice."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    metas = dict(model.named_parameters())    # alive, so ids stay theirs
    names = {id(p): n for n, p in metas.items()}
    pspecs = named_specs(model, device_mesh)
    coords = mesh_coords(device_mesh)

    class _Place(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                raise ValueError(f"init draws a placed parameter twice "
                                 f"({func})")
            name = names.get(id(args[0])) if args else None
            if name is None or not func._schema.is_mutable:
                return func(*args, **kwargs)
            p = args[0]
            whole = torch.empty(p.shape, dtype=p.dtype, device=device)
            func(whole, *args[1:], **kwargs)
            spec = pspecs[name]
            block = local_shard(whole, spec, device_mesh, coords).clone()
            del whole
            set_param(model, name, torch.nn.Parameter(DTensor.from_local(
                block, device_mesh, placements(spec, device_mesh),
                run_check=False, shape=p.shape, stride=p.stride()),
                requires_grad=p.requires_grad))
            return p

    with _Place():
        init()
    for name, p in model.named_parameters():
        if not is_dtensor(p):
            raise ValueError(f"init drew no value for {name}")


def batch_placements(device_mesh, leaf_shape: Tuple[int, ...],
                     batch_size: int) -> Tuple[Any, ...]:
    """``batch_spec``'s placements: dim 0 over the data axes."""
    return placements(batch_spec(device_mesh, leaf_shape, batch_size),
                      device_mesh)


def distribute_batch(batch: Mapping[str, torch.Tensor],
                     device_mesh) -> Dict[str, Any]:
    """Every leaf of a batch (the same global batch on every rank) as a
    DTensor cut by ``batch_spec``: each rank keeps its data rows."""
    from torch.distributed.tensor import distribute_tensor
    out = {}
    for k, v in batch.items():
        pl = batch_placements(device_mesh, tuple(v.shape), v.shape[0]) \
            if v.dim() else placements((), device_mesh)
        out[k] = distribute_tensor(v, device_mesh, pl, src_data_rank=None)
    return out


def cache_placements(cache: Any, device_mesh, batch: int, *,
                     mode: str = "time", use_model: bool = True) -> Any:
    """``cache_specs``' placements: the cache's tree (its NamedTuples and
    dicts) with each leaf's DTensor placements on ``device_mesh``.  Every
    leaf of a model's decode cache stacks its layers on axis 0 and its
    streams on axis 1 (``models/*.init_cache``), so the batch axis is 1,
    also where the layer count equals the batch."""
    return _map_cache(lambda spec: placements(spec, device_mesh),
                      cache_specs(_map_cache(_shape, cache), device_mesh,
                                  batch, use_model=use_model, mode=mode,
                                  batch_axis=1))


def distribute_cache(cache: Any, device_mesh, batch: int, *,
                     mode: str = "time", use_model: bool = True) -> Any:
    """Every leaf of a decode cache (the same whole cache on every rank)
    as a DTensor placed by ``cache_placements``: each rank keeps its
    block, no collective moves it (``distribute_batch``'s counterpart)."""
    from torch.distributed.tensor import distribute_tensor
    pls = cache_placements(cache, device_mesh, batch, mode=mode,
                           use_model=use_model)
    leaves = iter(tree_leaves_of(pls))
    return _map_cache(lambda t: distribute_tensor(
        t, device_mesh, next(leaves), src_data_rank=None), cache)


def tree_leaves_of(tree) -> List[Any]:
    """The leaves of a cache tree (``_map_cache``'s order)."""
    out: List[Any] = []
    _map_cache(lambda leaf: out.append(leaf), tree)
    return out


def placed_cache(build, device, device_mesh, batch: int, *,
                 mode: str = "time", use_model: bool = True) -> Any:
    """``build(device)`` (a cache's zero or constant init) with every leaf
    a DTensor placed by ``cache_placements``, where ``device`` holds only
    this rank's block of each: the layout is built on the meta device,
    each leaf's fill value read off the factory call that made it, and
    the block allocated and filled on ``device``.  A granite-8b server
    cache at B = 128, C = 32768 is 2.4 GB a card on (16, 16), never the
    whole 618 GB."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    fills: Dict[int, float] = {}
    aten = torch.ops.aten

    class _Fills(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is aten.zeros.default:
                fills[id(out)] = 0.0
            elif func is aten.full.default:
                fills[id(out)] = float(args[1])
            return out

    with _Fills():
        meta = build("meta")
    pls = iter(tree_leaves_of(cache_placements(
        meta, device_mesh, batch, mode=mode, use_model=use_model)))
    coords = mesh_coords(device_mesh)

    def place(t):
        pl = next(pls)
        if id(t) not in fills:
            raise ValueError(f"a cache leaf of {tuple(t.shape)} has no "
                             f"constant init")
        spec = spec_of(pl, t.dim(), device_mesh)
        block = local_shard(t, spec, device_mesh, coords)
        local = torch.full(block.shape, fills[id(t)], dtype=t.dtype,
                           device=device)
        return DTensor.from_local(local, device_mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())

    return _map_cache(place, meta)


def spec_of(pls, ndim: int, device_mesh) -> Spec:
    """The spec of DTensor placements ``pls`` (``placements``' inverse)
    over a tensor of ``ndim`` dims."""
    names = tuple(device_mesh.mesh_dim_names)
    spec: List[Any] = [None] * ndim
    for name, pl in zip(names, pls):
        if pl.is_shard():
            d = pl.dim % ndim
            spec[d] = name if spec[d] is None else (
                (spec[d] if isinstance(spec[d], tuple) else (spec[d],))
                + (name,))
    return tuple(spec)


def whole(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor: a DTensor's ``full_tensor()`` (a collective every
    rank must join), else ``t``."""
    return t.full_tensor() if is_dtensor(t) else t


def mesh_of(model: torch.nn.Module):
    """The DeviceMesh ``model``'s parameters are placed on, or None."""
    for p in model.parameters():
        if is_dtensor(p):
            return p.device_mesh
    return None


def split_heads(t: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    """(..., n_heads * head_dim) -> (..., n_heads, head_dim).  A DTensor
    whose last dim is split over a mesh dim that the heads do not divide
    (a rank would hold part of a head: granite's 8 kv heads of 128 at
    model 16) is first made whole on that mesh dim, as GSPMD gathers it."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate
        last = t.dim() - 1
        pls = list(t.placements)
        bad = [i for i, pl in enumerate(pls)
               if pl.is_shard() and pl.dim in (last, -1)
               and n_heads % t.device_mesh.size(i)]
        if bad:
            for i in bad:
                pls[i] = Replicate()
            t = t.redistribute(t.device_mesh, pls)
    return t.reshape(t.shape[:-1] + (n_heads, head_dim))


def _no_partial(pls):
    from torch.distributed.tensor import Replicate
    return [Replicate() if pl.is_partial() else pl for pl in pls]


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(..., H, D) -> (..., H * D).  A DTensor goes through a ``local_map``
    region placed as it is (heads split or whole), so the gradient comes
    back in that placement: DTensor cannot view a gradient split on
    ``H * D`` back into heads that do not divide the mesh dim."""
    shape = t.shape[:-2] + (t.shape[-2] * t.shape[-1],)
    if not is_dtensor(t):
        return t.reshape(shape)
    from torch.distributed.tensor.experimental import local_map
    pls = _no_partial(t.placements)
    return local_map(lambda x: x.reshape(x.shape[:-2] + (-1,)),
                     out_placements=pls, in_placements=(pls,),
                     device_mesh=t.device_mesh, redistribute_inputs=True)(t)


def row_placements(t) -> List[Any]:
    """Per mesh dim of the DTensor ``t``: ``Shard(0)`` where its rows
    (dim 0, the batch) are split over a data axis, else Replicate: the
    placement a region of each rank's own rows takes."""
    from torch.distributed.tensor import Replicate, Shard
    daxes = set(data_axes(t.device_mesh))
    return [Shard(0) if n in daxes and pl == Shard(0) else Replicate()
            for n, pl in zip(t.device_mesh.mesh_dim_names, t.placements)]


def batch_local(fn, *ts: torch.Tensor):
    """``fn(*ts)`` where ``fn`` works row by row on dim 0 of the first
    tensor (the batch), the others shared by every row (weights) or split
    alike.  DTensors run it in a ``local_map`` region: each keeps its
    batch split over the data axes and is whole on every other mesh dim;
    a tensor whole on a data axis the batch is split on gets its gradient
    there as a partial sum (each data rank saw its own rows).  The output
    is placed as the first input.  DTensor's own propagation would make
    some such ops' gradients whole over the global batch (``gather``'s
    backward allocates the global logits on every rank), and runs a loop
    over time op by op."""
    if not is_dtensor(ts[0]):
        return fn(*ts)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = ts[0].device_mesh
    daxes = set(data_axes(mesh))
    names = mesh.mesh_dim_names
    ins = tuple(row_placements(t) for t in ts)
    split = [any(p[i] == Shard(0) for p in ins) for i in range(len(names))]
    grads = tuple([Partial() if split[i] and pl == Replicate() and
                   names[i] in daxes else pl for i, pl in enumerate(p)]
                  for p in ins)
    return local_map(fn, out_placements=ins[0], in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*ts)


def heads_local(fn, *ts: torch.Tensor, dim: int = 2, outs: int = 1):
    """``fn(*ts)`` where ``fn`` works on each (batch row, head) alone: the
    batch at dim 0 and the heads at ``dim`` of every tensor.  DTensors
    run it in a ``local_map`` region placed as the first: its rows over
    the data axes, its heads over ``model`` where every tensor's heads
    divide it (else whole there); the output is placed so too.  DTensor's
    propagation of a product that merges the batch and the heads into one
    dim (an einsum's ``bmm``) searches its redistribute planner; the
    region runs such products as local ops.  ``outs``: how many tensors
    ``fn`` returns (each placed so)."""
    if not is_dtensor(ts[0]):
        return fn(*ts)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = ts[0].device_mesh
    names = list(mesh.mesh_dim_names)
    pls = row_placements(ts[0])
    if "model" in names:
        i = names.index("model")
        model = mesh.size(i)
        pls[i] = Shard(dim) if all(t.shape[dim] % model == 0 for t in ts) \
            else Replicate()
    ins = tuple(list(pls) for _ in ts)
    out = list(pls) if outs == 1 else tuple(list(pls) for _ in range(outs))
    return local_map(fn, out_placements=out, in_placements=ins,
                     in_grad_placements=ins, device_mesh=mesh,
                     redistribute_inputs=True)(*ts)


def model_region(fn, ts: Sequence[Any], specs: Sequence[Tuple[bool, Any]],
                 out_specs: Sequence[Tuple[bool, Any]], rows_of):
    """``fn(*ts)`` in a ``local_map`` region (forward only: a decode step)
    on ``rows_of``'s mesh.  ``specs[i] = (rows, placement)``: tensor i
    takes ``rows_of``'s batch split on the data axes where ``rows`` (else
    whole there) and ``placement`` on ``model``; at ``model`` = 1 it keeps
    its own placement there (no redistribution).  A plain tensor counts as
    replicated.  ``out_specs`` place the outputs alike (one spec: ``fn``
    returns one tensor)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = rows_of.device_mesh
    names = list(mesh.mesh_dim_names)
    rows = row_placements(rows_of)
    mi = names.index("model") if "model" in names else None
    one = mi is None or mesh.size(mi) == 1

    def pls(spec, t=None):
        has_rows, model_pl = spec
        out = [rows[i] if has_rows else Replicate()
               for i in range(len(names))]
        if mi is not None:
            out[mi] = t.placements[mi] if one and t is not None \
                else model_pl
        return out

    ts = [t if is_dtensor(t) else DTensor.from_local(
        t, mesh, [Replicate()] * len(names), run_check=False) for t in ts]
    ins = tuple(pls(s, t) for s, t in zip(specs, ts))
    outs = tuple(pls(s) for s in out_specs)
    return local_map(fn, out_placements=outs if len(outs) > 1 else outs[0],
                     in_placements=ins, device_mesh=mesh,
                     redistribute_inputs=True)(*ts)


def settle(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's partial sums made whole (an all-reduce over each mesh
    dim they are partial on: megatron's ``g`` after a row-parallel
    product), else ``t``.  The backward is the identity, as ``g``'s: the
    gradient of a replicated sum is whole on every rank.  DTensor's own
    redistribute would send the gradient back as partial sums, and the
    weight gradient of the product before it would then be computed
    whole on every rank; left partial, its propagation may instead
    reduce-scatter a layer's output over the sequence, which a later
    flattened product cannot take."""
    if not is_dtensor(t) or not any(pl.is_partial() for pl in t.placements):
        return t
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = t.device_mesh
    dims = [i for i, pl in enumerate(t.placements) if pl.is_partial()]
    out = [Replicate() if pl.is_partial() else pl for pl in t.placements]

    def body(x):
        for i in dims:
            x = reduce_from(x, mesh.get_group(i))
        return x

    return local_map(body, out_placements=out,
                     in_placements=(list(t.placements),),
                     in_grad_placements=(out,), device_mesh=mesh)(t)


def vocab_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (rows of a (V, d) table).  A DTensor table split on
    its rows over ``model`` runs the vocab-parallel lookup in a
    ``local_map`` region: each rank looks up the ids in its rows (zeros
    for the rest), and one all-reduce over ``model`` (``settle``) makes
    the result whole, as megatron's vocab-parallel embedding does.
    DTensor's own strategy moves the table to a split of its columns
    instead, and every product after it then runs on the whole width."""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    names = list(mesh.mesh_dim_names)
    daxes = set(data_axes(mesh))
    if not is_dtensor(ids):     # a plain tensor counts as replicated
        ids = DTensor.from_local(ids, mesh, [Replicate()] * len(names),
                                 run_check=False)
    ids_pl = row_placements(ids)
    tab_pl = [Shard(0) if n == "model" and pl == Shard(0) else Replicate()
              for n, pl in zip(names, table.placements)]
    tab_grad = [Partial() if ids_pl[i] == Shard(0) else tab_pl[i]
                for i in range(len(names))]
    split = "model" in names and tab_pl[names.index("model")] == Shard(0)
    out = [ids_pl[i] if names[i] in daxes else
           (Partial() if split and names[i] == "model" else Replicate())
           for i in range(len(names))]
    V = table.shape[0]

    def body(tab, i):
        if not split:
            return tab[i]
        lo = mesh.get_local_rank("model") * tab.shape[0]
        mine = (i >= lo) & (i < lo + tab.shape[0])
        rows = tab[torch.where(mine, i - lo, 0)]
        return rows * mine[..., None].to(rows.dtype)

    if V % max(mesh.size(names.index("model")) if "model" in names
               else 1, 1):
        raise ValueError(f"{V} rows do not split over model")
    y = local_map(body, out_placements=out, in_placements=(tab_pl, ids_pl),
                  in_grad_placements=(tab_grad, ids_pl), device_mesh=mesh,
                  redistribute_inputs=True)(table, ids)
    return settle(y)
