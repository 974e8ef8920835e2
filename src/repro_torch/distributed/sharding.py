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
                use_model: bool = True, mode: str = "heads") -> Any:
    """KV/SSM cache specs, the reference's rule: the batch axis (the first
    axis whose size is ``batch``) over the data axes; with a model axis,
    ``mode="heads"`` puts it on the last trailing dim (>= 2 past the
    batch axis, so the cache-time axis stays whole) that it divides, and
    ``mode="time"`` on the cache-time axis (batch axis + 1)."""
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
            baxis = next(i for i in range(ndim - 1) if shape[i] == batch)
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
