"""Carry weights between the JAX package's trees and the port's modules.

The reference keeps parameters as nested dicts with layers stacked on a
leading axis (``blocks/attn/wq/w`` of shape (n_layers, d, Hq*D)), or on
two (the hybrid's ``mamba_blocks``, (n_super, k, ...)), where the port
has a ``ModuleList`` of layers (of ``ModuleList``s).  The
bridge takes such a tree with numpy leaves (``jax.tree.map(np.asarray,
params)`` on the reference side; its paths are those of
``training/checkpoint.py::_flatten``) and copies every leaf into the
port's modules on a given device, layer by layer, in each parameter's
storage dtype.  ``collab_to_numpy`` goes the other way: the port's
parameters (or their f32 optimizer masters, or their gradients) as a tree
of the reference's layout, for leaf-by-leaf comparison.  It imports no
JAX: the caller does the ``np.asarray``.

The paper-scale ``init_paper_decomposition`` tree (``v/l{i}/{w,b}``,
``a``, ``raw_t``, ``u_net/...``) crosses with ``paper_from_numpy`` /
``paper_to_numpy``; ``training/checkpoint.py`` writes and reads both
layouts, optimizer moments included (``moments_to_numpy`` /
``load_moments``).  A model placed on a DeviceMesh dumps whole leaves,
one at a time: every rank joins each leaf's gather
(``distributed.sharding.whole``), and rank 0 alone keeps the leaf on the
host; the other ranks get empty leaves (``_host``).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.decomposition import CollabLM, PaperDecomposition
from repro_torch.distributed.sharding import (distribute_collab,
                                              is_dtensor, whole)


def _as_tensor(arr) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":  # ml_dtypes leaves of a bf16 tree
        a = a.astype(np.float32)   # exact
    return torch.from_numpy(np.array(a, order="C"))  # a writable copy


def _copy(p: torch.Tensor, src: torch.Tensor) -> None:
    p.copy_(src.to(p.device).to(p.dtype))


def _load(module: nn.Module, tree: Mapping[str, Any], path: str,
          put=_copy) -> None:
    """Walk ``tree`` against ``module``; ``put(param, src)`` takes each
    leaf (default: copy it into the parameter in its storage dtype)."""
    names = {n for n, _ in module.named_children()} | \
            {n for n, _ in module.named_parameters(recurse=False)}
    extra = set(tree) - names
    missing = names - set(tree)
    if extra or missing:
        raise ValueError(f"{path or 'root'}: tree has {sorted(extra)} the "
                         f"port lacks, lacks {sorted(missing)}")
    for key, sub in tree.items():
        child = getattr(module, key)
        where = f"{path}/{key}" if path else key
        if isinstance(child, nn.ModuleList):  # layers stacked on axis 0
            _load_stacked(child, sub, where, put)
        elif isinstance(child, nn.Module):
            _load(child, sub, where, put)
        else:
            src = _as_tensor(sub)
            if tuple(src.shape) != tuple(child.shape):
                raise ValueError(f"{where}: shape {tuple(src.shape)} != "
                                 f"port {tuple(child.shape)}")
            with torch.no_grad():
                put(child, src)


def _load_stacked(layers: nn.ModuleList, tree, where: str, put) -> None:
    if len(layers) == 0:  # zero layers: zero-length leaves of its shapes
        want, got = _shapes(layers), _map(tree, lambda a: np.shape(a))
        if got != want:
            raise ValueError(f"{where}: an empty stack has leaves {want}, "
                             f"the tree {got}")
        return
    for li, layer in enumerate(layers):
        sub = _index(tree, li, len(layers), where)
        if isinstance(layer, nn.ModuleList):  # a second stacked axis
            _load_stacked(layer, sub, f"{where}/{li}", put)
        else:
            _load(layer, sub, f"{where}/{li}", put)


def _index(tree, li: int, n: int, where: str):
    if isinstance(tree, Mapping):
        return {k: _index(v, li, n, f"{where}/{k}") for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.shape[0] != n:
        raise ValueError(f"{where}: {arr.shape[0]} stacked layers, port "
                         f"has {n}")
    return arr[li]


def collab_from_numpy(tree: Mapping[str, Any], cfg: ArchConfig,
                      device, device_mesh=None) -> CollabLM:
    """The reference's ``init_collab_lm`` tree -> ``CollabLM`` on ``device``;
    with a ``device_mesh``, every parameter then placed on it by the
    partition rules (``distributed.sharding.distribute_collab``: each rank
    keeps its block of the same whole leaves)."""
    model = CollabLM(cfg, device=device)
    _load(model, tree, "")
    if device_mesh is not None:
        distribute_collab(model, device_mesh)
    return model


def load_numpy(model: nn.Module, tree: Mapping[str, Any]) -> None:
    """Copy a reference tree into an existing module of the same layout,
    in place, each leaf in its parameter's storage dtype."""
    _load(model, tree, "")


def paper_from_numpy(tree: Mapping[str, Any], cfg, u_mode: str,
                     device) -> PaperDecomposition:
    """The reference's ``init_paper_decomposition`` tree (``cfg``: its
    ``PaperMLPConfig``) -> ``PaperDecomposition`` on ``device``; the cosine
    basis width and the independent net's widths are read off the tree."""
    n_modes, u_dims = 0, None
    if u_mode == "cosine":
        n_modes = int(np.asarray(tree["a"]).shape[0])
    if u_mode == "independent":
        ws = [np.asarray(tree["u_net"][f"l{i}"]["w"])
              for i in range(len(tree["u_net"]))]
        u_dims = tuple(w.shape[0] for w in ws) + (ws[-1].shape[1],)
    model = PaperDecomposition(cfg, u_mode=u_mode, u_dims=u_dims,
                               n_modes=n_modes, device=device)
    _load(model, tree, "")
    return model


def paper_to_numpy(model: PaperDecomposition) -> Dict[str, Any]:
    """``PaperDecomposition`` -> the reference's tree of f32 numpy leaves."""
    return _dump(model, lambda p: p.detach().float().cpu().numpy())


def _masters(model: CollabLM, state) -> Dict[int, torch.Tensor]:
    """id(parameter) -> its f32 master in an optimizer ``state`` made by
    ``opt.init(list(model.parameters()))``."""
    return {id(p): mw for p, mw in zip(model.parameters(), state.master)
            if mw is not None}


def load_masters(tree: Mapping[str, Any], model: CollabLM, state) -> None:
    """Copy the reference tree's f32 leaves into the f32 masters of an
    optimizer ``state``, so that a model loaded by ``collab_from_numpy``
    trains from the reference's exact f32 parameters (its stored weights
    are already their casts)."""
    masters = _masters(model, state)

    def put(p, src):
        if id(p) in masters:
            masters[id(p)].copy_(src.float())

    _load(model, tree, "", put)


def _dump(module: nn.Module, leaf) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, p in module.named_parameters(recurse=False):
        tree[key] = leaf(p)
    for key, child in module.named_children():
        tree[key] = _dump_stacked(child, leaf) \
            if isinstance(child, nn.ModuleList) else _dump(child, leaf)
    return tree


def _dump_stacked(layers: nn.ModuleList, leaf):
    """Layers stacked on axis 0 (a ``ModuleList`` of ``ModuleList``s on
    two axes).  A stack of no layers gives f32 leaves of length 0 in the
    reference's shapes."""
    if len(layers) == 0:
        return _map(_shapes(layers), lambda shape: np.zeros(shape,
                                                            np.float32))
    return _stack([_dump_stacked(layer, leaf)
                   if isinstance(layer, nn.ModuleList) else _dump(layer, leaf)
                   for layer in layers])


def _map(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _shapes(layers: nn.ModuleList):
    """The leaf shapes of a stack, from its layers or, for a stack of none
    (a ``LayerStack``), from a layer it builds on the meta device."""
    one = layers[0] if len(layers) else layers.make("meta")
    sub = _shapes(one) if isinstance(one, nn.ModuleList) \
        else _dump(one, lambda p: tuple(p.shape))
    return _map(sub, lambda shape: (len(layers),) + shape)


def _stack(layers):
    if isinstance(layers[0], dict):
        return {k: _stack([lay[k] for lay in layers]) for k in layers[0]}
    return np.stack(layers)


def _host(t: torch.Tensor) -> np.ndarray:
    """One leaf as f32 numpy.  A DTensor is gathered whole, which every
    rank joins; rank 0 keeps it and the other ranks get an empty array."""
    if is_dtensor(t):
        t = whole(t.detach())
        if torch.distributed.get_rank() != 0:
            return np.zeros((0,), np.float32)
    return t.detach().float().cpu().numpy()


def collab_to_numpy(model: CollabLM, state=None, *,
                    grads: bool = False) -> Dict[str, Any]:
    """``CollabLM`` -> the reference's ``init_collab_lm`` tree of f32 numpy
    leaves (layers stacked on axis 0).  With an optimizer ``state`` a
    parameter stored narrower than f32 is read from its f32 master; with
    ``grads=True`` the leaves are the parameters' gradients instead."""
    masters = {} if state is None else _masters(model, state)

    def leaf(p: torch.Tensor) -> np.ndarray:
        t: Optional[torch.Tensor] = p.grad if grads else masters.get(id(p), p)
        if t is None:
            raise ValueError("collab_to_numpy(grads=True) needs every "
                             "parameter's gradient")
        return _host(t)

    return _dump(model, leaf)


def _by_param(model: nn.Module, values) -> Dict[int, torch.Tensor]:
    """id(parameter) -> its entry of a list aligned with
    ``model.parameters()`` (an optimizer state's moments)."""
    return {id(p): t for p, t in zip(model.parameters(), values)}


def moments_to_numpy(model: nn.Module, state) -> Dict[str, Any]:
    """An optimizer ``state`` of ``model`` as the reference's ``AdamState``
    tree: ``{"count", "m", "v"}`` with ``m``/``v`` in the parameters'
    layout (``v`` is None for SGD, as in the reference)."""
    def tree(values):
        if values is None:
            return None
        by = _by_param(model, values)
        return _dump(model, lambda p: _host(by[id(p)]))

    return {"count": np.asarray(state.count, np.int32), "m": tree(state.m),
            "v": tree(state.v)}


def load_moments(tree: Mapping[str, Any], model: nn.Module, state) -> None:
    """Copy an ``AdamState`` tree (``moments_to_numpy``'s layout) into the
    optimizer ``state`` of ``model``, in place."""
    state.count = int(np.asarray(tree["count"]))
    for key in ("m", "v"):
        values = getattr(state, key)
        if values is None:
            continue
        by = _by_param(model, values)

        def put(p, src, by=by):
            by[id(p)].copy_(src.float())

        _load(model, tree[key], key, put)
