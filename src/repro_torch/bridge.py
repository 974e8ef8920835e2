"""Carry the JAX package's weights into the port.

The reference keeps parameters as nested dicts with layers stacked on a
leading axis (``blocks/attn/wq/w`` of shape (n_layers, d, Hq*D)).  The
bridge takes such a tree with numpy leaves (``jax.tree.map(np.asarray,
params)`` on the reference side; its paths are those of
``training/checkpoint.py::_flatten``) and copies every leaf into the
port's modules on a given device, layer by layer, in each parameter's
storage dtype.  It imports no JAX: the caller does the ``np.asarray``.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.decomposition import CollabLM


def _as_tensor(arr) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":  # ml_dtypes leaves of a bf16 tree
        a = a.astype(np.float32)   # exact
    return torch.from_numpy(np.array(a, order="C"))  # a writable copy


def _load(module: nn.Module, tree: Mapping[str, Any], path: str) -> None:
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
            for li, layer in enumerate(child):
                _load(layer, _index(sub, li, len(child), where), f"{where}/{li}")
        elif isinstance(child, nn.Module):
            _load(child, sub, where)
        else:
            src = _as_tensor(sub)
            if tuple(src.shape) != tuple(child.shape):
                raise ValueError(f"{where}: shape {tuple(src.shape)} != "
                                 f"port {tuple(child.shape)}")
            with torch.no_grad():
                child.copy_(src.to(child.device).to(child.dtype))


def _index(tree, li: int, n: int, where: str):
    if isinstance(tree, Mapping):
        return {k: _index(v, li, n, f"{where}/{k}") for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.shape[0] != n:
        raise ValueError(f"{where}: {arr.shape[0]} stacked layers, port "
                         f"has {n}")
    return arr[li]


def collab_from_numpy(tree: Mapping[str, Any], cfg: ArchConfig,
                      device) -> CollabLM:
    """The reference's ``init_collab_lm`` tree -> ``CollabLM`` on ``device``."""
    model = CollabLM(cfg, device=device)
    _load(model, tree, "")
    return model
