"""Checkpoints in the JAX package's layout (``training/checkpoint.py``),
written and read without JAX, so that one crosses frameworks both ways.

A checkpoint is a directory: ``params.npz`` and ``opt.npz`` hold one array
per leaf, keyed by the string ``jax.tree_util.keystr`` gives its path
(``['server']['blocks']['attn']['wq']['w']`` for the nested dicts of the
parameters; ``.count``, ``.m['...']`` and ``.v['...']`` for the fields of
the reference's ``AdamState``), and ``manifest.json`` holds
``{"step", "meta"}``.  Leaves are in the reference's tree layout (layers
stacked on a leading axis) through ``repro_torch.bridge``.

Both the collaborative LM (``CollabLM``) and the paper-scale
``PaperDecomposition`` are covered.  A parameter that the port stores
narrower than f32 is written from its f32 optimizer master when a state
is given, so that the reference restores its exact f32 parameters; on
load the master takes the f32 leaf and the stored weight its cast.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
from torch import nn

from repro_torch import bridge
from repro_torch.core.decomposition import CollabLM

_KEY = re.compile(r"\['([^']*)'\]")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts -> {keystr: leaf}; dict keys render as ``['key']``."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}['{k}']"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        parts = _KEY.findall(key)
        if "".join(f"['{p}']" for p in parts) != key:
            raise ValueError(f"not a dict key path: {key!r}")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def _params_tree(model: nn.Module, opt_state) -> Dict[str, Any]:
    if isinstance(model, CollabLM):
        return bridge.collab_to_numpy(model, opt_state)
    return bridge.paper_to_numpy(model)


def save(path: str, step: int, model: nn.Module, opt_state=None,
         meta: Optional[Dict] = None) -> None:
    """Write ``model`` (and ``opt_state``, made by ``opt.init`` from
    ``model.parameters()``) as a checkpoint the reference's ``load``
    reads."""
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "params.npz"),
             **_flatten(_params_tree(model, opt_state)))
    if opt_state is not None:
        st = bridge.moments_to_numpy(model, opt_state)
        flat = {".count": st["count"]}
        for key in ("m", "v"):
            if st[key] is not None:
                flat.update(_flatten(st[key], f".{key}"))
        np.savez(os.path.join(path, "opt.npz"), **flat)
    with open(os.path.join(path, "manifest.json"), "w") as fh:
        json.dump({"step": int(step), "meta": meta or {}}, fh)


def _opt_tree(npz) -> Dict[str, Any]:
    tree: Dict[str, Any] = {"count": npz[".count"]}
    for key in ("m", "v"):
        pre = f".{key}"
        sub = {k[len(pre):]: npz[k] for k in npz.files if k.startswith(pre)}
        tree[key] = _unflatten(sub) if sub else None
    return tree


def load(path: str, model: nn.Module, opt_state=None) -> Tuple[int, Dict]:
    """Read a checkpoint (the reference's or the port's) into ``model`` and,
    when given and present, into ``opt_state``, in place.  Returns (step,
    meta).  Every leaf must be there with the module's shape."""
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    with np.load(os.path.join(path, "params.npz")) as npz:
        tree = _unflatten({k: npz[k] for k in npz.files})
    bridge.load_numpy(model, tree)
    if opt_state is not None:
        bridge.load_masters(tree, model, opt_state)
    opt_file = os.path.join(path, "opt.npz")
    if opt_state is not None and os.path.exists(opt_file):
        with np.load(opt_file) as npz:
            bridge.load_moments(_opt_tree(npz), model, opt_state)
    return manifest["step"], manifest.get("meta", {})
