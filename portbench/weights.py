"""Seeded weights, drawn on the device a layer at a time.

Each draw group (``spec.group_of``: one layer, or one embedding, norm or
head) gets its own ``torch.Generator`` on the device, seeded from the
run's seed and the group's name, and one ``randn`` over all its random
leaves in name order; each leaf takes its slice, scaled to the port's
initial distribution (normal 1/sqrt(fan-in) projections and convs,
normal 0.02 embeddings, normal 0.1 monitor coefficients; ones, zeros and
the Mamba2 constants elsewhere) and rounded to the dtype it is served
in.  So the program's model and the reference, which draws a layer again
when it needs it, hold the same numbers, and the reference never keeps a
second copy of the whole model.  Imports nothing of the program."""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List

import torch

from portbench import spec

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def group_seed(seed: int, group: str) -> int:
    h = hashlib.sha256(f"{int(seed)}/{group}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def _inv_softplus(y: float) -> float:
    return math.log(math.expm1(y)) if y < 20 else y


def init_rule(name: str, shape, p: dict):
    """("normal", std) or ("const", tensor maker) for a leaf."""
    tail = name.split(".")[-1]
    if tail in ("scale", "norm_scale", "D"):
        return ("const", lambda dev: torch.ones(shape, device=dev))
    if tail in ("b", "dt_bias"):
        return ("const", lambda dev: torch.zeros(shape, device=dev))
    if tail == "A_log":
        return ("const", lambda dev: torch.log(
            torch.linspace(1.0, 16.0, shape[0], device=dev)))
    if tail == "raw_t":
        t = _inv_softplus(p["monitor"].get("t_init", 0.1))
        return ("const", lambda dev: torch.full(shape, t, device=dev))
    if name == "u_head.a":
        return ("normal", 0.1)
    if tail == "table":
        return ("normal", 0.02)
    if tail == "w":
        return ("normal", 1.0 / math.sqrt(shape[0]))
    raise ValueError(f"no initial distribution for {name}")


def draw_group(seed: int, group: str, leaves: List[spec.Leaf], p: dict,
               device) -> Dict[str, torch.Tensor]:
    """name -> tensor in its served dtype, on ``device``."""
    rules = [(leaf, init_rule(leaf[0], leaf[1], p)) for leaf in leaves]
    normal = [(leaf, r[1]) for leaf, r in rules if r[0] == "normal"]
    total = sum(spec.numel(leaf[1]) for leaf, _ in normal)
    flat = None
    if total:
        gen = torch.Generator(device=device)
        gen.manual_seed(group_seed(seed, group))
        flat = torch.randn(total, generator=gen, device=device,
                           dtype=torch.float32)
    out, off = {}, 0
    stds = dict((leaf[0], std) for leaf, std in normal)
    for (name, shape, dt), r in rules:
        if r[0] == "normal":
            n = spec.numel(shape)
            t = flat[off:off + n].view(shape) * stds[name]
            off += n
        else:
            t = r[1](device)
        out[name] = t.to(DTYPES[dt])
    return out


def fill(named_params, seed: int, p: dict) -> int:
    """Write the seeded weights into a model's parameters (``(name,
    tensor)`` pairs, e.g. ``model.named_parameters()``), group by group on
    each parameter's device.  Raises unless names, shapes and dtypes are
    exactly the spec's.  Returns the number of elements written."""
    params = dict(named_params)
    want = spec.leaves(p)
    names = [n for n, _, _ in want]
    if sorted(names) != sorted(params):
        missing = sorted(set(names) - set(params))
        extra = sorted(set(params) - set(names))
        raise ValueError(f"model leaves differ from the spec: missing "
                         f"{missing[:5]}, extra {extra[:5]}")
    n = 0
    with torch.no_grad():
        for group, leaves in spec.groups(p).items():
            dev = params[leaves[0][0]].device
            vals = draw_group(seed, group, leaves, p, dev)
            for name, shape, dt in leaves:
                dst = params[name]
                if tuple(dst.shape) != tuple(shape) or dst.dtype != DTYPES[dt]:
                    raise ValueError(f"{name}: model has {tuple(dst.shape)} "
                                     f"{dst.dtype}, spec {shape} {dt}")
                dst.copy_(vals[name])
                n += dst.numel()
            del vals
    return n
