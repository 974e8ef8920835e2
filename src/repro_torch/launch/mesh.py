"""Production meshes (the reference's ``launch/mesh.py``, TPU v5e pods).

Functions, not module constants: importing this module touches no device.
A mesh here is ``distributed.sharding.Mesh``: axis names, sizes and the
CUDA devices of its positions.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.distributed.sharding import Mesh


def _cards() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(data=16, model=16) over the first 256 cards, or (pod=2, data=16,
    model=16) over 512; a ValueError naming both counts on a host with
    fewer."""
    if multi_pod:
        shape, axes, what = (2, 16, 16), ("pod", "data", "model"), \
            "multi-pod"
    else:
        shape, axes, what = (16, 16), ("data", "model"), "production"
    n, have = math.prod(shape), _cards()
    if have < n:
        raise ValueError(f"the {what} mesh {dict(zip(axes, shape))} needs "
                         f"{n} devices, this host has {have}")
    return Mesh(axes, shape, tuple(torch.device("cuda", i)
                                   for i in range(n)))


def make_host_mesh(model: int = 1,
                   devices: Optional[Sequence] = None) -> Mesh:
    """(data, model) over ``devices`` (default: every card of the host),
    data = their count // model."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(_cards())]
    n = len(devices)
    if n == 0 or n % model:
        raise ValueError(f"a host mesh with model={model} needs a positive "
                         f"multiple of {model} devices, got {n}")
    return Mesh(("data", "model"), (n // model, model),
                tuple(torch.device(d) for d in devices))
