"""Production meshes (the reference's ``launch/mesh.py``, TPU v5e pods).

Functions, not module constants: importing this module touches no device.
A mesh here is ``distributed.sharding.Mesh``: axis names, sizes and the
CUDA devices of its positions.  ``device_mesh`` makes the
``torch.distributed`` DeviceMesh a step across it runs on.
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


BACKENDS = ("nccl", "gloo", "fake")


def device_mesh(mesh: Mesh, backend: str = "nccl"):
    """A ``torch.distributed.device_mesh.DeviceMesh`` with the dims (and
    sizes) of ``mesh``, named as its axes (``pod``/``data``/``model``), over
    a default process group of ``mesh.size`` ranks.

    ``nccl`` (CUDA tensors) and ``gloo`` (CPU tensors) join the process
    group ``torchrun``'s environment describes (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) unless one is up already.  ``fake``
    is the dry run's: a fake group of ``mesh.size`` ranks in this one
    process, rank 0, whose collectives move nothing.  Its device type is
    CUDA where PyTorch is built with CUDA, else the CPU (DTensor's
    vocab-split lookup writes a scalar on the mesh's device, which a
    CPU-only PyTorch cannot make for CUDA); under ``FakeTensorMode`` the
    ops and their counts are the same either way, and no card is needed.
    The fake group must be the process's default group, so a process runs
    one world size.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if not dist.is_initialized():
        if backend == "fake":
            from torch.testing._internal.distributed.fake_pg import FakeStore
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=mesh.size)
        else:
            dist.init_process_group(backend, init_method="env://")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"mesh {mesh.shape} needs {mesh.size} ranks, the "
                         f"process group has {dist.get_world_size()}")
    device_type = "cpu" if backend == "gloo" else "cuda"
    if backend == "fake" and not torch.backends.cuda.is_built():
        device_type = "cpu"
    if backend == "nccl":
        torch.cuda.set_device(dist.get_rank() % max(_cards(), 1))
    return init_device_mesh(device_type, mesh.axis_sizes,
                            mesh_dim_names=mesh.axis_names)


def abstract_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh's axes and sizes with no devices (the dry run's
    mesh: it places nothing on a card)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))
