"""Training launcher (``launch/train.py``).

Trains the collaborative LM with AdamW under ``warmup_cosine`` through
``launch/steps.py::make_train_step``, logs every 10 steps, and writes
checkpoints in the JAX package's layout (``training/checkpoint.py``).

Without ``torchrun``'s environment it trains on one device: ``--mesh
host`` (the default) is the host mesh over that device.  Under
``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) every rank joins one process group (NCCL on the cards,
gloo with ``--device cpu``) and trains the same step on a DeviceMesh:
``--mesh host`` is (data = world size, model = 1), ``--mesh
production|multipod`` the (16, 16) and (2, 16, 16) meshes, which need a
world of 256 and 512 ranks and raise a ValueError naming both counts on
a smaller one (``launch/mesh.py``).  The parameters, optimizer moments
(``opt_specs(zero1=cfg.zero1)``) and batch are DTensors placed by the
partition rules.  Each rank draws the weights the unplaced init would
and keeps its blocks as they are drawn, so a card holds its blocks and
one whole leaf at a time (``core.decomposition.init_collab_lm(...,
device_mesh=)``); rank 0 logs and writes the checkpoint, whole, gathered
leaf by leaf (``training/checkpoint.py``).  On the
card, dense archs reach the ``flash_attention`` kernel and the hybrid
also ``ssd_scan``, through ``collab_forward``.

Run (the host, reduced):
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
        --smoke --steps 50 --device cpu
Run (two CPU ranks):
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch granite-8b --smoke --steps 2 --batch 2 --device cpu
Without ``--device`` it trains on the card (and fails without one).
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.configs import registry
from repro_torch.data import tokens as tok
from repro_torch.launch.steps import make_train_step
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import AdamW, keeps_masters
from repro_torch.training.schedule import warmup_cosine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.names())
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--mesh", default="host",
                    choices=["host", "production", "multipod"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=500)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "on the host)")
    args = ap.parse_args(argv)
    from repro_torch.core.decomposition import init_collab_lm
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.launch.mesh import (abstract_production_mesh,
                                         device_mesh, make_host_mesh,
                                         make_production_mesh)
    from repro_torch.nn.module import resolve_device
    from repro_torch.training.loop import to_device, trainable

    world = int(os.environ.get("WORLD_SIZE", "0")) if "RANK" in \
        os.environ else 0
    if not world and args.mesh != "host":
        # a host with fewer devices ends here, as the reference's does
        make_production_mesh(multi_pod=args.mesh == "multipod")
    cfg = (registry.get_smoke(args.arch) if args.smoke
           else registry.get_full(args.arch))
    dmesh = None
    if world:
        mesh = (Mesh(("data", "model"), (world, 1)) if args.mesh == "host"
                else abstract_production_mesh(
                    multi_pod=args.mesh == "multipod"))
        if mesh.size != world:
            raise ValueError(f"the {args.mesh} mesh {mesh.shape} needs "
                             f"{mesh.size} devices, this world has {world}")
        cpu = args.device is not None and \
            torch.device(args.device).type == "cpu"
        dev = torch.device("cpu") if cpu else resolve_device(
            f"cuda:{os.environ.get('LOCAL_RANK', '0')}")
        dmesh = device_mesh(mesh, backend="gloo" if cpu else "nccl")
    else:
        dev = resolve_device(args.device)
        # the reference's host mesh over this process's one device
        mesh = make_host_mesh(model=1, devices=[dev])
    lead = dmesh is None or torch.distributed.get_rank() == 0
    log = print if lead else (lambda *a, **k: None)
    log(f"mesh {mesh.shape}  arch {cfg.name}  "
        f"batch {args.batch} x seq {args.seq}")

    opt = AdamW(lr=warmup_cosine(args.lr, 100, max(args.steps, 1000)))
    step_fn = make_train_step(cfg, opt)
    # every rank draws the same weights and batches; on a mesh it keeps
    # its blocks, one whole leaf at a time on its device
    model = init_collab_lm(cfg, torch.Generator(dev).manual_seed(0), dev,
                           device_mesh=dmesh)
    placements = None
    if dmesh is not None:
        placements = shd.opt_placements(model, dmesh, zero1=cfg.zero1)
    opt_state = opt.init(trainable(model), masters=keeps_masters(cfg),
                         placements=placements)

    batches = tok.lm_batches(0, cfg, args.batch, args.seq)
    t0 = time.time()
    try:
        for i in range(args.steps):
            batch = to_device(next(batches), dev)
            if dmesh is not None:
                batch = shd.distribute_batch(batch, dmesh)
            metrics = step_fn(model, opt_state, batch)
            if i % 10 == 0 or i == args.steps - 1:
                log(f"step {i:5d}  loss {float(metrics['loss']):.4f}  "
                    f"gnorm {float(metrics['grad_norm']):.3f}  "
                    f"({(time.time()-t0)/(i+1):.2f}s/step)", flush=True)
            if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
                ckpt.save(args.ckpt_dir, i + 1, model, opt_state,
                          meta={"arch": cfg.name})
        if args.ckpt_dir:
            ckpt.save(args.ckpt_dir, args.steps, model, opt_state,
                      meta={"arch": cfg.name})
            log(f"checkpoint -> {args.ckpt_dir}")
    finally:
        if dmesh is not None:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
