"""Training launcher (``launch/train.py``).

Trains the collaborative LM with AdamW under ``warmup_cosine`` through
``launch/steps.py::make_train_step``, logs every 10 steps, and writes
checkpoints in the JAX package's layout (``training/checkpoint.py``).
The port trains on one device: ``--mesh host`` (the default) is the
host mesh over that device.  The production meshes (``--mesh
production|multipod``, ``launch/mesh.py``) need 256 and 512 devices and
raise a ValueError naming both counts on a smaller host; a train step
across a ``DeviceMesh`` is ROADMAP queue 1, item 9.  On the card, dense
archs reach the ``flash_attention`` kernel and the hybrid also
``ssd_scan``, through ``collab_forward``.

Run (the host, reduced):
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
        --smoke --steps 50 --device cpu
Without ``--device`` it trains on the card (and fails without one).
"""
from __future__ import annotations

import argparse
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
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    if args.mesh != "host":
        # a host with fewer devices ends here, as the reference's does
        make_production_mesh(multi_pod=args.mesh == "multipod")
        from repro_torch.serving.api import _later
        raise _later(f"a train step across the {args.mesh} mesh",
                     "9 (dry run + mesh training)")

    from repro_torch.core.decomposition import init_collab_lm
    from repro_torch.nn.module import resolve_device
    from repro_torch.training.loop import to_device, trainable

    dev = resolve_device(args.device)
    cfg = (registry.get_smoke(args.arch) if args.smoke
           else registry.get_full(args.arch))
    # the reference's host mesh over this process's one device
    mesh = make_host_mesh(model=1, devices=[dev])
    print(f"mesh {mesh.shape}  arch {cfg.name}  "
          f"batch {args.batch} x seq {args.seq}")

    opt = AdamW(lr=warmup_cosine(args.lr, 100, max(args.steps, 1000)))
    step_fn = make_train_step(cfg, opt)
    model = init_collab_lm(cfg, torch.Generator(dev).manual_seed(0), dev)
    opt_state = opt.init(trainable(model), masters=keeps_masters(cfg))

    batches = tok.lm_batches(0, cfg, args.batch, args.seq)
    t0 = time.time()
    for i in range(args.steps):
        metrics = step_fn(model, opt_state, to_device(next(batches), dev))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:5d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)", flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, i + 1, model, opt_state,
                      meta={"arch": cfg.name})
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, model, opt_state,
                  meta={"arch": cfg.name})
        print(f"checkpoint -> {args.ckpt_dir}")


if __name__ == "__main__":
    main()
