"""One rank of the mesh training tests (tests/test_torch_mesh_train.py):
a gloo process group over ``tcp://localhost`` and, for each mesh of the
case, one (data, model) DeviceMesh on which every arch of that mesh
takes three train steps from the case's weights through the entry
points a user calls (``bridge.collab_from_numpy(..., device_mesh=)``,
``AdamW.init(..., placements=)``, ``launch.steps``); each arch's placed
init (``init_collab_lm(..., device_mesh=)``) is also held block for
block to the unplaced init placed after.  Then, on the case's prefill
mesh, the prefill step of every arch, at the threshold the parent writes
(``thr_{arch}.npy``).  Rank 0 writes the whole values.  Imports torch
and the port only.

    python tests/_torch_mesh_worker.py CASE_DIR RANK WORLD PORT

A mesh is named ``data,model`` with a trailing ``z`` for ZeRO-1
(``4,1z``).
"""
import json
import os
import sys
import time

import numpy as np
import torch

THR_WAIT_S = 180


def nested(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, leaf = path.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = v
    return tree


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def placed_init_equal(cfg, mesh) -> bool:
    """The placed init's blocks are those of the unplaced init placed
    after, bit for bit, on every rank."""
    from repro_torch.core.decomposition import init_collab_lm
    from repro_torch.distributed import sharding as shd
    placed = init_collab_lm(cfg, torch.Generator().manual_seed(1), "cpu",
                            device_mesh=mesh)
    ref = init_collab_lm(cfg, torch.Generator().manual_seed(1), "cpu")
    shd.distribute_collab(ref, mesh)
    want = dict(ref.named_parameters())
    return all(p.placements == want[n].placements
               and torch.equal(p.to_local(), want[n].to_local())
               for n, p in placed.named_parameters())


def train(case_dir, arch, cfg, mesh, lr):
    """Three train steps on the placed model: their metrics and the whole
    parameters after."""
    from repro_torch import bridge
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.training.loop import to_device, trainable
    from repro_torch.training.optimizer import AdamW, keeps_masters
    from repro_torch.training.schedule import warmup_cosine
    z = np.load(os.path.join(case_dir, f"{arch}.npz"))
    tree = nested({k[2:]: z[k] for k in z.files if k.startswith("p/")})
    batches = [{k.split("/", 1)[1]: z[k] for k in z.files
                if k.startswith(f"b{i}/")} for i in range(3)]
    model = bridge.collab_from_numpy(tree, cfg, "cpu", device_mesh=mesh)
    opt = AdamW(lr=warmup_cosine(lr, 2, 10))
    state = opt.init(trainable(model), masters=keeps_masters(cfg),
                     placements=shd.opt_placements(model, mesh,
                                                   zero1=cfg.zero1))
    step = steps.make_train_step(cfg, opt)
    out = {}
    for i, b in enumerate(batches):
        m = step(model, state, shd.distribute_batch(to_device(b, "cpu"),
                                                    mesh))
        for k, v in m.items():
            out[f"step{i}/{k}"] = float(v)
    for path, v in flat(bridge.collab_to_numpy(model, state)).items():
        out[f"p/{path}"] = v
    return out


def prefill(case_dir, arch, cfg, mesh):
    """The prefill step on the placed model at the parent's threshold (a
    gap in the reference's u, clear of ties)."""
    from repro_torch import bridge
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.training.loop import to_device
    thr_file = os.path.join(case_dir, f"thr_{arch}.npy")
    deadline = time.monotonic() + THR_WAIT_S
    while not os.path.exists(thr_file):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no threshold for {arch}")
        time.sleep(0.05)
    pcfg = cfg.replace(monitor=cfg.monitor.__class__(**{
        **cfg.monitor.__dict__, "threshold": float(np.load(thr_file)),
        "trigger_margin": 0.0}))
    z = np.load(os.path.join(case_dir, f"{arch}.npz"))
    tree = nested({k[2:]: z[k] for k in z.files if k.startswith("p/")})
    model = bridge.collab_from_numpy(tree, pcfg, "cpu", device_mesh=mesh)
    pre = {k.split("/", 1)[1]: z[k] for k in z.files
           if k.startswith("pre/")}
    got = steps.make_prefill_step(pcfg)(
        model, shd.distribute_batch(to_device(pre, "cpu"), mesh))
    return {f"prefill/{k}": shd.whole(v).float().numpy()
            for k, v in got.items()}


def main(case_dir, rank, world, port):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import registry

    with open(os.path.join(case_dir, "case.json")) as fh:
        case = json.load(fh)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)

    def save(name, out):
        if rank == 0:
            np.savez(os.path.join(case_dir, f"{name}.npz"), **out)

    try:
        meshes = {}
        for mesh_arg, archs in case["meshes"].items():
            shape = tuple(int(x) for x in mesh_arg.rstrip("z").split(","))
            mesh = meshes[mesh_arg] = init_device_mesh(
                "cpu", shape, mesh_dim_names=("data", "model"))
            for arch in archs:
                t0 = time.perf_counter()
                cfg = registry.get_smoke(arch).replace(
                    zero1=mesh_arg.endswith("z"),
                    **case["overrides"].get(arch, {}))
                out = train(case_dir, arch, cfg, mesh, case["lr"])
                out["placed_init_equal"] = placed_init_equal(cfg, mesh)
                out["seconds"] = time.perf_counter() - t0
                save(f"out_{mesh_arg}_{arch}", out)
        mesh = meshes[case["prefill"]]
        for arch in case["meshes"][case["prefill"]]:
            cfg = registry.get_smoke(arch).replace(
                **case["overrides"].get(arch, {}))
            save(f"out_prefill_{arch}", prefill(case_dir, arch, cfg, mesh))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
