"""One rank of the expert-parallel MoE tests (tests/test_torch_moe_ep.py):
a gloo process group over ``tcp://localhost``, a (data, model)
DeviceMesh, this rank's block of the MoE cut by ``nn.moe.local_moe`` and
its data shard's tokens through ``moe_dispatch(impl="ep")``, forward and
backward.  Imports torch and the port only.

    python tests/_torch_ep_worker.py CASE.npz OUT_DIR RANK WORLD PORT
"""
import os
import sys

import numpy as np
import torch


def main(case, out_dir, rank, world, port):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import bridge
    from repro_torch.distributed import sharding as shd
    from repro_torch.nn import moe as tmoe

    z = np.load(case, allow_pickle=True)
    meta = z["meta"].item()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = init_device_mesh("cpu", tuple(meta["mesh"]),
                                mesh_dim_names=("data", "model"))
        coords = shd.mesh_coords(mesh)
        E, K, D, F = meta["E"], meta["K"], meta["D"], meta["F"]
        full = tmoe.MoE(D, F, E, n_shared=meta["n_shared"], device="cpu")
        tree = {k[2:]: z[k] for k in z.files if k.startswith("p/")}
        nested = {}
        for path, v in tree.items():
            node = nested
            *head, leaf = path.split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[leaf] = v
        bridge.load_numpy(full, nested)
        local = tmoe.local_moe(full, mesh)
        for prm in local.parameters():
            prm.requires_grad_(True)
        dshard = np.split(z["x"], meta["mesh"][0])[coords["data"]]
        cot = np.split(z["cot"], meta["mesh"][0])[coords["data"]]
        out = {"coords": np.asarray([coords["data"], coords["model"]])}
        for cf in meta["cfs"]:
            x = torch.tensor(dshard, requires_grad=True)
            with shd.use_mesh(mesh):
                y, aux = tmoe.moe_dispatch(
                    local, x, n_experts=E, top_k=K, capacity_factor=cf,
                    compute_dtype=torch.float32, impl="auto")
            (y * torch.as_tensor(cot)).sum().backward()
            out[f"{cf}/y"] = y.detach().numpy()
            out[f"{cf}/aux"] = aux.detach().numpy()
            out[f"{cf}/grad/x"] = x.grad.numpy()
            for name, prm in local.named_parameters():
                out[f"{cf}/grad/{name.replace('.', '/')}"] = \
                    prm.grad.numpy().copy()
                prm.grad = None
        for name, spec in shd.iter_paths(local.specs):
            out[f"spec/{name}"] = np.asarray(repr(spec))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
         int(sys.argv[5]))
