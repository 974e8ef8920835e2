"""One rank of the mesh serving tests (tests/test_torch_mesh_serve.py): a
gloo process group over ``tcp://localhost`` and, for each case of the
case file, a (data, model) DeviceMesh on which the case's arch takes
``T`` serve steps from an empty cache through the entry points a user
calls: ``bridge.collab_from_numpy(..., device_mesh=)``,
``models.api.init_cache(..., device_mesh=)`` (the server cache placed by
``cache_specs(mode=cfg.decode_cache_shard)``, the edge cache over the
data axes only), ``distribute_batch`` for the tokens and
``launch.steps.make_serve_step``.  Rank 0 writes the whole outputs of
every step and the whole caches after the last.  Then rank 0 alone, in a
process group of one, holds the serve step placed on a (1, 1) mesh to
the unplaced step, bit for bit.  Imports torch and the port only.

    python tests/_torch_mesh_serve_worker.py CASE_DIR RANK WORLD PORT PORT1
"""
import json
import os
import sys
import time

import numpy as np
import torch

THR_WAIT_S = 120


def nested(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, leaf = path.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = v
    return tree


def load(case_dir, name):
    z = np.load(os.path.join(case_dir, f"{name}.npz"))
    tree = nested({k[2:]: z[k] for k in z.files if k.startswith("p/")})
    return tree, z["tokens"], {k[6:]: z[k] for k in z.files
                               if k.startswith("cross/")}


def config(case):
    """The case's SMOKE config with its overrides, at the threshold the
    parent writes for its variant (a gap in the reference's u, margin
    0)."""
    from repro_torch.configs import registry
    thr_file = os.path.join(case["dir"], f"thr_{case['variant']}.npy")
    deadline = time.monotonic() + THR_WAIT_S
    while not os.path.exists(thr_file):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no threshold for {case['variant']}")
        time.sleep(0.05)
    cfg = registry.get_smoke(case["arch"]).replace(**case["overrides"])
    return cfg.replace(monitor=cfg.monitor.__class__(**{
        **cfg.monitor.__dict__, "threshold": float(np.load(thr_file)),
        "trigger_margin": 0.0}))


def caches(cfg, case, mesh, cross):
    """The server and edge caches, placed on ``mesh`` (or whole with
    None); a VLM's image K/V filled with the parent's rows."""
    from repro_torch.core.decomposition import edge_arch
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import api
    kw = {} if mesh is None else {"device_mesh": mesh}
    server = api.init_cache(cfg, case["B"], case["S"], "cpu", **kw)
    edge = api.init_cache(edge_arch(cfg), case["B"], case["S_edge"], "cpu",
                          **kw, **({} if mesh is None
                                   else {"use_model": False}))
    if cross:
        for leaf, name in zip(server["cross"], ("k", "v")):
            leaf = leaf.detach()
            whole = torch.as_tensor(cross[name])
            if shd.is_dtensor(leaf):
                spec = shd.spec_of(leaf.placements, leaf.dim(), mesh)
                whole = shd.local_shard(whole, spec, mesh,
                                        shd.mesh_coords(mesh))
                leaf = leaf.to_local()
            leaf.copy_(whole)
    return server, edge


def serve(case, mesh):
    """``T`` serve steps of the case on ``mesh`` (None: unplaced): the
    whole outputs of each step, the whole caches after the last."""
    from repro_torch import bridge
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    cfg = config(case)
    tree, tokens, cross = load(case["dir"], case["arch"])
    model = bridge.collab_from_numpy(tree, cfg, "cpu", device_mesh=mesh)
    server, edge = caches(cfg, case, mesh, cross)
    step = steps.make_serve_step(cfg)
    out = {}
    for t in range(case["T"]):
        tok = torch.as_tensor(tokens[:, t])
        if mesh is not None:
            tok = shd.distribute_batch({"t": tok}, mesh)["t"]
        got = step(model, server, edge, tok, t)
        for k in ("logits", "u", "fhat", "mask"):
            out[f"s{t}/{k}"] = shd.whole(got[k])
    for key, cache in (("server", server), ("edge", edge)):
        for path, leaf in shd.iter_paths(cache):
            out[f"{key}/{path}"] = shd.whole(leaf)
    return out


def bitwise(case_dir, cases):
    """Rank 0 in a group of one: each case's serve step placed on a (1, 1)
    mesh against the unplaced step, bit for bit."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data",
                                                            "model"))
    res = {}
    for name, case in cases.items():
        t0 = time.perf_counter()
        placed = serve(case, mesh)
        plain = serve(case, None)
        res[name] = {"equal": all(torch.equal(placed[k], plain[k])
                                  for k in plain),
                     "keys": len(plain), "seconds":
                     time.perf_counter() - t0}
    with open(os.path.join(case_dir, "bitwise.json"), "w") as fh:
        json.dump(res, fh)


def main(case_dir, rank, world, port, port1):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    with open(os.path.join(case_dir, "case.json")) as fh:
        spec = json.load(fh)
    for case in (*spec["cases"].values(), *spec["bitwise"].values()):
        case["dir"] = case_dir
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        meshes = {}
        for name, case in spec["cases"].items():
            t0 = time.perf_counter()
            shape = tuple(case["mesh"])
            if shape not in meshes:
                meshes[shape] = init_device_mesh(
                    "cpu", shape, mesh_dim_names=("data", "model"))
            out = serve(case, meshes[shape])
            if rank == 0:
                out = {k: v.float().numpy() for k, v in out.items()}
                out["seconds"] = time.perf_counter() - t0
                np.savez(os.path.join(case_dir, f"out_{name}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        dist.init_process_group("gloo",
                                init_method=f"tcp://localhost:{port1}",
                                world_size=1, rank=0)
        try:
            bitwise(case_dir, spec["bitwise"])
        finally:
            dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], *(int(a) for a in sys.argv[2:6]))
