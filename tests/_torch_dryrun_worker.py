"""The dry run's mesh checks on a fake process group of 8 ranks
(tests/test_torch_dryrun.py), as one process: the fake group must be the
default group.  Imports torch and the port only; prints one JSON line.

    python tests/_torch_dryrun_worker.py
"""
import json

import torch


def placements_match_local_shard():
    """distribute_tensor under ``placements(spec)`` gives every rank the
    block ``local_shard`` cuts, on a (data 2, model 4) and a (pod 2, data
    2, model 2) mesh; returns the blocks compared."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.distributed import sharding as shd
    whole = torch.arange(8 * 8 * 4, dtype=torch.float32).reshape(8, 8, 4)
    cases = [((2, 4), ("data", "model"),
              [(None, "model"), ("model", None), ("data", "model"),
               (None, None, "model"), ("model", "data"), ()]),
             ((2, 2, 2), ("pod", "data", "model"),
              [(("pod", "data"), "model"), ("model", ("pod", "data")),
               (None, ("data", "model")), ("pod",)])]
    n = 0
    from repro_torch.configs import registry
    from repro_torch.models import api as model_api
    cfg = registry.get_smoke("zamba2-7b")
    for rank in range(8):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=8)
        try:
            # a decode cache placed from the whole one, and one allocated
            # block by block: each rank's block is local_shard's
            dm = init_device_mesh("cpu", (4, 2),
                                  mesh_dim_names=("data", "model"))
            gen = torch.Generator().manual_seed(0)
            full = model_api.init_cache(cfg, 8, 16, "cpu")
            for leaf in shd.tree_leaves_of(full):
                leaf.normal_(generator=gen)
            placed = shd.distribute_cache(full, dm, 8)
            alloc = model_api.init_cache(cfg, 8, 16, "cpu", device_mesh=dm)
            coords = shd.mesh_coords(dm)
            for w, p, a in zip(*(shd.tree_leaves_of(t)
                                 for t in (full, placed, alloc))):
                spec = shd.spec_of(p.placements, p.dim(), dm)
                assert torch.equal(p.to_local(),
                                   shd.local_shard(w, spec, dm, coords))
                assert a.placements == p.placements
                assert a.to_local().shape == p.to_local().shape
                n += 1
            for sizes, names, specs in cases:
                dm = init_device_mesh("cpu", sizes, mesh_dim_names=names)
                coords = shd.mesh_coords(dm)
                for spec in specs:
                    got = distribute_tensor(
                        whole, dm, shd.placements(spec, dm),
                        src_data_rank=None).to_local()
                    want = shd.local_shard(whole, spec, dm, coords)
                    assert torch.equal(got, want), (rank, names, spec)
                    n += 1
        finally:
            dist.destroy_process_group()
    return n


def main():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES_BY_NAME
    from repro_torch.core.decomposition import edge_arch
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.launch import dryrun, layer_costs as lc, roofline as rf
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models import api as model_api
    from repro_torch.training.optimizer import keeps_masters
    out = {"blocks": placements_match_local_shard()}
    mesh = Mesh(("data", "model"), (4, 2))
    dm = device_mesh(mesh, backend="fake")
    shape = SHAPES_BY_NAME["train_4k"]

    # a column-split product counts half of the whole one at model 2
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(64, 32), dm,
                               [Replicate(), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(32, 8), dm,
                               [Replicate(), Shard(1)], run_check=False,
                               shape=(32, 16), stride=(16, 1))
        c = dryrun.CostCounter()
        with c:
            y = x @ w
        out["split_flops"] = [c.counts()["flops"], 2 * 64 * 32 * 16,
                              tuple(y.to_local().shape)]

    # the probes' extrapolation against a direct count of the whole depth
    cfg = registry.get_smoke("zamba2-7b")
    direct = dryrun.count_step(cfg, shape, dm)
    full_counts, probes = lc.probe_plan(cfg)
    pc = {name: rf.cost_dict(dryrun.count_step(lc.with_counts(cfg, k),
                                               shape, dm))
          for name, k in probes}
    out["direct"] = rf.cost_dict(direct)
    out["extrapolated"] = lc.extrapolate(full_counts, pc)
    out["groups"] = full_counts
    out["kernels"] = direct["kernels"]

    # argument bytes: the local blocks, computed here from the rules
    with FakeTensorMode():
        model = steps.placed_shapes(cfg, dm)
    coords = shd.mesh_coords(dm)
    specs = shd.named_specs(model, dm)
    from repro_torch.core.decomposition import CollabLM
    ref = CollabLM(cfg, device="meta")
    want = 0
    for name, p in ref.named_parameters():
        blk = shd.local_shard(p, specs[name], dm, coords)
        moments = 2 * 4 * blk.numel()
        master = 4 * blk.numel() if keeps_masters(cfg) and \
            p.dtype != torch.float32 else 0
        want += blk.numel() * blk.element_size() + moments + master
    B, S = shape.global_batch // 4, shape.seq_len
    want += B * S * 4 * 3     # tokens, labels (int32), monitor_target f32
    out["arg_bytes"] = [direct["arg_bytes"], want]

    # model-axis collectives in the train step at model 2
    out["model_group_bytes"] = direct["by_group"].get(
        dm.get_group("model").group_name, 0)
    out["data_group_bytes"] = direct["by_group"].get(
        dm.get_group("data").group_name, 0)

    # the monitor step: the rules keep the edge tower and the heads whole
    # on every rank, so each rank runs it on its own rows from its local
    # blocks with no collective
    gcfg = registry.get_smoke("granite-8b")
    with FakeTensorMode():
        model = steps.placed_shapes(gcfg, dm)
        edge = [(n, p) for n, p in model.named_parameters()
                if n.split(".")[0] in ("edge", "u_head", "v_head")]
        out["edge_replicated"] = all(
            all(pl.is_replicate() for pl in p.placements) for _, p in edge)
        for n, p in edge:
            shd.set_param(model, n, torch.nn.Parameter(
                p.to_local(), requires_grad=False))
        ecache = model_api.init_cache(edge_arch(gcfg), 2, 16, "cpu")
        tok = torch.zeros(2, dtype=torch.int32)
        c = dryrun.CostCounter()
        with c:
            r = steps.make_monitor_step(gcfg)(model, ecache, tok, 3)
        out["monitor"] = {"namespaces": c.counts()["namespaces"],
                          "collectives": c.counts()["collectives"],
                          "u_shape": list(r["u"].shape)}
    out.update(decode_checks(dm))
    print(json.dumps(out))


def decode_checks(dm):
    """The decode kind of ``step_and_specs`` on the (4, 2) mesh for the
    archs the reference's dry-run test compiles (SMOKE, B 8, a 64-token
    cache), counted; and the monitor step on a placed model with an edge
    cache over the data axes only (``init_cache(..., use_model=False)``),
    its tokens split over data."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.decomposition import edge_arch
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import api as model_api
    shape = ShapeConfig("d", 64, 8, "decode")
    out = {"decode": {}}
    for arch in ("granite-8b", "deepseek-v3-671b", "zamba2-7b"):
        cfg = registry.get_smoke(arch)
        c = dryrun.count_step(cfg, shape, dm)
        with FakeTensorMode(allow_non_fake_inputs=True):
            _, args = steps.step_and_specs(cfg, shape, dm)
        server = args[1]
        out["decode"][arch] = {
            "kernels": {k: v["calls"] for k, v in c["kernels"].items()},
            "combine_flops": c["kernels"]["monitor_combine"]["flops"],
            "collectives": c["collectives"],
            "model_bytes": c["by_group"].get(
                dm.get_group("model").group_name, 0),
            "server_placements": sorted({
                tuple(pl.dim if pl.is_shard() else None
                      for pl in leaf.placements)
                for leaf in shd.tree_leaves_of(server)}, key=str),
            "edge_model_whole": all(
                leaf.placements[1].is_replicate()
                for leaf in shd.tree_leaves_of(args[2])),
            "layers": cfg.n_layers, "heads": cfg.n_heads,
            "head_dim": cfg.resolved_head_dim}
    gcfg = registry.get_smoke("granite-8b")
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = steps.placed_shapes(gcfg, dm)
        ecache = model_api.init_cache(edge_arch(gcfg), 8, 16, "cpu",
                                      device_mesh=dm, use_model=False)
        tok = DTensor.from_local(torch.zeros(2, dtype=torch.int32), dm,
                                 shd.batch_placements(dm, (8,), 8),
                                 run_check=False, shape=(8,), stride=(1,))
        c = dryrun.CostCounter()
        with c:
            r = steps.make_monitor_step(gcfg)(model, ecache, tok, 3)
        out["placed_monitor"] = {"namespaces": c.counts()["namespaces"],
                                 "collectives": c.counts()["collectives"],
                                 "u_shape": list(r["u"].shape)}
    return out


if __name__ == "__main__":
    main()
