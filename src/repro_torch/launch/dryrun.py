"""The dry run (``launch/dryrun.py``): what each (arch x input shape)
costs per device on the production mesh, counted over fake tensors.

One rank's program of the SPMD step runs eagerly under a
``FakeTensorMode`` (fake CUDA tensors: shapes, no storage, no card) on a
fake process group of 256 ranks (512 with ``--multi-pod``), the step and
its DTensor inputs from ``launch/steps.py::step_and_specs``.  A
``CostCounter`` (a ``TorchDispatchMode`` under DTensor, so it sees the
local shards' ops) counts per device:

- **FLOPs**: ``torch.utils.flop_counter``'s formula of every aten op,
  plus the hand-written kernels' counts from their shape functions
  (``kernels/ops.py``: a fake operand never reaches a kernel);
- **bytes**: the inputs and outputs of every aten op that makes a
  tensor (views and allocations aside) and of every kernel.  An eager
  step moves that much: nothing is fused.  A gather by index (``t[i]``)
  and a scatter in place (``t[i] = v``, a decode step's cache write)
  move the rows they touch and their indices, not the whole ``t``;
- **collective bytes**: the result bytes of each collective, by kind;
- **argument bytes**: the local blocks of the parameters, the optimizer
  moments (and masters) and the batch;
- **peak temporary bytes**: the most bytes held at once by tensors the
  step made (their storages, tracked until freed).

DTensor's sharding propagation also runs ops over fake tensors of the
global shapes; the counter skips those (they are no rank's work).  Costs
come from small probes per layer group extrapolated to the full depth
(``launch/layer_costs.py``), as the reference's do; the full-depth step
runs once, for its peak memory and to show the placement holds at full
depth.  The roofline terms use the H100 SXM's peaks
(``launch/roofline.py``): they are computed, not measured.

The fake group must be the process's default group, so run it as a
module (or a subprocess):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
        --shape train_4k [--multi-pod] [--out results.jsonl]

The decode shapes (``decode_32k``, ``long_500k``) count the serve step
(``launch/steps.py::make_serve_step``) on caches placed as a deployment
holds them: the server cache split by ``cache_specs(mode=
cfg.decode_cache_shard)``, the edge cache over the data axes only;
their model FLOPs are ``2 * active * B``, one token a stream:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \
        --shape decode_32k
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
import weakref
from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import registry
from repro_torch.configs.base import INPUT_SHAPES, SHAPES_BY_NAME
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.launch import layer_costs as lc
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import abstract_production_mesh, device_mesh
from repro_torch.launch.steps import step_and_specs
from repro_torch.serving.mesh import C10D_NAMESPACES

SHAPE_NAMES = tuple(s.name for s in INPUT_SHAPES)

_ALLOCATING_NOTHING = {torch.ops.aten.empty.memory_format,
                       torch.ops.aten.empty_strided.default,
                       torch.ops.aten.empty_like.default}

# ops that touch only the indexed rows of their first operand
_BY_INDEX = {torch.ops.aten.index.Tensor, torch.ops.aten.index_put_.default}

_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
          ("reduce_scatter", "reduce-scatter"),
          ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
          ("send", "collective-permute"), ("recv", "collective-permute"),
          ("permute", "collective-permute"))


def _collective_kind(func) -> Optional[str]:
    if func.namespace not in C10D_NAMESPACES:
        return None
    name = func._opname
    for key, kind in _KINDS:
        if key in name:
            return kind
    return None   # wait_tensor, barrier, ...


def _group_name(args, kwargs) -> str:
    """The process group a collective runs over: a functional
    collective's group-name argument, or a c10d op's ProcessGroup."""
    for a in tree_leaves((args, kwargs)):
        if isinstance(a, str):
            return a
        if hasattr(a, "group_name"):
            return a.group_name
    return "?"


def _in_propagation() -> bool:
    """Whether DTensor's sharding propagation is running the op (over
    tensors of the global shapes, to infer the output's)."""
    f = sys._getframe(2)
    for _ in range(40):
        if f is None:
            return False
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class CostCounter(TorchDispatchMode):
    """Per-device FLOPs, bytes, collective bytes by kind and peak bytes of
    the local ops that run inside it (see the module note).  The kernels'
    shape functions add to ``kernels`` while the counter is in
    ``ops.shape_counters``."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, float] = {k: 0.0
                                              for k in rf.COLLECTIVES}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.by_group: Dict[str, float] = {}    # group name -> bytes
        self.namespaces: Dict[str, int] = {}    # ops namespace -> ops
        self.n_ops = 0
        self._live: Dict[int, int] = {}
        self._now = 0
        self.peak = 0

    def __enter__(self):
        ops.shape_counters.append(self.kernels)
        return super().__enter__()

    def __exit__(self, *exc):
        ops.shape_counters.remove(self.kernels)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # DTensor runs it as local ops
        out = func(*args, **kwargs)
        if _in_propagation():
            return out
        self.n_ops += 1
        self.namespaces[func.namespace] = \
            self.namespaces.get(func.namespace, 0) + 1
        kind = _collective_kind(func)
        if kind is not None:
            n = sum(t.numel() * t.element_size() for t in _tensors(out))
            self.collectives[kind] += n
            group = _group_name(args, kwargs)
            self.by_group[group] = self.by_group.get(group, 0) + n
            return out
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if func in _BY_INDEX:   # the rows (out / values) twice, the indices
            rows = out if func is torch.ops.aten.index.Tensor else args[2]
            self.bytes += 2 * rows.numel() * rows.element_size() + sum(
                t.numel() * t.element_size() for t in _tensors(args[1]))
        elif func.namespace == "aten" and func not in _ALLOCATING_NOTHING \
                and not func.is_view and _tensors(out):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in _tensors((args, kwargs, out)))
        for t in _tensors(out):
            self._hold(t)
        return out

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self._now += n
        self.peak = max(self.peak, self._now)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self._now -= self._live.pop(key, 0)

    def counts(self) -> Dict:
        k_flops = sum(e["flops"] for e in self.kernels.values())
        k_bytes = sum(e["bytes"] for e in self.kernels.values())
        return {"flops": self.flops + k_flops, "bytes": self.bytes + k_bytes,
                "collectives": dict(self.collectives),
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "by_group": dict(self.by_group),
                "namespaces": dict(self.namespaces),
                "peak_bytes": self.peak, "ops": self.n_ops}


def _local_bytes(tree) -> int:
    total = 0
    for t in _tensors(tree):
        t = t.to_local() if shd.is_dtensor(t) else t
        total += t.numel() * t.element_size()
    return total


def _arg_bytes(args) -> int:
    """The local blocks of every argument: parameters, optimizer moments
    and masters, the batch."""
    total = 0
    for a in args:
        if isinstance(a, torch.nn.Module):
            total += _local_bytes(list(a.parameters()))
        elif hasattr(a, "m"):       # an OptState
            total += _local_bytes([a.m, a.v, [x for x in a.master
                                              if x is not None]])
        else:
            total += _local_bytes(a)
    return total


def _active_params(model, cfg):
    """(active, total) server parameter counts: routed expert weights
    scaled by top_k / n_experts."""
    total = routed = 0
    for name, p in model.server.named_parameters():
        total += p.numel()
        if ".moe.w_" in f".{name}":
            routed += p.numel()
    if cfg.is_moe and routed:
        return total - routed + routed * cfg.top_k / cfg.n_experts, total
    return float(total), total


def _model_flops(cfg, shape, model) -> float:
    """6 active B S (train), 2 active B S (prefill), 2 active B (decode:
    one token a stream), as the reference counts them."""
    active, _ = _active_params(model, cfg)
    if shape.kind == "decode":
        return 2.0 * active * shape.global_batch
    tokens = shape.global_batch * shape.seq_len
    return (6.0 if shape.kind == "train" else 2.0) * active * tokens


def count_step(cfg, shape, dmesh) -> Dict:
    """One rank's step of ``shape`` on ``dmesh`` (a fake DeviceMesh),
    counted: ``CostCounter.counts()`` plus ``arg_bytes``, ``model_flops``
    and ``seconds``."""
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args = step_and_specs(cfg, shape, dmesh)
        counter = CostCounter()
        with counter:
            step(*args)
        out = counter.counts()
        out["arg_bytes"] = _arg_bytes(args)
        out["model_flops"] = _model_flops(cfg, shape, args[0])
    out["seconds"] = time.perf_counter() - t0
    return out


def run_pair(arch: str, shape_name: str, *, multi_pod: bool = False,
             smoke: bool = False) -> Dict:
    """One (arch x shape) dry-run record on the production mesh: the
    full-depth step (peak bytes, argument bytes), then the probes of
    ``layer_costs`` (per-device FLOPs, bytes, collective bytes),
    extrapolated to the full depth."""
    cfg = registry.get_smoke(arch) if smoke else registry.get_full(arch)
    shape = SHAPES_BY_NAME[shape_name]
    mesh = abstract_production_mesh(multi_pod=multi_pod)
    dmesh = device_mesh(mesh, backend="fake")
    chips = mesh.size
    mesh_desc = "x".join(str(s) for s in mesh.axis_sizes)
    full = count_step(cfg, shape, dmesh)
    t_probes = time.perf_counter()
    full_counts, probes = lc.probe_plan(cfg)
    probe_costs = {name: rf.cost_dict(count_step(
        lc.with_counts(cfg, counts), shape, dmesh))
        for name, counts in probes}
    costs = lc.extrapolate(full_counts, probe_costs)
    t_probes = time.perf_counter() - t_probes
    roof = rf.analyze_costs(costs, arch=arch, shape=shape_name,
                            mesh_desc=mesh_desc, chips=chips,
                            model_flops=full["model_flops"])
    roof.bytes_per_device_peak = float(full["arg_bytes"] + full["peak_bytes"])
    rec = roof.as_dict()
    rec.update({
        "chips": chips,
        "compile_full_s": round(full["seconds"], 1),
        "compile_probes_s": round(t_probes, 1),
        "memory_analysis": {"argument_size_in_bytes": full["arg_bytes"],
                            "output_size_in_bytes": 0,
                            "temp_size_in_bytes": full["peak_bytes"],
                            "generated_code_size_in_bytes": 0},
        "kernels": full["kernels"],
        "peaks": {"flops": rf.PEAK_FLOPS, "hbm": rf.HBM_BW,
                  "link": rf.LINK_BW, "card": "H100 SXM",
                  "note": "computed from counts, not measured"},
    })
    print(rf.fmt_row(roof), flush=True)
    gb = (full["arg_bytes"] + full["peak_bytes"]) / 2**30
    print(f"    args+temp per device: {gb:.2f} GiB   full step "
          f"{full['seconds']:.0f}s probes {t_probes:.0f}s", flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, choices=SHAPE_NAMES,
                    help="shape name (default: all four)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="the SMOKE configs (default: FULL)")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else registry.names()
    shapes = [args.shape] if args.shape else list(SHAPE_NAMES)
    results = []
    for a in archs:
        for s in shapes:
            try:
                rec = run_pair(a, s, multi_pod=args.multi_pod,
                               smoke=args.smoke)
                rec["status"] = "ok"
            except Exception as e:  # a failure here is a placement bug
                traceback.print_exc()
                rec = {"arch": a, "shape": s, "status": "FAIL",
                       "error": repr(e)}
            results.append(rec)
            if args.out:
                with open(args.out, "a") as fh:
                    fh.write(json.dumps(rec) + "\n")
    n_ok = sum(r["status"] == "ok" for r in results)
    print(f"\n{n_ok}/{len(results)} pairs counted OK (computed from counts "
          f"over H100 SXM peaks, not measured)")
    if n_ok < len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
