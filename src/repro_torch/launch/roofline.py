"""Roofline terms of a dry-run step at the H100 SXM's peaks
(``launch/roofline.py``).

    compute term    = FLOPs / peak FLOP/s
    memory term     = bytes / HBM rate
    collective term = collective bytes / link rate

Every count is per device: ``launch/dryrun.py`` counts one rank's
program of the SPMD step (local shards) under fake tensors, where the
reference reads XLA's ``cost_analysis`` and its partitioned HLO.  FLOPs
are ``torch.utils.flop_counter``'s formulas over the aten ops plus the
hand-written kernels' own counts (their shape functions,
``kernels/ops.py``); bytes are the inputs and outputs of every aten op
and kernel, which an eager step moves as it is, with no fusion;
collective bytes are the result bytes of each collective, by the five
kinds the reference names.

The peaks are an H100 SXM's: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3,
450 GB/s NVLink 4 in one direction.  The production mesh's model axis
of 16 spans two 8-card NVLink nodes, and the data axis crosses nodes
too, where the network is slower than NVLink: the collective term is a
lower bound.  These are computed from counts, not measured.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Optional

# H100 SXM per-card constants
PEAK_FLOPS = 989e12        # dense bf16 FLOP/s
HBM_BW = 3.35e12           # bytes/s
LINK_BW = 450e9            # bytes/s, NVLink 4, one direction

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_breakdown: Dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float            # 6*N*D (or 2*N*D forward only), ACTIVE params
    useful_flops_ratio: float     # model_flops / (chips * flops_per_device)
    bytes_per_device_peak: Optional[float] = None

    def as_dict(self) -> Dict:
        return asdict(self)


def cost_dict(counts: Dict) -> Dict[str, float]:
    """The flat cost record of one counted step (``dryrun.CostCounter
    .counts()``): flops, bytes and ``coll_<kind>`` for the five kinds."""
    d = {"flops": float(counts["flops"]), "bytes": float(counts["bytes"])}
    for k in COLLECTIVES:
        d["coll_" + k] = float(counts["collectives"].get(k, 0))
    return d


def analyze_costs(costs: Dict[str, float], *, arch: str, shape: str,
                  mesh_desc: str, chips: int, model_flops: float) -> Roofline:
    flops = costs["flops"]
    byts = costs["bytes"]
    cb = {k[len("coll_"):]: v for k, v in costs.items()
          if k.startswith("coll_")}
    ctotal = float(sum(cb.values()))
    terms = {"compute": flops / PEAK_FLOPS, "memory": byts / HBM_BW,
             "collective": ctotal / LINK_BW}
    bottleneck = max(terms, key=terms.get)
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_desc,
        flops_per_device=flops, bytes_per_device=byts,
        collective_bytes_per_device=ctotal, collective_breakdown=cb,
        compute_s=terms["compute"], memory_s=terms["memory"],
        collective_s=terms["collective"], bottleneck=bottleneck,
        model_flops=model_flops,
        useful_flops_ratio=(model_flops / (chips * flops)) if flops else 0.0,
    )


def fmt_row(r: Roofline) -> str:
    return (f"{r.arch:22s} {r.shape:12s} {r.mesh:10s} "
            f"compute {r.compute_s*1e3:9.3f}ms  memory {r.memory_s*1e3:9.3f}ms  "
            f"collective {r.collective_s*1e3:9.3f}ms  -> {r.bottleneck:10s} "
            f"useful {100*r.useful_flops_ratio:5.1f}%")
