"""Small sizes for the CPU tests: the cells' configurations and mixes cut to
what a test run holds (the port's SMOKE widths, bf16 compute as the cells
run), and a helper that runs a cell's runner on a device."""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import manifest, traffic  # noqa: E402
from portbench.run import Context  # noqa: E402

MON = {"n_layers": 1, "d_model": 64, "n_heads": 2, "d_ff": 128,
       "n_features": 16, "t_init": 0.1, "s": 0.2, "threshold": 0.0,
       "trigger_margin": 0.25, "correction_capacity": 0.25,
       "sigma": "sigmoid"}
GRANITE = {"name": "granite-8b", "family": "dense", "citation": "test",
           "n_layers": 2, "d_model": 256, "n_heads": 4, "n_kv_heads": 2,
           "d_ff": 512, "vocab_size": 512, "rope_theta": 1e4,
           "norm_eps": 1e-5, "tie_embeddings": True,
           "long_context_window": 8192, "dtype": "bfloat16",
           "param_dtype": "float32", "remat": True, "monitor": MON}
ZAMBA = dict(GRANITE, name="zamba2-7b", family="hybrid", n_layers=5,
             n_kv_heads=4, ssm_state=16, ssm_conv=4, ssm_expand=2,
             ssm_chunk=16, shared_attn_every=2)
CONFIGS = {"granite-8b.fleet": GRANITE, "granite-8b.train": GRANITE,
           "zamba2-7b.train": ZAMBA}
# Each cell's mix by name; the fleet's cell is not in BENCHMARK.json (its
# host-paced rates spread past any bound, PERF.md), its files stay tested.
TRAFFIC = {"granite-8b.fleet": "fleet", "granite-8b.train": "train",
           "zamba2-7b.train": "train"}


def f32(p: dict) -> dict:
    return dict(p, dtype="float32")


def mix(workload: str) -> dict:
    m = traffic.load_mix(TRAFFIC[workload])
    if m["runner"] == "fleet":
        return dict(m, streams=4, max_len=16, ramp_scheduled_steps=4,
                    check_streams=4, profile_steps=1)
    return dict(m, batch=2, seq=32, profile_steps=1)


def drive(workload: str, device, *, seed: int = 2**31 + 11,
          seconds: float = 0.0, p: dict = None, control: bool = False,
          limits: dict = None):
    """Run ``workload``'s runner at the small size, its window ``seconds``
    long (0: one step); returns (out, ctx)."""
    import torch
    torch.manual_seed(0)
    m = mix(workload)
    lim = limits if limits is not None else \
        manifest.limits(workload)["limits"]
    ctx = Context(p=p or CONFIGS[workload], mix=m, limits=lim, seed=seed,
                  seconds=seconds, trace=False, device=device,
                  t_start=time.perf_counter(), control=control)
    out = manifest.runner(m).run(ctx)
    return out, ctx
