"""Linear layer-cost extrapolation for the dry run's roofline
(``launch/layer_costs.py``), copied for the port's ``ArchConfig``.

Layers inside one layer group are identical, so a step's cost is linear
in each group's layer count:

    cost(counts) = glue + sum_g counts[g] * c_g

``dryrun.run_pair`` counts small probes (the base, every group at one
layer, plus one probe per group at two), solves for {glue, c_g} and
extrapolates to the full counts.  The port counts an eager step, which
runs every layer, so the extrapolation is exact up to rounding:
``tests/test_torch_dryrun.py`` holds it within 0.1% of a direct count
of the whole depth at SMOKE.  The full-depth step is still run once, for
its peak memory.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchConfig


def count_knobs(cfg: ArchConfig) -> Dict[str, int]:
    """Full per-group layer counts for each layer group of the arch."""
    for every in ((cfg.family == "vlm" and cfg.cross_attn_every),
                  (cfg.family == "hybrid" and cfg.shared_attn_every),
                  (cfg.family == "ssm" and cfg.slstm_every)):
        if every:
            n_super = cfg.n_layers // every
            tail = cfg.n_layers - n_super * every
            k = {"super": n_super}
            if tail:
                k["tail"] = tail
            return k
    if cfg.is_moe:
        k = {}
        if cfg.first_dense_layers:
            k["dense"] = cfg.first_dense_layers
        k["moe"] = cfg.n_layers - cfg.first_dense_layers
        return k
    return {"blocks": cfg.n_layers}


def with_counts(cfg: ArchConfig, counts: Dict[str, int]) -> ArchConfig:
    """The config with reduced per-group counts (same layer shapes)."""
    for every in ((cfg.family == "vlm" and cfg.cross_attn_every),
                  (cfg.family == "hybrid" and cfg.shared_attn_every),
                  (cfg.family == "ssm" and cfg.slstm_every)):
        if every:
            return cfg.replace(
                n_layers=every * counts["super"] + counts.get("tail", 0))
    if cfg.is_moe:
        fd = counts.get("dense", 0)
        return cfg.replace(first_dense_layers=fd, n_layers=fd + counts["moe"])
    return cfg.replace(n_layers=counts["blocks"])


def probe_plan(cfg: ArchConfig):
    """(full_counts, [(name, counts)]): the base (every group 1), then one
    probe per group with that group at 2."""
    full = count_knobs(cfg)
    base = {g: 1 for g in full}
    probes = [("base", dict(base))]
    for g in full:
        c = dict(base)
        c[g] = 2
        probes.append((g, c))
    return full, probes


def extrapolate(full: Dict[str, int], probe_costs: Dict[str, Dict[str, float]]
                ) -> Dict[str, float]:
    """probe_costs: {'base': {...}, '<group>': {...}} of cost dicts -> the
    full cost dict.  cost(base) = glue + sum c_g; cost(g) = base + c_g."""
    base = probe_costs["base"]
    out = {}
    for key in base:
        c_g = {g: probe_costs[g][key] - base[key] for g in full}
        glue = base[key] - sum(c_g.values())
        out[key] = glue + sum(c_g[g] * full[g] for g in full)
        # numerical floor: costs cannot be negative
        out[key] = max(out[key], 0.0)
    return out
