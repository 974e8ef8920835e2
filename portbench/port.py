"""The system under test, built from a configuration file: the port's
``ArchConfig`` from the file's ``port`` block, and its collaborative
model with the benchmark's seeded weights written into it.  With the
runners, the only code here that imports the program."""
from __future__ import annotations

from portbench import weights


def arch(p: dict):
    from repro_torch.configs.base import ArchConfig, MonitorConfig
    kw = dict(p)
    mon = MonitorConfig(**kw.pop("monitor"))
    return ArchConfig(**kw, monitor=mon)


def collab_model(p: dict, seed: int, device):
    """(cfg, model): an uninitialised ``CollabLM`` on ``device``, filled
    with the seeded weights."""
    from repro_torch.core.decomposition import CollabLM
    cfg = arch(p)
    model = CollabLM(cfg, device)
    weights.fill(model.named_parameters(), seed, p)
    return cfg, model
