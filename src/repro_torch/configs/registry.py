"""Architecture registry of the port: ``get_full``/``get_smoke`` by name.

Only the configs the port runs are here (the dense ones and the zamba2
hybrid).  Every other arch of the JAX registry raises
``NotImplementedError`` naming its ROADMAP queue.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

_ARCHS = {
    "granite-8b": "repro_torch.configs.granite_8b",
    "paper-synthetic": "repro_torch.configs.paper_synthetic",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
}

# archs of the JAX registry that later slices port (ROADMAP queue 1, item 7)
_LATER = ("qwen1.5-110b", "deepseek-v3-671b", "qwen2.5-32b",
          "musicgen-large", "qwen1.5-32b", "mixtral-8x22b",
          "llama-3.2-vision-11b", "xlstm-350m", "paper-financial")


def _module(name: str):
    if name in _LATER:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: see ROADMAP.md queue 1, "
            "item 7 (other families)")
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}")
    return importlib.import_module(_ARCHS[name])


def get_full(name: str) -> ArchConfig:
    mod = _module(name)
    return mod.SERVING if name == "paper-synthetic" else mod.FULL


def get_smoke(name: str) -> ArchConfig:
    mod = _module(name)
    return mod.SERVING if name == "paper-synthetic" else mod.SMOKE
