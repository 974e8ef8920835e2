"""Architecture registry of the port: ``get_full``/``get_smoke`` by name,
as in the JAX package (``configs/registry.py``).

Every arch of the JAX registry is here: the ten LM backbones (dense
granite-8b and the Qwen archs, the MoE family, the zamba2 hybrid,
llama-3.2-vision, musicgen and xlstm) and the paper's own two
experiments, whose FULL/SMOKE are ``PaperMLPConfig``s (the LM-scale
serving workload is ``paper_synthetic.SERVING``).
"""
from __future__ import annotations

import importlib
from typing import List

# in the JAX registry's order
_ARCHS = {
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "qwen1.5-110b": "repro_torch.configs.qwen15_110b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "qwen2.5-32b": "repro_torch.configs.qwen25_32b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "qwen1.5-32b": "repro_torch.configs.qwen15_32b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama32_vision_11b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    # the paper's own experiments (synthetic cosine / financial monitoring)
    "paper-synthetic": "repro_torch.configs.paper_synthetic",
    "paper-financial": "repro_torch.configs.paper_financial",
}

# archs of the JAX registry still to port: none
_LATER = ()


def names(include_paper: bool = False) -> List[str]:
    """The archs, LM backbones first, in the JAX registry's order."""
    ns = [n for n in _ARCHS if not n.startswith("paper-")]
    return ns + [n for n in _ARCHS if n.startswith("paper-")] \
        if include_paper else ns


def get_module(name: str):
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}")
    return importlib.import_module(_ARCHS[name])


def get_full(name: str):
    return get_module(name).FULL


def get_smoke(name: str):
    return get_module(name).SMOKE
