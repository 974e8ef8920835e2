"""Architecture registry of the port: ``get_full``/``get_smoke`` by name,
as in the JAX package (``configs/registry.py``).

Only the configs the port runs are here: the dense granite-8b and Qwen
archs, the MoE family (mixtral-8x22b, deepseek-v3 with MLA and MTP), the
zamba2 hybrid and the paper's own two experiments, whose FULL/SMOKE are
``PaperMLPConfig``s (the LM-scale serving workload is
``paper_synthetic.SERVING``).  Every other arch of the JAX registry
raises ``NotImplementedError`` naming its ROADMAP queue.
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
    "qwen1.5-32b": "repro_torch.configs.qwen15_32b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    # the paper's own experiments (synthetic cosine / financial monitoring)
    "paper-synthetic": "repro_torch.configs.paper_synthetic",
    "paper-financial": "repro_torch.configs.paper_financial",
}

# archs of the JAX registry that later slices port (ROADMAP queue 1, item 7)
_LATER = ("musicgen-large", "llama-3.2-vision-11b", "xlstm-350m")


def names(include_paper: bool = False) -> List[str]:
    """The ported archs, LM backbones first (the JAX registry's order less
    the archs still to port)."""
    ns = [n for n in _ARCHS if not n.startswith("paper-")]
    return ns + [n for n in _ARCHS if n.startswith("paper-")] \
        if include_paper else ns


def get_module(name: str):
    if name in _LATER:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: see ROADMAP.md queue 1, "
            "item 7 (other families)")
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}")
    return importlib.import_module(_ARCHS[name])


def get_full(name: str):
    return get_module(name).FULL


def get_smoke(name: str):
    return get_module(name).SMOKE
