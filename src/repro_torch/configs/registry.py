"""Architecture registry of the port: ``--arch <id>`` resolution for every
launcher, the JAX package's ``configs/registry.py`` arch for arch."""
from __future__ import annotations

import importlib
from typing import Dict, List

__all__ = ["ARCH_MODULES", "get_arch", "list_archs", "shapes_for"]

ARCH_MODULES: Dict[str, str] = {
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "yi-9b": "repro_torch.configs.yi_9b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "meshgraphnet": "repro_torch.configs.meshgraphnet",
    "graphcast": "repro_torch.configs.graphcast",
    "schnet": "repro_torch.configs.schnet",
    "dimenet": "repro_torch.configs.dimenet",
    "sasrec": "repro_torch.configs.sasrec",
    "graphgen-paper": "repro_torch.configs.graphgen_paper",
}


def get_arch(name: str):
    """The arch module (``CONFIG``, ``SMOKE``, ``SHAPE_FAMILY``, ...)."""
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCH_MODULES)}")
    return importlib.import_module(ARCH_MODULES[name])


def list_archs(assigned_only: bool = False) -> List[str]:
    """Every arch id; ``assigned_only`` leaves out graphgen-paper, the
    paper's own workload, which is not one of the 40 assigned cells."""
    names = list(ARCH_MODULES)
    if assigned_only:
        names.remove("graphgen-paper")
    return names


def shapes_for(name: str) -> List[str]:
    from . import shapes

    fam = get_arch(name).SHAPE_FAMILY
    return {
        "lm": list(shapes.LM_SHAPES),
        "gnn": list(shapes.GNN_SHAPES),
        "recsys": list(shapes.REC_SHAPES),
        "graphgen": ["pagerank"],
    }[fam]
