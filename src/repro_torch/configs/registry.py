"""Architecture registry of the port: ``--arch <id>`` resolution.

The archs whose path the port runs are listed; each of the JAX
package's others raises with the ROADMAP.md Queue 1 item that brings it.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

__all__ = ["ARCH_MODULES", "NOT_PORTED", "get_arch", "list_archs", "shapes_for"]

ARCH_MODULES: Dict[str, str] = {
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "yi-9b": "repro_torch.configs.yi_9b",
    "meshgraphnet": "repro_torch.configs.meshgraphnet",
    "graphcast": "repro_torch.configs.graphcast",
    "schnet": "repro_torch.configs.schnet",
    "dimenet": "repro_torch.configs.dimenet",
    "sasrec": "repro_torch.configs.sasrec",
}

# the reference's other archs, and what brings each
NOT_PORTED: Dict[str, str] = {
    "granite-moe-3b-a800m": "Queue 1 item 1 (models/moe.py with model sharding)",
    "moonshot-v1-16b-a3b": "Queue 1 item 1 (models/moe.py with model sharding)",
    "llama3-405b": "Queue 1 item 1 (model sharding: 405B does not fit one card)",
    "graphgen-paper": "Queue 1 item 2 (launch/*: its cells; the analytics run through "
                      "repro_torch.launch.distributed_analytics)",
}


def get_arch(name: str):
    """The arch module (``CONFIG``, ``SMOKE``, ``SHAPE_FAMILY``)."""
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet: ROADMAP.md {NOT_PORTED[name]}; "
                       f"the port has {sorted(ARCH_MODULES)}")
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; the port has {sorted(ARCH_MODULES)}")
    return importlib.import_module(ARCH_MODULES[name])


def list_archs() -> List[str]:
    return list(ARCH_MODULES)


def shapes_for(name: str) -> List[str]:
    from . import shapes

    fam = get_arch(name).SHAPE_FAMILY
    return {
        "lm": list(shapes.LM_SHAPES),
        "gnn": list(shapes.GNN_SHAPES),
        "recsys": list(shapes.REC_SHAPES),
    }[fam]
