"""Architecture registry of the port: ``--arch <id>`` resolution.

Only the archs whose path the port runs are listed; the JAX package's
others (llama3-405b, the MoE archs, the GNNs, SASRec, graphgen-paper)
wait for their modules (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

__all__ = ["ARCH_MODULES", "get_arch", "list_archs"]

ARCH_MODULES: Dict[str, str] = {
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "yi-9b": "repro_torch.configs.yi_9b",
}


def get_arch(name: str):
    """The arch module (``CONFIG``, ``SMOKE``, ``SHAPE_FAMILY``)."""
    if name not in ARCH_MODULES:
        raise KeyError(
            f"arch {name!r} is unknown or not ported yet; the port has "
            f"{sorted(ARCH_MODULES)}"
        )
    return importlib.import_module(ARCH_MODULES[name])


def list_archs() -> List[str]:
    return list(ARCH_MODULES)
