"""Architecture configs of the port (plain data, no JAX): exact published
configurations and reduced smoke variants.

``registry.get_arch(name)`` resolves ``--arch <id>``.
"""
from .base import GNNConfig, MoEConfig, RecsysConfig, TransformerConfig
from .registry import get_arch, list_archs, shapes_for

__all__ = [
    "GNNConfig",
    "MoEConfig",
    "RecsysConfig",
    "TransformerConfig",
    "get_arch",
    "list_archs",
    "shapes_for",
]
