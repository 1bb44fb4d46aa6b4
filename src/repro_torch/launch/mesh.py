"""Elastic re-mesh arithmetic (the JAX package's ``launch/mesh.py``,
pure Python).

A mesh is a ``(data, model)`` grid of devices; after failures the
supervisor asks for the largest grid the survivors can form.  Building
device meshes (``make_production_mesh`` / ``make_host_mesh``) and the
hardware constants of the roofline wait for the launch slice, which
gives them H100 sources.
"""
from __future__ import annotations

from typing import Tuple

__all__ = ["largest_feasible_mesh"]


def largest_feasible_mesh(
    n_devices: int, model_parallel: int = 16
) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Elastic re-mesh after failures: the largest (data, model) grid that
    fits the surviving device count, shrinking data parallelism first
    (orchestrator contract: model-parallel groups are the survival unit).
    """
    if n_devices < 1:
        raise ValueError("no surviving devices to re-mesh")
    model = min(model_parallel, n_devices)
    while n_devices % model:
        model -= 1
    data = n_devices // model
    return (data, model), ("data", "model")
