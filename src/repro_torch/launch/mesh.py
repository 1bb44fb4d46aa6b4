"""Device meshes and the elastic re-mesh arithmetic (the JAX package's
``launch/mesh.py``).

A mesh is a ``(data, model)`` grid of devices: :func:`make_host_mesh`
builds the reference's host mesh as a
``torch.distributed.device_mesh.DeviceMesh``, and after failures the
supervisor asks :func:`largest_feasible_mesh` for the largest grid the
survivors can form.  ``make_production_mesh`` and the hardware constants
of the roofline wait for the dry-run tooling (ROADMAP.md Queue 1 item
2), which gives them H100 sources.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["make_host_mesh", "largest_feasible_mesh"]


def make_host_mesh(device_type: str = "cuda"):
    """The ``(n, 1)`` mesh named ``("data", "model")`` over the initialised
    process group's ``n`` ranks, in rank order.  Without a group it is a
    one-rank mesh that needs none (it creates no process group; a
    one-device mesh makes every annotation a no-op)."""
    from torch.distributed.device_mesh import DeviceMesh

    from ..distributed.world import initialized, rank_world

    names = ("data", "model")
    if initialized():
        _, world = rank_world()
        return DeviceMesh(device_type, torch.arange(world).reshape(world, 1),
                          mesh_dim_names=names)
    return DeviceMesh(device_type, torch.zeros((1, 1), dtype=torch.int64),
                      mesh_dim_names=names, _init_backend=False, _rank=0)


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
