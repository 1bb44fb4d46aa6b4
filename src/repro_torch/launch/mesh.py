"""Device meshes, the H100 constants of the roofline, and the elastic
re-mesh arithmetic (the JAX package's ``launch/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims:
:func:`make_production_mesh` is the reference's production mesh, a
``(16, 16)`` grid named ``("data", "model")`` for one pod of 256 ranks or
``(2, 16, 16)`` with ``"pod"`` first for 512, over the initialised process
group (the dry-run's is a fake one:
:func:`repro_torch.distributed.world.init_fake_group`);
:func:`make_host_mesh` is the ``(n, 1)`` mesh over the group's ranks; and
after failures the supervisor asks :func:`largest_feasible_mesh` for the
largest grid the survivors can form.

The constants are NVIDIA H100 SXM5 80GB datasheet figures, not
measurements: the roofline of :mod:`repro_torch.launch.roofline` reads
them in place of the reference's TPU v5e constants.  A cluster of H100s
is laid out as nodes of :data:`NODE_SIZE` GPUs joined by NVLink 4 inside a
node and by one InfiniBand NDR link per GPU between nodes.  The
reference's pod of 256 chips stays the unit of its ICI / DCI split.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = [
    "PEAK_FLOPS_BF16", "HBM_BW", "HBM_BYTES", "NVLINK_BW", "NETWORK_BW", "NODE_SIZE",
    "POD_SIZE", "make_production_mesh", "make_host_mesh", "largest_feasible_mesh",
]

# H100 SXM5 datasheet figures (not measured)
PEAK_FLOPS_BF16 = 989e12       # dense bf16 tensor-core FLOP/s per GPU
HBM_BW = 3.35e12               # HBM3 bytes/s per GPU
HBM_BYTES = 80e9               # HBM3 bytes per GPU
NVLINK_BW = 450e9              # NVLink 4 bytes/s per direction per GPU, inside a node
NETWORK_BW = 50e9              # InfiniBand NDR, 400 Gb/s per GPU, between nodes
NODE_SIZE = 8                  # GPUs per NVLink node (HGX H100)
POD_SIZE = 256                 # the reference's pod: its ICI / DCI boundary


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """``(16, 16)`` named ``("data", "model")`` over 256 ranks, or ``(2, 16,
    16)`` named ``("pod", "data", "model")`` over 512, in rank order, over
    the initialised process group (which must have that many ranks)."""
    from torch.distributed.device_mesh import DeviceMesh

    from ..distributed.world import initialized, rank_world

    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if not initialized() or rank_world()[1] != n:
        raise ValueError(f"the production mesh {shape} needs an initialised group of {n} ranks")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=names)


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
