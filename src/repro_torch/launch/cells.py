"""Serving replica placement (DESIGN.md §10).

The port's copy of the placement half of the JAX package's
``launch/cells.py``: pure planning over device indices, no devices
touched.  The rest of that module (the dry-run cells over mesh rules)
is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["ReplicaPlacement", "place_serving_replicas"]


@dataclasses.dataclass(frozen=True)
class ReplicaPlacement:
    """One serving replica pinned to a contiguous device group."""

    tenant: str
    replica: int
    devices: Tuple[int, ...]


def place_serving_replicas(
    tenants,
    n_devices: int,
    *,
    group_size: int = 1,
    replicas: int = 1,
) -> list:
    """Place ``replicas`` serving replicas per tenant over ``n_devices``.

    Devices are carved into contiguous groups of ``group_size`` (a group
    is one :class:`~repro_torch.serve.tier.GraphServingTier` process's
    devices); tenant replicas go round-robin over the groups, so group
    load is balanced to within one replica and two replicas of the same
    tenant never share a group (they exist to survive that group).  Pure
    planning — no devices are touched; launchers consume the returned
    :class:`ReplicaPlacement` list.
    """
    tenants = list(tenants)
    if group_size <= 0 or n_devices < group_size:
        raise ValueError(
            f"need at least one group of {group_size} devices, have "
            f"{n_devices}"
        )
    groups = [
        tuple(range(g * group_size, (g + 1) * group_size))
        for g in range(n_devices // group_size)
    ]
    if replicas > len(groups):
        raise ValueError(
            f"{replicas} replicas per tenant need {replicas} distinct "
            f"device groups, have {len(groups)}"
        )
    # consecutive slots per tenant: replicas land on consecutive groups
    # (mod G), so with replicas <= len(groups) a tenant's replicas are
    # always disjoint, and sequential slot assignment keeps group load
    # balanced to within one replica
    out = []
    slot = 0
    for tenant in tenants:
        for r in range(replicas):
            out.append(ReplicaPlacement(
                tenant=tenant, replica=r,
                devices=groups[slot % len(groups)],
            ))
            slot += 1
    return out
