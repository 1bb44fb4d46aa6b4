"""Semirings for condensed-graph propagation (PyTorch).

The paper distinguishes *duplicate-insensitive* graph algorithms (run
directly on C-DUP) from *duplicate-sensitive* ones (need dedup).  In
linear-algebra terms: propagation under an **idempotent** semiring add
(``min``, ``max``, ``or``) is invariant to path multiplicity, while a ring
add (``+``) counts paths.  Each algorithm in
:mod:`repro_torch.core.algorithms` declares its semiring; the engine uses
the ``idempotent`` flag to decide whether a dedup structure is required
for exactness (paper §4.1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

__all__ = [
    "Semiring",
    "PLUS_TIMES",
    "MIN_PLUS",
    "MAX_TIMES",
    "MAX_MIN",
    "OR_AND",
    "KERNEL_SEMIRINGS",
    "kernelizable",
    "segment_reduce",
]


@dataclasses.dataclass(frozen=True)
class Semiring:
    name: str
    add_kind: str  # 'sum' | 'min' | 'max'
    mul: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    zero: float
    one: float
    idempotent: bool
    supports_subtraction: bool = False  # needed by the DEDUP-C correction

    def add(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.add_kind == "sum":
            return x + y
        if self.add_kind == "min":
            return torch.minimum(x, y)
        if self.add_kind == "max":
            return torch.maximum(x, y)
        raise ValueError(self.add_kind)


PLUS_TIMES = Semiring(
    name="plus_times",
    add_kind="sum",
    mul=torch.mul,
    zero=0.0,
    one=1.0,
    idempotent=False,
    supports_subtraction=True,
)

MIN_PLUS = Semiring(
    name="min_plus",
    add_kind="min",
    mul=torch.add,
    zero=math.inf,
    one=0.0,
    idempotent=True,
)

MAX_TIMES = Semiring(
    name="max_times",
    add_kind="max",
    mul=torch.mul,
    zero=0.0,
    one=1.0,
    idempotent=True,
)

# Boolean reachability encoded in {0,1} floats so the same segment kernels
# apply; `or` == max, `and` == min(x, y) == x*y on {0,1}.
OR_AND = Semiring(
    name="or_and",
    add_kind="max",
    mul=torch.minimum,
    zero=0.0,
    one=1.0,
    idempotent=True,
)

# Widest / bottleneck paths over non-negative capacities: a path's width
# is the min capacity along it, the best path the max over widths.
MAX_MIN = Semiring(
    name="max_min",
    add_kind="max",
    mul=torch.minimum,
    zero=0.0,
    one=math.inf,
    idempotent=True,
)


# Semirings the bit-packed SpMM kernels realize: over a 0/1 incidence
# layer ⊗ by the incidence weight (the semiring one) is the identity for
# all of these, so one kernel step is just the ⊕-reduction.
KERNEL_SEMIRINGS = frozenset(
    {"plus_times", "min_plus", "max_times", "or_and", "max_min"}
)


def kernelizable(semiring: Semiring) -> bool:
    """Whether one propagation step of this semiring can dispatch to the
    bit-packed SpMM kernels (:mod:`repro_torch.kernels.bitmap_spmm`).
    Unknown semirings stay on the segment-reduce path."""
    return semiring.name in KERNEL_SEMIRINGS and semiring.add_kind in (
        "sum",
        "min",
        "max",
    )


def segment_reduce(
    semiring: Semiring,
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
) -> torch.Tensor:
    """⊕-reduce ``values`` (``(E,)`` or ``(E, F)``) by ``segment_ids``.

    Empty segments follow the JAX package's conventions: ``sum`` gives 0,
    ``min`` leaves ``+inf``, and ``max`` maps every ``-inf`` — a genuine
    ``-inf`` value included — to the semiring zero.
    """
    shape = (num_segments,) + tuple(values.shape[1:])
    idx = segment_ids.to(torch.int64)
    if semiring.add_kind == "sum":
        out = torch.zeros(shape, dtype=values.dtype, device=values.device)
        return out.index_add_(0, idx, values)
    if semiring.add_kind not in ("min", "max"):
        raise ValueError(semiring.add_kind)
    if values.ndim > 1:
        idx = idx.reshape((-1,) + (1,) * (values.ndim - 1)).expand_as(values)
    init = math.inf if semiring.add_kind == "min" else -math.inf
    out = torch.full(shape, init, dtype=values.dtype, device=values.device)
    reduce = "amin" if semiring.add_kind == "min" else "amax"
    out.scatter_reduce_(0, idx, values, reduce, include_self=False)
    if semiring.add_kind == "max":
        out = torch.where(
            torch.isneginf(out), torch.full_like(out, semiring.zero), out
        )
    return out
