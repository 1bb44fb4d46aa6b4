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
from typing import Callable, Optional, Tuple

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
    "SegmentPlan",
    "segment_plan",
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


@dataclasses.dataclass
class SegmentPlan:
    """A fixed order for a segment sum, built once from the segment ids.

    Segments are grouped by the power of two that bounds their length;
    ``gather[c]`` is a ``(len(segs[c]), 2**k)`` matrix of positions into
    the values, each row one segment's values in a fixed order and padded
    with ``n_values`` (an appended zero row).  Each group is reduced by one
    ``sum`` over a fixed shape, so a planned sum adds in an order that
    depends only on the ids (and the tiebreak they were sorted by), never
    on how the device schedules the work: its float bits repeat from call
    to call, which ``index_add_`` on CUDA does not promise.  A row holds at
    most twice its segment's values, so the gathers stay within ``2E``."""

    num_segments: int
    n_values: int
    segs: Tuple[torch.Tensor, ...]
    gather: Tuple[torch.Tensor, ...]
    traced: bool = False


def segment_plan(
    segment_ids: torch.Tensor,
    num_segments: int,
    tiebreak: Optional[torch.Tensor] = None,
) -> SegmentPlan:
    """The :class:`SegmentPlan` of ``segment_ids``, on their device.

    Within a segment, values are taken in ``tiebreak`` order (stable, so
    equal keys keep their positions), else in position order.  With the
    source row of each edge as the tiebreak, a layer's planned sums do not
    change, bit for bit, when its edge list is permuted.

    Fake ids (a dry-run's trace, :mod:`repro_torch.launch.op_cost`) have
    no values to plan from: the plan is marked ``traced`` and the sum is
    traced as a scatter-add of the same values, whose shapes do not depend
    on the ids."""
    from torch._subclasses.fake_tensor import is_fake

    ids = segment_ids.to(torch.int64).reshape(-1)
    n = int(ids.shape[0])
    if is_fake(ids):
        return SegmentPlan(int(num_segments), n, (), (), traced=True)
    dev = ids.device
    if tiebreak is None:
        order = torch.argsort(ids, stable=True)
    else:
        by_tie = torch.argsort(tiebreak.to(torch.int64).reshape(-1), stable=True)
        order = by_tie[torch.argsort(ids[by_tie], stable=True)]
    counts = torch.bincount(ids, minlength=num_segments)
    starts = torch.cumsum(counts, 0) - counts
    segs = torch.nonzero(counts).reshape(-1)
    seg_counts = counts[segs]
    # ceil(log2(count)): a segment of c values takes a row of 2**k >= c
    klass = torch.ceil(torch.log2(seg_counts.to(torch.float64))).to(torch.int64)
    out_segs, out_gather = [], []
    for k in torch.unique(klass).tolist():
        sel = segs[klass == k]
        width = torch.arange(1 << k, device=dev)
        pos = starts[sel][:, None] + width[None, :]
        valid = width[None, :] < counts[sel][:, None]
        out_segs.append(sel)
        out_gather.append(torch.where(valid, order[pos.clamp_(max=max(n - 1, 0))], n))
    return SegmentPlan(int(num_segments), n, tuple(out_segs), tuple(out_gather))


def _planned_sum(values: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    if values.shape[0] != plan.n_values:
        raise ValueError(
            f"segment plan covers {plan.n_values} values, got {values.shape[0]}"
        )
    rest = tuple(values.shape[1:])
    out = torch.zeros((plan.num_segments,) + rest, dtype=values.dtype,
                      device=values.device)
    padded = torch.cat([values, values.new_zeros((1,) + rest)])
    for segs, gather in zip(plan.segs, plan.gather):
        out.index_copy_(0, segs, padded[gather].sum(dim=1))
    return out


def segment_reduce(
    semiring: Semiring,
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    plan: Optional[SegmentPlan] = None,
) -> torch.Tensor:
    """⊕-reduce ``values`` (``(E,)`` or ``(E, F)``) by ``segment_ids``.

    Empty segments follow the JAX package's conventions: ``sum`` gives 0,
    ``min`` leaves ``+inf``, and ``max`` maps every ``-inf`` — a genuine
    ``-inf`` value included — to the semiring zero.  The sum adds each
    segment's values in the fixed order of ``plan`` (built from
    ``segment_ids`` when none is given), so its bits repeat on every
    device; min and max are order-free already.
    """
    shape = (num_segments,) + tuple(values.shape[1:])
    idx = segment_ids.to(torch.int64)
    if semiring.add_kind == "sum":
        if plan is None:
            plan = segment_plan(idx, num_segments)
        if plan.traced:
            return values.new_zeros(shape).index_add_(0, idx, values)
        return _planned_sum(values, plan)
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
