"""Representation advisor (paper §6.5) + cost-based plan front door.

Given a freshly extracted C-DUP graph and workload hints, recommend the
in-memory representation:

* expansion small (< ``expand_margin`` growth)       -> EXP
* algorithms touch a small fraction of the graph     -> C-DUP
* multi-pass duplicate-sensitive analytics           -> BITMAP-2 / DEDUP-C
* repeated analyses over time (amortized preprocessing) -> DEDUP-1/DEDUP-2

On the device engine the BITMAP traversal semantics collapse into
DEDUP-C (see DESIGN.md §2), so the device recommendation column differs
from the paper's host recommendation where applicable.

The advisor is cost-based (DESIGN.md §12): the *pipeline* knobs
(sharding, spilling, merge arity, pack method, fused correction) are
chosen by :func:`repro_torch.core.cost.plan` — re-exported here — and
the *device* representation is routed through the same cost model when
the caller hands over a measured :class:`~repro_torch.kernels.autotune.
CrossoverTable`: a measured-slower CUDA cell removes DEDUP-C's kernel
advantage and can flip the device recommendation back to EXP for
mildly-expanding graphs (``device_representation_costs``).  The port's
copy of the JAX package's module: the same recommendation, field for
field, for the same graph and table.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .condensed import CondensedGraph, ExpansionAccounting
from .cost import (  # noqa: F401  (re-exported plan API)
    ExtractionPlan,
    PlanConfig,
    PlanReport,
    Throughputs,
    device_representation_costs,
    plan,
)

__all__ = [
    "Recommendation",
    "recommend",
    "plan",
    "ExtractionPlan",
    "PlanConfig",
    "PlanReport",
    "Throughputs",
]


@dataclasses.dataclass
class Recommendation:
    host_representation: str
    device_representation: str
    reason: str
    expansion_ratio: float
    duplication_ratio: float
    # evidence for the expansion sweep the ratios came from: chunk/run
    # residency under the caller's budget (None only if stats were
    # injected some other way)
    expansion_accounting: Optional[ExpansionAccounting] = None
    # measured device costs (µs per pass) when a CrossoverTable was given
    device_costs: Optional[dict] = None


def _route_device(
    rec: Recommendation, graph: CondensedGraph, crossover, n_features: int
) -> Recommendation:
    """Re-decide the device column from measured kernel timings.

    The ladder's device pick assumes the condensed SpMM wins on the
    kernel; a measured CrossoverTable can contradict that.  Only the
    DEDUP-C pick is revisited — EXP/C-DUP picks have no kernel leg."""
    if crossover is None or rec.device_representation != "DEDUP-C":
        return rec
    costs = device_representation_costs(
        rec.expansion_ratio, rec.duplication_ratio, crossover,
        n_src=graph.n_real, n_features=n_features,
    )
    if costs is None:
        return rec
    rec = dataclasses.replace(rec, device_costs=costs)
    if costs["EXP"] < costs["DEDUP-C"]:
        return dataclasses.replace(
            rec,
            device_representation="EXP",
            reason=rec.reason + (
                "; measured CrossoverTable makes DEDUP-C "
                f"{costs['DEDUP-C']:.1f}us/pass vs EXP "
                f"{costs['EXP']:.1f}us/pass — device flips to EXP"
            ),
        )
    return rec


def recommend(
    graph: CondensedGraph,
    workload: str = "multi_pass",          # 'point' | 'single_pass' | 'multi_pass' | 'repeated'
    duplicate_sensitive: bool = True,
    expand_margin: float = 1.2,
    budget_triples: Optional[int] = None,
    chunk_rows: Optional[int] = None,
    crossover=None,
    n_features: int = 128,
) -> Recommendation:
    """Recommend host/device representations for ``graph``.

    The sizing stats are measured with one budgeted
    :meth:`~repro_torch.core.condensed.CondensedGraph.expansion_stats` sweep
    (previously two unbudgeted full expansions — an advisor call could
    blow the memory wall it exists to warn about).  ``budget_triples``
    bounds that sweep's resident triples; the
    :class:`~repro_torch.core.condensed.ExpansionAccounting` evidence rides on
    ``Recommendation.expansion_accounting``.

    ``crossover`` (a measured :class:`~repro_torch.kernels.autotune.
    CrossoverTable`) routes the device column through the cost model
    (DESIGN.md §12): a DEDUP-C pick survives only while the measured
    kernel timings actually favor it at ``n_features``-wide batches.
    """
    cond = max(graph.n_edges_condensed, 1)
    acct = ExpansionAccounting(budget_triples=budget_triples)
    exp_edges, dup = graph.expansion_stats(
        chunk_rows=chunk_rows,
        budget_triples=budget_triples,
        accounting=acct,
    )
    ratio = exp_edges / cond

    if ratio <= expand_margin:
        return Recommendation(
            "EXP", "EXP",
            f"expansion grows edges only {ratio:.2f}x (<= {expand_margin}); "
            "paper §6.5 suggests expanding outright",
            ratio, dup, acct,
        )
    if not duplicate_sensitive or workload == "point":
        return Recommendation(
            "C-DUP", "C-DUP",
            "duplicate-insensitive or point workload: operate on C-DUP "
            "directly (paper §4.1/§6.5)",
            ratio, dup, acct,
        )
    if workload == "repeated":
        rep = "DEDUP-2" if graph.is_single_layer() else "DEDUP-1"
        rec = Recommendation(
            rep, "DEDUP-C",
            "repeated analyses amortize one-time dedup rewriting "
            "(paper §6.5); device engine uses the vectorized correction",
            ratio, dup, acct,
        )
        return _route_device(rec, graph, crossover, n_features)
    rec = Recommendation(
        "BITMAP-2", "DEDUP-C",
        "multi-pass duplicate-sensitive analytics: BITMAP-2 on host "
        "iterators; correction-SpMV on device (DESIGN.md §2)",
        ratio, dup, acct,
    )
    return _route_device(rec, graph, crossover, n_features)
