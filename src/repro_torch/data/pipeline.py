"""Data pipelines: the graph side's sharded host -> device build.

:func:`sharded_extract_to_device` (DESIGN.md §7): relational catalog ->
budgeted sharded extraction -> device graph, with the per-layer bitmap
packing also done shard-at-a-time so no stage of the host pipeline
materializes an unbounded transient.

The JAX package's module also holds the LM and recommender batch
pipelines (``TokenPipeline``, ``sasrec_batches``, ``gnn_batch``); they
wait for the port's models (ROADMAP.md, Queue 1 item 6).
"""
from __future__ import annotations

from typing import Optional

__all__ = ["sharded_extract_to_device"]


def sharded_extract_to_device(
    catalog,
    dsl_text: str,
    n_shards: int,
    max_resident_rows: Optional[int] = None,
    mode: str = "auto",
    packed: bool = False,
    pack_shard_edges: Optional[int] = None,
    correction_budget_triples: Optional[int] = None,
    spill_dir: Optional[str] = None,
    max_assembly_bytes: Optional[int] = None,
    delta_log: Optional[object] = None,
    plan: Optional[object] = None,
    device="cuda",
):
    """Catalog -> budgeted sharded extraction -> device graph, end to end.

    The larger-than-memory serving pipeline (DESIGN.md §7/§8): extraction
    runs in ``n_shards`` row partitions with per-shard transients capped
    at ``max_resident_rows`` (violations raise — see
    :class:`repro_torch.core.planner.ExtractionBudget`) and — when
    ``spill_dir`` is given — per-shard outputs spilled to disk as each
    shard finishes, tree-reduce merged instead of held resident
    (``max_assembly_bytes`` caps the assembly buffers; without a spill
    directory an over-cap accumulation raises).  The DEDUP-C correction
    is built with the streaming fold (optionally under
    ``correction_budget_triples``), and — when ``packed`` — each layer's
    bitmap operands are packed shard-at-a-time (``pack_shard_edges``
    edges per slice) before upload to ``device``.  Returns
    ``(extraction_result, device_graph)``; the device graph is
    duplicate-exact (DEDUP-C) and identical to the one the unsharded
    pipeline would build.

    ``delta_log`` (a replayed ``DeltaLog``) waits for ``core/delta.py``
    (ROADMAP.md, Queue 1 item 1) and ``plan`` (an ``ExtractionPlan``) for
    ``core/cost.py`` (Queue 1 item 2): both raise ``NotImplementedError``.
    """
    from ..core import dedup, engine
    from ..core.extract import extract_sharded

    if delta_log is not None:
        raise NotImplementedError(
            "delta_log= is not ported yet (ROADMAP.md, Queue 1 item 1: core/delta.py)"
        )
    if plan is not None:
        raise NotImplementedError(
            "plan= is not ported yet (ROADMAP.md, Queue 1 item 2: core/cost.py)"
        )
    res = extract_sharded(
        catalog, dsl_text, n_shards=n_shards,
        max_resident_rows=max_resident_rows, mode=mode,
        spill_dir=spill_dir, max_assembly_bytes=max_assembly_bytes,
    )
    corr = dedup.build_correction_streaming(
        res.graph, budget_triples=correction_budget_triples
    )
    if packed:
        dev = engine.to_device_packed(
            res.graph, correction=corr, pack_shard_edges=pack_shard_edges,
            device=device,
        )
    else:
        dev = engine.to_device(res.graph, correction=corr, device=device)
    return res, dev
