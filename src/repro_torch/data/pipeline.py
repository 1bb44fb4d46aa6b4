"""Data pipelines: the graph side's sharded host -> device build.

:func:`sharded_extract_to_device` (DESIGN.md §7): relational catalog ->
budgeted sharded extraction -> device graph, with the per-layer bitmap
packing also done shard-at-a-time so no stage of the host pipeline
materializes an unbounded transient.

The JAX package's module also holds the LM and recommender batch
pipelines (``TokenPipeline``, ``sasrec_batches``, ``gnn_batch``); they
wait for the port's models (ROADMAP.md, Queue 1 item 2).
"""
from __future__ import annotations

from typing import Dict, Optional

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

    ``delta_log``: a :class:`~repro_torch.core.serialize.DeltaLog` of
    committed writes since the base catalog.  When given, the pipeline
    resumes from base graph + log via
    :meth:`~repro_torch.core.delta.LiveGraph.replay` (byte-identical to
    extracting the mutated catalog from scratch) and the device graph is
    stamped with the replayed ``graph_version`` — so a restarted server
    comes back serving the *current* graph, not the base snapshot.
    Sharded spill staging applies to the base build only (delta batches
    are small); both paths honor ``max_resident_rows``.

    ``plan``: a :class:`repro_torch.core.cost.ExtractionPlan` from
    :func:`repro_torch.core.cost.plan` (DESIGN.md §12).  When given, it
    drives both stages: extraction runs the plan's sharding/spill/budget
    config (the explicit ``n_shards`` / ``max_*`` / ``spill_dir`` knobs
    are ignored in its favor), and the device pack honors the plan's
    ``pack_method`` / ``fuse_correction`` knobs.  Incompatible with
    ``delta_log`` (a replayed graph's plan came from the base catalog).
    """
    from ..core import dedup, engine
    from ..core.extract import extract, extract_sharded

    pack_kwargs: Dict[str, object] = {}
    if plan is not None and delta_log is not None:
        raise ValueError("pass either plan= or delta_log=, not both")
    if plan is not None and packed:
        pack_kwargs = dict(plan.device_kwargs())

    graph_version = 0
    if delta_log is not None:
        from ..core.delta import LiveGraph
        from ..core.planner import ExtractionBudget

        budget = (
            ExtractionBudget(max_resident_rows=max_resident_rows)
            if max_resident_rows is not None
            else None
        )
        live = LiveGraph.replay(
            catalog, dsl_text, delta_log, mode=mode, budget=budget
        )
        res = live.result()
        graph_version = live.version
    elif plan is not None:
        res = extract(catalog, dsl_text, preprocess=False, plan=plan,
                      spill_dir=spill_dir)
    else:
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
            graph_version=graph_version, device=device, **pack_kwargs,
        )
    else:
        dev = engine.to_device(
            res.graph, correction=corr, graph_version=graph_version,
            device=device,
        )
    return res, dev
