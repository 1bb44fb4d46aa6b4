"""End-to-end graph extraction: DSL text + Catalog -> CondensedGraph (§4.2).

Steps (paper §4.2):
  1. execute Nodes statements, build the real-node id space;
  2. plan every Edges statement (chain order + large-output marking);
  3. execute small-output segments eagerly ("handed to the database");
  4. create a virtual-node layer per postponed join attribute;
  5. assemble BipartiteEdges per segment into Chains (direct edges when a
     statement has no postponed join);
  6. optional preprocessing: expand cheap virtual nodes (Step 6).

Sharded extraction (DESIGN.md §7): pass ``n_shards > 1`` (or any
``ExtractionBudget``) and every step above runs partition-parallel —
Nodes tables and segment leading atoms are split into contiguous row
shards, each shard is executed with its transients charged against the
budget, and a merge step (sorted-key :class:`NodeSpace` union, local ->
global virtual-id remap, shard-order edge concatenation) reassembles a
``CondensedGraph`` byte-identical to the unsharded build.

Out-of-core assembly (DESIGN.md §8): pass ``spill_dir=`` and the per-
shard outputs no longer accumulate in host RAM — each shard's assembled
bundle (:class:`~repro_torch.core.serialize.ShardAssembly`) is written to an
atomically-committed, byte-accounted spill record the moment the shard
finishes, and the merge becomes a log-depth tree reduce
(:func:`~repro_torch.core.serialize.tree_merge_records`) that streams spilled
shards ``merge_arity`` at a time.  A finished spill directory is
self-contained: :func:`merge_spilled_graph` rebuilds the identical
``CondensedGraph`` from disk alone (and refuses a partial spill).

The port's copy of the JAX package's pipeline, graph for graph and budget
field for budget field, ``plan=`` (an
:class:`~repro_torch.core.cost.ExtractionPlan`) included.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .condensed import BipartiteEdges, Chain, CondensedGraph
from .dsl import ExtractionQuery, Rule, parse
from .planner import (
    ChainPlan,
    ExtractionBudget,
    _bind_table,
    bind_atom,
    execute_segment,
    execute_segment_shard,
    plan_rule,
)
from .relational import Catalog, ShardedTable, Table
from .serialize import (
    ShardAssembly,
    ShardSpillStore,
    SpillError,
    merge_assemblies,
    tree_merge_records,
)

__all__ = [
    "ExtractionResult",
    "NodeSpace",
    "extract",
    "extract_query",
    "extract_sharded",
    "merge_spilled_graph",
]

@dataclasses.dataclass
class NodeSpace:
    """Raw node keys <-> dense ids, with per-type bookkeeping (paper §4.2
    Step 1: the real-node id space every chain endpoint indexes into).

    ``keys`` must be sorted strictly ascending (i.e. sorted and
    duplicate-free): :meth:`lookup` is a ``searchsorted``, and the sharded
    merge step unions per-shard key sets under the same invariant — so it
    is asserted at construction (the ``BipartiteEdges`` convention) rather
    than surfacing later as silently wrong lookups.
    """

    keys: np.ndarray          # raw key per dense id, sorted ascending
    type_ids: np.ndarray      # node-type index per dense id
    type_names: List[str]

    def __post_init__(self) -> None:
        self.keys = np.asarray(self.keys)
        if self.keys.ndim != 1:
            raise ValueError(f"keys must be 1-D, got shape {self.keys.shape}")
        if self.keys.size > 1 and not bool(np.all(self.keys[:-1] < self.keys[1:])):
            raise ValueError(
                "NodeSpace keys must be sorted strictly ascending "
                "(searchsorted lookups and shard merges rely on it)"
            )

    @property
    def n(self) -> int:
        return int(self.keys.size)

    def lookup(self, values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Map raw keys to dense ids; second array = found mask."""
        values = np.asarray(values)
        if self.n == 0:
            # clip against n-1 == -1 would index the empty key array;
            # an empty space simply finds nothing.
            return (
                np.zeros(values.shape, dtype=np.int64),
                np.zeros(values.shape, dtype=bool),
            )
        idx = np.searchsorted(self.keys, values)
        idx = np.clip(idx, 0, self.n - 1)
        found = self.keys[idx] == values
        return idx, found


@dataclasses.dataclass
class ExtractionResult:
    """Everything one extraction produced (paper §4.2 output bundle):
    the condensed graph, the node id space, the per-rule plans, and —
    when the sharded pipeline ran — the shard count and the threaded
    :class:`~repro_torch.core.planner.ExtractionBudget` accounting."""

    graph: CondensedGraph
    nodes: NodeSpace
    plans: List[ChainPlan]
    seconds: float
    dropped_endpoints: int
    mode: str
    n_shards: int = 1
    budget: Optional[ExtractionBudget] = None

    def summary(self) -> Dict[str, object]:
        out = {
            "n_real": self.graph.n_real,
            "n_virtual": self.graph.n_virtual,
            "edges_condensed": self.graph.n_edges_condensed,
            "seconds": round(self.seconds, 4),
            "mode": self.mode,
            "plans": [p.describe() for p in self.plans],
        }
        if self.n_shards != 1 or self.budget is not None:
            out["n_shards"] = self.n_shards
        if self.budget is not None:
            out["budget"] = self.budget.summary()
        return out


def _node_rule_parts(
    catalog: Catalog, rules: Sequence[Rule]
) -> List[Tuple[Rule, Table, str, int]]:
    """Bind every Nodes rule once; returns (rule, bound table, id var,
    type index) in rule order (paper §4.2 Step 1)."""
    parts = []
    for i, rule in enumerate(rules):
        if len(rule.atoms) != 1:
            raise ValueError("Nodes statements bind one relation each")
        t = bind_atom(catalog, rule.atoms[0], rule.comparisons)
        parts.append((rule, t, rule.head_vars[0], i))
    return parts


def _build_node_space(
    catalog: Catalog, rules: Sequence[Rule]
) -> Tuple[NodeSpace, Dict[str, np.ndarray]]:
    """One-shot node-space build (paper §4.2 Step 1): concatenate every
    Nodes rule's keys, dedup with first-occurrence wins for the type id.
    The sharded equivalent is :func:`_build_node_space_sharded`."""
    key_parts: List[np.ndarray] = []
    type_parts: List[np.ndarray] = []
    prop_parts: Dict[str, List[Tuple[np.ndarray, np.ndarray]]] = {}
    type_names: List[str] = []
    for rule, t, id_var, _ in _node_rule_parts(catalog, rules):
        keys = t.column(id_var)
        type_names.append(rule.atoms[0].relation)
        key_parts.append(keys)
        type_parts.append(np.full(keys.size, len(type_names) - 1, dtype=np.int32))
        for prop in rule.head_vars[1:]:
            prop_parts.setdefault(prop, []).append((keys, t.column(prop)))
    return _node_space_from_parts(key_parts, type_parts, prop_parts, type_names)


def _node_space_from_parts(
    key_parts: Sequence[np.ndarray],
    type_parts: Sequence[np.ndarray],
    prop_parts: Dict[str, List[Tuple[np.ndarray, np.ndarray]]],
    type_names: List[str],
) -> Tuple[NodeSpace, Dict[str, np.ndarray]]:
    """Bound Nodes-rule parts (in rule order) -> ``(NodeSpace, props)``.

    The first-occurrence-wins dedup + property scatter shared by the
    one-shot build above and the incremental rebuild
    (``core/delta.py``, DESIGN.md §9) — one implementation, so the
    two node spaces cannot drift.  ``key_parts`` may already carry a
    delete mask applied by the caller: a key whose every occurrence was
    masked out simply never reaches the union (the tombstone semantics)."""
    all_keys = np.concatenate(key_parts)
    all_types = np.concatenate(type_parts)
    uniq, first = np.unique(all_keys, return_index=True)
    space = NodeSpace(keys=uniq, type_ids=all_types[first], type_names=type_names)
    props = _scatter_props(space, prop_parts)
    return space, props


def _scatter_props(
    space: NodeSpace,
    prop_parts: Dict[str, List[Tuple[np.ndarray, np.ndarray]]],
) -> Dict[str, np.ndarray]:
    """Scatter per-rule property columns into the dense node space, in
    part order (later parts overwrite, matching the one-shot build)."""
    props: Dict[str, np.ndarray] = {}
    for name, parts in prop_parts.items():
        out = np.zeros(space.n, dtype=parts[0][1].dtype)
        for keys, vals in parts:
            idx, found = space.lookup(keys)
            out[idx[found]] = vals[found]
        props[name] = out
    return props


def _iter_node_shard_blocks(
    catalog: Catalog,
    rules: Sequence[Rule],
    n_shards: int,
    shard_range: Sequence[int],
    budget: Optional[ExtractionBudget],
):
    """Yield one bound Nodes-rule row shard at a time: ``(rule_index,
    rule, shard_index, bound_table, keys, unique_keys, first_local)``.

    The single implementation of the per-``(rule, shard)`` bind /
    budget-charge / unique sequence that both the in-memory candidate
    build (:func:`_build_node_space_sharded`) and the spill path
    (:func:`_spill_node_shards`) consume — they must never drift, or the
    spilled and resident node spaces stop being byte-identical.  The
    bound table is released from the budget when the caller advances the
    iterator, so each consumer must finish with one shard before asking
    for the next (both do: spill writes the record, the in-memory path
    stashes candidate arrays).
    """
    for tindex, rule in enumerate(rules):
        if len(rule.atoms) != 1:
            raise ValueError("Nodes statements bind one relation each")
        id_var = rule.head_vars[0]
        sharded = ShardedTable(
            catalog.table(rule.atoms[0].relation), n_shards, mode="rows"
        )
        for s in shard_range:
            if budget is not None:
                budget.begin_shard()
            block = sharded.shard(s)
            if budget is not None:
                budget.charge(len(block), "node-space base block")
            st = _bind_table(block, rule.atoms[0], rule.comparisons)
            if budget is not None:
                budget.charge(len(st), "bound node block")
                budget.release(len(block))
            keys = st.column(id_var)
            uk, first = np.unique(keys, return_index=True)
            yield tindex, rule, s, st, keys, uk, first
            if budget is not None:
                budget.release(len(st))
                budget.end_shard()


def _build_node_space_sharded(
    catalog: Catalog,
    rules: Sequence[Rule],
    n_shards: int,
    budget: Optional[ExtractionBudget],
) -> Tuple[NodeSpace, Dict[str, np.ndarray]]:
    """Shard-wise node-space build, byte-identical to
    :func:`_build_node_space` (DESIGN.md §7).

    Each Nodes rule's *base relation* is row-sharded and bound
    block-at-a-time (binding is row-local, so concatenated bound blocks
    equal the one-shot bound table row-for-row); every shard contributes
    its sorted unique keys tagged with the *global* bound-row index of
    their first occurrence.  The merge sorts candidates by that index and
    dedups, so the "first Nodes row wins" type assignment of the one-shot
    build is preserved exactly, while no single step ever holds more than
    one shard's scan block plus the (deduplicated) candidate set.
    """
    cand_keys: List[np.ndarray] = []
    cand_types: List[np.ndarray] = []
    cand_gidx: List[np.ndarray] = []
    prop_parts: Dict[str, List[Tuple[np.ndarray, np.ndarray]]] = {}
    type_names: List[str] = [rule.atoms[0].relation for rule in rules]
    offset = 0
    node_bytes = 0  # candidate + property buffers held until the merge
    for tindex, rule, s, st, keys, uk, first in _iter_node_shard_blocks(
        catalog, rules, n_shards, range(n_shards), budget
    ):
        cand_keys.append(uk)
        cand_types.append(np.full(uk.size, tindex, dtype=np.int32))
        cand_gidx.append(first.astype(np.int64) + offset)
        # charge what the spill path would have written as this shard's
        # node record (same bytes), so peak_assembly_bytes is comparable
        # between the accumulate-resident and spill-to-disk pipelines
        nb = int(uk.nbytes) + uk.size * 8
        for prop in rule.head_vars[1:]:
            prop_parts.setdefault(prop, []).append((keys, st.column(prop)))
        if rule.head_vars[1:]:
            nb += int(keys.nbytes) + sum(
                int(st.column(p).nbytes) for p in rule.head_vars[1:]
            )
        if budget is not None:
            budget.charge_assembly(nb, "node-shard candidates (resident)")
        node_bytes += nb
        offset += len(st)
    all_keys = np.concatenate(cand_keys)
    all_types = np.concatenate(cand_types)
    all_gidx = np.concatenate(cand_gidx)
    # sorted-key union with first-global-occurrence wins: ordering the
    # candidates by global row index makes np.unique's first-occurrence
    # index pick exactly the row the one-shot build would have picked
    order = np.argsort(all_gidx, kind="stable")
    uniq, first = np.unique(all_keys[order], return_index=True)
    space = NodeSpace(
        keys=uniq, type_ids=all_types[order][first], type_names=type_names
    )
    props = _scatter_props(space, prop_parts)
    if budget is not None:
        budget.release_assembly(node_bytes)
    return space, props


def _assemble_rule(
    nodes: NodeSpace,
    seg_results: Sequence[Tuple[np.ndarray, np.ndarray]],
    layer_keys: Sequence[np.ndarray],
) -> Tuple[Chain, int]:
    """Paper §4.2 Steps 4–5 for one Edges rule with postponed joins: map
    segment endpoint values into the real node space / the given virtual
    layer key spaces and wrap the per-segment ``BipartiteEdges`` in a
    :class:`Chain`.  ``layer_keys`` may be shard-local (the sharded path
    remaps to global ids in the merge step) or global (one-shot path).
    Returns the chain and the count of dropped real endpoints."""
    dropped = 0
    edges: List[BipartiteEdges] = []
    for k, (sv, dv) in enumerate(seg_results):
        if k == 0:
            sid, sok = nodes.lookup(sv)
            n_src = nodes.n
        else:
            sid = np.searchsorted(layer_keys[k - 1], sv)
            sok = np.ones(sid.size, dtype=bool)
            n_src = layer_keys[k - 1].size
        if k == len(seg_results) - 1:
            did, dok = nodes.lookup(dv)
            n_dst = nodes.n
        else:
            did = np.searchsorted(layer_keys[k], dv)
            dok = np.ones(did.size, dtype=bool)
            n_dst = layer_keys[k].size
        ok = sok & dok
        dropped += int((~ok).sum())
        edges.append(BipartiteEdges(sid[ok], did[ok], n_src, n_dst))
    return Chain(edges), dropped


def _local_layer_keys(
    seg_results: Sequence[Tuple[np.ndarray, np.ndarray]], n_layers: int
) -> List[np.ndarray]:
    """Virtual-node key space per postponed attribute (paper §4.2 Step 4):
    the distinct values observed on both sides of each segment boundary."""
    return [
        np.unique(np.concatenate([seg_results[k][1], seg_results[k + 1][0]]))
        for k in range(n_layers)
    ]


def extract_query(
    catalog: Catalog,
    query: ExtractionQuery,
    mode: str = "auto",
    preprocess: bool = False,
    n_shards: int = 1,
    budget: Optional[ExtractionBudget] = None,
    spill_dir: Optional[str] = None,
    merge_arity: int = 2,
    plan: Optional[object] = None,
) -> ExtractionResult:
    """Plan + execute a parsed extraction query (paper §4.2 Steps 1–6).

    ``mode`` selects join postponement (see :func:`repro_torch.core.planner.
    plan_rule`); ``preprocess`` applies the paper's Step-6 cheap-virtual-
    node expansion.  With ``n_shards > 1`` — or any ``budget``, which
    forces the instrumented pipeline even for one shard — extraction runs
    sharded (DESIGN.md §7): per-table row partitions, per-shard segment
    execution under budget accounting, and a merge step that reassembles
    a ``CondensedGraph`` byte-identical to the unsharded build.

    ``spill_dir`` additionally makes the *assembly* out of core
    (DESIGN.md §8): each shard's output is written to a spill record as
    the shard finishes instead of accumulating in RAM, and the merge
    runs as an ``merge_arity``-way tree reduce over the spilled records.
    The result is still byte-identical; assembly-budget violations
    (``budget.max_assembly_bytes``) spill instead of raising.

    ``plan`` executes a :class:`repro_torch.core.cost.ExtractionPlan`
    directly (DESIGN.md §12): the plan's config overrides ``n_shards`` /
    ``merge_arity`` / ``mode``, its budget caps are installed when the
    caller did not pass a ``budget``, and a spilling plan without an
    explicit ``spill_dir`` assembles through a temporary directory.
    """
    if plan is not None:
        cfg = plan.config
        n_shards = int(cfg.n_shards)
        merge_arity = int(cfg.merge_arity)
        mode = plan.mode
        if budget is None:
            budget = plan.make_budget()
        if cfg.spill and spill_dir is None:
            import os as _os
            import tempfile as _tempfile

            with _tempfile.TemporaryDirectory(prefix="extract-plan-") as td:
                return _extract_query_sharded(
                    catalog, query, mode, preprocess, n_shards, budget,
                    _os.path.join(td, "spill"), merge_arity,
                )
        if not cfg.spill:
            spill_dir = None
    if n_shards != 1 or budget is not None or spill_dir is not None:
        return _extract_query_sharded(
            catalog, query, mode, preprocess, max(n_shards, 1), budget,
            spill_dir, merge_arity,
        )
    t0 = time.perf_counter()
    nodes, props = _build_node_space(catalog, query.nodes_rules)

    chains: List[Chain] = []
    direct_s: List[np.ndarray] = []
    direct_d: List[np.ndarray] = []
    plans: List[ChainPlan] = []
    dropped = 0

    for rule in query.edges_rules:
        plan = plan_rule(catalog, rule, mode=mode)
        plans.append(plan)
        id1, id2 = plan.endpoint_vars
        # Segment endpoint variables: ID1, large attrs..., ID2
        large_vars = [v for v, l in zip(plan.link_vars, plan.large) if l]
        seg_vars = [id1] + large_vars + [id2]
        seg_results: List[Tuple[np.ndarray, np.ndarray]] = []
        for k, seg in enumerate(plan.segments):
            seg_results.append(
                execute_segment(catalog, plan, seg, seg_vars[k], seg_vars[k + 1])
            )
        if len(seg_results) == 1:
            # No postponed join: direct real->real edges (multiplicity kept
            # as repeated entries — this IS the expanded multiset).
            sv, dv = seg_results[0]
            sid, sok = nodes.lookup(sv)
            did, dok = nodes.lookup(dv)
            ok = sok & dok
            dropped += int((~ok).sum())
            direct_s.append(sid[ok])
            direct_d.append(did[ok])
            continue
        layer_keys = _local_layer_keys(seg_results, len(large_vars))
        chain, d = _assemble_rule(nodes, seg_results, layer_keys)
        dropped += d
        chains.append(chain)

    graph = _finish_graph(nodes, props, chains, direct_s, direct_d, preprocess)
    return ExtractionResult(
        graph=graph,
        nodes=nodes,
        plans=plans,
        seconds=time.perf_counter() - t0,
        dropped_endpoints=dropped,
        mode=mode,
    )


def _finish_graph(
    nodes: NodeSpace,
    props: Dict[str, np.ndarray],
    chains: List[Chain],
    direct_s: List[np.ndarray],
    direct_d: List[np.ndarray],
    preprocess: bool,
) -> CondensedGraph:
    """Shared tail of both pipelines: concatenate direct edges, build the
    ``CondensedGraph``, optionally run paper §4.2 Step-6 preprocessing."""
    direct = None
    if direct_s:
        ds, dd = np.concatenate(direct_s), np.concatenate(direct_d)
        if ds.size:
            direct = BipartiteEdges(ds, dd, nodes.n, nodes.n)
    graph = CondensedGraph(
        nodes.n, chains, direct, node_properties=props, node_type=nodes.type_ids
    )
    if preprocess:
        graph = graph.preprocess()
    return graph


def _plans_info(
    catalog: Catalog, query: ExtractionQuery, mode: str
) -> List[Tuple[ChainPlan, List[str], List[str]]]:
    """Plan every Edges rule once; returns ``(plan, seg_vars,
    large_vars)`` per rule — the static inputs of every shard's run."""
    info = []
    for rule in query.edges_rules:
        plan = plan_rule(catalog, rule, mode=mode)
        id1, id2 = plan.endpoint_vars
        large_vars = [v for v, l in zip(plan.link_vars, plan.large) if l]
        info.append((plan, [id1] + large_vars + [id2], large_vars))
    return info


def _extract_shard(
    catalog: Catalog,
    plans_info: Sequence[Tuple[ChainPlan, List[str], List[str]]],
    nodes: NodeSpace,
    shard_index: int,
    n_shards: int,
    budget: Optional[ExtractionBudget],
) -> ShardAssembly:
    """Run *every* Edges rule's segments for one shard and assemble the
    shard's complete output bundle (DESIGN.md §8).

    Shard-major driving order — all segments of shard ``s`` before any
    segment of shard ``s+1`` — is what makes spilling possible: the
    moment this returns, everything shard ``s`` will ever contribute is
    in one :class:`~repro_torch.core.serialize.ShardAssembly`, ready to leave
    RAM.  Per-``(segment, shard)`` budget charges are identical to the
    segment-major order of DESIGN.md §7, so ``peak_resident_rows`` is
    unchanged.
    """
    chains: Dict[int, Tuple[Chain, List[np.ndarray]]] = {}
    direct: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    dropped = 0
    for r, (plan, seg_vars, large_vars) in enumerate(plans_info):
        seg_results = [
            execute_segment_shard(
                catalog, plan, seg, seg_vars[k], seg_vars[k + 1],
                shard_index, n_shards, budget,
            )
            for k, seg in enumerate(plan.segments)
        ]
        if len(plan.segments) == 1:
            sv, dv = seg_results[0]
            sid, sok = nodes.lookup(sv)
            did, dok = nodes.lookup(dv)
            ok = sok & dok
            dropped += int((~ok).sum())
            direct[r] = (sid[ok], did[ok])
            continue
        local_keys = _local_layer_keys(seg_results, len(large_vars))
        chain_s, d = _assemble_rule(nodes, seg_results, local_keys)
        dropped += d
        chains[r] = (chain_s, local_keys)
    return ShardAssembly(chains, direct, dropped)


def _graph_from_assembly(
    nodes: NodeSpace,
    props: Dict[str, np.ndarray],
    assembly: ShardAssembly,
    preprocess: bool,
) -> CondensedGraph:
    """Fully-merged assembly -> ``CondensedGraph``, in rule order (the
    order the one-shot build appends chains and direct blocks)."""
    chains = [assembly.chains[r][0] for r in sorted(assembly.chains)]
    direct_s = [assembly.direct[r][0] for r in sorted(assembly.direct)]
    direct_d = [assembly.direct[r][1] for r in sorted(assembly.direct)]
    return _finish_graph(nodes, props, chains, direct_s, direct_d, preprocess)


def _extract_query_sharded(
    catalog: Catalog,
    query: ExtractionQuery,
    mode: str,
    preprocess: bool,
    n_shards: int,
    budget: Optional[ExtractionBudget],
    spill_dir: Optional[str] = None,
    merge_arity: int = 2,
) -> ExtractionResult:
    """The sharded pipeline behind :func:`extract_query` (DESIGN.md §7/§8).

    Identical structure to the one-shot path, except that every data-
    touching step runs per row shard: the node space is built shard-wise
    and merged by sorted key, each shard executes all its segments via
    :func:`repro_torch.core.planner.execute_segment_shard` and assembles a
    shard-local bundle over its own virtual key spaces, and the merge
    (:func:`repro_torch.core.serialize.merge_assemblies`, built on
    :func:`repro_torch.core.condensed.merge_chain_shards`) remaps those to the
    global sorted key union — producing edge arrays equal element-for-
    element to the unsharded build's.

    Without ``spill_dir`` every shard bundle stays resident until one
    single-pass merge (the §7 behaviour, assembly bytes charged to the
    budget); with it, bundles spill to disk as they finish and the merge
    is a ``merge_arity``-way tree reduce over the records (§8).
    """
    if spill_dir is not None and budget is None:
        budget = ExtractionBudget(spill_enabled=True)
    t0 = time.perf_counter()

    if spill_dir is not None:
        store = ShardSpillStore(spill_dir)
        # single-writer pipeline: drop any records a previous run left in
        # a reused directory, so finalize() certifies only this run's
        store.clear_records()
        _spill_node_shards(
            catalog, query.nodes_rules, n_shards, range(n_shards), store, budget
        )
        nodes, props = _node_space_from_spill(
            store, query.nodes_rules, n_shards, budget
        )
    else:
        store = None
        nodes, props = _build_node_space_sharded(
            catalog, query.nodes_rules, n_shards, budget
        )

    plans_info = _plans_info(catalog, query, mode)
    plans = [p for p, _, _ in plans_info]

    if store is not None:
        shard_names = _spill_chain_shards(
            catalog, plans_info, nodes, n_shards, range(n_shards), store, budget
        )
        final, merged = tree_merge_records(
            store, shard_names, arity=merge_arity, budget=budget
        )
        # the final merged assembly is the condensed graph itself — the
        # product, not an assembly buffer; its residency is already the
        # last tree round's output in merge_peak_resident_bytes
        if merged is None:  # single shard: no merge ran, read the leaf
            merged, _ = store.read_assembly(final)
        _write_nodespace_record(store, nodes, props)
        store.finalize(meta={
            "kind": "extraction_spill",
            "n_shards": n_shards,
            "n_rules": len(plans_info),
            "mode": mode,
            "preprocess": preprocess,
            "final_record": final,
        })
        graph = _graph_from_assembly(nodes, props, merged, preprocess)
    else:
        assemblies: List[ShardAssembly] = []
        charged = 0
        for s in range(n_shards):
            a = _extract_shard(catalog, plans_info, nodes, s, n_shards, budget)
            if budget is not None:
                nb = a.nbytes()
                budget.charge_assembly(nb, "shard assembly (resident)")
                charged += nb
            assemblies.append(a)
        merged = merge_assemblies(assemblies)
        if budget is not None:
            if len(assemblies) > 1:  # a single shard passes through unmerged
                budget.note_merge(charged + merged.nbytes())
            budget.release_assembly(charged)
        graph = _graph_from_assembly(nodes, props, merged, preprocess)

    return ExtractionResult(
        graph=graph,
        nodes=nodes,
        plans=plans,
        seconds=time.perf_counter() - t0,
        dropped_endpoints=merged.dropped,
        mode=mode,
        n_shards=n_shards,
        budget=budget,
    )


# ---------------------------------------------------------------------------
# Spill-phase primitives (DESIGN.md §8) — also driven, phase by phase with
# barriers between, by the JAX package's multi-host spill extraction
# ---------------------------------------------------------------------------

def _node_record_name(rule_index: int, shard_index: int) -> str:
    return f"nodes_r{rule_index:03d}_s{shard_index:05d}"


def _shard_record_name(shard_index: int) -> str:
    return f"shard_s{shard_index:05d}"


def _spill_node_shards(
    catalog: Catalog,
    rules: Sequence[Rule],
    n_shards: int,
    shard_range: Sequence[int],
    store: ShardSpillStore,
    budget: Optional[ExtractionBudget],
) -> List[str]:
    """Spill phase 1: bind each Nodes rule's row shards in ``shard_range``
    and write one candidate record per ``(rule, shard)``.

    A record holds the shard-local *NodeSpace candidates* — the block's
    sorted-unique keys plus each key's first-occurrence row index local
    to the block — and the raw property columns.  The global merge
    (:func:`_node_space_from_spill`) orders candidates by the
    lexicographic triple ``(rule, shard, local_first)``, which equals the
    global bound-row order the one-shot build dedups in, without any
    shard needing the bound row counts of shards it never saw — that is
    what lets processes spill node candidates independently and exchange
    them through the spill directory.
    """
    names: List[str] = []
    for tindex, rule, s, st, keys, uk, first in _iter_node_shard_blocks(
        catalog, rules, n_shards, shard_range, budget
    ):
        arrays: Dict[str, np.ndarray] = {
            "cand_keys": uk,
            "cand_local_first": first.astype(np.int64),
        }
        prop_names = list(rule.head_vars[1:])
        if prop_names:
            arrays["prop_keys"] = keys
            for prop in prop_names:
                arrays[f"prop_{prop}"] = st.column(prop)
        nbytes = sum(int(np.asarray(a).nbytes) for a in arrays.values())
        name = _node_record_name(tindex, s)
        if budget is not None:
            budget.charge_assembly(nbytes, "node-shard record", spilling=True)
        store.write_record(
            name, arrays,
            meta={"rule": tindex, "shard": s, "props": prop_names},
        )
        if budget is not None:
            budget.note_spill(nbytes)
            budget.release_assembly(nbytes)
        names.append(name)
    return names


def _node_space_from_spill(
    store: ShardSpillStore,
    rules: Sequence[Rule],
    n_shards: int,
    budget: Optional[ExtractionBudget],
) -> Tuple[NodeSpace, Dict[str, np.ndarray]]:
    """Spill phase 2a: global :class:`NodeSpace` + dense properties from
    *every* ``(rule, shard)`` node record in the store.

    Candidates from all records are unioned with first-occurrence-wins
    ordered by ``(rule, shard, local_first)`` — byte-identical to the
    in-memory :func:`_build_node_space_sharded` and therefore to the
    one-shot build.  Properties are then scattered in a second streaming
    pass, one record resident at a time, in the same rule-major
    shard-minor order as the in-memory scatter (later parts overwrite).
    """
    cand_keys: List[np.ndarray] = []
    cand_rule: List[np.ndarray] = []
    cand_shard: List[np.ndarray] = []
    cand_local: List[np.ndarray] = []
    type_names = [rule.atoms[0].relation for rule in rules]
    cand_bytes = 0  # the candidate union is resident until the space exists
    for r in range(len(rules)):
        for s in range(n_shards):
            # selective read: the candidate pass never touches the
            # property columns — those stream back in the scatter pass
            arrays, meta, nbytes = store.read_record(
                _node_record_name(r, s),
                names=["cand_keys", "cand_local_first"],
            )
            uk = arrays["cand_keys"]
            cand_keys.append(uk)
            cand_rule.append(np.full(uk.size, r, dtype=np.int32))
            cand_shard.append(np.full(uk.size, s, dtype=np.int64))
            cand_local.append(arrays["cand_local_first"])
            nb = int(uk.nbytes) + uk.size * (8 + 8 + 4)
            if budget is not None:
                # the union itself cannot spill (it becomes the NodeSpace),
                # so charge it report-only like the other spill-path buffers
                budget.charge_assembly(
                    nb, "node-candidate union (resident)", spilling=True
                )
            cand_bytes += nb
    all_keys = np.concatenate(cand_keys)
    all_rule = np.concatenate(cand_rule)
    # first-global-occurrence wins: (rule, shard, local_first) is the
    # bound-row concat order of the one-shot build, lexsorted
    order = np.lexsort(
        (np.concatenate(cand_local), np.concatenate(cand_shard), all_rule)
    )
    uniq, first = np.unique(all_keys[order], return_index=True)
    space = NodeSpace(
        keys=uniq, type_ids=all_rule[order][first], type_names=type_names
    )
    if budget is not None:
        budget.release_assembly(cand_bytes)
    # streaming property scatter, rule-major shard-minor (= part order of
    # the in-memory build; later parts overwrite)
    props: Dict[str, np.ndarray] = {}
    for r, rule in enumerate(rules):
        prop_names = list(rule.head_vars[1:])
        if not prop_names:
            continue
        for s in range(n_shards):
            arrays, meta, nbytes = store.read_record(
                _node_record_name(r, s),
                names=["prop_keys"] + [f"prop_{p}" for p in prop_names],
            )
            # charge what was actually read (the selective load skips the
            # candidate arrays), not the record's total
            read_bytes = sum(int(a.nbytes) for a in arrays.values())
            if budget is not None:
                budget.charge_assembly(
                    read_bytes, "node-record scatter", spilling=True
                )
            keys = arrays["prop_keys"]
            idx, found = space.lookup(keys)
            for prop in prop_names:
                vals = arrays[f"prop_{prop}"]
                if prop not in props:
                    props[prop] = np.zeros(space.n, dtype=vals.dtype)
                props[prop][idx[found]] = vals[found]
            if budget is not None:
                budget.release_assembly(read_bytes)
    return space, props


def _spill_chain_shards(
    catalog: Catalog,
    plans_info: Sequence[Tuple[ChainPlan, List[str], List[str]]],
    nodes: NodeSpace,
    n_shards: int,
    shard_range: Sequence[int],
    store: ShardSpillStore,
    budget: Optional[ExtractionBudget],
) -> List[str]:
    """Spill phase 2b: extract each shard in ``shard_range`` (all rules,
    all segments) and write its :class:`ShardAssembly` record the moment
    it completes — the shard's output leaves RAM before the next shard's
    extraction begins, which is the whole out-of-core point."""
    names: List[str] = []
    for s in shard_range:
        assembly = _extract_shard(catalog, plans_info, nodes, s, n_shards, budget)
        nbytes = assembly.nbytes()
        name = _shard_record_name(s)
        if budget is not None:
            budget.charge_assembly(nbytes, "shard assembly", spilling=True)
        store.write_assembly(name, assembly)
        if budget is not None:
            budget.note_spill(nbytes)
            budget.release_assembly(nbytes)
        names.append(name)
    return names


def _write_nodespace_record(
    store: ShardSpillStore, nodes: NodeSpace, props: Dict[str, np.ndarray]
) -> int:
    """Persist the merged node space so a finished spill directory is
    self-contained (:func:`merge_spilled_graph` needs no catalog)."""
    arrays: Dict[str, np.ndarray] = {"keys": nodes.keys, "type_ids": nodes.type_ids}
    for name, arr in props.items():
        arrays[f"prop_{name}"] = np.asarray(arr)
    return store.write_record(
        "nodespace", arrays,
        meta={"type_names": nodes.type_names, "props": sorted(props)},
    )


def _read_nodespace_record(
    store: ShardSpillStore,
) -> Tuple[NodeSpace, Dict[str, np.ndarray]]:
    arrays, meta, _ = store.read_record("nodespace")
    nodes = NodeSpace(
        keys=arrays["keys"], type_ids=arrays["type_ids"],
        type_names=list(meta["type_names"]),
    )
    props = {name: arrays[f"prop_{name}"] for name in meta["props"]}
    return nodes, props


def merge_spilled_graph(
    spill_dir: str,
    merge_arity: int = 2,
    budget: Optional[ExtractionBudget] = None,
    reuse_final: bool = True,
) -> Tuple[CondensedGraph, NodeSpace]:
    """Rebuild the ``CondensedGraph`` from a finished spill directory
    alone — no catalog, no re-extraction (DESIGN.md §8).

    Validates the spill first (:meth:`ShardSpillStore.open`): a partial
    directory — missing closing manifest, missing or truncated records,
    uncommitted ``*.tmp-*`` litter — raises
    :class:`~repro_torch.core.serialize.SpillError` instead of being silently
    merged.  The writing run records its fully-merged partial in the
    manifest (``final_record``); with ``reuse_final`` (the default) that
    record is loaded directly — a pure read, safe on read-only storage.
    With ``reuse_final=False`` (or when the final record is absent) the
    per-shard assembly records are tree-reduced again ``merge_arity`` at
    a time.  Either way the graph is byte-identical to the extraction
    that wrote the spill (and to the unsharded build).
    """
    store = ShardSpillStore.open(spill_dir)
    meta = store.manifest()["meta"]
    if meta.get("kind") != "extraction_spill":
        raise SpillError(
            f"{spill_dir!r} is not an extraction spill (kind={meta.get('kind')!r})"
        )
    n_shards = int(meta["n_shards"])
    nodes, props = _read_nodespace_record(store)
    final_record = meta.get("final_record")
    if reuse_final and final_record and store.has_record(final_record):
        merged, _ = store.read_assembly(final_record)
    else:
        shard_names = [_shard_record_name(s) for s in range(n_shards)]
        missing = [n for n in shard_names if not store.has_record(n)]
        if missing:
            raise SpillError(f"spill is missing shard records: {missing}")
        final, merged = tree_merge_records(
            store, shard_names, arity=merge_arity, out_prefix="remerge_",
            budget=budget,
        )
        if merged is None:
            merged, _ = store.read_assembly(final)
        if final.startswith("remerge_"):
            store.delete_record(final)
    graph = _graph_from_assembly(nodes, props, merged, bool(meta["preprocess"]))
    return graph, nodes


def extract(
    catalog: Catalog,
    dsl_text: str,
    mode: str = "auto",
    preprocess: bool = False,
    n_shards: int = 1,
    budget: Optional[ExtractionBudget] = None,
    spill_dir: Optional[str] = None,
    merge_arity: int = 2,
    plan: Optional[object] = None,
) -> ExtractionResult:
    """Parse + plan + execute a DSL program against a catalog (paper §4.2;
    the Fig-1 entry point).  ``n_shards`` / ``budget`` select the sharded
    pipeline (DESIGN.md §7); ``spill_dir`` makes assembly out-of-core
    with a ``merge_arity``-way tree-reduce merge (DESIGN.md §8).

    ``plan`` takes a :class:`repro_torch.core.cost.ExtractionPlan` (from
    :func:`repro_torch.core.cost.plan`, DESIGN.md §12): its config
    supplies the sharding / spill / merge-arity knobs and its budget
    caps."""
    return extract_query(
        catalog, parse(dsl_text), mode=mode, preprocess=preprocess,
        n_shards=n_shards, budget=budget, spill_dir=spill_dir,
        merge_arity=merge_arity, plan=plan,
    )


def extract_sharded(
    catalog: Catalog,
    dsl_text: str,
    n_shards: int,
    max_resident_rows: Optional[int] = None,
    mode: str = "auto",
    preprocess: bool = False,
    spill_dir: Optional[str] = None,
    max_assembly_bytes: Optional[int] = None,
    merge_arity: int = 2,
) -> ExtractionResult:
    """Convenience front-end for larger-than-memory extraction
    (DESIGN.md §7/§8): shard the pipeline ``n_shards`` ways and enforce
    ``max_resident_rows`` per shard (violations raise
    :class:`~repro_torch.core.planner.ExtractionBudgetError`).
    ``max_assembly_bytes`` caps the assembly buffers too: without
    ``spill_dir`` an over-cap accumulation raises; with it, shard outputs
    spill to disk as they finish and the merge streams them back
    ``merge_arity`` at a time.  The result's ``budget`` field carries the
    accounting; the graph is byte-identical to
    ``extract(catalog, dsl_text)``'s either way.
    """
    budget = ExtractionBudget(
        max_resident_rows=max_resident_rows,
        max_assembly_bytes=max_assembly_bytes,
    )
    return extract(
        catalog, dsl_text, mode=mode, preprocess=preprocess,
        n_shards=n_shards, budget=budget, spill_dir=spill_dir,
        merge_arity=merge_arity,
    )
