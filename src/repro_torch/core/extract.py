"""End-to-end graph extraction: DSL text + Catalog -> CondensedGraph (§4.2).

Steps (paper §4.2):
  1. execute Nodes statements, build the real-node id space;
  2. plan every Edges statement (chain order + large-output marking);
  3. execute small-output segments eagerly ("handed to the database");
  4. create a virtual-node layer per postponed join attribute;
  5. assemble BipartiteEdges per segment into Chains (direct edges when a
     statement has no postponed join);
  6. optional preprocessing: expand cheap virtual nodes (Step 6).

This is the one-shot pipeline of the JAX package's ``extract_query``;
its graphs are identical array for array.  Sharded, budgeted, spilled and
plan-driven extraction are not ported yet (ROADMAP.md, Queue 1 item 8):
asking for them raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .condensed import BipartiteEdges, Chain, CondensedGraph
from .dsl import ExtractionQuery, Rule, parse
from .planner import ChainPlan, bind_atom, execute_segment, plan_rule
from .relational import Catalog

__all__ = [
    "ExtractionResult",
    "NodeSpace",
    "extract",
    "extract_query",
]

_SHARDED_TODO = (
    "sharded / budgeted / spilled / plan-driven extraction is not ported "
    "yet (ROADMAP.md, Queue 1 item 8: sharded and spilled extraction "
    "with serialize.py)"
)


@dataclasses.dataclass
class NodeSpace:
    """Raw node keys <-> dense ids, with per-type bookkeeping (paper §4.2
    Step 1: the real-node id space every chain endpoint indexes into).

    ``keys`` must be sorted strictly ascending: :meth:`lookup` is a
    ``searchsorted``, so it is asserted at construction.
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
                "(searchsorted lookups rely on it)"
            )

    @property
    def n(self) -> int:
        return int(self.keys.size)

    def lookup(self, values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Map raw keys to dense ids; second array = found mask."""
        values = np.asarray(values)
        if self.n == 0:
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
    the condensed graph, the node id space and the per-rule plans."""

    graph: CondensedGraph
    nodes: NodeSpace
    plans: List[ChainPlan]
    seconds: float
    dropped_endpoints: int
    mode: str
    n_shards: int = 1



def _build_node_space(
    catalog: Catalog, rules: Sequence[Rule]
) -> Tuple[NodeSpace, Dict[str, np.ndarray]]:
    """Node-space build (paper §4.2 Step 1): concatenate every Nodes
    rule's keys, dedup with first-occurrence wins for the type id, then
    scatter the property columns in rule order (later rules overwrite)."""
    key_parts: List[np.ndarray] = []
    type_parts: List[np.ndarray] = []
    prop_parts: Dict[str, List[Tuple[np.ndarray, np.ndarray]]] = {}
    type_names: List[str] = []
    for rule in rules:
        if len(rule.atoms) != 1:
            raise ValueError("Nodes statements bind one relation each")
        t = bind_atom(catalog, rule.atoms[0], rule.comparisons)
        keys = t.column(rule.head_vars[0])
        type_names.append(rule.atoms[0].relation)
        key_parts.append(keys)
        type_parts.append(np.full(keys.size, len(type_names) - 1, dtype=np.int32))
        for prop in rule.head_vars[1:]:
            prop_parts.setdefault(prop, []).append((keys, t.column(prop)))
    all_keys = np.concatenate(key_parts)
    all_types = np.concatenate(type_parts)
    uniq, first = np.unique(all_keys, return_index=True)
    space = NodeSpace(keys=uniq, type_ids=all_types[first], type_names=type_names)
    props: Dict[str, np.ndarray] = {}
    for name, parts in prop_parts.items():
        out = np.zeros(space.n, dtype=parts[0][1].dtype)
        for keys, vals in parts:
            idx, found = space.lookup(keys)
            out[idx[found]] = vals[found]
        props[name] = out
    return space, props


def _assemble_rule(
    nodes: NodeSpace,
    seg_results: Sequence[Tuple[np.ndarray, np.ndarray]],
    layer_keys: Sequence[np.ndarray],
) -> Tuple[Chain, int]:
    """Paper §4.2 Steps 4–5 for one Edges rule with postponed joins: map
    segment endpoint values into the real node space / the virtual layer
    key spaces and wrap the per-segment ``BipartiteEdges`` in a
    :class:`Chain`.  Returns the chain and the count of dropped real
    endpoints."""
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


def extract_query(
    catalog: Catalog,
    query: ExtractionQuery,
    mode: str = "auto",
    preprocess: bool = False,
    n_shards: int = 1,
    budget: Optional[object] = None,
    spill_dir: Optional[str] = None,
    plan: Optional[object] = None,
) -> ExtractionResult:
    """Plan + execute a parsed extraction query (paper §4.2 Steps 1–6).

    ``mode`` selects join postponement (see :func:`plan_rule`);
    ``preprocess`` applies the paper's Step-6 cheap-virtual-node
    expansion.  ``n_shards != 1``, ``budget``, ``spill_dir`` and ``plan``
    select pipelines that are not ported yet and raise
    ``NotImplementedError``.
    """
    if n_shards != 1 or budget is not None or spill_dir is not None or plan is not None:
        raise NotImplementedError(_SHARDED_TODO)
    t0 = time.perf_counter()
    nodes, props = _build_node_space(catalog, query.nodes_rules)

    chains: List[Chain] = []
    direct_s: List[np.ndarray] = []
    direct_d: List[np.ndarray] = []
    plans: List[ChainPlan] = []
    dropped = 0

    for rule in query.edges_rules:
        rule_plan = plan_rule(catalog, rule, mode=mode)
        plans.append(rule_plan)
        id1, id2 = rule_plan.endpoint_vars
        # Segment endpoint variables: ID1, large attrs..., ID2
        large_vars = [v for v, l in zip(rule_plan.link_vars, rule_plan.large) if l]
        seg_vars = [id1] + large_vars + [id2]
        seg_results = [
            execute_segment(catalog, rule_plan, seg, seg_vars[k], seg_vars[k + 1])
            for k, seg in enumerate(rule_plan.segments)
        ]
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
        # Virtual-node key space per postponed attribute (paper §4.2 Step
        # 4): the distinct values seen on both sides of each boundary.
        layer_keys = [
            np.unique(np.concatenate([seg_results[k][1], seg_results[k + 1][0]]))
            for k in range(len(large_vars))
        ]
        chain, d = _assemble_rule(nodes, seg_results, layer_keys)
        dropped += d
        chains.append(chain)

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
    return ExtractionResult(
        graph=graph,
        nodes=nodes,
        plans=plans,
        seconds=time.perf_counter() - t0,
        dropped_endpoints=dropped,
        mode=mode,
    )


def extract(
    catalog: Catalog,
    dsl_text: str,
    mode: str = "auto",
    preprocess: bool = False,
    n_shards: int = 1,
    budget: Optional[object] = None,
    spill_dir: Optional[str] = None,
    plan: Optional[object] = None,
) -> ExtractionResult:
    """Parse + plan + execute a DSL program against a catalog (paper §4.2;
    the Fig-1 entry point).  One-shot only; see :func:`extract_query`."""
    return extract_query(
        catalog, parse(dsl_text), mode=mode, preprocess=preprocess,
        n_shards=n_shards, budget=budget, spill_dir=spill_dir, plan=plan,
    )
