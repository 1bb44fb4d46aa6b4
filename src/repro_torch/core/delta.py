"""Incremental extraction: a :class:`CondensedGraph` that stays fresh
under table writes (DESIGN.md §9).

The paper extracts once; production databases mutate continuously.  The
observation that makes incremental maintenance *exact* (byte-identical to
re-extraction, not approximately fresh) is that the sharded pipeline's
merge is already an associative monoid over contiguous partitions of
every segment's output (DESIGN.md §7/§8) — so a row delta is just one
more partition:

* **binding is row-local** (:func:`repro_torch.core.planner._bind_table_rows`):
  the mutated table is ``old[keep] ++ inserts``, so its bound rows are
  the surviving old bound rows followed by the bound insert rows — a
  two-part contiguous partition ``(kept, delta)``;
* **the node space is a first-occurrence-wins sorted-key union**
  (:func:`repro_torch.core.extract._node_space_from_parts`): applying the
  delete mask to the cached key parts *is* the tombstone — a key whose
  every occurrence was deleted never reaches the union;
* **the shard merge** (:func:`repro_torch.core.serialize.merge_assemblies`)
  turns per-part assemblies back into the one-shot build, byte for byte.

:class:`LiveGraph` caches the per-rule bound tables, segment outputs and
assembled chains of the base extraction; :meth:`LiveGraph.apply_delta`
re-binds only the touched tables, re-executes only the touched
multi-atom segments, assembles one :class:`ShardAssembly` per delta
partition, merges, and bumps a monotonic :class:`GraphVersion` the
device layer and :class:`repro_torch.serve.server.GraphQueryServer` use for
cache invalidation.  Durability comes from the write-ahead
:class:`repro_torch.core.serialize.DeltaLog` — every delta is logged (append
-> fsync -> manifest-last) *before* it is applied, so a crashed update
replays to the identical graph via :meth:`LiveGraph.replay`.

The port's copy of the JAX package's module of the same name: host NumPy
over the port's extraction modules, so a live graph stays byte-identical
to the JAX package's after the same deltas, and a log either package
wrote replays in the other.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .dsl import ExtractionQuery, parse
from .extract import (
    ExtractionResult,
    NodeSpace,
    _assemble_rule,
    _graph_from_assembly,
    _local_layer_keys,
    _node_space_from_parts,
    _plans_info,
    bind_atom,
)
from .condensed import Chain, CondensedGraph
from .planner import (
    ChainPlan,
    ExtractionBudget,
    _bind_table_rows,
    execute_segment,
    execute_segment_shard,
    plan_rule,
)
from .relational import Catalog, Table
from .serialize import DeltaLog, ShardAssembly, merge_assemblies

__all__ = [
    "GraphVersion",
    "LiveGraph",
    "apply_delta",
    "mutate_catalog",
]

# Delta specs (the shapes DeltaLog.append stores and replays):
#   inserts: {table_name: {column_name: values}}   rows appended
#   deletes: {table_name: (key_column, values)}    rows whose key matches
Inserts = Dict[str, Dict[str, np.ndarray]]
Deletes = Dict[str, Tuple[str, np.ndarray]]


@dataclasses.dataclass(frozen=True, order=True)
class GraphVersion:
    """Monotonic version of a live graph: bumped by every
    :func:`apply_delta` (including an empty one — the write was
    acknowledged, so caches keyed on the old version must die).  The
    device containers carry it as their ``graph_version`` field, and
    :class:`repro_torch.serve.server.GraphQueryServer` rejects stale-version
    submits outright (DESIGN.md §9)."""

    version: int

    def __int__(self) -> int:
        return int(self.version)

    def __index__(self) -> int:
        return int(self.version)


# ---------------------------------------------------------------------------
# Canonical delta semantics (shared by apply_delta and the test reference)
# ---------------------------------------------------------------------------

def _mutate_table(
    table: Table,
    ins_cols: Optional[Dict[str, np.ndarray]],
    del_spec: Optional[Tuple[str, np.ndarray]],
) -> Tuple[Table, int, int, int]:
    """Apply one table's delta; returns ``(new_table, n_kept, n_deleted,
    n_inserted)``.  Deletes first (drop every row whose key column takes
    a deleted value), then inserts appended at the end — so a
    delete-then-reinsert of the same key lands at the table's tail, and
    ``n_kept`` is the base-row index where the insert partition begins
    (the split point the incremental bind partitions at)."""
    keep = np.ones(len(table), dtype=bool)
    if del_spec is not None:
        key_col, values = del_spec
        if key_col not in table.column_names:
            raise ValueError(
                f"delete key column {key_col!r} not in table "
                f"{table.name!r} ({table.column_names})"
            )
        keep &= ~np.isin(table.column(key_col), np.asarray(values))
    n_deleted = int(keep.size - keep.sum())
    n_kept = int(keep.sum())
    keep_rows = np.nonzero(keep)[0]
    cols = {c: table.column(c)[keep_rows] for c in table.column_names}
    n_inserted = 0
    if ins_cols:
        if set(ins_cols) != set(table.column_names):
            raise ValueError(
                f"insert into {table.name!r} must give exactly columns "
                f"{table.column_names}, got {sorted(ins_cols)}"
            )
        arrays = {c: np.asarray(ins_cols[c]) for c in table.column_names}
        sizes = {a.shape[0] for a in arrays.values()}
        if len(sizes) != 1:
            raise ValueError(
                f"insert columns for {table.name!r} have unequal lengths"
            )
        n_inserted = sizes.pop()
        cols = {
            c: np.concatenate([cols[c], arrays[c]])
            for c in table.column_names
        }
    return Table(table.name, cols), n_kept, n_deleted, n_inserted


def _mutate_catalog_info(
    catalog: Catalog, inserts: Optional[Inserts], deletes: Optional[Deletes]
) -> Tuple[Catalog, Dict[str, Tuple[int, int, int]]]:
    """Apply a delta to every touched table; returns the new catalog plus
    ``{lowercase_name: (n_kept, n_deleted, n_inserted)}`` for the touched
    tables.  Untouched :class:`Table` objects are *reused* (their cached
    column stats stay valid — which is why an untouched rule re-plans to
    the identical plan)."""
    ins = {k.lower(): v for k, v in (inserts or {}).items()}
    dels = {k.lower(): v for k, v in (deletes or {}).items()}
    for name in list(ins) + list(dels):
        if name not in catalog:
            raise KeyError(
                f"delta touches unknown table {name!r}; "
                f"catalog has {catalog.table_names}"
            )
    touched: Dict[str, Tuple[int, int, int, bool]] = {}
    out = Catalog()
    for name in catalog.table_names:
        t = catalog.table(name)
        if name in ins or name in dels:
            t2, n_kept, n_del, n_ins = _mutate_table(
                t, ins.get(name), dels.get(name)
            )
            # dtype-preserved: concatenating the inserts did not promote
            # any column (e.g. a wider unicode or int->float), so bound
            # values of the base rows are bit-identical to the cached
            # ones — the precondition of the append-only fast path
            preserved = all(
                t2.column(c).dtype == t.column(c).dtype
                for c in t.column_names
            )
            touched[name] = (n_kept, n_del, n_ins, preserved)
            t = t2
        out.add(t)
    return out, touched


def mutate_catalog(
    catalog: Catalog,
    inserts: Optional[Inserts] = None,
    deletes: Optional[Deletes] = None,
) -> Catalog:
    """The canonical delta semantics, applied to a plain catalog: per
    touched table, delete every row whose key column matches a deleted
    value, then append the insert rows.  :func:`apply_delta` maintains
    the live graph so it is byte-identical to
    ``extract(mutate_catalog(catalog, inserts, deletes), dsl)`` — this
    function is that reference, and the property tests compare against
    it directly."""
    out, _ = _mutate_catalog_info(catalog, inserts, deletes)
    return out


# ---------------------------------------------------------------------------
# Live graph
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _RuleCache:
    """Everything one Edges rule's base extraction produced, kept so an
    untouched rule costs nothing on the next delta: the plan, the
    per-segment endpoint values, and the assembled entry (chain + global
    layer keys, or direct dense-id edges)."""

    plan: ChainPlan
    seg_vars: List[str]
    large_vars: List[str]
    seg_values: List[Tuple[np.ndarray, np.ndarray]]
    chain: Optional[Tuple[Chain, List[np.ndarray]]]
    direct: Optional[Tuple[np.ndarray, np.ndarray]]
    dropped: int


class LiveGraph:
    """A condensed graph plus the extraction state needed to keep it
    fresh under writes (DESIGN.md §9).

    Construction runs a full extraction and caches, per Nodes rule, the
    bound table, and per Edges rule a :class:`_RuleCache`.
    :meth:`apply_delta` then maintains the graph incrementally:

    * tables: deletes first, inserts appended (:func:`mutate_catalog`);
    * node space: rebuilt from cached bound tables only when a Nodes
      relation was touched — the delete mask applied before the
      sorted-key union is the tombstone;
    * Edges rules: untouched rules (with an unchanged node space) reuse
      their assembled entry verbatim; touched rules re-bind only their
      single-atom segments (split at the insert boundary into a
      ``(kept, delta)`` partition) and re-execute only their touched
      multi-atom segments, then assemble one :class:`ShardAssembly` per
      partition and merge — the DESIGN.md §7 merge invariant makes the
      result byte-identical to a fresh extraction of the mutated tables.

    With ``log=`` attached (a fresh :class:`~repro_torch.core.serialize.
    DeltaLog`), every delta is appended to the write-ahead log *before*
    it is applied; :meth:`replay` rebuilds the identical live graph from
    the base catalog plus the log after a crash.
    """

    def __init__(
        self,
        catalog: Catalog,
        dsl_text: str,
        mode: str = "auto",
        preprocess: bool = False,
        budget: Optional[ExtractionBudget] = None,
        log: Optional[DeltaLog] = None,
    ) -> None:
        if log is not None and len(log):
            raise ValueError(
                "LiveGraph() builds the *base* graph and must start from "
                f"an empty delta log, but {log.directory!r} has "
                f"{len(log)} entries — use LiveGraph.replay() to rebuild "
                "from base catalog + log"
            )
        self.query: ExtractionQuery = parse(dsl_text)
        self.mode = mode
        self.preprocess = preprocess
        self.budget = budget
        self.log = log
        self.catalog = catalog
        self.version = 0
        self.last_apply_seconds = 0.0
        # version listeners (DESIGN.md §10): called after every successful
        # apply with (graph, GraphVersion) — the serving tier's
        # invalidation hook (result caches keyed on the old version die,
        # device residency refreshes from the new host graph)
        self._version_listeners: List = []
        self._build_full()

    # -- invalidation hooks ---------------------------------------------------
    def add_version_listener(self, callback) -> None:
        """Register ``callback(graph, version)`` to fire after every
        successful :meth:`apply_delta` (state already swapped, version
        already bumped — the callback sees exactly what a fresh reader
        would).  Listeners fire *after* the WAL append and the apply, so
        a listener crash cannot lose an acknowledged write; exceptions
        propagate to the caller of ``apply_delta``."""
        self._version_listeners.append(callback)

    def remove_version_listener(self, callback) -> None:
        self._version_listeners.remove(callback)

    # -- base build -----------------------------------------------------------
    def _build_full(self) -> None:
        t0 = time.perf_counter()
        self._node_bound: List[Table] = []
        for rule in self.query.nodes_rules:
            if len(rule.atoms) != 1:
                raise ValueError("Nodes statements bind one relation each")
            self._node_bound.append(
                bind_atom(self.catalog, rule.atoms[0], rule.comparisons)
            )
        self.nodes, self.props = self._node_space()
        self._rules: List[_RuleCache] = []
        for plan, seg_vars, large_vars in _plans_info(
            self.catalog, self.query, self.mode
        ):
            seg_values = [
                self._run_segment(self.catalog, plan, k, seg_vars)
                for k in range(len(plan.segments))
            ]
            cache = _RuleCache(
                plan, seg_vars, large_vars, seg_values, None, None, 0
            )
            self._set_entry(cache, self._assemble(
                len(self._rules), plan, large_vars, [seg_values]
            ))
            self._rules.append(cache)
        self.graph = self._finish()
        self.last_apply_seconds = time.perf_counter() - t0

    def _node_space(self) -> Tuple[NodeSpace, Dict[str, np.ndarray]]:
        """Node space from the cached bound Nodes tables — the same
        :func:`_node_space_from_parts` tail as the one-shot build, so the
        incremental rebuild cannot drift from ``extract``'s."""
        key_parts: List[np.ndarray] = []
        type_parts: List[np.ndarray] = []
        prop_parts: Dict[str, List[Tuple[np.ndarray, np.ndarray]]] = {}
        type_names: List[str] = []
        for rule, t in zip(self.query.nodes_rules, self._node_bound):
            keys = t.column(rule.head_vars[0])
            type_names.append(rule.atoms[0].relation)
            key_parts.append(keys)
            type_parts.append(
                np.full(keys.size, len(type_names) - 1, dtype=np.int32)
            )
            for prop in rule.head_vars[1:]:
                prop_parts.setdefault(prop, []).append((keys, t.column(prop)))
        return _node_space_from_parts(
            key_parts, type_parts, prop_parts, type_names
        )

    def _run_segment(
        self, catalog: Catalog, plan: ChainPlan, k: int, seg_vars: List[str]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Execute one segment eagerly.  With a budget attached the
        single-shard sharded executor runs instead of the one-shot one —
        byte-identical output (the DESIGN.md §7 parity invariant), but
        every transient is charged to the rows account."""
        seg = plan.segments[k]
        if self.budget is not None:
            return execute_segment_shard(
                catalog, plan, seg, seg_vars[k], seg_vars[k + 1],
                0, 1, self.budget,
            )
        return execute_segment(catalog, plan, seg, seg_vars[k], seg_vars[k + 1])

    # -- assembly -------------------------------------------------------------
    def _assemble(
        self,
        r: int,
        plan: ChainPlan,
        large_vars: List[str],
        parts: Sequence[List[Tuple[np.ndarray, np.ndarray]]],
        pre: Optional[ShardAssembly] = None,
    ) -> ShardAssembly:
        """Assemble each delta partition against the current node space
        and merge them in partition order.  ``parts`` is a contiguous
        partition of every segment's output rows (kept rows first, then
        the delta; a fully recomputed segment contributes ``(full,
        empty)``), which is exactly the contract of the sharded merge —
        so the merged entry equals the one-shot assembly of the
        concatenated values, byte for byte.

        ``pre`` is an already-assembled leading partition (the cached
        entry on the append-only fast path); it is merged ahead of the
        value parts without re-assembling its rows."""
        live = [
            p for i, p in enumerate(parts)
            if (pre is None and i == 0) or any(sv.size for sv, _ in p)
        ]
        assemblies: List[ShardAssembly] = [] if pre is None else [pre]
        for pv in live:
            if len(plan.segments) == 1:
                sv, dv = pv[0]
                sid, sok = self.nodes.lookup(sv)
                did, dok = self.nodes.lookup(dv)
                ok = sok & dok
                assemblies.append(ShardAssembly(
                    {}, {r: (sid[ok], did[ok])}, int((~ok).sum())
                ))
            else:
                keys = _local_layer_keys(pv, len(large_vars))
                chain, d = _assemble_rule(self.nodes, pv, keys)
                assemblies.append(ShardAssembly({r: (chain, keys)}, {}, d))
        return merge_assemblies(assemblies)

    @staticmethod
    def _set_entry(cache: _RuleCache, merged: ShardAssembly) -> None:
        cache.chain = next(iter(merged.chains.values()), None)
        cache.direct = next(iter(merged.direct.values()), None)
        cache.dropped = merged.dropped

    def _finish(self) -> CondensedGraph:
        assembly = ShardAssembly(
            {r: c.chain for r, c in enumerate(self._rules) if c.chain},
            {r: c.direct for r, c in enumerate(self._rules) if c.direct},
            sum(c.dropped for c in self._rules),
        )
        return _graph_from_assembly(
            self.nodes, self.props, assembly, self.preprocess
        )

    # -- deltas ---------------------------------------------------------------
    def apply_delta(
        self,
        inserts: Optional[Inserts] = None,
        deletes: Optional[Deletes] = None,
    ) -> Tuple[CondensedGraph, GraphVersion]:
        """Apply one batch of writes; returns the fresh graph and its new
        version.  When a :class:`DeltaLog` is attached the batch is
        appended (append -> fsync -> manifest-last) *before* any state
        changes — the write-ahead order that makes a crashed apply
        replayable to the identical graph."""
        # validate against the current catalog before logging, so a bad
        # delta is rejected without leaving a poisoned log entry behind
        _mutate_catalog_info(self.catalog, inserts, deletes)
        if self.log is not None:
            self.log.append(inserts, deletes)
        return self._apply(inserts, deletes)

    def _apply(
        self, inserts: Optional[Inserts], deletes: Optional[Deletes]
    ) -> Tuple[CondensedGraph, GraphVersion]:
        t0 = time.perf_counter()
        budget = self.budget
        catalog, touched = _mutate_catalog_info(self.catalog, inserts, deletes)

        # -- node space: rebind touched Nodes tables, tombstoned union ----
        nodes_changed = False
        for i, rule in enumerate(self.query.nodes_rules):
            if rule.atoms[0].relation.lower() in touched:
                base = catalog.table(rule.atoms[0].relation)
                if budget is not None:
                    budget.charge(len(base), "delta node rebind")
                self._node_bound[i] = bind_atom(
                    catalog, rule.atoms[0], rule.comparisons
                )
                if budget is not None:
                    budget.release(len(base))
                nodes_changed = True
        if nodes_changed:
            old = self.nodes
            self.nodes, self.props = self._node_space()
            # a write that leaves the key->id mapping intact (property
            # update, delete-then-reinsert of the same key) invalidates
            # nothing downstream: chains index dense ids, and those only
            # depend on (keys, type_ids) — reuse every cached entry
            nodes_changed = not (
                old.keys.dtype == self.nodes.keys.dtype
                and np.array_equal(old.keys, self.nodes.keys)
                and np.array_equal(old.type_ids, self.nodes.type_ids)
            )

        # -- Edges rules: reuse, re-bind, or re-execute -------------------
        for r, cache in enumerate(self._rules):
            rule_touched = any(
                a.relation.lower() in touched for a in cache.plan.atoms
            )
            if not rule_touched and not nodes_changed:
                if budget is not None:
                    budget.delta_rules_reused += 1
                continue  # entry reused verbatim
            if not rule_touched:
                # segment outputs are unchanged; only the endpoint id
                # space moved — re-assemble from the cached values
                self._set_entry(cache, self._assemble(
                    r, cache.plan, cache.large_vars, [cache.seg_values]
                ))
                if budget is not None:
                    budget.delta_rules_recomputed += 1
                continue
            self._apply_rule(r, cache, catalog, touched, nodes_changed)
            if budget is not None:
                budget.delta_rules_recomputed += 1

        self.catalog = catalog
        self.graph = self._finish()
        self.version += 1
        if budget is not None:
            budget.charge_delta(
                sum(t[2] for t in touched.values()),
                sum(t[1] for t in touched.values()),
            )
        self.last_apply_seconds = time.perf_counter() - t0
        out = self.graph, GraphVersion(self.version)
        for callback in list(self._version_listeners):
            callback(*out)
        return out

    def _apply_rule(
        self,
        r: int,
        cache: _RuleCache,
        catalog: Catalog,
        touched: Dict[str, Tuple[int, int, int, bool]],
        nodes_changed: bool,
    ) -> None:
        """Incrementally recompute one touched Edges rule: keep cached
        segment outputs where possible, split re-bound single-atom
        segments at the insert boundary, fully re-execute touched
        multi-atom segments, then assemble per partition and merge.

        Append-only fast path: when the delta only *inserts* rows (no
        deletes on any table this rule reads, column dtypes preserved),
        the plan marking is unchanged, every touched segment is
        single-atom and the node space did not move, the cached merged
        entry already *is* the assembly of all pre-delta rows (by
        induction over the merge monoid) — so only the insert tail is
        bound and assembled, and merged behind the cached entry.  That
        turns the apply cost from O(table) into O(delta) + O(merge)."""
        plan, compatible = cache.plan, True
        if self.mode == "auto":
            # stats of the touched tables moved; the chain order is
            # structural (never stats-dependent) but the large-output
            # marking is — a changed marking voids the segment caches
            plan = plan_rule(catalog, cache.plan.rule, mode=self.mode)
            compatible = plan.large == cache.plan.large
        id1, id2 = plan.endpoint_vars
        large_vars = [v for v, l in zip(plan.link_vars, plan.large) if l]
        seg_vars = [id1] + large_vars + [id2]

        fast = compatible and not nodes_changed
        if fast:
            for seg in plan.segments:
                atoms = plan.atoms[seg[0]: seg[1] + 1]
                stats = [
                    touched[a.relation.lower()] for a in atoms
                    if a.relation.lower() in touched
                ]
                if not stats:
                    continue
                if len(atoms) != 1 or any(
                    n_del or not preserved
                    for _, n_del, _, preserved in stats
                ):
                    fast = False
                    break
        if fast:
            self._apply_rule_append(
                r, cache, catalog, plan, large_vars, seg_vars, touched
            )
            return

        kept: List[Tuple[np.ndarray, np.ndarray]] = []
        delta: List[Tuple[np.ndarray, np.ndarray]] = []
        new_values: List[Tuple[np.ndarray, np.ndarray]] = []
        for k, seg in enumerate(plan.segments):
            atoms = plan.atoms[seg[0]: seg[1] + 1]
            seg_touched = any(a.relation.lower() in touched for a in atoms)
            if compatible and not seg_touched:
                vals = cache.seg_values[k]
                kept.append(vals)
                delta.append((vals[0][:0], vals[1][:0]))
                new_values.append(vals)
            elif compatible and len(atoms) == 1:
                # single-atom segment: binding is row-local, so the bound
                # mutated table splits at the insert boundary into the
                # (kept, delta) partition — no join to redo
                atom = atoms[0]
                base = catalog.table(atom.relation)
                if self.budget is not None:
                    self.budget.charge(len(base), "delta segment rebind")
                bound, rows = _bind_table_rows(
                    base, atom, plan.rule.comparisons
                )
                if self.budget is not None:
                    self.budget.release(len(base))
                sv = bound.column(seg_vars[k])
                dv = bound.column(seg_vars[k + 1])
                n_kept_base = touched[atom.relation.lower()][0]
                split = int(np.searchsorted(rows, n_kept_base))
                kept.append((sv[:split], dv[:split]))
                delta.append((sv[split:], dv[split:]))
                new_values.append((sv, dv))
            else:
                # multi-atom (eager hash-join) segments interleave rows
                # from both join sides, so a row delta is not a
                # contiguous slice of the output — re-execute in full
                vals = self._run_segment(catalog, plan, k, seg_vars)
                kept.append(vals)
                delta.append((vals[0][:0], vals[1][:0]))
                new_values.append(vals)

        cache.plan = plan
        cache.seg_vars = seg_vars
        cache.large_vars = large_vars
        cache.seg_values = new_values
        self._set_entry(
            cache, self._assemble(r, plan, large_vars, [kept, delta])
        )

    def _apply_rule_append(
        self,
        r: int,
        cache: _RuleCache,
        catalog: Catalog,
        plan: ChainPlan,
        large_vars: List[str],
        seg_vars: List[str],
        touched: Dict[str, Tuple[int, int, int, bool]],
    ) -> None:
        """The append-only fast path (preconditions checked by the
        caller).  Binding is row-local and there are no deletes, so the
        bound mutated table is exactly ``cached bound rows ++ bound
        insert rows``: only the insert tail of each touched table is
        bound, assembled as the delta partition, and merged behind the
        cached entry — which by induction equals the single-part
        assembly of every pre-delta row."""
        delta: List[Tuple[np.ndarray, np.ndarray]] = []
        new_values: List[Tuple[np.ndarray, np.ndarray]] = []
        for k, seg in enumerate(plan.segments):
            atoms = plan.atoms[seg[0]: seg[1] + 1]
            vals = cache.seg_values[k]
            if not any(a.relation.lower() in touched for a in atoms):
                delta.append((vals[0][:0], vals[1][:0]))
                new_values.append(vals)
                continue
            atom = atoms[0]
            table = catalog.table(atom.relation)
            n_kept_base = touched[atom.relation.lower()][0]
            tail = Table(table.name, {
                c: table.column(c)[n_kept_base:] for c in table.column_names
            })
            if self.budget is not None:
                self.budget.charge(len(tail), "delta tail rebind")
            bound, _rows = _bind_table_rows(tail, atom, plan.rule.comparisons)
            if self.budget is not None:
                self.budget.release(len(tail))
            sv = bound.column(seg_vars[k])
            dv = bound.column(seg_vars[k + 1])
            delta.append((sv, dv))
            new_values.append((
                np.concatenate([vals[0], sv]),
                np.concatenate([vals[1], dv]),
            ))

        pre = ShardAssembly(
            {r: cache.chain} if cache.chain is not None else {},
            {r: cache.direct} if cache.direct is not None else {},
            cache.dropped,
        )
        cache.plan = plan
        cache.seg_vars = seg_vars
        cache.large_vars = large_vars
        cache.seg_values = new_values
        self._set_entry(
            cache, self._assemble(r, plan, large_vars, [delta], pre=pre)
        )

    # -- durability -----------------------------------------------------------
    @classmethod
    def replay(
        cls,
        catalog: Catalog,
        dsl_text: str,
        log: DeltaLog,
        mode: str = "auto",
        preprocess: bool = False,
        budget: Optional[ExtractionBudget] = None,
    ) -> "LiveGraph":
        """Rebuild the live graph from the *base* catalog plus a delta
        log: build the base extraction, then re-apply every certified
        log entry in order (without re-appending).  Because
        :meth:`apply_delta` logs before it mutates, this lands on the
        exact graph and version the crashed process had acknowledged —
        byte-identical, not merely equivalent.  The log stays attached,
        so subsequent applies append to it."""
        live = cls(catalog, dsl_text, mode=mode, preprocess=preprocess,
                   budget=budget)
        for ins, dels in log.entries():
            live._apply(ins, dels)
        live.log = log
        return live

    def result(self) -> ExtractionResult:
        """Package the live state as an :class:`ExtractionResult`, the
        bundle the device pipeline (:mod:`repro_torch.data.pipeline`) consumes."""
        return ExtractionResult(
            graph=self.graph,
            nodes=self.nodes,
            plans=[c.plan for c in self._rules],
            seconds=self.last_apply_seconds,
            dropped_endpoints=sum(c.dropped for c in self._rules),
            mode=self.mode,
            n_shards=1,
            budget=self.budget,
        )


def apply_delta(
    live: LiveGraph,
    inserts: Optional[Inserts] = None,
    deletes: Optional[Deletes] = None,
) -> Tuple[CondensedGraph, GraphVersion]:
    """Apply one batch of inserts/deletes to a live graph; returns
    ``(graph, version)`` with the graph byte-identical
    (:func:`repro_torch.core.condensed.graphs_identical`) to a fresh
    ``extract`` of the mutated tables and the version bumped by one.
    Module-level spelling of :meth:`LiveGraph.apply_delta`."""
    return live.apply_delta(inserts, deletes)
