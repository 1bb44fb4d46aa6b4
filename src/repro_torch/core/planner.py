"""Extraction planning: chain ordering + large-output join detection (§3.3, §4.2).

For each Edges rule the planner:

1. orders the body atoms into a join chain from the atom binding ``ID1``
   to the atom binding ``ID2`` (acyclic conjunctive queries; Case 1 of the
   paper — Case 2 falls back to full expansion);
2. estimates every join's output with catalog ``n_distinct`` statistics and
   marks it *large-output* iff  ``|R||S|/d > 2(|R|+|S|)``  (paper Step 2);
3. splits the chain into segments at large-output joins — each segment is
   executed eagerly (hash joins; "handed to the database"), each postponed
   join attribute becomes a virtual-node layer.

``mode`` overrides: ``"condensed"`` postpones every join (paper Fig 5a),
``"expanded"`` postpones none (EXP extraction), ``"auto"`` uses the stats.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .dsl import Atom, Comparison, Rule
from .relational import Catalog, Table, hash_join

__all__ = [
    "ChainPlan",
    "plan_rule",
    "bind_atom",
    "execute_segment",
    "execute_segment_sharded",
    "execute_segment_shard",
    "ExtractionBudget",
    "ExtractionBudgetError",
]


class ExtractionBudgetError(RuntimeError):
    """Raised when a shard's resident working set exceeds the budget.

    Per-shard transients (``max_resident_rows``) never spill: a violated
    budget aborts extraction so the caller can re-shard (more shards =
    smaller blocks) instead of quietly blowing host memory (DESIGN.md §7).
    Assembly buffers (``max_assembly_bytes``) raise only when no
    ``spill_dir`` was given — with one, the pipeline spills each shard's
    output to disk as the shard finishes instead (DESIGN.md §8).
    """


@dataclasses.dataclass
class ExtractionBudget:
    """Peak-resident accounting for sharded extraction (DESIGN.md §7/§8).

    The sharded-extraction analog of ``ExpansionAccounting``
    (:mod:`repro_torch.core.condensed`): one instance is threaded through the
    node-space build and every per-shard segment execution, charging each
    transient host array (bound atom blocks, filtered probe sides, join
    outputs) while it is resident.  ``peak_resident_rows`` is therefore an
    upper bound on the rows any single shard holds at once — the quantity
    that must stay bounded for larger-than-memory extraction.

    Two accounts, two units:

    * **Per-shard transients** (rows) — charged by :meth:`charge`,
      capped by ``max_resident_rows``.  A violating charge raises
      :class:`ExtractionBudgetError` immediately; transients never spill.
    * **Assembly buffers** (bytes) — each shard's *output* (the edge /
      key arrays awaiting the merge) charged by :meth:`charge_assembly`
      while resident, capped by ``max_assembly_bytes``.  Without a spill
      directory the outputs of every shard accumulate until the merge,
      so ``peak_assembly_bytes`` grows with shard count and a cap
      violation raises; with ``spill_enabled`` (the ``spill_dir=`` knob,
      DESIGN.md §8) each shard's output is written to disk and released
      as the shard finishes, so the peak stays bounded by roughly one
      shard's output no matter how many shards run, and ``spilled_bytes``
      records what went to disk instead.  Merge-phase residency (the
      tree-reduce operands) is *reported* in
      ``merge_peak_resident_bytes`` / ``n_merge_rounds`` but not capped:
      the final round's output is the condensed graph itself, which must
      fit by definition.
    """

    max_resident_rows: Optional[int] = None
    resident_rows: int = 0           # live: rows currently charged
    peak_resident_rows: int = 0      # max resident_rows ever observed
    n_shards_processed: int = 0
    n_segments_executed: int = 0
    n_rows_joined: int = 0           # total join-output rows across shards
    shard_peaks: List[int] = dataclasses.field(default_factory=list)
    _shard_peak: int = 0
    # -- assembly-buffer account (bytes; DESIGN.md §8) -------------------
    max_assembly_bytes: Optional[int] = None
    spill_enabled: bool = False      # set by the pipeline when spill_dir given
    resident_assembly_bytes: int = 0
    peak_assembly_bytes: int = 0
    spilled_bytes: int = 0           # total bytes written to spill records
    n_spilled_records: int = 0
    merge_peak_resident_bytes: int = 0  # max operand+output bytes in one merge group
    n_merge_rounds: int = 0
    # -- incremental-extraction account (core/delta.py; DESIGN.md §9) ----
    n_delta_applies: int = 0
    delta_rows_inserted: int = 0     # insert rows bound across applies
    delta_rows_deleted: int = 0      # tombstoned rows across applies
    delta_rules_reused: int = 0      # Edges rules reused verbatim
    delta_rules_recomputed: int = 0  # Edges rules re-planned/re-executed

    def charge_delta(self, n_inserted: int, n_deleted: int) -> None:
        """Record one ``core/delta.py`` ``apply_delta`` pass.  Delta
        binds and recomputed segments go through the same :meth:`charge` /
        :meth:`release` rows account as sharded extraction; these counters
        only record how much write traffic the live graph absorbed and
        how much cached work each apply salvaged."""
        self.n_delta_applies += 1
        self.delta_rows_inserted += int(n_inserted)
        self.delta_rows_deleted += int(n_deleted)

    def charge(self, n_rows: int, what: str = "rows") -> None:
        self.resident_rows += int(n_rows)
        if self.resident_rows > self.peak_resident_rows:
            self.peak_resident_rows = self.resident_rows
        if self.resident_rows > self._shard_peak:
            self._shard_peak = self.resident_rows
        if (
            self.max_resident_rows is not None
            and self.resident_rows > self.max_resident_rows
        ):
            raise ExtractionBudgetError(
                f"extraction budget exceeded: {self.resident_rows} resident "
                f"rows ({what}) > max_resident_rows={self.max_resident_rows}; "
                "increase the budget or extract with more shards"
            )

    def release(self, n_rows: int) -> None:
        self.resident_rows -= int(n_rows)

    def charge_assembly(
        self, n_bytes: int, what: str = "assembly buffer",
        spilling: bool = False,
    ) -> None:
        """Charge bytes of shard output held resident awaiting the merge.

        Raises :class:`ExtractionBudgetError` past ``max_assembly_bytes``
        unless the charging pipeline is spilling (``spilling=True``) — a
        spilling caller bounds residency by writing the buffer out and
        releasing it, so the cap is enforced by construction rather than
        by raising (a single shard output larger than the cap still
        raises: it must be resident to be built; use more shards).
        ``spilling`` is strictly per-call — the ``spill_enabled`` field
        is bookkeeping for :meth:`summary`, never an enforcement switch —
        so a budget that came out of a spilled run and is reused on a
        later non-spilling run keeps the cap enforced.
        """
        self.resident_assembly_bytes += int(n_bytes)
        if self.resident_assembly_bytes > self.peak_assembly_bytes:
            self.peak_assembly_bytes = self.resident_assembly_bytes
        if (
            self.max_assembly_bytes is not None
            and self.resident_assembly_bytes > self.max_assembly_bytes
        ):
            if not spilling:
                raise ExtractionBudgetError(
                    f"assembly budget exceeded: {self.resident_assembly_bytes} "
                    f"resident assembly bytes ({what}) > max_assembly_bytes="
                    f"{self.max_assembly_bytes}; pass spill_dir= to assemble "
                    "out of core, or raise the budget"
                )
            if int(n_bytes) > self.max_assembly_bytes:
                raise ExtractionBudgetError(
                    f"assembly budget unsatisfiable: a single {what} of "
                    f"{n_bytes} bytes exceeds max_assembly_bytes="
                    f"{self.max_assembly_bytes} even with spilling; "
                    "extract with more shards"
                )

    def release_assembly(self, n_bytes: int) -> None:
        self.resident_assembly_bytes -= int(n_bytes)

    def note_spill(self, n_bytes: int) -> None:
        """Record bytes handed off to a spill record (disk, not RAM)."""
        self.spilled_bytes += int(n_bytes)
        self.n_spilled_records += 1

    def note_merge(self, n_bytes: int) -> None:
        """Record one merge group's operand + output residency."""
        if int(n_bytes) > self.merge_peak_resident_bytes:
            self.merge_peak_resident_bytes = int(n_bytes)

    def begin_shard(self) -> None:
        self._shard_peak = self.resident_rows

    def end_shard(self) -> None:
        self.n_shards_processed += 1
        self.shard_peaks.append(self._shard_peak)
        self._shard_peak = self.resident_rows

    def summary(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "max_resident_rows": self.max_resident_rows,
            "peak_resident_rows": self.peak_resident_rows,
            "n_shards_processed": self.n_shards_processed,
            "n_segments_executed": self.n_segments_executed,
            "n_rows_joined": self.n_rows_joined,
            "peak_assembly_bytes": self.peak_assembly_bytes,
        }
        if self.max_assembly_bytes is not None:
            out["max_assembly_bytes"] = self.max_assembly_bytes
        if self.spill_enabled or self.spilled_bytes:
            out["spilled_bytes"] = self.spilled_bytes
            out["n_spilled_records"] = self.n_spilled_records
            out["n_merge_rounds"] = self.n_merge_rounds
            out["merge_peak_resident_bytes"] = self.merge_peak_resident_bytes
        if self.n_delta_applies:
            out["n_delta_applies"] = self.n_delta_applies
            out["delta_rows_inserted"] = self.delta_rows_inserted
            out["delta_rows_deleted"] = self.delta_rows_deleted
            out["delta_rules_reused"] = self.delta_rules_reused
            out["delta_rules_recomputed"] = self.delta_rules_recomputed
        return out


@dataclasses.dataclass
class ChainPlan:
    """One Edges rule's executable plan (paper §3.3/§4.2 Step 2): the
    chain-ordered atoms, the per-link large-output decisions, and the
    eager segments between postponed joins."""

    rule: Rule
    atoms: List[Atom]            # chain order
    link_vars: List[str]         # join variable between consecutive atoms
    large: List[bool]            # per link: postponed (virtual layer)?
    est_sizes: List[float]       # per link: estimated join output rows
    segments: List[Tuple[int, int]]  # inclusive atom index ranges
    endpoint_vars: Tuple[str, str]   # (ID1 var, ID2 var)

    @property
    def n_virtual_layers(self) -> int:
        return sum(self.large)

    def describe(self) -> str:
        parts = []
        for i, a in enumerate(self.atoms):
            parts.append(a.relation)
            if i < len(self.link_vars):
                tag = "**" if self.large[i] else ""
                parts.append(f"-[{self.link_vars[i]}{tag}]-")
        return " ".join(parts)


def _chain_order(rule: Rule) -> Tuple[List[Atom], List[str]]:
    """Order atoms into a chain ID1 ~> ID2 (backtracking Hamiltonian path)."""
    id1, id2 = rule.head_vars[0], rule.head_vars[1]
    atoms = list(rule.atoms)
    if len(atoms) == 1:
        a = atoms[0]
        if id1 in a.variables() and id2 in a.variables():
            return atoms, []
        raise ValueError(f"single atom must bind both {id1} and {id2}")

    starts = [i for i, a in enumerate(atoms) if id1 in a.variables()]
    if not starts:
        raise ValueError(f"no atom binds {id1}")

    def shared(a: Atom, b: Atom) -> List[str]:
        return [v for v in a.variables() if v in b.variables()]

    def backtrack(path: List[int], links: List[str]) -> Optional[Tuple[List[int], List[str]]]:
        if len(path) == len(atoms):
            if id2 in atoms[path[-1]].variables():
                return path, links
            return None
        last = atoms[path[-1]]
        for j in range(len(atoms)):
            if j in path:
                continue
            for v in shared(last, atoms[j]):
                res = backtrack(path + [j], links + [v])
                if res:
                    return res
        return None

    for s in starts:
        res = backtrack([s], [])
        if res:
            order, links = res
            return [atoms[i] for i in order], links
    raise ValueError(
        f"atoms of rule do not form a chain from {id1} to {id2} "
        "(cyclic or disconnected query — paper Case 2); "
        "use mode='expanded'"
    )


def bind_atom(catalog: Catalog, atom: Atom, comparisons: Sequence[Comparison]) -> Table:
    """Materialize an atom (paper §4.2 Step 1/3): positional column ->
    variable binding, constant/equality selections, and the rule's
    comparison predicates pushed down to the base relation scan."""
    return _bind_table(catalog.table(atom.relation), atom, comparisons)


def _bind_table(
    table: Table, atom: Atom, comparisons: Sequence[Comparison]
) -> Table:
    """:func:`bind_atom` against an explicit table — every binding step
    (constant/equality masks, comparison pushdown) is row-local, so
    binding a row slice equals slicing the bound table: the property the
    sharded pipeline uses to bind base relations block-at-a-time
    (DESIGN.md §7)."""
    out, _ = _bind_table_rows(table, atom, comparisons)
    return out


def _bind_table_rows(
    table: Table, atom: Atom, comparisons: Sequence[Comparison]
) -> Tuple[Table, np.ndarray]:
    """:func:`_bind_table` with row provenance: also returns the base-row
    indices (ascending, into ``table``) of the surviving bound rows.  The
    incremental pipeline (``core/delta.py``, DESIGN.md §9) keeps
    these so a later delete can tombstone exactly the bound rows whose
    base rows went away — the delete-mask extension of the row-local
    binding property above."""
    cols = table.column_names
    if len(atom.args) != len(cols):
        raise ValueError(
            f"atom {atom.relation}/{len(atom.args)} does not match table "
            f"arity {len(cols)} ({cols})"
        )
    mask = np.ones(len(table), dtype=bool)
    for pos, value in atom.constants:
        mask &= table.column(cols[pos]) == value
    var_cols: Dict[str, np.ndarray] = {}
    for var, col in zip(atom.args, cols):
        if var == "_":
            continue
        if var in var_cols:
            mask &= table.column(col) == var_cols[var]  # R(x, x) equality
            continue
        var_cols[var] = table.column(col)
    for cmp_ in comparisons:
        if cmp_.var in var_cols:
            mask &= np.asarray(cmp_.apply(var_cols[cmp_.var]), dtype=bool)
    rows = np.nonzero(mask)[0]
    out = Table(atom.relation, {v: c[rows] for v, c in var_cols.items()})
    return out, rows


def plan_rule(catalog: Catalog, rule: Rule, mode: str = "auto") -> ChainPlan:
    """Plan one Edges rule (paper §3.3 chain ordering + §4.2 Step 2
    large-output marking): order the body atoms into an ID1 ~> ID2 chain,
    estimate each link's join output from catalog ``n_distinct`` stats,
    and split the chain into eager segments at postponed joins.  ``mode``:
    ``'auto'`` (stats decide, the paper's ``|R||S|/d > 2(|R|+|S|)`` rule),
    ``'condensed'`` (postpone every join, Fig 5a), ``'expanded'``
    (postpone none — EXP extraction)."""
    if rule.kind != "edges":
        raise ValueError("plan_rule plans Edges rules")
    atoms, links = _chain_order(rule)
    id1, id2 = rule.head_vars[0], rule.head_vars[1]

    large: List[bool] = []
    est: List[float] = []
    for i, v in enumerate(links):
        lt = bind_atom(catalog, atoms[i], rule.comparisons)
        rt = bind_atom(catalog, atoms[i + 1], rule.comparisons)
        d = max(lt.stats(v).n_distinct, rt.stats(v).n_distinct, 1)
        size = len(lt) * len(rt) / d
        est.append(size)
        if mode == "condensed":
            large.append(True)
        elif mode == "expanded":
            large.append(False)
        else:
            large.append(size > 2 * (len(lt) + len(rt)))

    segments: List[Tuple[int, int]] = []
    start = 0
    for i, is_large in enumerate(large):
        if is_large:
            segments.append((start, i))
            start = i + 1
    segments.append((start, len(atoms) - 1))
    return ChainPlan(
        rule=rule,
        atoms=atoms,
        link_vars=links,
        large=large,
        est_sizes=est,
        segments=segments,
        endpoint_vars=(id1, id2),
    )


def execute_segment(
    catalog: Catalog,
    plan: ChainPlan,
    seg: Tuple[int, int],
    in_var: str,
    out_var: str,
) -> Tuple[np.ndarray, np.ndarray]:
    """Run one small-output segment eagerly; returns (in_values, out_values).

    This is the part the paper "hands to the database" (§4.2 Step 3): a
    sequence of small-output hash joins, projected down to the segment
    endpoints.  The whole segment is materialized on one host; for the
    partition-parallel variant see :func:`execute_segment_sharded`.
    """
    i, j = seg
    acc = bind_atom(catalog, plan.atoms[i], plan.rule.comparisons)
    for k in range(i + 1, j + 1):
        nxt = bind_atom(catalog, plan.atoms[k], plan.rule.comparisons)
        acc = hash_join(acc, nxt, plan.link_vars[k - 1], plan.link_vars[k - 1])
    if in_var not in acc.column_names or out_var not in acc.column_names:
        raise ValueError(
            f"segment {seg} missing endpoint vars {in_var}/{out_var}; "
            f"has {acc.column_names}"
        )
    return acc.column(in_var), acc.column(out_var)


def _probe_partition(
    table: Table,
    atom: Atom,
    comparisons: Sequence[Comparison],
    key_var: str,
    shard_keys: np.ndarray,
    n_blocks: int,
    budget: Optional[ExtractionBudget],
) -> Table:
    """Bind + filter the probe side of one shard's join, block by block.

    A columnar semi-join: keep only probe rows whose join key occurs in
    the shard's build-side keys (sorted-membership test, the bucket-probe
    half of a hash-partitioned join).  Dropping non-matching rows cannot
    change the join output, and — because binding is row-local and the
    surviving rows keep their relative order — it cannot change the
    output *order* either, which is what the byte-identical merge step
    relies on (DESIGN.md §7).

    The base relation is scanned in ``n_blocks`` row blocks, each bound
    and filtered before the next is touched, so the charged residency is
    one scan block plus the accumulated survivors — never a full bound
    copy of the probe table (the budget's whole point).
    """
    from .relational import shard_bounds

    parts: List[Dict[str, np.ndarray]] = []
    for lo, hi in shard_bounds(len(table), n_blocks):
        block = table.row_slice(lo, hi)
        if budget is not None:
            budget.charge(len(block), "probe scan block")
        bound = _bind_table(block, atom, comparisons)
        mask = np.isin(bound.column(key_var), shard_keys)
        part = {k: v[mask] for k, v in bound.columns.items()}
        if budget is not None:
            budget.charge(int(mask.sum()), "filtered probe rows")
            budget.release(len(block))
        parts.append(part)
    return Table(
        atom.relation,
        {k: np.concatenate([p[k] for p in parts]) for k in parts[0]},
    )


def execute_segment_sharded(
    catalog: Catalog,
    plan: ChainPlan,
    seg: Tuple[int, int],
    in_var: str,
    out_var: str,
    n_shards: int,
    budget: Optional[ExtractionBudget] = None,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Partition-parallel :func:`execute_segment` (DESIGN.md §7).

    The segment's leading *base relation* is split into ``n_shards``
    contiguous row blocks (:class:`repro_torch.core.relational.ShardedTable`,
    ``mode='rows'``) and bound block-at-a-time (binding is row-local, see
    :func:`_bind_table`); each shard joins its bound block through the
    remaining atoms, with every probe side scanned in blocks and cut down
    to the shard's live join keys by :func:`_probe_partition`.  Returns
    one ``(in_values, out_values)`` pair per shard — empty shards return
    empty arrays, and concatenating the shard results in order reproduces
    the unsharded :func:`execute_segment` output element-for-element
    (``hash_join`` enumerates build rows in order, so a contiguous build
    block yields the corresponding contiguous output slice).

    ``budget`` charges *everything* a shard makes resident — base-scan
    blocks, bound blocks, filtered probe survivors, join outputs — so
    ``peak_resident_rows`` is an honest bound on per-shard extraction
    transients (the catalog's own columns are the database substrate and
    are not charged; no full bound copy of any table is ever created on
    this path).
    """
    return [
        execute_segment_shard(
            catalog, plan, seg, in_var, out_var, s, n_shards, budget
        )
        for s in range(n_shards)
    ]


def execute_segment_shard(
    catalog: Catalog,
    plan: ChainPlan,
    seg: Tuple[int, int],
    in_var: str,
    out_var: str,
    shard_index: int,
    n_shards: int,
    budget: Optional[ExtractionBudget] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One shard of :func:`execute_segment_sharded` (DESIGN.md §7/§8).

    Runs shard ``shard_index`` of the segment's leading-base-relation row
    partition through the remaining atoms and returns its ``(in_values,
    out_values)`` pair.  Factored out of the all-shards loop so callers
    can drive shards in any grouping — in particular the out-of-core
    pipeline, which runs *every segment of one shard* before moving on,
    letting that shard's whole assembled output spill to disk while later
    shards are still unextracted, and the multi-host mapping
    (``distributed/sharding.py``'s ``extraction_shard_range``), which
    hands each process a contiguous slice of ``range(n_shards)``.  Budget
    charges are identical per ``(segment, shard)`` regardless of the
    driving order, so ``peak_resident_rows`` does not depend on who
    loops.
    """
    from .relational import ShardedTable

    i, j = seg
    sharded = ShardedTable(
        catalog.table(plan.atoms[i].relation), n_shards, mode="rows"
    )
    probe_tables = [
        catalog.table(plan.atoms[k].relation) for k in range(i + 1, j + 1)
    ]
    if budget is not None:
        budget.begin_shard()
    block = sharded.shard(shard_index)
    if budget is not None:
        budget.charge(len(block), "leading base block")
    acc = _bind_table(block, plan.atoms[i], plan.rule.comparisons)
    if budget is not None:
        budget.charge(len(acc), "bound leading block")
        budget.release(len(block))
    for k, ptab in enumerate(probe_tables):
        link = plan.link_vars[i + k]
        probe = _probe_partition(
            ptab, plan.atoms[i + 1 + k], plan.rule.comparisons,
            link, acc.column(link), n_shards, budget,
        )
        joined = hash_join(acc, probe, link, link)
        if budget is not None:
            budget.charge(len(joined), "join output")
            budget.n_rows_joined += len(joined)
            budget.release(len(acc) + len(probe))
        acc = joined
    if in_var not in acc.column_names or out_var not in acc.column_names:
        raise ValueError(
            f"segment {seg} missing endpoint vars {in_var}/{out_var}; "
            f"has {acc.column_names}"
        )
    result = (acc.column(in_var), acc.column(out_var))
    if budget is not None:
        # the shard's output is streamed into the assembly buffers (its
        # bytes are charged there via charge_assembly) — release it from
        # the per-shard transient rows account
        budget.release(len(acc))
        budget.n_segments_executed += 1
        budget.end_shard()
    return result
