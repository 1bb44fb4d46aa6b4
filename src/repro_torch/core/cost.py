"""Cost-based extraction optimizer (DESIGN.md §12).

The paper's §6.5 advisor picks a *representation* from two measured
ratios; the extraction pipeline has many more knobs — ``n_shards``,
rows-vs-hash partitioning, spilling, ``merge_arity``, the pack fold
method, fused-vs-unfused correction — which interact with the caller's
:class:`~repro_torch.core.planner.ExtractionBudget`.  This module chooses them
with a cost model instead of by hand:

* :func:`profile_query` binds every rule atom once (binding is row-local
  and cheap relative to extraction) and records, per atom, the exact
  bound cardinality plus the join-key fan-out stats
  (:class:`~repro_torch.core.relational.ColumnStats.max_count`) that make the
  peak bounds *sound* rather than expected.
* :func:`peak_resident_rows_bound` / :func:`assembly_account_bounds`
  replay the budget's exact charge sequences
  (:func:`~repro_torch.core.planner.execute_segment_shard`,
  ``_build_node_space_sharded``, the spill writers) symbolically and
  return upper bounds on what :class:`ExtractionBudget` will observe.
  Feasibility pruning against the caller's caps therefore cannot pass a
  plan that raises :class:`~repro_torch.core.planner.ExtractionBudgetError`.
* :func:`plan_cost` turns the profile into predicted wall seconds using
  measured throughputs where available (``CrossoverTable`` kernel
  timings, :func:`repro_torch.kernels.pack.measure_pack_throughput`) and
  analytic host floors (:data:`HOST_MEM_BW` / :data:`HOST_DISK_BW`) where
  not — the same measured-overrides-analytic precedence as kernel
  dispatch.
* :func:`plan` enumerates the bounded configuration space, prunes
  infeasible or invariant-breaking configs with an explicit reason each,
  and returns a :class:`PlanReport` whose chosen
  :class:`ExtractionPlan` executes directly through
  :func:`repro_torch.core.extract.extract` /
  :func:`repro_torch.data.pipeline.sharded_extract_to_device`.

All predictions are deterministic functions of (catalog, query, mode,
throughputs, crossover) — no clocks, no randomness — so plan choice is
reproducible, and the port's report equals the JAX package's field by
field for the same inputs (tests/test_torch_plan.py).  The crossover
table's ``'cuda'`` / ``'segment'`` backends stand where the JAX
package's ``'pallas'`` / ``'xla'`` stand.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .dsl import ExtractionQuery, parse
from .planner import ExtractionBudget, bind_atom, plan_rule
from .relational import Catalog, Table

# Analytic floors of the host NumPy extraction pipeline, not measurements
# of any machine: sequential copy/scan bytes per second of one host core,
# and the write + read-back bytes per second of a spill directory.  Kept
# equal to the JAX package's constants so that both packages choose the
# same plan; a measured Throughputs overrides them.
HOST_MEM_BW = 8e9
HOST_DISK_BW = 0.8e9

__all__ = [
    "Throughputs",
    "QueryProfile",
    "profile_query",
    "peak_resident_rows_bound",
    "peak_transient_bytes_bound",
    "assembly_account_bounds",
    "PlanConfig",
    "PlanCost",
    "ExtractionPlan",
    "PrunedPlan",
    "PlanReport",
    "plan",
    "plan_cost",
    "device_representation_costs",
    "HOST_MEM_BW",
    "HOST_DISK_BW",
]

# Charged alongside each unique-key candidate: the int64 first-occurrence
# index in the no-spill node build / the spilled candidate record.
_CAND_EXTRA = 8
# The spilled candidate *union* additionally holds int64 shard + int32
# rule tags per candidate (see extract._node_space_from_spill).
_UNION_EXTRA = 8 + 8 + 4
# Edge arrays are int64 (src, dst) pairs from lookup/searchsorted.
_EDGE_BYTES = 16


# ---------------------------------------------------------------------------
# Throughputs: measured where available, analytic floors where not
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Throughputs:
    """Rates the wall-time model divides work by.

    Defaults are conservative single-core floors derived from the analytic
    host floors above; callers with measurements
    (:func:`repro_torch.kernels.pack.measure_pack_throughput`) override
    the relevant fields.  Frozen so a ``Throughputs`` pins a
    deterministic plan choice.
    """

    scan_rows_per_s: float = 100e6       # base-relation row-slice scan
    bind_rows_per_s: float = 60e6        # selection masks + column gather
    join_rows_per_s: float = 25e6        # hash_join build+probe+emit rows
    assemble_bytes_per_s: float = HOST_MEM_BW / 4
    merge_bytes_per_s: float = HOST_MEM_BW / 8
    spill_bytes_per_s: float = HOST_DISK_BW
    shard_overhead_s: float = 2e-4       # per-shard fixed dispatch cost
    pack_reduceat_edges_per_s: float = 30e6
    pack_scatter_edges_per_s: float = 12e6
    correction_triples_per_s: float = 8e6

    def pack_edges_per_s(self, method: str) -> float:
        if method == "scatter":
            return self.pack_scatter_edges_per_s
        return self.pack_reduceat_edges_per_s

    @classmethod
    def with_measured_pack(
        cls, pack_rates: Dict[str, float], **overrides: float
    ) -> "Throughputs":
        """Build from a :func:`measure_pack_throughput` result."""
        kw: Dict[str, float] = dict(overrides)
        if "reduceat" in pack_rates:
            kw["pack_reduceat_edges_per_s"] = float(pack_rates["reduceat"])
        if "scatter" in pack_rates:
            kw["pack_scatter_edges_per_s"] = float(pack_rates["scatter"])
        return cls(**kw)


# ---------------------------------------------------------------------------
# Query profile: one bind pass, exact cardinalities + sound fan-out stats
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AtomProfile:
    """One chain atom.  For probe atoms (every atom after a segment's
    lead) the ``link_*`` fields describe the join into this atom:
    ``link_max_count`` is the most-common join-key frequency in the bound
    probe table — each accumulator row matches at most that many probe
    rows, which is what makes the join-output bounds sound."""

    relation: str
    base_rows: int
    base_row_bytes: int
    bound_rows: int
    bound_row_bytes: int
    link_max_count: int = 0       # 0 for segment leads
    link_n_distinct: int = 1      # max of both bound sides (planner's d)
    link_value_bytes: int = 8


@dataclasses.dataclass(frozen=True)
class SegmentProfile:
    atoms: Tuple[AtomProfile, ...]
    in_value_bytes: int = 8       # dtype itemsize of the in-endpoint var
    out_value_bytes: int = 8      # dtype itemsize of the out-endpoint var


@dataclasses.dataclass(frozen=True)
class RuleProfile:
    describe: str
    segments: Tuple[SegmentProfile, ...]

    @property
    def direct(self) -> bool:
        """Single-segment rules emit direct real->real edges."""
        return len(self.segments) == 1


@dataclasses.dataclass(frozen=True)
class NodeRuleProfile:
    relation: str
    base_rows: int
    base_row_bytes: int
    bound_rows: int
    key_bytes: int
    prop_bytes: int               # summed property-column itemsizes (0 = none)


@dataclasses.dataclass(frozen=True)
class QueryProfile:
    node_rules: Tuple[NodeRuleProfile, ...]
    edge_rules: Tuple[RuleProfile, ...]

    def scaled(self, row_factor: float) -> "QueryProfile":
        """The profile of the same query over ``row_factor``-times the
        rows (distinct counts held fixed, so per-key fan-out scales with
        the rows).  Used by the monotonicity properties."""

        def s(v: int) -> int:
            return int(math.ceil(v * row_factor))

        nodes = tuple(
            dataclasses.replace(
                nr, base_rows=s(nr.base_rows), bound_rows=s(nr.bound_rows)
            )
            for nr in self.node_rules
        )
        edges = []
        for rp in self.edge_rules:
            segs = []
            for sp in rp.segments:
                atoms = tuple(
                    dataclasses.replace(
                        a,
                        base_rows=s(a.base_rows),
                        bound_rows=s(a.bound_rows),
                        link_max_count=s(a.link_max_count),
                    )
                    for a in sp.atoms
                )
                segs.append(dataclasses.replace(sp, atoms=atoms))
            edges.append(dataclasses.replace(rp, segments=tuple(segs)))
        return QueryProfile(nodes, tuple(edges))


def _row_bytes(table: Table) -> int:
    return sum(int(c.dtype.itemsize) for c in table.columns.values())


def _var_itemsize(bound_tables: Sequence[Table], var: str) -> int:
    for t in bound_tables:
        if var in t.column_names:
            return int(t.column(var).dtype.itemsize)
    return 8


def profile_query(
    catalog: Catalog,
    query: Union[str, ExtractionQuery],
    mode: str = "auto",
) -> QueryProfile:
    """Bind every rule atom once and collect the cardinalities the cost
    model needs.  One pass over the bound data (``Table.analyze`` on the
    bound columns) — the same work :func:`plan_rule` already does to mark
    large links, extended with the ``max_count`` fan-out stat."""
    if isinstance(query, str):
        query = parse(query)

    node_profiles: List[NodeRuleProfile] = []
    for rule in query.nodes_rules:
        atom = rule.atoms[0]
        base = catalog.table(atom.relation)
        bound = bind_atom(catalog, atom, rule.comparisons)
        key_isz = int(bound.column(rule.head_vars[0]).dtype.itemsize)
        prop_isz = sum(
            int(bound.column(p).dtype.itemsize) for p in rule.head_vars[1:]
        )
        node_profiles.append(NodeRuleProfile(
            relation=atom.relation,
            base_rows=len(base),
            base_row_bytes=_row_bytes(base),
            bound_rows=len(bound),
            key_bytes=key_isz,
            prop_bytes=prop_isz,
        ))

    edge_profiles: List[RuleProfile] = []
    for rule in query.edges_rules:
        cp = plan_rule(catalog, rule, mode=mode)
        id1, id2 = cp.endpoint_vars
        large_vars = [v for v, l in zip(cp.link_vars, cp.large) if l]
        seg_vars = [id1] + large_vars + [id2]
        segs: List[SegmentProfile] = []
        for k, (i, j) in enumerate(cp.segments):
            atom_profiles: List[AtomProfile] = []
            bound_tables: List[Table] = []
            for a_idx in range(i, j + 1):
                atom = cp.atoms[a_idx]
                base = catalog.table(atom.relation)
                bound = bind_atom(catalog, atom, rule.comparisons)
                bound_tables.append(bound)
                if a_idx == i:
                    atom_profiles.append(AtomProfile(
                        relation=atom.relation,
                        base_rows=len(base),
                        base_row_bytes=_row_bytes(base),
                        bound_rows=len(bound),
                        bound_row_bytes=_row_bytes(bound),
                    ))
                    continue
                link = cp.link_vars[a_idx - 1]
                left = bound_tables[-2].stats(link)
                right = bound.stats(link)
                atom_profiles.append(AtomProfile(
                    relation=atom.relation,
                    base_rows=len(base),
                    base_row_bytes=_row_bytes(base),
                    bound_rows=len(bound),
                    bound_row_bytes=_row_bytes(bound),
                    link_max_count=int(right.max_count),
                    link_n_distinct=max(left.n_distinct, right.n_distinct, 1),
                    link_value_bytes=int(bound.column(link).dtype.itemsize),
                ))
            segs.append(SegmentProfile(
                atoms=tuple(atom_profiles),
                in_value_bytes=_var_itemsize(bound_tables, seg_vars[k]),
                out_value_bytes=_var_itemsize(bound_tables, seg_vars[k + 1]),
            ))
        edge_profiles.append(RuleProfile(
            describe=cp.describe(), segments=tuple(segs)
        ))
    return QueryProfile(tuple(node_profiles), tuple(edge_profiles))


# ---------------------------------------------------------------------------
# Sound peak bounds: symbolic replay of the budget charge sequences
# ---------------------------------------------------------------------------

def _ceil_div(a: int, n: int) -> int:
    return -(-int(a) // max(int(n), 1))


def _segment_peaks(
    seg: SegmentProfile, n_shards: int
) -> Tuple[int, int, int, int]:
    """Replay :func:`execute_segment_shard`'s charges for the worst shard.

    Returns ``(peak_rows, peak_bytes, out_rows_total, out_rows_shard)``:
    the rows/bytes peaks any one shard's transients can reach, the sound
    bound on the segment's *total* output rows (all shards), and on one
    shard's output rows.  All four are nondecreasing in table rows and
    nonincreasing in ``n_shards`` by construction.
    """
    lead = seg.atoms[0]
    block = _ceil_div(lead.base_rows, n_shards)
    acc_s = min(block, lead.bound_rows)       # worst shard's accumulator rows
    acc_t = lead.bound_rows                   # summed over all shards
    acc_w = lead.bound_row_bytes              # accumulator row width
    peak_r = block + acc_s
    peak_b = block * lead.base_row_bytes + acc_s * acc_w
    for pa in seg.atoms[1:]:
        pblock = _ceil_div(pa.base_rows, n_shards)
        # probe survivors: every kept row's key occurs in the shard's
        # accumulator, and one key matches at most link_max_count rows
        surv = min(pa.bound_rows, acc_s * pa.link_max_count)
        j_s = acc_s * pa.link_max_count
        j_t = acc_t * pa.link_max_count
        j_w = acc_w + pa.bound_row_bytes      # join concatenates columns
        # (a) last probe scan block charged on top of all survivors
        peak_r = max(peak_r, acc_s + surv + pblock)
        peak_b = max(
            peak_b,
            acc_s * acc_w + surv * pa.bound_row_bytes
            + pblock * pa.base_row_bytes,
        )
        # (b) join output charged before acc + probe are released
        peak_r = max(peak_r, acc_s + surv + j_s)
        peak_b = max(
            peak_b, acc_s * acc_w + surv * pa.bound_row_bytes + j_s * j_w
        )
        acc_s, acc_t, acc_w = j_s, j_t, j_w
    return peak_r, peak_b, acc_t, acc_s


def peak_resident_rows_bound(profile: QueryProfile, n_shards: int) -> int:
    """Sound upper bound on ``ExtractionBudget.peak_resident_rows``.

    Every charge/release pair of the node build and every segment shard
    is replayed symbolically; transients are fully released between
    shards and segments, so the overall peak is the max over phases."""
    peak = 0
    for nr in profile.node_rules:
        block = _ceil_div(nr.base_rows, n_shards)
        peak = max(peak, block + min(block, nr.bound_rows))
    for rp in profile.edge_rules:
        for sp in rp.segments:
            peak = max(peak, _segment_peaks(sp, n_shards)[0])
    return peak


def peak_transient_bytes_bound(profile: QueryProfile, n_shards: int) -> int:
    """:func:`peak_resident_rows_bound` with each charged row weighted by
    its table's actual per-row byte width (string property columns are
    wide; a rows-only view hides that)."""
    peak = 0
    for nr in profile.node_rules:
        block = _ceil_div(nr.base_rows, n_shards)
        bnd = min(block, nr.bound_rows)
        peak = max(
            peak,
            block * nr.base_row_bytes + bnd * (nr.key_bytes + nr.prop_bytes),
        )
    for rp in profile.edge_rules:
        for sp in rp.segments:
            peak = max(peak, _segment_peaks(sp, n_shards)[1])
    return peak


def _node_assembly_bounds(
    profile: QueryProfile, n_shards: int
) -> Tuple[int, int]:
    """(no-spill accumulated node-candidate bytes, max single spill
    charge) for the node-space phase."""
    total = 0
    single = 0
    for nr in profile.node_rules:
        block = _ceil_div(nr.base_rows, n_shards)
        b_s = min(block, nr.bound_rows)
        per_shard = b_s * (nr.key_bytes + _CAND_EXTRA)
        per_rule = nr.bound_rows * (nr.key_bytes + _CAND_EXTRA)
        if nr.prop_bytes:
            per_shard += b_s * (nr.key_bytes + nr.prop_bytes)
            per_rule += nr.bound_rows * (nr.key_bytes + nr.prop_bytes)
        total += per_rule
        # spill singles: the (rule, shard) record, the candidate-union
        # slice, and the property-scatter read — the largest covers all
        single = max(
            single, per_shard, b_s * (nr.key_bytes + _UNION_EXTRA)
        )
    return total, single


def assembly_account_bounds(
    profile: QueryProfile, n_shards: int
) -> Tuple[int, int]:
    """Sound bounds for the assembly-bytes account, as
    ``(no_spill_peak, spill_single_charge_peak)``.

    No-spill: node candidates accumulate (then release), then every
    shard's :class:`~repro_torch.core.serialize.ShardAssembly` accumulates
    until the merge — the peak is the larger phase, and a cap violation
    raises.  Spilling: each buffer is charged ``spilling=True`` and
    released once written, so only a *single* charge above the cap can
    raise ("unsatisfiable") — the bound is the largest single charge:
    one shard's complete assembly, or one node record/union slice."""
    node_total, node_single = _node_assembly_bounds(profile, n_shards)
    chain_total = 0
    chain_shard = 0  # one shard's complete ShardAssembly (all rules)
    for rp in profile.edge_rules:
        outs_t: List[int] = []
        outs_s: List[int] = []
        for sp in rp.segments:
            _, _, out_t, out_s = _segment_peaks(sp, n_shards)
            outs_t.append(out_t)
            outs_s.append(out_s)
            chain_total += out_t * _EDGE_BYTES
            chain_shard += out_s * _EDGE_BYTES
        for k in range(len(rp.segments) - 1):
            vb = max(
                rp.segments[k].out_value_bytes,
                rp.segments[k + 1].in_value_bytes,
            )
            chain_total += (outs_t[k] + outs_t[k + 1]) * vb
            chain_shard += (outs_s[k] + outs_s[k + 1]) * vb
    return max(node_total, chain_total), max(node_single, chain_shard)


# ---------------------------------------------------------------------------
# Plan space
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, order=True)
class PlanConfig:
    """One point of the bounded configuration space.  Ordered, so ties in
    predicted wall time break deterministically by field order."""

    n_shards: int = 1
    partition: str = "rows"
    spill: bool = False
    merge_arity: int = 2
    pack_method: str = "reduceat"
    fuse_correction: bool = True

    def to_json_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json_dict(cls, d: Dict[str, object]) -> "PlanConfig":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)})


@dataclasses.dataclass(frozen=True)
class PlanCost:
    """Predicted cost of one :class:`PlanConfig`.

    ``wall_s`` and the per-stage terms are *expectations* (planner's
    ``|R||S|/d`` estimates over measured/analytic rates); the ``peak_*``
    fields are *sound upper bounds* on what the budget accounts will
    observe — the feasibility side never relies on expectations."""

    wall_s: float
    scan_s: float
    bind_s: float
    join_s: float
    assemble_s: float
    spill_s: float
    merge_s: float
    pack_s: float
    correction_s: float
    est_edges: float                # expected condensed edges
    est_assembly_bytes: float
    peak_resident_rows: int         # sound bound (rows account)
    peak_transient_bytes: int       # rows bound weighted by row widths
    peak_assembly_bytes: int        # sound bound (bytes account)
    peak_bytes: int                 # transient + assembly co-residency

    def to_json_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json_dict(cls, d: Dict[str, object]) -> "PlanCost":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)})


def _estimate_stage_seconds(
    profile: QueryProfile, config: PlanConfig, tp: Throughputs
) -> Dict[str, float]:
    n = config.n_shards
    scan_rows = 0.0
    bind_rows = 0.0
    join_rows = 0.0
    node_bytes = 0.0
    for nr in profile.node_rules:
        scan_rows += nr.base_rows
        bind_rows += nr.bound_rows
        node_bytes += nr.bound_rows * (nr.key_bytes + _CAND_EXTRA)
        if nr.prop_bytes:
            node_bytes += nr.bound_rows * (nr.key_bytes + nr.prop_bytes)
    est_edges = 0.0
    chain_bytes = 0.0
    for rp in profile.edge_rules:
        seg_outs: List[float] = []
        for sp in rp.segments:
            lead = sp.atoms[0]
            scan_rows += lead.base_rows
            bind_rows += lead.bound_rows
            acc = float(lead.bound_rows)
            for pa in sp.atoms[1:]:
                # _probe_partition scans the FULL probe relation once per
                # shard — the dominant reason small jobs prefer n_shards=1
                scan_rows += n * pa.base_rows
                out = acc * pa.bound_rows / max(pa.link_n_distinct, 1)
                bind_rows += min(float(pa.bound_rows), out + acc)
                join_rows += acc + pa.bound_rows + out
                acc = out
            seg_outs.append(acc)
            est_edges += acc
            chain_bytes += acc * _EDGE_BYTES
        for k in range(len(rp.segments) - 1):
            vb = max(
                rp.segments[k].out_value_bytes,
                rp.segments[k + 1].in_value_bytes,
            )
            chain_bytes += (seg_outs[k] + seg_outs[k + 1]) * vb
    assembly_bytes = node_bytes + chain_bytes

    scan_s = scan_rows / tp.scan_rows_per_s
    bind_s = bind_rows / tp.bind_rows_per_s
    join_s = join_rows / tp.join_rows_per_s
    assemble_s = assembly_bytes / tp.assemble_bytes_per_s \
        + n * tp.shard_overhead_s
    spill_s = 0.0
    merge_s = 0.0
    if config.spill:
        # every assembly buffer is written out and read back at least once
        spill_s = 2.0 * assembly_bytes / tp.spill_bytes_per_s
        if n > 1:
            rounds = max(
                1, math.ceil(math.log(n) / math.log(max(config.merge_arity, 2)))
            )
            merge_s = rounds * chain_bytes / tp.merge_bytes_per_s
    elif n > 1:
        merge_s = chain_bytes / tp.merge_bytes_per_s
    pack_s = 2.0 * est_edges / tp.pack_edges_per_s(config.pack_method)
    correction_s = est_edges / tp.correction_triples_per_s
    if config.fuse_correction:
        # the fused epilogue folds the correction into the propagation
        # pass instead of a separate SpMV over the duplicate planes
        correction_s *= 0.25
    return {
        "scan_s": scan_s,
        "bind_s": bind_s,
        "join_s": join_s,
        "assemble_s": assemble_s,
        "spill_s": spill_s,
        "merge_s": merge_s,
        "pack_s": pack_s,
        "correction_s": correction_s,
        "est_edges": est_edges,
        "est_assembly_bytes": assembly_bytes,
    }


def plan_cost(
    profile: QueryProfile,
    config: PlanConfig,
    throughputs: Optional[Throughputs] = None,
) -> PlanCost:
    """Predicted cost of executing ``profile`` under ``config``."""
    tp = throughputs or Throughputs()
    stages = _estimate_stage_seconds(profile, config, tp)
    rows_bound = peak_resident_rows_bound(profile, config.n_shards)
    transient_bound = peak_transient_bytes_bound(profile, config.n_shards)
    no_spill_peak, spill_single = assembly_account_bounds(
        profile, config.n_shards
    )
    assembly_bound = spill_single if config.spill else no_spill_peak
    wall = sum(
        stages[k] for k in (
            "scan_s", "bind_s", "join_s", "assemble_s", "spill_s",
            "merge_s", "pack_s", "correction_s",
        )
    )
    return PlanCost(
        wall_s=wall,
        scan_s=stages["scan_s"],
        bind_s=stages["bind_s"],
        join_s=stages["join_s"],
        assemble_s=stages["assemble_s"],
        spill_s=stages["spill_s"],
        merge_s=stages["merge_s"],
        pack_s=stages["pack_s"],
        correction_s=stages["correction_s"],
        est_edges=stages["est_edges"],
        est_assembly_bytes=stages["est_assembly_bytes"],
        peak_resident_rows=rows_bound,
        peak_transient_bytes=transient_bound,
        peak_assembly_bytes=assembly_bound,
        peak_bytes=transient_bound + assembly_bound,
    )


# ---------------------------------------------------------------------------
# ExtractionPlan / PlanReport
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExtractionPlan:
    """An executable plan: the chosen config plus everything
    ``extract`` / ``sharded_extract_to_device`` need to run it."""

    config: PlanConfig
    cost: PlanCost
    mode: str
    query_text: str
    max_resident_rows: Optional[int] = None
    max_assembly_bytes: Optional[int] = None

    def make_budget(self) -> ExtractionBudget:
        return ExtractionBudget(
            max_resident_rows=self.max_resident_rows,
            max_assembly_bytes=self.max_assembly_bytes,
            spill_enabled=self.config.spill,
        )

    def extract_kwargs(self) -> Dict[str, object]:
        """Knobs for :func:`repro_torch.core.extract.extract`."""
        return {
            "n_shards": self.config.n_shards,
            "merge_arity": self.config.merge_arity,
        }

    def device_kwargs(self) -> Dict[str, object]:
        """Knobs for :func:`repro_torch.core.engine.to_device_packed`."""
        return {
            "pack_method": self.config.pack_method,
            "fuse_correction": self.config.fuse_correction,
        }

    def execute(self, catalog: Catalog, preprocess: bool = False,
                spill_dir: Optional[str] = None):
        """Run the plan; returns an ``ExtractionResult``.  Spilling plans
        without an explicit ``spill_dir`` use a temporary directory."""
        from .extract import extract

        if not self.query_text:
            raise ValueError(
                "plan was built from a parsed ExtractionQuery, not DSL "
                "text; call extract(catalog, dsl_text, plan=plan) instead"
            )

        return extract(
            catalog, self.query_text, mode=self.mode, preprocess=preprocess,
            plan=self, spill_dir=spill_dir,
        )

    def to_json_dict(self) -> Dict[str, object]:
        return {
            "config": self.config.to_json_dict(),
            "cost": self.cost.to_json_dict(),
            "mode": self.mode,
            "query_text": self.query_text,
            "max_resident_rows": self.max_resident_rows,
            "max_assembly_bytes": self.max_assembly_bytes,
        }

    @classmethod
    def from_json_dict(cls, d: Dict[str, object]) -> "ExtractionPlan":
        return cls(
            config=PlanConfig.from_json_dict(d["config"]),
            cost=PlanCost.from_json_dict(d["cost"]),
            mode=d["mode"],
            query_text=d["query_text"],
            max_resident_rows=d["max_resident_rows"],
            max_assembly_bytes=d["max_assembly_bytes"],
        )


@dataclasses.dataclass(frozen=True)
class PrunedPlan:
    config: PlanConfig
    reason: str
    predicted_peak_bytes: Optional[int] = None

    def to_json_dict(self) -> Dict[str, object]:
        return {
            "config": self.config.to_json_dict(),
            "reason": self.reason,
            "predicted_peak_bytes": self.predicted_peak_bytes,
        }

    @classmethod
    def from_json_dict(cls, d: Dict[str, object]) -> "PrunedPlan":
        return cls(
            config=PlanConfig.from_json_dict(d["config"]),
            reason=d["reason"],
            predicted_peak_bytes=d["predicted_peak_bytes"],
        )


@dataclasses.dataclass(frozen=True)
class PlanReport:
    """The optimizer's full answer: chosen plan, ranked feasible
    alternatives, and every pruned config with the reason it lost."""

    chosen: ExtractionPlan
    ranked: Tuple[Tuple[PlanConfig, PlanCost], ...]
    pruned: Tuple[PrunedPlan, ...]
    rules: Tuple[str, ...]
    n_enumerated: int
    budget_rows: Optional[int] = None
    budget_bytes: Optional[int] = None

    def to_json_dict(self) -> Dict[str, object]:
        return {
            "version": 1,
            "chosen": self.chosen.to_json_dict(),
            "ranked": [
                {"config": c.to_json_dict(), "cost": k.to_json_dict()}
                for c, k in self.ranked
            ],
            "pruned": [p.to_json_dict() for p in self.pruned],
            "rules": list(self.rules),
            "n_enumerated": self.n_enumerated,
            "budget_rows": self.budget_rows,
            "budget_bytes": self.budget_bytes,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict(), sort_keys=True, indent=1)

    @classmethod
    def from_json_dict(cls, d: Dict[str, object]) -> "PlanReport":
        if d.get("version") != 1:
            raise ValueError(f"unknown plan-report version: {d.get('version')!r}")
        return cls(
            chosen=ExtractionPlan.from_json_dict(d["chosen"]),
            ranked=tuple(
                (
                    PlanConfig.from_json_dict(r["config"]),
                    PlanCost.from_json_dict(r["cost"]),
                )
                for r in d["ranked"]
            ),
            pruned=tuple(
                PrunedPlan.from_json_dict(p) for p in d["pruned"]
            ),
            rules=tuple(d["rules"]),
            n_enumerated=d["n_enumerated"],
            budget_rows=d["budget_rows"],
            budget_bytes=d["budget_bytes"],
        )

    @classmethod
    def from_json(cls, text: str) -> "PlanReport":
        return cls.from_json_dict(json.loads(text))

    def render(self) -> str:
        """Markdown report through the launch-layer renderer."""
        from ..launch.report import render_plan_report

        return render_plan_report(self.to_json_dict())


def _crossover_prefers_segment(crossover) -> bool:
    """True when every measured cell of the table says the segment path
    wins — the fused CUDA epilogue (K3) then stands down at dispatch, so
    enumerating fused configs would just mispredict."""
    entries = getattr(crossover, "entries", ())
    if not entries:
        return False
    return all(entry.backend == "segment" for _, entry in entries)


def plan(
    catalog: Catalog,
    dsl_text: Union[str, ExtractionQuery],
    *,
    budget: Optional[ExtractionBudget] = None,
    mode: str = "auto",
    throughputs: Optional[Throughputs] = None,
    crossover=None,
    n_shards_candidates: Sequence[int] = (1, 2, 4, 8),
    merge_arities: Sequence[int] = (2, 4),
    pack_methods: Sequence[str] = ("reduceat", "scatter"),
) -> PlanReport:
    """Enumerate, prune, rank; return the full :class:`PlanReport`.

    Pruning invariants (DESIGN.md §12):

    * hash partitioning is enumerated but always pruned — the shard merge
      relies on contiguous-row shards to reproduce the unsharded output
      order, so a hash partition would break byte-identity;
    * a config whose *sound* peak bound violates the caller's budget is
      pruned before costing — so a plan this function returns never
      raises :class:`~repro_torch.core.planner.ExtractionBudgetError`;
    * spilling with one shard is skipped (one record, nothing to bound);
    * fused-correction configs are pruned when a measured
      ``CrossoverTable`` says the segment path wins everywhere (the fused
      CUDA epilogue stands down at dispatch, so the knob cannot pay off).
    """
    text = dsl_text if isinstance(dsl_text, str) else None
    query = parse(dsl_text) if isinstance(dsl_text, str) else dsl_text
    tp = throughputs or Throughputs()
    profile = profile_query(catalog, query, mode=mode)
    budget_rows = budget.max_resident_rows if budget is not None else None
    budget_bytes = budget.max_assembly_bytes if budget is not None else None
    fused_stands_down = crossover is not None and _crossover_prefers_segment(
        crossover
    )

    feasible: List[Tuple[PlanConfig, PlanCost]] = []
    pruned: List[PrunedPlan] = []
    n_enumerated = 0
    for n in n_shards_candidates:
        base_cfg = PlanConfig(n_shards=n)
        # hash partitioning: enumerated, never feasible (see docstring)
        if n > 1:
            n_enumerated += 1
            pruned.append(PrunedPlan(
                config=dataclasses.replace(base_cfg, partition="hash"),
                reason=(
                    "hash partitioning breaks the order-preserving shard "
                    "merge (DESIGN.md §7 byte-identity invariant); only "
                    "contiguous row shards reproduce the unsharded output"
                ),
            ))
        rows_bound = peak_resident_rows_bound(profile, n)
        transient_bound = peak_transient_bytes_bound(profile, n)
        no_spill_peak, spill_single = assembly_account_bounds(profile, n)
        spill_options: List[Tuple[bool, int]] = [(False, merge_arities[0])]
        if n > 1:
            spill_options += [(True, a) for a in merge_arities]
        for spill, arity in spill_options:
            cfg0 = dataclasses.replace(
                base_cfg, spill=spill, merge_arity=arity
            )
            assembly_bound = spill_single if spill else no_spill_peak
            n_enumerated += 1
            if budget_rows is not None and rows_bound > budget_rows:
                pruned.append(PrunedPlan(
                    config=cfg0,
                    reason=(
                        f"predicted peak resident rows {rows_bound} > "
                        f"max_resident_rows={budget_rows}"
                    ),
                    predicted_peak_bytes=transient_bound + assembly_bound,
                ))
                continue
            if budget_bytes is not None and assembly_bound > budget_bytes:
                why = "single spill charge" if spill else "resident assembly"
                pruned.append(PrunedPlan(
                    config=cfg0,
                    reason=(
                        f"predicted {why} {assembly_bound} bytes > "
                        f"max_assembly_bytes={budget_bytes}"
                    ),
                    predicted_peak_bytes=transient_bound + assembly_bound,
                ))
                continue
            for pm in pack_methods:
                for fuse in (True, False):
                    cfg = dataclasses.replace(
                        cfg0, pack_method=pm, fuse_correction=fuse
                    )
                    if fuse and fused_stands_down:
                        n_enumerated += 1
                        pruned.append(PrunedPlan(
                            config=cfg,
                            reason=(
                                "measured CrossoverTable prefers the "
                                "segment path in every cell: the fused "
                                "CUDA epilogue stands down at dispatch"
                            ),
                        ))
                        continue
                    n_enumerated += 1
                    feasible.append((cfg, plan_cost(profile, cfg, tp)))

    if not feasible:
        detail = "; ".join(
            f"{p.config.n_shards}-shard "
            f"{'spill' if p.config.spill else 'no-spill'}: {p.reason}"
            for p in pruned[:4]
        )
        raise ValueError(
            f"no feasible extraction plan under the budget ({detail})"
        )

    feasible.sort(key=lambda t: (t[1].wall_s, t[0]))
    chosen_cfg, chosen_cost = feasible[0]
    chosen = ExtractionPlan(
        config=chosen_cfg,
        cost=chosen_cost,
        mode=mode,
        query_text=text if text is not None else "",
        max_resident_rows=budget_rows,
        max_assembly_bytes=budget_bytes,
    )
    rules = tuple(rp.describe for rp in profile.edge_rules)
    return PlanReport(
        chosen=chosen,
        ranked=tuple(feasible),
        pruned=tuple(pruned),
        rules=rules,
        n_enumerated=n_enumerated,
        budget_rows=budget_rows,
        budget_bytes=budget_bytes,
    )


# ---------------------------------------------------------------------------
# Device-representation costs (advisor routing, DESIGN.md §12)
# ---------------------------------------------------------------------------

def device_representation_costs(
    expansion_ratio: float,
    duplication_ratio: float,
    crossover,
    n_src: int,
    n_features: int = 128,
) -> Optional[Dict[str, float]]:
    """Relative device cost (µs per propagation pass) of DEDUP-C vs EXP
    from a measured :class:`~repro_torch.kernels.autotune.CrossoverTable`
    cell.

    DEDUP-C runs the condensed SpMM on the measured-faster backend plus a
    correction pass over the duplicate planes (the segment path, scaled
    by the duplication ratio); EXP runs the segment path over the
    expanded edge multiset (scaled by the expansion ratio).  A
    measured-slower CUDA cell removes DEDUP-C's kernel advantage, which
    can flip the recommendation back to EXP for mildly-expanding graphs.
    Returns None when the table has no measurement for this op."""
    if crossover is None:
        return None
    entry = crossover.lookup("sum", n_src, n_features)
    if entry is None:
        return None
    segment = float(entry.segment_us)
    cuda = float(entry.cuda_us)
    return {
        "DEDUP-C": min(cuda, segment) + segment * max(duplication_ratio, 0.0),
        "EXP": segment * max(expansion_ratio, 1.0),
    }
