"""Columnar in-memory relational store with catalog statistics.

This is the paper's "RDBMS" substrate (GraphGen sits on PostgreSQL; here we
implement the minimal relational layer the extraction planner needs: tables
as named NumPy columns, key/foreign-key hash joins, projections, selections,
and pg_stats-style ``n_distinct`` statistics used by the large-output-join
detector in :mod:`repro_torch.core.planner`).

Everything is columnar so that join results feed straight into the
condensed-graph edge arrays without row materialization.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Table",
    "Catalog",
    "ShardedTable",
    "hash_join",
    "semi_join",
    "shard_bounds",
    "hash_partition",
]


@dataclasses.dataclass
class ColumnStats:
    """pg_stats analog for one column."""

    n_distinct: int
    min_value: Optional[float] = None
    max_value: Optional[float] = None
    null_frac: float = 0.0
    # Most-common-value frequency: the largest number of rows sharing one
    # value.  Gives a *sound* per-row join fan-out bound (a probe row can
    # match at most max_count build rows), which the extraction cost model
    # needs for budget-feasibility pruning where the |R||S|/d estimate is
    # only an expectation.
    max_count: int = 1


class Table:
    """An immutable named collection of equal-length columns."""

    def __init__(self, name: str, columns: Mapping[str, np.ndarray]):
        if not columns:
            raise ValueError(f"table {name!r} needs at least one column")
        lengths = {len(v) for v in columns.values()}
        if len(lengths) != 1:
            raise ValueError(f"ragged columns in table {name!r}: {lengths}")
        self.name = name
        self.columns: Dict[str, np.ndarray] = {
            k: np.asarray(v) for k, v in columns.items()
        }
        self._stats: Dict[str, ColumnStats] = {}

    # -- basic relational ops -------------------------------------------------
    def __len__(self) -> int:
        return len(next(iter(self.columns.values())))

    @property
    def column_names(self) -> List[str]:
        return list(self.columns)

    def column(self, name: str) -> np.ndarray:
        try:
            return self.columns[name]
        except KeyError:
            raise KeyError(
                f"table {self.name!r} has no column {name!r}; has {self.column_names}"
            ) from None

    def project(self, names: Sequence[str]) -> "Table":
        return Table(self.name, {n: self.column(n) for n in names})

    def select(self, predicate: Callable[[Dict[str, np.ndarray]], np.ndarray]) -> "Table":
        mask = np.asarray(predicate(self.columns), dtype=bool)
        return Table(self.name, {k: v[mask] for k, v in self.columns.items()})

    def rename(self, mapping: Mapping[str, str]) -> "Table":
        return Table(
            self.name, {mapping.get(k, k): v for k, v in self.columns.items()}
        )

    def head(self, n: int = 5) -> Dict[str, np.ndarray]:
        return {k: v[:n] for k, v in self.columns.items()}

    def row_slice(self, lo: int, hi: int) -> "Table":
        """Contiguous row block ``[lo, hi)`` as a new table (view columns)."""
        return Table(self.name, {k: v[lo:hi] for k, v in self.columns.items()})

    # -- statistics ------------------------------------------------------------
    def analyze(self) -> None:
        """Populate catalog statistics (ANALYZE)."""
        for name, col in self.columns.items():
            uniq, counts = np.unique(col, return_counts=True)
            numeric = np.issubdtype(col.dtype, np.number)
            self._stats[name] = ColumnStats(
                n_distinct=int(uniq.size),
                min_value=float(col.min()) if numeric and col.size else None,
                max_value=float(col.max()) if numeric and col.size else None,
                max_count=int(counts.max()) if counts.size else 0,
            )

    def stats(self, column: str) -> ColumnStats:
        if column not in self._stats:
            self.analyze()
        return self._stats[column]

    def nbytes(self) -> int:
        return sum(int(v.nbytes) for v in self.columns.values())

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Table({self.name!r}, rows={len(self)}, cols={self.column_names})"


class Catalog:
    """A named collection of tables; the "database" handed to the DSL."""

    def __init__(self, tables: Iterable[Table] = ()):  # noqa: D401
        self._tables: Dict[str, Table] = {}
        for t in tables:
            self.add(t)

    def add(self, table: Table) -> None:
        self._tables[table.name.lower()] = table

    def table(self, name: str) -> Table:
        try:
            return self._tables[name.lower()]
        except KeyError:
            raise KeyError(
                f"no table {name!r}; catalog has {sorted(self._tables)}"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name.lower() in self._tables

    @property
    def table_names(self) -> List[str]:
        return sorted(self._tables)

    def nbytes(self) -> int:
        return sum(t.nbytes() for t in self._tables.values())


# ---------------------------------------------------------------------------
# Sharded table views (DESIGN.md §7).
# ---------------------------------------------------------------------------

def shard_bounds(n_rows: int, n_shards: int) -> List[Tuple[int, int]]:
    """Contiguous row-block boundaries for ``n_shards`` shards.

    Always returns exactly ``n_shards`` blocks: the last block is ragged
    when ``n_rows % n_shards != 0`` and trailing blocks are empty when
    ``n_shards > n_rows`` — callers (the sharded extraction pipeline,
    DESIGN.md §7) rely on the fixed shard count, and concatenating the
    blocks in order reproduces ``range(n_rows)`` exactly.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    width = -(-n_rows // n_shards) if n_rows else 0
    out = []
    for s in range(n_shards):
        lo = min(s * width, n_rows)
        out.append((lo, min(lo + width, n_rows)))
    return out


def _hash_codes(values: np.ndarray) -> np.ndarray:
    """Value-determined uint64 codes: equal values get equal codes no
    matter which array they appear in.  This is what makes the
    :func:`hash_partition` contract *cross-table* — rank-based codes
    (``searchsorted`` against the array's own unique values) would send
    the same key to different shards of different tables."""
    values = np.asarray(values)
    if values.size == 0:
        return np.zeros(0, dtype=np.uint64)
    if np.issubdtype(values.dtype, np.integer):
        return values.astype(np.int64).view(np.uint64)
    if np.issubdtype(values.dtype, np.floating):
        return values.astype(np.float64).view(np.uint64)
    # fixed-width unicode/bytes: FNV-1a folded over the code units
    u = np.ascontiguousarray(np.asarray(values, dtype=np.str_))
    width = max(u.dtype.itemsize // 4, 1)
    units = u.view(np.uint32).reshape(u.size, width).astype(np.uint64)
    h = np.full(u.size, np.uint64(14695981039346656037))
    for col in units.T:
        h = (h ^ col) * np.uint64(1099511628211)
    return h


def hash_partition(values: np.ndarray, n_shards: int) -> np.ndarray:
    """Shard id per value: a multiplicative hash of value-determined codes.

    Equal values always land in the same shard *across arrays* (the
    join-key contract: partitioning both join sides this way makes
    per-shard joins exhaustive), because the codes depend only on the
    value itself (:func:`_hash_codes`) — never on the surrounding array.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    codes = _hash_codes(values)
    # Knuth multiplicative hash; spreads consecutive keys across shards.
    mixed = (codes * np.uint64(2654435761)) >> np.uint64(16)
    return (mixed % np.uint64(n_shards)).astype(np.int64)


class ShardedTable:
    """A :class:`Table` partitioned into row shards, with per-shard stats.

    Two partitioning modes (DESIGN.md §7):

    * ``'rows'`` (default) — contiguous row blocks via :func:`shard_bounds`.
      Order-preserving: concatenating the shards in order reproduces the
      base table row-for-row, which is what lets the sharded extraction
      merge step rebuild a byte-identical ``CondensedGraph``.
    * ``'hash'`` — rows bucketed by :func:`hash_partition` of ``key``
      (pg-style hash partitioning on a join key).  Equal keys are co-located
      so per-shard joins against an identically partitioned table are
      exhaustive; row order is *not* preserved across shards.

    Per-shard ``ColumnStats`` come from :meth:`stats` — the planner's
    global estimates stay on the base table, but shard-local cardinalities
    are what a per-shard budget planner needs.
    """

    def __init__(self, table: Table, n_shards: int, mode: str = "rows",
                 key: Optional[str] = None):
        if mode not in ("rows", "hash"):
            raise ValueError(f"unknown shard mode {mode!r}")
        if mode == "hash" and key is None:
            raise ValueError("hash partitioning needs a key column")
        self.table = table
        self.n_shards = int(n_shards)
        self.mode = mode
        self.key = key
        if mode == "rows":
            self._bounds = shard_bounds(len(table), self.n_shards)
            self._masks: Optional[List[np.ndarray]] = None
        else:
            sid = hash_partition(table.column(key), self.n_shards)
            self._bounds = None
            self._masks = [sid == s for s in range(self.n_shards)]
        self._shards: Dict[int, Table] = {}

    def __len__(self) -> int:
        return self.n_shards

    def shard(self, s: int) -> Table:
        if not 0 <= s < self.n_shards:
            raise IndexError(f"shard {s} out of range [0, {self.n_shards})")
        if s not in self._shards:
            if self._bounds is not None:
                lo, hi = self._bounds[s]
                self._shards[s] = self.table.row_slice(lo, hi)
            else:
                mask = self._masks[s]
                self._shards[s] = Table(
                    self.table.name,
                    {k: v[mask] for k, v in self.table.columns.items()},
                )
        return self._shards[s]

    def __iter__(self) -> Iterable[Table]:
        return (self.shard(s) for s in range(self.n_shards))

    def shard_rows(self, s: int) -> int:
        if self._bounds is not None:
            lo, hi = self._bounds[s]
            return hi - lo
        return int(self._masks[s].sum())

    def stats(self, s: int, column: str) -> ColumnStats:
        """Per-shard pg_stats: ``ANALYZE`` scoped to one shard."""
        return self.shard(s).stats(column)


# ---------------------------------------------------------------------------
# Joins. Columnar hash joins over integer or string key columns.
# ---------------------------------------------------------------------------

def _factorize(*cols: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Map the union of values in ``cols`` to dense int codes."""
    union = np.unique(np.concatenate([np.asarray(c) for c in cols]))
    return tuple(np.searchsorted(union, np.asarray(c)) for c in cols)


def hash_join(
    left: Table,
    right: Table,
    left_on: str,
    right_on: str,
    suffixes: Tuple[str, str] = ("_l", "_r"),
) -> Table:
    """Inner equi-join, returning a new table with all columns of both sides.

    Output-size faithful: materializes every matching pair (this is the
    expensive operation the condensed representation avoids for
    large-output joins).
    """
    lkey, rkey = _factorize(left.column(left_on), right.column(right_on))
    order = np.argsort(rkey, kind="stable")
    rkey_sorted = rkey[order]
    # For every left row, the contiguous run of matching right rows.
    starts = np.searchsorted(rkey_sorted, lkey, side="left")
    ends = np.searchsorted(rkey_sorted, lkey, side="right")
    counts = ends - starts
    lidx = np.repeat(np.arange(len(left)), counts)
    # Offsets into each run.
    total = int(counts.sum())
    if total:
        run_offsets = np.arange(total) - np.repeat(
            np.cumsum(counts) - counts, counts
        )
        ridx = order[np.repeat(starts, counts) + run_offsets]
    else:
        ridx = np.empty(0, dtype=np.int64)

    out: Dict[str, np.ndarray] = {}
    same_key = left_on == right_on
    for k, v in left.columns.items():
        if same_key and k == left_on:
            out[k] = v[lidx]  # canonical single copy of the join key
        else:
            out[k if k not in right.columns else k + suffixes[0]] = v[lidx]
    for k, v in right.columns.items():
        if same_key and k == right_on:
            continue
        out[k if k not in left.columns else k + suffixes[1]] = v[ridx]
    return Table(f"{left.name}_join_{right.name}", out)


def semi_join(left: Table, right: Table, left_on: str, right_on: str) -> Table:
    """Rows of ``left`` with at least one match in ``right`` (no blow-up)."""
    lkey, rkey = _factorize(left.column(left_on), right.column(right_on))
    mask = np.isin(lkey, np.unique(rkey))
    return Table(left.name, {k: v[mask] for k, v in left.columns.items()})


def estimate_join_output(
    left: Table, right: Table, left_on: str, right_on: str
) -> float:
    """Uniform-distribution join size estimate |R||S|/max(d_l, d_r).

    This is the estimator the paper's Step 2 uses (``n_distinct`` from
    pg_stats); deliberately simple and replaceable.
    """
    d = max(left.stats(left_on).n_distinct, right.stats(right_on).n_distinct, 1)
    return len(left) * len(right) / d
