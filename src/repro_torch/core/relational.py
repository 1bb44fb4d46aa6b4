"""Columnar in-memory relational store with catalog statistics.

This is the paper's "RDBMS" substrate (GraphGen sits on PostgreSQL; here we
implement the minimal relational layer the extraction planner needs: tables
as named NumPy columns, key/foreign-key hash joins, projections, selections,
and pg_stats-style ``n_distinct`` statistics used by the large-output-join
detector in :mod:`repro_torch.core.planner`).

Everything is columnar so that join results feed straight into the
condensed-graph edge arrays without row materialization.  Sharded table
views are not ported yet (ROADMAP.md, Queue 1 item 8).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np

__all__ = [
    "Table",
    "Catalog",
    "hash_join",
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

    def select(self, predicate: Callable[[Dict[str, np.ndarray]], np.ndarray]) -> "Table":
        mask = np.asarray(predicate(self.columns), dtype=bool)
        return Table(self.name, {k: v[mask] for k, v in self.columns.items()})

    def head(self, n: int = 5) -> Dict[str, np.ndarray]:
        return {k: v[:n] for k, v in self.columns.items()}

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
