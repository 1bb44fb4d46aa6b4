"""Condensed graph representations (C-DUP and friends).

The paper's central data structure: a directed acyclic multi-layer graph in
which *real* nodes are connected only through layers of *virtual* nodes
(one layer per postponed large-output join attribute).  An edge ``u -> v``
exists in the *expanded* graph iff at least one directed path
``u_s -> ... -> v_t`` exists here; the number of such paths is the pair's
*multiplicity* (the duplication problem, paper §4.1).

Linear-algebra view (see DESIGN.md §2): a single-layer chain is an
incidence pair ``(B_in, B_out)`` and the expanded multiplicity matrix is
``M = B_in · B_out``; a k-layer chain is the product of k+1 sparse
matrices.  All propagation in :mod:`repro_torch.core.engine` exploits
this factorization instead of materializing ``M``.

Everything in this module is host-side NumPy — extraction and dedup are
irregular/preprocessing work; the device-facing tensors are built by
``repro_torch.core.engine.to_device`` / ``to_device_packed`` from these
containers.  The port's copy of the JAX package's module of the same
name: identical arrays from identical inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "BipartiteEdges",
    "Chain",
    "CondensedGraph",
    "ExpandedGraph",
    "ExpansionAccounting",
    "fold_path_pairs",
    "split_expansion_budget",
    "graphs_identical",
    "DEFAULT_CHUNK_ROWS",
]

# Leading-row block size used when a streaming caller gives no explicit
# chunking: small graphs expand in one block (no overhead vs the old
# one-shot path), graphs with more real nodes get bounded blocks.
DEFAULT_CHUNK_ROWS = 65_536


@dataclasses.dataclass
class ExpansionAccounting:
    """Bookkeeping for streaming expansion (DESIGN.md §2).

    One instance is threaded through ``iter_path_pairs`` (which reports the
    active chunk's raw-composition bound) and :func:`fold_path_pairs`
    (which reports sorted-run residency), so ``peak_resident_triples`` is
    an upper bound on the number of expanded ``(u, v, m)`` triples live at
    any instant — the quantity the streaming-budget benchmarks assert
    against ``budget_triples``.
    """

    budget_triples: Optional[int] = None
    n_chunks: int = 0                # chunks yielded by the iterator
    n_paths: int = 0                 # raw expanded paths walked
    n_triples_out: int = 0           # aggregated triples yielded
    peak_resident_triples: int = 0   # max triples live at once
    n_merges: int = 0                # sorted-run consolidation passes
    n_overflow_chunks: int = 0       # single rows whose cost exceeds budget
    resident_chunk: int = 0          # live: active chunk's raw bound
    resident_runs: int = 0           # live: triples held in fold runs

    def _observe(self) -> None:
        live = self.resident_chunk + self.resident_runs
        if live > self.peak_resident_triples:
            self.peak_resident_triples = live

    def begin_chunk(self, cost: int, budget: Optional[int] = None) -> None:
        """``budget`` is the *chunker's* active budget (the half split off
        ``budget_triples``) — a chunk above it is a single row too big to
        honor the residency guarantee, recorded as an overflow."""
        self.n_chunks += 1
        self.resident_chunk = int(cost)
        if budget is not None and cost > budget:
            self.n_overflow_chunks += 1
        self._observe()

    def end_chunk(self, n_paths: int, n_triples: int) -> None:
        self.n_paths += int(n_paths)
        self.n_triples_out += int(n_triples)
        self.resident_chunk = 0

    def runs_changed(self, resident: int, merged: bool = False) -> None:
        self.resident_runs = int(resident)
        if merged:
            self.n_merges += 1
        self._observe()


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BipartiteEdges:
    """Directed edges from one level to the next (COO) — one incidence
    factor of the condensed representation (paper §4.2 Step 5).  Ids are
    validated against ``n_src``/``n_dst`` at construction so range bugs
    surface here, not as silent gather corruption."""

    src: np.ndarray
    dst: np.ndarray
    n_src: int
    n_dst: int

    def __post_init__(self) -> None:
        self.src = np.asarray(self.src, dtype=np.int64)
        self.dst = np.asarray(self.dst, dtype=np.int64)
        if self.src.shape != self.dst.shape:
            raise ValueError("src/dst shape mismatch")
        if self.src.size:
            if self.src.max() >= self.n_src or self.src.min() < 0:
                raise ValueError("src id out of range")
            if self.dst.max() >= self.n_dst or self.dst.min() < 0:
                raise ValueError("dst id out of range")

    @property
    def n_edges(self) -> int:
        return int(self.src.size)

    def reversed(self) -> "BipartiteEdges":
        return BipartiteEdges(self.dst.copy(), self.src.copy(), self.n_dst, self.n_src)

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.n_src)

    def in_degrees(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.n_dst)

    def nbytes(self) -> int:
        return int(self.src.nbytes + self.dst.nbytes)



@dataclasses.dataclass
class Chain:
    """One Edges-statement's condensed path structure (paper §4.2 Step 5:
    one virtual-node layer per postponed large-output join).

    ``edges[0]`` goes real -> virtual-layer-1, ``edges[-1]`` goes
    virtual-layer-k -> real; middle entries connect consecutive virtual
    layers.  ``len(edges) == n_layers + 1`` and ``n_layers >= 1``.
    """

    edges: List[BipartiteEdges]

    def __post_init__(self) -> None:
        if len(self.edges) < 2:
            raise ValueError("a Chain needs at least one virtual layer")
        for a, b in zip(self.edges, self.edges[1:]):
            if a.n_dst != b.n_src:
                raise ValueError("inconsistent layer sizes in chain")

    @property
    def n_layers(self) -> int:
        return len(self.edges) - 1

    @property
    def n_real(self) -> int:
        return self.edges[0].n_src

    @property
    def layer_sizes(self) -> List[int]:
        return [e.n_dst for e in self.edges[:-1]]

    @property
    def n_virtual(self) -> int:
        return sum(self.layer_sizes)

    @property
    def n_edges(self) -> int:
        return sum(e.n_edges for e in self.edges)

    def nbytes(self) -> int:
        return sum(e.nbytes() for e in self.edges)

    # -- expansion -----------------------------------------------------------
    def path_pairs(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All (u, v, multiplicity) realized by this chain.

        Materializes the expansion — only used by EXP conversion, oracle
        tests, and DEDUP-C correction building.  Work/memory is
        O(#expanded paths), chunked over leading-layer nodes to bound the
        peak (paper: this is exactly the cost the condensed rep avoids at
        query time).
        """
        src, dst, mult = _compose_chain(self.edges)
        return src, dst, mult

    # -- streaming expansion (DESIGN.md §2) ------------------------------------
    def per_source_expansion_cost(self) -> np.ndarray:
        """Upper bound on raw triples materialized expanding each leading row.

        ``cost[u] = Σ_i paths(u -> level i+1)``: the sum over compose steps
        of the pre-aggregation output size, i.e. everything the chunked
        composition ever materializes for ``u``.  Computed with k+1
        backward bincount sweeps — O(k²·E) host work, no expansion.
        """
        cost = np.zeros(self.n_real, dtype=np.int64)
        for i in range(len(self.edges)):
            v = np.ones(self.edges[i].n_dst, dtype=np.float64)
            for j in range(i, -1, -1):
                e = self.edges[j]
                v = np.bincount(
                    e.src, weights=v[e.dst], minlength=e.n_src
                )
            cost += v.astype(np.int64)
        return cost

    def n_paths(self) -> int:
        """Total expanded path count (``M.sum()``) without expanding."""
        v = np.ones(self.edges[-1].n_dst, dtype=np.float64)
        for e in reversed(self.edges):
            v = np.bincount(e.src, weights=v[e.dst], minlength=e.n_src)
        return int(v.sum())

    def iter_path_pairs(
        self,
        chunk_rows: Optional[int] = None,
        budget_triples: Optional[int] = None,
        accounting: Optional["ExpansionAccounting"] = None,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Chunked :meth:`path_pairs`: yield aggregated (u, v, m) triples
        block-by-block over leading real rows, never composing more than a
        bounded slice of the expansion at once.

        ``chunk_rows`` fixes the block width in leading rows;
        ``budget_triples`` sizes blocks adaptively from
        :meth:`per_source_expansion_cost` so each block's raw composition
        stays within the budget (a single row whose cost exceeds it gets
        its own block, recorded as an overflow chunk in ``accounting``).
        With neither, blocks default to :data:`DEFAULT_CHUNK_ROWS`.
        Concatenating and aggregating all yielded chunks reproduces
        :meth:`path_pairs` exactly (chunks of one chain are disjoint in u).
        """
        e0 = self.edges[0]
        order = np.argsort(e0.src, kind="stable")
        src_sorted = e0.src[order]
        dst_sorted = e0.dst[order]
        # Cost planning is only needed for budget-sized blocks and for
        # accounting; the default fixed-width path skips the k+1 sweeps.
        cost = None
        if budget_triples is not None or accounting is not None:
            cost = self.per_source_expansion_cost()
        for lo, hi in _row_blocks(self.n_real, cost, chunk_rows, budget_triples):
            a = np.searchsorted(src_sorted, lo, side="left")
            b = np.searchsorted(src_sorted, hi, side="left")
            if a == b:
                continue
            if accounting is not None:
                accounting.begin_chunk(
                    int(cost[lo:hi].sum()), budget=budget_triples
                )
            sub = BipartiteEdges(
                src_sorted[a:b], dst_sorted[a:b], e0.n_src, e0.n_dst
            )
            s, d, m = _compose_chain([sub] + list(self.edges[1:]))
            if accounting is not None:
                accounting.end_chunk(int(m.sum()), s.size)
            yield s, d, m


def _row_blocks(
    n: int,
    cost: Optional[np.ndarray],
    chunk_rows: Optional[int],
    budget_triples: Optional[int],
) -> Iterator[Tuple[int, int]]:
    """Leading-row block boundaries for one streaming pass.

    With a budget, each block is the maximal row prefix whose summed cost
    stays within it (never fewer than one row), found by binary search on
    the cumulative cost — no per-row Python loop.
    """
    if n == 0:
        return
    if budget_triples is not None:
        assert cost is not None
        cum = np.cumsum(cost)
        lo = 0
        base = 0
        while lo < n:
            hi = int(np.searchsorted(cum, base + budget_triples, side="right"))
            hi = max(hi, lo + 1)  # a single row may exceed the budget
            yield lo, hi
            base = int(cum[hi - 1])
            lo = hi
        return
    width = chunk_rows if chunk_rows is not None else DEFAULT_CHUNK_ROWS
    width = max(int(width), 1)
    for lo in range(0, n, width):
        yield lo, min(lo + width, n)


def _compose_pair(
    left: Tuple[np.ndarray, np.ndarray, np.ndarray],
    right: BipartiteEdges,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Compose (u -> m, mult) with bipartite (m -> v): returns (u -> v, mult)."""
    lsrc, lmid, lmult = left
    # Sort right edges by src so each mid id owns a contiguous run.
    order = np.argsort(right.src, kind="stable")
    rsrc_sorted = right.src[order]
    rdst_sorted = right.dst[order]
    starts = np.searchsorted(rsrc_sorted, lmid, side="left")
    ends = np.searchsorted(rsrc_sorted, lmid, side="right")
    counts = ends - starts
    total = int(counts.sum())
    usrc = np.repeat(lsrc, counts)
    umult = np.repeat(lmult, counts)
    if total:
        offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
        udst = rdst_sorted[np.repeat(starts, counts) + offs]
    else:
        udst = np.empty(0, dtype=np.int64)
    # Aggregate duplicate (u, v) pairs, summing multiplicities.
    return _aggregate_pairs(usrc, udst, umult, right.n_dst)


def _aggregate_pairs(
    src: np.ndarray, dst: np.ndarray, mult: np.ndarray, n_dst: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    if src.size == 0:
        return src, dst, mult
    key = src * np.int64(n_dst) + dst
    uniq, inverse = np.unique(key, return_inverse=True)
    summed = np.bincount(inverse, weights=mult.astype(np.float64))
    return (uniq // n_dst).astype(np.int64), (uniq % n_dst).astype(np.int64), summed.astype(np.int64)


def _compose_chain(
    edges: Sequence[BipartiteEdges],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    acc = (edges[0].src, edges[0].dst, np.ones(edges[0].n_edges, dtype=np.int64))
    acc = _aggregate_pairs(*acc, edges[0].n_dst)
    for e in edges[1:]:
        acc = _compose_pair(acc, e)
    return acc


def split_expansion_budget(budget_triples: Optional[int]) -> Optional[int]:
    """Half of a full streaming budget: one half bounds chunk composition,
    the other bounds sorted-run residency in :func:`fold_path_pairs`."""
    if budget_triples is None:
        return None
    return max(int(budget_triples) // 2, 1)


def fold_path_pairs(
    chunks: Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    n_dst: int,
    budget_triples: Optional[int] = None,
    accounting: Optional[ExpansionAccounting] = None,
    aggregate=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Out-of-core merge of aggregated (src, dst, mult) chunk triples.

    Chunks accumulate as sorted runs; whenever the resident triple count
    exceeds ``budget_triples`` the runs are consolidated into one (equal
    keys summed), so residency never grows past
    ``max(budget, unique pairs) + one chunk``.  The result is identical —
    ordering, values, and dtypes — to aggregating all chunks at once.
    ``aggregate`` defaults to the host merge; pass an alternative (e.g.
    the device segment-sum fold in :mod:`repro_torch.core.dedup`) to run the
    consolidation elsewhere.
    """
    if aggregate is None:
        aggregate = _aggregate_pairs
    runs_s: List[np.ndarray] = []
    runs_d: List[np.ndarray] = []
    runs_m: List[np.ndarray] = []
    resident = 0
    for s, d, m in chunks:
        runs_s.append(s)
        runs_d.append(d)
        runs_m.append(m)
        resident += s.size
        if accounting is not None:
            accounting.runs_changed(resident)
        if (
            budget_triples is not None
            and resident > budget_triples
            and len(runs_s) > 1
        ):
            s, d, m = aggregate(
                np.concatenate(runs_s),
                np.concatenate(runs_d),
                np.concatenate(runs_m),
                n_dst,
            )
            runs_s, runs_d, runs_m = [s], [d], [m]
            resident = s.size
            if accounting is not None:
                accounting.runs_changed(resident, merged=True)
    if not runs_s:
        z = np.empty(0, dtype=np.int64)
        return z, z, z
    out = aggregate(
        np.concatenate(runs_s),
        np.concatenate(runs_d),
        np.concatenate(runs_m),
        n_dst,
    )
    if accounting is not None:
        accounting.runs_changed(out[0].size, merged=len(runs_s) > 1)
    return out


def _arrays_identical(a: Optional[np.ndarray], b: Optional[np.ndarray]) -> bool:
    if a is None or b is None:
        return a is b
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and bool(np.array_equal(a, b))


def _edges_identical(a: Optional[BipartiteEdges], b: Optional[BipartiteEdges]) -> bool:
    if a is None or b is None:
        return a is b
    return (
        a.n_src == b.n_src
        and a.n_dst == b.n_dst
        and _arrays_identical(a.src, b.src)
        and _arrays_identical(a.dst, b.dst)
    )


def graphs_identical(a: "CondensedGraph", b: "CondensedGraph") -> bool:
    """Byte-identity of two condensed graphs: every edge array (values,
    order, dtype), layer size, direct edge set, node type, and node
    property must match exactly.  This is the sharded-extraction merge
    invariant (DESIGN.md §7) — far stricter than graph isomorphism or
    equal expansions, and what the parity suite asserts.
    """
    if a.n_real != b.n_real or len(a.chains) != len(b.chains):
        return False
    for ca, cb in zip(a.chains, b.chains):
        if len(ca.edges) != len(cb.edges):
            return False
        if not all(_edges_identical(ea, eb) for ea, eb in zip(ca.edges, cb.edges)):
            return False
    if not _edges_identical(a.direct, b.direct):
        return False
    if not _arrays_identical(a.node_type, b.node_type):
        return False
    if sorted(a.node_properties) != sorted(b.node_properties):
        return False
    return all(
        _arrays_identical(v, b.node_properties[k])
        for k, v in a.node_properties.items()
    )


# ---------------------------------------------------------------------------
# Expanded graph
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ExpandedGraph:
    """The EXP representation (paper §4.1 baseline): unique (src, dst)
    pairs + path multiplicity."""

    src: np.ndarray
    dst: np.ndarray
    multiplicity: np.ndarray
    n: int

    @property
    def n_edges(self) -> int:
        return int(self.src.size)

    def nbytes(self) -> int:
        return int(self.src.nbytes + self.dst.nbytes)

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.n)

    def without_self_loops(self) -> "ExpandedGraph":
        keep = self.src != self.dst
        return ExpandedGraph(
            self.src[keep], self.dst[keep], self.multiplicity[keep], self.n
        )


# ---------------------------------------------------------------------------
# The C-DUP container
# ---------------------------------------------------------------------------

class CondensedGraph:
    """Union of condensed chains + direct edges over one real-node set.

    This is C-DUP exactly as extracted: duplication (multiplicity > 1) is
    allowed and expected.  Dedup algorithms in :mod:`repro_torch.core.dedup`
    consume this and emit either a rewritten ``CondensedGraph`` (DEDUP-1),
    bitmap side-structures (BITMAP-1/2), or a correction edge list
    (DEDUP-C).
    """

    def __init__(
        self,
        n_real: int,
        chains: Sequence[Chain] = (),
        direct: Optional[BipartiteEdges] = None,
        node_properties: Optional[Dict[str, np.ndarray]] = None,
        node_type: Optional[np.ndarray] = None,
    ) -> None:
        self.n_real = int(n_real)
        self.chains = list(chains)
        for c in self.chains:
            if c.n_real != self.n_real or c.edges[-1].n_dst != self.n_real:
                raise ValueError("chain endpoints must be the real node set")
        if direct is not None and (
            direct.n_src != self.n_real or direct.n_dst != self.n_real
        ):
            raise ValueError("direct edges must connect real nodes")
        self.direct = direct
        self.node_properties = dict(node_properties or {})
        self.node_type = node_type  # heterogeneous graphs: int type id per node

    # -- bookkeeping ----------------------------------------------------------
    @property
    def n_virtual(self) -> int:
        return sum(c.n_virtual for c in self.chains)

    @property
    def n_edges_condensed(self) -> int:
        n = sum(c.n_edges for c in self.chains)
        if self.direct is not None:
            n += self.direct.n_edges
        return n

    def nbytes(self) -> int:
        n = sum(c.nbytes() for c in self.chains)
        if self.direct is not None:
            n += self.direct.nbytes()
        return n

    # -- semantics ------------------------------------------------------------
    def iter_path_pairs(
        self,
        chunk_rows: Optional[int] = None,
        budget_triples: Optional[int] = None,
        accounting: Optional[ExpansionAccounting] = None,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Chunked expansion of the whole graph: every chain's
        :meth:`Chain.iter_path_pairs` blocks followed by direct-edge blocks
        (each aggregated, multiplicity = repeat count).  Chunks from
        different chains / the direct set may repeat a (u, v) pair — fold
        them with :func:`fold_path_pairs` to recover
        :meth:`multiplicities` exactly.
        """
        for c in self.chains:
            yield from c.iter_path_pairs(
                chunk_rows=chunk_rows,
                budget_triples=budget_triples,
                accounting=accounting,
            )
        if self.direct is not None and self.direct.n_edges:
            e = self.direct
            order = np.argsort(e.src, kind="stable")
            src_sorted = e.src[order]
            dst_sorted = e.dst[order]
            cost = None
            if budget_triples is not None:
                cost = np.bincount(e.src, minlength=e.n_src)
            for lo, hi in _row_blocks(e.n_src, cost, chunk_rows, budget_triples):
                a = np.searchsorted(src_sorted, lo, side="left")
                b = np.searchsorted(src_sorted, hi, side="left")
                if a == b:
                    continue
                if accounting is not None:
                    accounting.begin_chunk(b - a, budget=budget_triples)
                s, d, m = _aggregate_pairs(
                    src_sorted[a:b],
                    dst_sorted[a:b],
                    np.ones(b - a, dtype=np.int64),
                    e.n_dst,
                )
                if accounting is not None:
                    accounting.end_chunk(b - a, s.size)
                yield s, d, m

    def multiplicities(
        self,
        chunk_rows: Optional[int] = None,
        budget_triples: Optional[int] = None,
        accounting: Optional[ExpansionAccounting] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All expanded (u, v, multiplicity) triples.

        Streams :meth:`iter_path_pairs` through the sorted-run fold, so
        peak host memory is O(unique pairs + one chunk), never O(raw
        expanded paths) — the expansion memory wall the condensed
        representation exists to avoid.  ``budget_triples`` is split
        half/half between chunk composition and run residency, so the
        combined peak stays within the budget whenever the unique-pair
        count and every single row's expansion fit in half of it.
        """
        half = split_expansion_budget(budget_triples)
        return fold_path_pairs(
            self.iter_path_pairs(
                chunk_rows=chunk_rows,
                budget_triples=half,
                accounting=accounting,
            ),
            self.n_real,
            budget_triples=half,
            accounting=accounting,
        )

    def expand(
        self,
        drop_self_loops: bool = False,
        chunk_rows: Optional[int] = None,
        budget_triples: Optional[int] = None,
    ) -> ExpandedGraph:
        """Materialize EXP (paper's baseline representation) via the
        chunked iterator — the output is O(unique pairs) either way; the
        intermediate expansion is bounded by the chunking."""
        s, d, m = self.multiplicities(
            chunk_rows=chunk_rows, budget_triples=budget_triples
        )
        g = ExpandedGraph(s, d, m, self.n_real)
        return g.without_self_loops() if drop_self_loops else g

    # -- preprocessing (paper §4.2 step 6) -------------------------------------
    def preprocess(self, expand_threshold: Optional[float] = None) -> "CondensedGraph":
        """Expand virtual nodes whose expansion does not grow the graph.

        Paper rule: expand virtual node with ``in*out <= in + out + 1``.
        Implemented for single-layer chains (the common case; multi-layer
        middle nodes would need a DAG rep — those chains pass through).
        """
        new_chains: List[Chain] = []
        direct_s: List[np.ndarray] = [
            self.direct.src if self.direct is not None else np.empty(0, np.int64)
        ]
        direct_d: List[np.ndarray] = [
            self.direct.dst if self.direct is not None else np.empty(0, np.int64)
        ]
        for chain in self.chains:
            if chain.n_layers != 1:
                new_chains.append(chain)
                continue
            e_in, e_out = chain.edges
            ins = e_in.in_degrees()  # per virtual node
            outs = e_out.out_degrees()
            cost_keep = ins + outs + 1
            cost_expand = ins * outs
            expand_mask = cost_expand <= cost_keep
            if not expand_mask.any():
                new_chains.append(chain)
                continue
            # Direct edges from expanded virtual nodes.
            keep_in = ~expand_mask[e_in.dst]
            keep_out = ~expand_mask[e_out.src]
            sub_in = BipartiteEdges(
                e_in.src[~keep_in], e_in.dst[~keep_in], e_in.n_src, e_in.n_dst
            )
            sub_out = BipartiteEdges(
                e_out.src[~keep_out], e_out.dst[~keep_out], e_out.n_src, e_out.n_dst
            )
            if sub_in.n_edges:
                # Preserve path multiplicity: expanding a virtual node keeps
                # each path as its own direct edge (dedup happens later).
                s, d, m = _compose_chain([sub_in, sub_out])
                direct_s.append(np.repeat(s, m))
                direct_d.append(np.repeat(d, m))
            # Remaining virtual nodes, re-indexed densely.
            remap = -np.ones(e_in.n_dst, dtype=np.int64)
            kept = np.flatnonzero(~expand_mask)
            remap[kept] = np.arange(kept.size)
            if kept.size:
                new_in = BipartiteEdges(
                    e_in.src[keep_in],
                    remap[e_in.dst[keep_in]],
                    e_in.n_src,
                    int(kept.size),
                )
                new_out = BipartiteEdges(
                    remap[e_out.src[keep_out]],
                    e_out.dst[keep_out],
                    int(kept.size),
                    e_out.n_dst,
                )
                new_chains.append(Chain([new_in, new_out]))
        ds = np.concatenate(direct_s)
        dd = np.concatenate(direct_d)
        direct = (
            BipartiteEdges(ds, dd, self.n_real, self.n_real) if ds.size else None
        )
        return CondensedGraph(
            self.n_real, new_chains, direct, self.node_properties, self.node_type
        )

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"CondensedGraph(n_real={self.n_real}, n_virtual={self.n_virtual}, "
            f"chains={len(self.chains)}, edges={self.n_edges_condensed})"
        )

