"""Deduplication algorithms & structures (paper §5, App. B).

Input everywhere: a C-DUP :class:`~repro_torch.core.condensed.CondensedGraph`.
Outputs:

* :func:`build_correction`   — DEDUP-C: sparse correction triples
  ``(src, dst, count)`` with ``A = M − D`` (``A = min(M, 1)``, minus the
  diagonal when self loops are dropped), so ring propagation over the
  condensed graph subtracts ``D x`` and counts every expanded edge once.
* :func:`build_wedge_correction` — the quadratic correction ``W`` with
  ``A² = M² − W`` for two-hop (wedge) propagation.
* :func:`bitmap1` / :func:`bitmap2` — BITMAP representations (paper §5.1):
  per-(real source, virtual node) bitmaps over the virtual node's
  out-slots.  BITMAP-2 is the greedy set-cover variant, as a parallel
  greedy (all real nodes advance one pick per round).
* :func:`dedup1_*`           — four DEDUP-1 rewriting algorithms (§5.2.1)
  for single-layer symmetric condensed graphs.
* :func:`dedup2_greedy`      — DEDUP-2 (App. B): virtual-virtual edges.

Everything here is host-side NumPy/Python preprocessing, as in the paper
(a one-time cost amortized over analyses, §6.1.3), and a verbatim copy of
the JAX package's module of the same name: identical inputs give
identical arrays, sets and iteration orders (the greedy algorithms
shuffle with ``default_rng(0)``).  The optional device fold of the
streaming correction runs on torch.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .condensed import (
    BipartiteEdges,
    Chain,
    CondensedGraph,
    ExpansionAccounting,
    _aggregate_pairs,
    build_csr,
    fold_path_pairs,
    split_expansion_budget,
)

__all__ = [
    "build_correction",
    "build_correction_streaming",
    "build_wedge_correction",
    "StreamedCorrection",
    "TRIPLE_BYTES",
    "BitmapRep",
    "bitmap1",
    "bitmap2",
    "dedup1_naive_virtual_first",
    "dedup1_naive_real_first",
    "dedup1_greedy_real_first",
    "dedup1_greedy_virtual_first",
    "Dedup1Result",
    "Dedup2Rep",
    "dedup2_greedy",
    "membership_sets",
    "graph_from_membership",
    "is_symmetric_single_layer",
]


def build_correction(
    graph: CondensedGraph, drop_self_loops: bool = True
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sparse D with  A = M - D,  A = min(M, 1) (minus diag if requested).

    Returns (src, dst, count) triples: count = multiplicity-1 for
    duplicated off-diagonal pairs, plus full multiplicity on the diagonal
    when ``drop_self_loops``.
    """
    s, d, m = graph.multiplicities()
    return _correction_from_multiplicities(s, d, m, drop_self_loops)


def _correction_from_multiplicities(
    s: np.ndarray, d: np.ndarray, m: np.ndarray, drop_self_loops: bool
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    diag = s == d
    if drop_self_loops:
        corr = np.where(diag, m, m - 1)
    else:
        corr = m - 1
    keep = corr > 0
    return s[keep], d[keep], corr[keep]


def _coo_coalesce(
    src: np.ndarray, dst: np.ndarray, val: np.ndarray, n: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    key = src.astype(np.int64) * n + dst.astype(np.int64)
    uniq, inv = np.unique(key, return_inverse=True)
    out = np.zeros(uniq.size, dtype=np.int64)
    np.add.at(out, inv, val.astype(np.int64))
    keep = out != 0
    return (uniq[keep] // n), (uniq[keep] % n), out[keep]


def _coo_matmul(
    a: Tuple[np.ndarray, np.ndarray, np.ndarray],
    b: Tuple[np.ndarray, np.ndarray, np.ndarray],
    n: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sparse ``A @ B`` over (src, dst, val) COO triples, no dense n×n."""
    as_, ad, av = a
    bs, bd, bv = b
    if as_.size == 0 or bs.size == 0:
        e = np.zeros(0, np.int64)
        return e, e.copy(), e.copy()
    order = np.argsort(bs, kind="stable")
    bs_s, bd_s, bv_s = bs[order], bd[order], bv[order]
    lo = np.searchsorted(bs_s, ad, side="left")
    hi = np.searchsorted(bs_s, ad, side="right")
    cnt = hi - lo
    total = int(cnt.sum())
    if total == 0:
        e = np.zeros(0, np.int64)
        return e, e.copy(), e.copy()
    rep = np.repeat(np.arange(as_.size), cnt)
    offset = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    idx = np.repeat(lo, cnt) + offset
    return _coo_coalesce(
        as_[rep], bd_s[idx], av[rep].astype(np.int64) * bv_s[idx], n
    )


def build_wedge_correction(
    graph: CondensedGraph,
    correction: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    drop_self_loops: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sparse W with  A² = M² − W:  the *wedge correction* (DESIGN.md §11).

    The linear DEDUP-C identity ``A = M − D`` only makes single hops
    exact; wedge counting (the two-hop building block of triangle
    counting and clustering coefficients) squares it:

        ``A² = (M − D)² = M² − (M·D + D·M − D²)``

    so ``W = M·D + D·M − D²`` is exactly the count of *duplicate wedges*
    — two-hop paths whose legs are realized by more than one condensed
    path through shared virtual nodes — that raw C-DUP wedge propagation
    over-counts.  Returned as coalesced (src, dst, count) triples built
    sparsely from the expansion triples (no dense n×n materialization);
    :func:`repro_torch.core.engine.propagate_wedge` subtracts them in one
    segment pass after two raw multiplicity hops.  ``W`` may carry
    negative counts where ``D²`` dominates; that is expected — it is a
    correction operator, not a multiplicity matrix.
    """
    if correction is None:
        correction = build_correction(graph, drop_self_loops=drop_self_loops)
    cs, cd, cm = (np.asarray(t) for t in tuple(correction))
    D = (cs, cd, cm.astype(np.int64))
    s, d, m = graph.multiplicities()
    M = (s, d, m.astype(np.int64))
    n = graph.n_real
    md = _coo_matmul(M, D, n)
    dm = _coo_matmul(D, M, n)
    dd = _coo_matmul(D, D, n)
    src = np.concatenate([md[0], dm[0], dd[0]])
    dst = np.concatenate([md[1], dm[1], dd[1]])
    val = np.concatenate([md[2], dm[2], -dd[2]])
    return _coo_coalesce(src, dst, val, n)


# Host accounting unit for one resident (src, dst, mult) int64 triple.
TRIPLE_BYTES = 24


@dataclasses.dataclass
class StreamedCorrection:
    """DEDUP-C correction triples plus the accounting that built them.

    Unpacks like the plain ``(src, dst, count)`` tuple from
    :func:`build_correction`, so ``engine.to_device(..., correction=...)``
    accepts either; ``accounting`` carries the streaming-budget evidence
    (peak resident triples, chunk/merge counts).
    """

    src: np.ndarray
    dst: np.ndarray
    count: np.ndarray
    accounting: ExpansionAccounting

    def __iter__(self):
        return iter((self.src, self.dst, self.count))

    def __len__(self) -> int:
        return 3

    def __getitem__(self, i):
        return (self.src, self.dst, self.count)[i]

    @property
    def nnz(self) -> int:
        """The number of correction triples."""
        return int(self.src.size)

    def nbytes(self) -> int:
        return int(self.src.nbytes + self.dst.nbytes + self.count.nbytes)


def _device_aggregator(device):
    """The multiplicity fold on ``device``: sort the pair keys, then one
    segment sum over runs of equal keys, so the host only receives
    already-aggregated triples.  Keys and sums are int64 on the device, so
    no size limit applies beyond int64's."""

    def aggregate(
        src: np.ndarray, dst: np.ndarray, mult: np.ndarray, n_dst: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if src.size == 0:
            return _aggregate_pairs(src, dst, mult, n_dst)
        key = torch.from_numpy(
            np.asarray(src, np.int64) * np.int64(n_dst) + np.asarray(dst, np.int64)
        ).to(device)
        ks, order = torch.sort(key)
        ms = torch.from_numpy(np.asarray(mult, np.int64)).to(device)[order]
        is_new = torch.ones_like(ks, dtype=torch.bool)
        is_new[1:] = ks[1:] != ks[:-1]
        seg = torch.cumsum(is_new.to(torch.int64), 0) - 1
        n_uniq = int(seg[-1].item()) + 1
        sums = torch.zeros(n_uniq, dtype=torch.int64, device=ks.device)
        sums.index_add_(0, seg, ms)
        uniq = ks[is_new].cpu().numpy()
        summed = sums.cpu().numpy()
        return uniq // n_dst, uniq % n_dst, summed

    return aggregate


def build_correction_streaming(
    graph: CondensedGraph,
    budget_bytes: Optional[int] = None,
    *,
    budget_triples: Optional[int] = None,
    chunk_rows: Optional[int] = None,
    drop_self_loops: bool = True,
    device_fold: bool = False,
    device="cuda",
) -> StreamedCorrection:
    """DEDUP-C correction identical to :func:`build_correction`, built
    without ever materializing the full expansion on the host.

    The graph's chunked expansion iterator walks leading rows in bounded
    blocks and a sorted-run fold consolidates duplicate (u, v) keys
    whenever residency crosses the budget — half of which bounds per-chunk
    composition and half run residency.  ``budget_bytes`` is the same
    budget in host bytes (:data:`TRIPLE_BYTES` per triple);
    ``budget_triples`` takes precedence.  ``device_fold`` runs the run
    consolidation on ``device`` (a torch sort plus a segment sum).
    """
    if budget_triples is None and budget_bytes is not None:
        budget_triples = max(int(budget_bytes) // TRIPLE_BYTES, 1)
    accounting = ExpansionAccounting(budget_triples=budget_triples)
    half = split_expansion_budget(budget_triples)
    s, d, m = fold_path_pairs(
        graph.iter_path_pairs(
            chunk_rows=chunk_rows,
            budget_triples=half,
            accounting=accounting,
        ),
        graph.n_real,
        budget_triples=half,
        accounting=accounting,
        aggregate=_device_aggregator(device) if device_fold else None,
    )
    cs, cd, cm = _correction_from_multiplicities(s, d, m, drop_self_loops)
    return StreamedCorrection(cs, cd, cm, accounting)


# ---------------------------------------------------------------------------
# Shared single-layer helpers
# ---------------------------------------------------------------------------

def _single_chain(graph: CondensedGraph) -> Chain:
    if len(graph.chains) != 1 or graph.chains[0].n_layers != 1:
        raise ValueError(
            "this algorithm handles one single-layer chain "
            f"(got {len(graph.chains)} chains, max {graph.max_layers} layers)"
        )
    return graph.chains[0]


def is_symmetric_single_layer(graph: CondensedGraph) -> bool:
    try:
        chain = _single_chain(graph)
    except ValueError:
        return False
    e_in, e_out = chain.edges
    a = np.lexsort((e_in.dst, e_in.src))
    b = np.lexsort((e_out.src, e_out.dst))
    return (
        e_in.n_edges == e_out.n_edges
        and np.array_equal(e_in.src[a], e_out.dst[b])
        and np.array_equal(e_in.dst[a], e_out.src[b])
    )


def membership_sets(graph: CondensedGraph) -> List[Set[int]]:
    """Virtual-node member sets of a symmetric single-layer graph."""
    chain = _single_chain(graph)
    e_in = chain.edges[0]
    sets: List[Set[int]] = [set() for _ in range(e_in.n_dst)]
    for u, v in zip(e_in.src.tolist(), e_in.dst.tolist()):
        sets[v].add(u)
    return sets


def graph_from_membership(
    n_real: int,
    sets: Sequence[Set[int]],
    direct_pairs: Sequence[Tuple[int, int]] = (),
) -> CondensedGraph:
    """Build a symmetric single-layer C-DUP from membership sets.

    ``direct_pairs`` are undirected (u, v) — stored as bidirectional edges.
    Empty and singleton sets are dropped (they realize no pairs).
    """
    live = [s for s in sets if len(s) >= 2]
    srcs: List[np.ndarray] = [np.empty(0, dtype=np.int64)]
    dsts: List[np.ndarray] = [np.empty(0, dtype=np.int64)]
    for vid, s in enumerate(live):
        members = np.fromiter(s, dtype=np.int64)
        srcs.append(members)
        dsts.append(np.full(members.size, vid, dtype=np.int64))
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    chains = []
    if src.size:
        e_in = BipartiteEdges(src, dst, n_real, len(live))
        chains = [Chain([e_in, e_in.reversed()])]
    direct = None
    if direct_pairs:
        pa = np.array([p[0] for p in direct_pairs], dtype=np.int64)
        pb = np.array([p[1] for p in direct_pairs], dtype=np.int64)
        direct = BipartiteEdges(
            np.concatenate([pa, pb]), np.concatenate([pb, pa]), n_real, n_real
        )
    return CondensedGraph(n_real, chains, direct)


# ---------------------------------------------------------------------------
# Triple expansion shared by the BITMAP algorithms.
# For every in-edge (u, V) and every out-slot s of V (dst v): one triple.
# Triple order = (u-grouped, in-adjacency order, slot order) = DFS order.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Triples:
    edge_id: np.ndarray   # index into the u-grouped in-edge list
    u: np.ndarray
    v: np.ndarray
    slot: np.ndarray      # out-slot within the virtual node
    pair_ptr: np.ndarray  # per in-edge: [ptr[i], ptr[i+1]) range of triples
    in_src: np.ndarray    # u per in-edge (grouped by u, adjacency order)
    in_dst: np.ndarray    # V per in-edge
    out_indptr: np.ndarray
    out_indices: np.ndarray
    n_real: int
    n_virtual: int


def _expand_triples(graph: CondensedGraph) -> _Triples:
    chain = _single_chain(graph)
    e_in, e_out = chain.edges
    out_csr = build_csr(e_out)
    order = np.argsort(e_in.src, kind="stable")
    in_src = e_in.src[order]
    in_dst = e_in.dst[order]
    deg = (out_csr.indptr[1:] - out_csr.indptr[:-1])[in_dst]
    pair_ptr = np.zeros(in_src.size + 1, dtype=np.int64)
    np.cumsum(deg, out=pair_ptr[1:])
    total = int(pair_ptr[-1])
    edge_id = np.repeat(np.arange(in_src.size), deg)
    offs = np.arange(total) - np.repeat(pair_ptr[:-1], deg)
    tri_v = out_csr.indices[np.repeat(out_csr.indptr[:-1][in_dst], deg) + offs]
    return _Triples(
        edge_id=edge_id,
        u=np.repeat(in_src, deg),
        v=tri_v,
        slot=offs,
        pair_ptr=pair_ptr,
        in_src=in_src,
        in_dst=in_dst,
        out_indptr=out_csr.indptr,
        out_indices=out_csr.indices,
        n_real=graph.n_real,
        n_virtual=e_in.n_dst,
    )


@dataclasses.dataclass
class BitmapRep:
    """BITMAP representation: C-DUP edges + per-(u,V) out-slot bitmaps.

    ``bits[pair_ptr[i]:pair_ptr[i+1]]`` is the bitmap of in-edge ``i``
    (edges grouped by source real node, adjacency order).  Deleted in-edges
    (BITMAP-2 set-cover leftovers) have ``edge_alive = False`` and no bits.
    """

    graph: CondensedGraph
    in_src: np.ndarray
    in_dst: np.ndarray
    edge_alive: np.ndarray
    bits: np.ndarray       # uint8 0/1 per (in-edge, out-slot)
    pair_ptr: np.ndarray

    @property
    def n_bitmaps(self) -> int:
        return int(self.edge_alive.sum())

    @property
    def n_bits(self) -> int:
        return int(self.bits.size)

    def nbytes(self) -> int:
        """Packed-bitmap memory accounting (bits/8 + edges + indexes)."""
        edges = int(self.edge_alive.sum()) * 16  # surviving condensed edges
        out_edges = self.graph.chains[0].edges[1].n_edges * 16
        return edges + out_edges + (self.n_bits + 7) // 8 + self.pair_ptr.nbytes

    def to_dedup_pairs(self) -> Tuple[np.ndarray, np.ndarray]:
        """Surviving (u, v) pairs — each exactly once if valid (test hook)."""
        alive = self.edge_alive[
            np.repeat(np.arange(self.in_src.size), np.diff(self.pair_ptr))
        ]
        on = (self.bits == 1) & alive
        tri = _expand_triples(self.graph)
        return tri.u[on], tri.v[on]


def bitmap1(graph: CondensedGraph) -> BitmapRep:
    """BITMAP-1 (paper §5.1.1): first-path-wins bit assignment.

    Vectorized equivalent of the per-real-node DFS: the DFS visit order is
    (source, in-adjacency, out-slot); the first triple reaching a given
    (u, v) pair gets bit 1, later ones 0.  Keeps every C-DUP edge.
    """
    tri = _expand_triples(graph)
    key = tri.u.astype(np.int64) * tri.n_real + tri.v
    _, first_idx = np.unique(key, return_index=True)
    bits = np.zeros(tri.u.size, dtype=np.uint8)
    bits[first_idx] = 1
    return BitmapRep(
        graph=graph,
        in_src=tri.in_src,
        in_dst=tri.in_dst,
        edge_alive=np.ones(tri.in_src.size, dtype=bool),
        bits=bits,
        pair_ptr=tri.pair_ptr,
    )


def bitmap2(graph: CondensedGraph, max_rounds: int = 10_000) -> BitmapRep:
    """BITMAP-2 (paper §5.1.3): greedy set cover per real node.

    Parallel-greedy rounds: in each round every still-unfinished real node
    picks its uncovered-gain-maximizing virtual neighbor (equal to the
    sequential greedy because sources are independent).  Edges with zero
    remaining gain are deleted (paper: "there is no reason to traverse
    those").
    """
    tri = _expand_triples(graph)
    n_in = tri.in_src.size
    key = tri.u.astype(np.int64) * tri.n_real + tri.v
    uniq, pair_id = np.unique(key, return_inverse=True)
    covered = np.zeros(uniq.size, dtype=bool)
    bits = np.zeros(tri.u.size, dtype=np.uint8)
    # edge states: 0 undecided / 1 chosen / 2 deleted
    state = np.zeros(n_in, dtype=np.int8)
    tri_edge = tri.edge_id

    for _ in range(max_rounds):
        undecided = state == 0
        if not undecided.any():
            break
        tri_live = undecided[tri_edge] & ~covered[pair_id]
        gain = np.bincount(tri_edge[tri_live], minlength=n_in)
        gain[~undecided] = -1
        # Per-source argmax over undecided edges.
        src = tri.in_src
        best_gain = np.full(tri.n_real, -1, dtype=np.int64)
        np.maximum.at(best_gain, src, gain)
        is_best = (gain == best_gain[src]) & undecided
        # Tie-break: lowest edge index per source.
        first_of_src = np.zeros(n_in, dtype=bool)
        cand = np.flatnonzero(is_best)
        if cand.size:
            # edges are grouped by src already; first candidate per src wins
            srcs_c = src[cand]
            first = np.ones(cand.size, dtype=bool)
            first[1:] = srcs_c[1:] != srcs_c[:-1]
            first_of_src[cand[first]] = True
        zero_gain = first_of_src & (gain <= 0)
        pick = first_of_src & (gain > 0)
        # Deleting: zero-gain picks mean every remaining edge of that source
        # is useless; delete all undecided edges of finished sources.
        done_src = np.zeros(tri.n_real, dtype=bool)
        done_src[src[zero_gain]] = True
        state[(state == 0) & done_src[src]] = 2
        if pick.any():
            state[pick] = 1
            on = pick[tri_edge] & ~covered[pair_id]
            # a virtual node's out-list may repeat a target (multiplicity
            # from a multi-layer collapse): set one slot per pair, not all
            on_idx = np.flatnonzero(on)
            _, first_slot = np.unique(pair_id[on_idx], return_index=True)
            bits[on_idx[first_slot]] = 1
            covered[pair_id[on_idx]] = True
    else:  # pragma: no cover - loop guard
        raise RuntimeError("bitmap2 did not converge")

    return BitmapRep(
        graph=graph,
        in_src=tri.in_src,
        in_dst=tri.in_dst,
        edge_alive=state == 1,
        bits=bits,
        pair_ptr=tri.pair_ptr,
    )


# ---------------------------------------------------------------------------
# DEDUP-1 rewriting algorithms (paper §5.2.1), symmetric single-layer.
#
# State shared by all four: membership sets S_V, a pair-coverage counter
# over unordered real pairs, and accumulated direct edges.  Validity
# invariant (checked in tests): every originally-connected pair is covered
# exactly once; no new pairs appear.
# ---------------------------------------------------------------------------

def _require_symmetric(graph: CondensedGraph) -> List[Set[int]]:
    if not is_symmetric_single_layer(graph):
        raise ValueError(
            "DEDUP-1 algorithms are implemented for symmetric single-layer "
            "graphs (paper's evaluated setting); symmetrize or use "
            "BITMAP-2 / DEDUP-C for the general case"
        )
    return membership_sets(graph)


def _pair(u: int, v: int) -> Tuple[int, int]:
    return (u, v) if u < v else (v, u)


@dataclasses.dataclass
class Dedup1Result:
    graph: CondensedGraph
    n_direct_edges: int
    n_virtual_edges: int
    seconds: float

    @property
    def total_edges(self) -> int:
        # Undirected accounting to match the paper's figures: a membership
        # edge is one edge, a direct pair is one edge.
        return self.n_direct_edges + self.n_virtual_edges


def _finalize(
    n_real: int,
    sets: Sequence[Set[int]],
    direct: Set[Tuple[int, int]],
    t0: float,
) -> Dedup1Result:
    live = [s for s in sets if len(s) >= 2]
    g = graph_from_membership(n_real, live, sorted(direct))
    return Dedup1Result(
        graph=g,
        n_direct_edges=len(direct),
        n_virtual_edges=sum(len(s) for s in live),
        seconds=time.perf_counter() - t0,
    )


def _order(n: int, ordering: str, rng: Optional[np.random.Generator]) -> np.ndarray:
    idx = np.arange(n)
    if ordering == "random":
        (rng or np.random.default_rng(0)).shuffle(idx)
    return idx


def dedup1_naive_virtual_first(
    graph: CondensedGraph,
    ordering: str = "random",
    rng: Optional[np.random.Generator] = None,
) -> Dedup1Result:
    """Paper 'Naive Virtual Nodes First': add virtual nodes one at a time,
    shaving overlaps > 1 against already-processed nodes by moving one real
    node out of the lower-degree virtual node and patching with direct
    edges."""
    t0 = time.perf_counter()
    sets = [set(s) for s in _require_symmetric(graph)]
    rng = rng or np.random.default_rng(0)
    n_real = graph.n_real
    member_of: List[Set[int]] = [set() for _ in range(n_real)]  # processed only
    covered: Set[Tuple[int, int]] = set()
    direct: Set[Tuple[int, int]] = set()
    processed: List[int] = []

    def cover_set(vid: int) -> None:
        s = sorted(sets[vid])
        for i, a in enumerate(s):
            for b in s[i + 1 :]:
                covered.add(_pair(a, b))

    def uncover_node(vid: int, r: int) -> None:
        for other in sets[vid]:
            if other != r:
                covered.discard(_pair(r, other))

    for vid in _order(len(sets), ordering, rng).tolist():
        S = sets[vid]
        changed = True
        while changed and len(S) >= 2:
            changed = False
            # Find a processed virtual node overlapping in >= 2 members.
            counts: Dict[int, int] = {}
            for u in S:
                for rid in member_of[u]:
                    counts[rid] = counts.get(rid, 0) + 1
            for rid, c in counts.items():
                if c <= 1:
                    continue
                inter = list(S & sets[rid])
                r = inter[int(rng.integers(len(inter)))]
                # Remove from the lower-degree virtual node.
                victim = vid if len(S) <= len(sets[rid]) else rid
                if victim == rid:
                    uncover_node(rid, r)
                    sets[rid].discard(r)
                    member_of[r].discard(rid)
                    # Patch r's lost connections through rid.
                    for other in sets[rid]:
                        p = _pair(r, other)
                        if p not in covered:
                            direct.add(p)
                            covered.add(p)
                else:
                    S.discard(r)
                    # r loses its (future) connections through V; patch
                    # against the rest of V's current members.
                    for other in S:
                        p = _pair(r, other)
                        if p not in covered:
                            direct.add(p)
                            covered.add(p)
                changed = True
                break
        # Commit V: remove members whose pairs are already covered? The
        # naive algorithm guarantees overlap <= 1 now; cover V's pairs,
        # but any single pre-covered pair (overlap exactly 1 via direct
        # edges) must be avoided: drop direct duplicates.
        s_sorted = sorted(S)
        for i, a in enumerate(s_sorted):
            for b in s_sorted[i + 1 :]:
                p = _pair(a, b)
                if p in covered:
                    direct.discard(p)  # keep via V instead if it was direct
                    if p in direct:
                        continue
        # Re-check: pairs covered through processed virtual nodes (overlap
        # exactly 1) stay; that single shared member contributes no pair.
        for i, a in enumerate(s_sorted):
            for b in s_sorted[i + 1 :]:
                covered.add(_pair(a, b))
        for u in S:
            member_of[u].add(vid)
        processed.append(vid)
    return _finalize(n_real, sets, direct, t0)


def dedup1_naive_real_first(
    graph: CondensedGraph,
    ordering: str = "random",
    rng: Optional[np.random.Generator] = None,
) -> Dedup1Result:
    """Paper 'Naive Real Nodes First': per real node, resolve all pairwise
    overlaps among its virtual neighborhood (processed set scoped to the
    node)."""
    t0 = time.perf_counter()
    sets = [set(s) for s in _require_symmetric(graph)]
    rng = rng or np.random.default_rng(0)
    n_real = graph.n_real
    direct: Set[Tuple[int, int]] = set()
    # membership index kept live as sets mutate
    member: List[Set[int]] = [set() for _ in range(n_real)]
    for vid, s in enumerate(sets):
        for u in s:
            member[u].add(vid)

    def covered_elsewhere(a: int, b: int, excl: Tuple[int, ...]) -> bool:
        common = member[a] & member[b]
        return bool(common - set(excl)) or _pair(a, b) in direct

    for u in _order(n_real, ordering, rng).tolist():
        local: List[int] = []
        for vid in sorted(member[u]):
            for rid in local:
                while len(sets[vid] & sets[rid]) > 1:
                    inter = sorted(sets[vid] & sets[rid])
                    r = inter[int(rng.integers(len(inter)))]
                    victim = vid if len(sets[vid]) <= len(sets[rid]) else rid
                    keeper = rid if victim == vid else vid
                    sets[victim].discard(r)
                    member[r].discard(victim)
                    for other in sets[victim]:
                        if not covered_elsewhere(r, other, (victim,)):
                            direct.add(_pair(r, other))
            if vid in member[u]:
                local.append(vid)
    return _finalize(n_real, sets, direct, t0)


def dedup1_greedy_real_first(
    graph: CondensedGraph,
    ordering: str = "random",
    rng: Optional[np.random.Generator] = None,
) -> Dedup1Result:
    """Paper 'Greedy Real Nodes First' (Fig 8): per real node u, greedily
    select which virtual nodes u stays connected to (set-cover heuristic);
    u's duplicated memberships are dropped, patched by direct edges."""
    t0 = time.perf_counter()
    sets = [set(s) for s in _require_symmetric(graph)]
    rng = rng or np.random.default_rng(0)
    n_real = graph.n_real
    direct: Set[Tuple[int, int]] = set()
    member: List[Set[int]] = [set() for _ in range(n_real)]
    for vid, s in enumerate(sets):
        for x in s:
            member[x].add(vid)

    for u in _order(n_real, ordering, rng).tolist():
        vlist = sorted(member[u])
        if len(vlist) <= 1:
            continue
        # Universe: u's neighbors through its virtual nodes.
        covered: Set[int] = set()
        chosen: List[int] = []
        remaining = set(vlist)
        while remaining:
            best, best_gain = -1, 0
            for vid in sorted(remaining):
                gain = len((sets[vid] - {u}) - covered)
                if gain > best_gain:
                    best, best_gain = vid, gain
            if best < 0:
                break
            chosen.append(best)
            remaining.discard(best)
            covered |= sets[best] - {u}
        # u leaves every unchosen virtual node; patch pairs (u, w) that
        # were ONLY covered by an unchosen node.
        for vid in sorted(remaining):
            sets[vid].discard(u)
            member[u].discard(vid)
        # Now recompute u's coverage: duplicates among chosen still exist
        # for neighbors reachable via 2+ chosen nodes — greedy cover keeps
        # first-cover, drop u from later covers would break OTHER pairs;
        # instead shave per-pair: for each neighbor w covered twice, remove
        # w or u from one set and patch.
        seen: Dict[int, int] = {}
        for vid in chosen:
            for w in sorted(sets[vid] - {u}):
                if w not in seen:
                    seen[w] = vid
                    continue
                # duplicate (u, w) via seen[w] and vid: shave from the
                # smaller set, patch broken pairs.
                victim = vid if len(sets[vid]) <= len(sets[seen[w]]) else seen[w]
                r = u if len(sets[victim]) == 2 else (u if rng.integers(2) else w)
                # removing r from victim breaks r's pairs inside victim
                sets[victim].discard(r)
                member[r].discard(victim)
                for other in sorted(sets[victim]):
                    common = member[r] & member[other]
                    if not common and _pair(r, other) not in direct:
                        direct.add(_pair(r, other))
                if victim == seen[w]:
                    seen[w] = vid
    return _finalize(n_real, sets, direct, t0)


def dedup1_greedy_virtual_first(
    graph: CondensedGraph,
    ordering: str = "random",
    rng: Optional[np.random.Generator] = None,
) -> Dedup1Result:
    """Paper 'Greedy Virtual Nodes First' (Fig 9; used for Fig 10 DEDUP-1).

    Virtual nodes enter one at a time; overlaps |C_i| >= 2 against already
    placed nodes are shaved by repeatedly removing the real node with the
    best benefit/cost ratio (cost = direct edges added, benefit = overlap
    reduction across all conflicting nodes).
    """
    t0 = time.perf_counter()
    sets = [set(s) for s in _require_symmetric(graph)]
    rng = rng or np.random.default_rng(0)
    n_real = graph.n_real
    direct: Set[Tuple[int, int]] = set()
    member: List[Set[int]] = [set() for _ in range(n_real)]  # placed only
    placed: Set[int] = set()

    for vid in _order(len(sets), ordering, rng).tolist():
        V = sets[vid]
        while True:
            # Conflicting placed nodes and their intersections with V.
            counts: Dict[int, List[int]] = {}
            for u in sorted(V):
                for rid in member[u]:
                    counts.setdefault(rid, []).append(u)
            conflicts = {rid: c for rid, c in counts.items() if len(c) >= 2}
            if not conflicts:
                break
            # candidate removals: real r from V, or r from a conflicting rid
            best_ratio, best_action = -1.0, None
            cand_pool: List[Tuple[int, int]] = []
            for rid, inter in sorted(conflicts.items()):
                for r in inter:
                    cand_pool.append((rid, r))
            for rid, r in cand_pool:
                # Option A: remove r from V.
                benefit_a = sum(1 for rid2, it in conflicts.items() if r in it)
                cost_a = max(len(V) - 1, 1) - 0  # direct edges to patch
                # Patching only pairs not covered elsewhere — approximate
                # cost by |V|-1 (paper uses the same upper-bound flavor).
                ratio_a = benefit_a / max(cost_a, 1)
                # Option B: remove r from rid.
                benefit_b = 1.0
                cost_b = max(len(sets[rid]) - 1, 1)
                ratio_b = benefit_b / max(cost_b, 1)
                if ratio_a > best_ratio:
                    best_ratio, best_action = ratio_a, ("V", r, rid)
                if ratio_b > best_ratio:
                    best_ratio, best_action = ratio_b, ("R", r, rid)
            assert best_action is not None
            kind, r, rid = best_action
            if kind == "V":
                V.discard(r)
                for other in sorted(V):
                    common = member[r] & member[other]
                    if not common and _pair(r, other) not in direct:
                        direct.add(_pair(r, other))
            else:
                sets[rid].discard(r)
                member[r].discard(rid)
                for other in sorted(sets[rid]):
                    common = member[r] & member[other]
                    # may also be covered by V (about to be placed)
                    in_v = r in V and other in V
                    if not common and not in_v and _pair(r, other) not in direct:
                        direct.add(_pair(r, other))
        # place V
        for u in V:
            member[u].add(vid)
        placed.add(vid)
        # direct edges now covered by V are dropped
        for i, a in enumerate(sorted(V)):
            for b in sorted(V):
                if b > a:
                    direct.discard(_pair(a, b))
    return _finalize(n_real, sets, direct, t0)


# ---------------------------------------------------------------------------
# DEDUP-2 (App. B): symmetric single-layer with virtual-virtual edges.
# neighbors(u) = ⋃_{V ∋ u} [ (S_V − u) ∪ ⋃_{W ~ V} S_W ]
# Invariants: (1) |S_V ∩ S_W| <= 1 for all V, W;
#             (2) adjacent virtual nodes are disjoint;
#             (3) the virtual neighbors of any V are pairwise disjoint;
#             (4) every pair covered exactly once overall.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Dedup2Rep:
    n_real: int
    sets: List[Set[int]]
    vv_edges: Set[Tuple[int, int]]  # undirected virtual-virtual edges
    seconds: float = 0.0

    def neighbor_lists(self) -> List[Set[int]]:
        adj: List[Set[int]] = [set() for _ in range(self.n_real)]
        vadj: Dict[int, Set[int]] = {}
        for a, b in self.vv_edges:
            vadj.setdefault(a, set()).add(b)
            vadj.setdefault(b, set()).add(a)
        for vid, s in enumerate(self.sets):
            for u in s:
                adj[u] |= s - {u}
                for w in vadj.get(vid, ()):
                    adj[u] |= self.sets[w]
        return adj

    def pair_multiplicities(self) -> Dict[Tuple[int, int], int]:
        mult: Dict[Tuple[int, int], int] = {}
        vadj: Dict[int, Set[int]] = {}
        for a, b in self.vv_edges:
            vadj.setdefault(a, set()).add(b)
            vadj.setdefault(b, set()).add(a)
        for vid, s in enumerate(self.sets):
            ss = sorted(s)
            for i, a in enumerate(ss):
                for b in ss[i + 1 :]:
                    p = _pair(a, b)
                    mult[p] = mult.get(p, 0) + 1
            for w in vadj.get(vid, ()):
                if w < vid:
                    continue  # count each vv edge once
                for a in sorted(s):
                    for b in sorted(self.sets[w]):
                        if a == b:
                            continue
                        p = _pair(a, b)
                        mult[p] = mult.get(p, 0) + 1
        return mult

    @property
    def n_edges(self) -> int:
        return sum(len(s) for s in self.sets) + len(self.vv_edges)

    def nbytes(self) -> int:
        return self.n_edges * 16




def dedup2_greedy(
    graph: CondensedGraph,
    ordering: str = "identity",
    rng: Optional[np.random.Generator] = None,
) -> Dedup2Rep:
    """Greedy DEDUP-2 construction (App. B flavor), monotone-coverage variant.

    Virtual nodes are placed one at a time.  When the incoming set ``V``
    overlaps an already-placed set ``P`` in >= 2 members, ``P`` is *split*
    into ``(V∩P, P−V)`` joined by a vv-edge — a transformation that keeps
    the covered-pair set and all invariants exactly intact (both halves
    inherit P's vv-edges) — and the remainder ``V − P`` is placed
    recursively and linked back when legal.  Singleton virtual nodes (the
    paper's device) carry vv-edges for 1-member remainders; leftover pairs
    fall back to 2-member pair-sets.

    Invariants maintained throughout (checked by tests):
      (1) |S_V ∩ S_W| <= 1 for all non-adjacent placed V, W
      (2) adjacent virtual nodes are disjoint
      (3) the virtual neighbors of any V are pairwise disjoint
      (4) every expanded pair is covered exactly once
    """
    t0 = time.perf_counter()
    orig = [set(s) for s in _require_symmetric(graph)]
    rng = rng or np.random.default_rng(0)
    n_real = graph.n_real

    placed: List[Set[int]] = []
    vadj: List[Set[int]] = []  # vv adjacency by placed id
    covered: Set[Tuple[int, int]] = set()

    def pairs_of(s: Set[int]) -> List[Tuple[int, int]]:
        ss = sorted(s)
        return [(a, b) for i, a in enumerate(ss) for b in ss[i + 1 :]]

    def add_node(s: Set[int], cover: bool = True) -> int:
        placed.append(set(s))
        vadj.append(set())
        if cover:
            covered.update(pairs_of(s))
        return len(placed) - 1

    def can_link(i: int, j: int) -> bool:
        a, b = placed[i], placed[j]
        if i == j or a & b:
            return False  # invariant (2)
        if j in vadj[i]:
            return False
        for w in vadj[i]:
            if placed[w] & b:
                return False  # invariant (3) at i
        for w in vadj[j]:
            if placed[w] & a:
                return False  # invariant (3) at j
        return all(
            _pair(x, y) not in covered for x in a for y in b
        )

    def link(i: int, j: int) -> None:
        vadj[i].add(j)
        vadj[j].add(i)
        covered.update(_pair(x, y) for x in placed[i] for y in placed[j])

    def split(i: int, w1: Set[int]) -> int:
        """Split placed[i] into (w1, rest) + vv edge; coverage unchanged."""
        rest = placed[i] - w1
        assert rest, "split requires a proper subset"
        placed[i] = set(w1)
        j = add_node(rest, cover=False)
        old_nbrs = list(vadj[i])
        vadj[i].add(j)
        vadj[j].add(i)
        for w in old_nbrs:
            vadj[j].add(w)
            vadj[w].add(j)
        return i

    def cover_cross(a: Set[int], b: Set[int]) -> None:
        for x in sorted(a):
            for y in sorted(b):
                if x != y and _pair(x, y) not in covered:
                    add_node({x, y})

    def place(V: Set[int]) -> Optional[int]:
        """Cover all pairs of V; return a placed id whose set == V if one
        exists afterwards, else None."""
        if not V:
            return None
        if len(V) == 1:
            return add_node(V)  # singleton (covers nothing; may carry edges)
        # Largest >= 2 overlap with a placed node.
        best, best_ov = -1, 1
        for i, s in enumerate(placed):
            ov = len(V & s)
            if ov > best_ov:
                best, best_ov = i, ov
        if best < 0:
            if all(p not in covered for p in pairs_of(V)):
                return add_node(V)
            for p in pairs_of(V):
                if p not in covered:
                    add_node(set(p))
            return None
        W1 = V & placed[best]
        w1_id = best if placed[best] == W1 else split(best, W1)
        rest = V - W1
        if not rest:
            return w1_id
        r_id = place(rest)
        if r_id is not None and can_link(r_id, w1_id):
            link(r_id, w1_id)
        else:
            cover_cross(W1, rest)
        return None

    for vid in _order(len(orig), ordering, rng).tolist():
        place(orig[vid])

    # Drop empty sets and edge-less singletons; remap vv edges.
    keep = [
        i
        for i, s in enumerate(placed)
        if len(s) >= 2 or (len(s) == 1 and vadj[i])
    ]
    remap = {old: new for new, old in enumerate(keep)}
    vv_out: Set[Tuple[int, int]] = set()
    for i in keep:
        for j in vadj[i]:
            if j in remap:
                vv_out.add(_pair(remap[i], remap[j]))
    return Dedup2Rep(
        n_real=n_real,
        sets=[set(placed[i]) for i in keep],
        vv_edges=vv_out,
        seconds=time.perf_counter() - t0,
    )
