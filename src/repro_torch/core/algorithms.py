"""Graph algorithms over any device representation (paper §3.4, §6.1.2).

The port of the JAX package's ``repro/core/algorithms.py``: degrees,
PageRank, personalized PageRank, HITS, BFS, reachability, connected
components, common-neighbor scores, the vertex-centric superstep loop,
weighted shortest and widest paths, strongly connected components and
the condensation DAG, triangles and clustering coefficients.  Each
produces identical results on EXP / DEDUP-1 / DEDUP-C
(duplicate-sensitive) or additionally on raw C-DUP (duplicate-insensitive:
BFS, components, reachability, SCC, shortest / widest paths).

The batched variants (:func:`bfs_multi`, :func:`reachable_multi`,
:func:`shortest_paths_multi`, :func:`widest_paths_multi`,
:func:`personalized_pagerank` over a seed batch,
:func:`common_neighbors_multi`, the triangle blocks) run ``B``
independent analyses as one ``(n, B)`` frontier — one factorized SpMM per
superstep — with one *shared* vote-to-halt across the batch: supersteps
continue while any column is still active, and settled columns are fixed
points of their own updates.  ``lax.while_loop`` / ``fori_loop`` become
Python loops; the vote-to-halt costs one ``.item()`` per superstep.
Frontiers are made on the graph's device; 1-D frontiers (HITS, the
vertex programs) stay on the segment path, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .engine import DeviceGraph, propagate, propagate_wedge
from .semiring import MAX_MIN, MIN_PLUS, OR_AND, PLUS_TIMES, Semiring

__all__ = [
    "n_nodes",
    "one_hot_frontier",
    "out_degrees",
    "in_degrees",
    "pagerank",
    "personalized_pagerank",
    "bfs",
    "bfs_multi",
    "reachable",
    "reachable_multi",
    "connected_components",
    "common_neighbor_counts",
    "common_neighbors_multi",
    "hits",
    "VertexProgram",
    "vertex_program",
    "shortest_paths",
    "shortest_paths_multi",
    "widest_paths",
    "widest_paths_multi",
    "scc_labels",
    "Condensation",
    "condensation",
    "triangle_counts",
    "clustering_coefficients",
]


def n_nodes(graph: DeviceGraph) -> int:
    """Number of real nodes in any device representation."""
    return graph.n if hasattr(graph, "n") else graph.n_real


def one_hot_frontier(
    n: int,
    sources,
    value: float = 1.0,
    fill: float = 0.0,
    dtype=torch.float32,
    device="cuda",
) -> torch.Tensor:
    """``(n, B)`` frontier matrix on ``device``: column ``i`` is ``fill``
    everywhere and ``value`` at ``sources[i]``.  Requires
    ``0 <= sources[i] < n`` (validated at the boundary, as
    ``GraphQueryServer.submit`` does)."""
    sources = torch.as_tensor(sources, dtype=torch.int64, device=device).reshape(-1)
    b = sources.shape[0]
    x = torch.full((n, b), fill, dtype=dtype, device=device)
    x[sources, torch.arange(b, device=device)] = value
    return x


def _sources(graph: DeviceGraph, sources) -> torch.Tensor:
    return torch.as_tensor(sources, dtype=torch.int64, device=graph.device).reshape(-1)


# ---------------------------------------------------------------------------
# Degree and PageRank (duplicate-SENSITIVE)
# ---------------------------------------------------------------------------

def out_degrees(graph: DeviceGraph) -> torch.Tensor:
    ones = torch.ones((n_nodes(graph),), dtype=torch.float32, device=graph.device)
    return propagate(graph, ones, PLUS_TIMES, reverse=True)


def in_degrees(graph: DeviceGraph) -> torch.Tensor:
    ones = torch.ones((n_nodes(graph),), dtype=torch.float32, device=graph.device)
    return propagate(graph, ones, PLUS_TIMES)


def pagerank(
    graph: DeviceGraph,
    damping: float = 0.85,
    num_iters: int = 20,
) -> torch.Tensor:
    """Standard power-iteration PageRank with dangling redistribution."""
    n = n_nodes(graph)
    deg = out_degrees(graph)
    x = torch.full((n,), 1.0 / n, dtype=torch.float32, device=graph.device)
    live = deg > 0
    for _ in range(num_iters):
        contrib = torch.where(live, x / torch.clamp(deg, min=1.0), 0.0)
        y = propagate(graph, contrib, PLUS_TIMES)
        dangling = torch.sum(torch.where(live, 0.0, x))
        y = y + dangling / n
        x = (1.0 - damping) / n + damping * y
    return x


def personalized_pagerank(
    graph: DeviceGraph,
    seeds: torch.Tensor,
    damping: float = 0.85,
    num_iters: int = 20,
) -> torch.Tensor:
    """PageRank with restart at ``seeds``: one restart distribution
    ``(n,)`` or a batch ``(n, B)`` iterated jointly, so each power step is
    a single SpMM over all ``B`` queries."""
    deg = out_degrees(graph)
    degb = deg if seeds.ndim == 1 else deg[:, None]
    live = degb > 0
    seeds = seeds.to(torch.float32)
    x = seeds
    for _ in range(num_iters):
        contrib = torch.where(live, x / torch.clamp(degb, min=1.0), 0.0)
        y = propagate(graph, contrib, PLUS_TIMES)
        dangling = torch.sum(torch.where(live, 0.0, x), dim=0)
        y = y + dangling * seeds
        x = (1.0 - damping) * seeds + damping * y
    return x


# ---------------------------------------------------------------------------
# BFS & reachability (duplicate-INSENSITIVE: run directly on C-DUP)
# ---------------------------------------------------------------------------

def bfs(graph: DeviceGraph, source: int, max_iters: Optional[int] = None) -> torch.Tensor:
    """Hop distances from ``source`` (inf where unreachable); the ``B=1``
    column of :func:`bfs_multi`."""
    return bfs_multi(graph, [source], max_iters=max_iters)[:, 0]


def bfs_multi(
    graph: DeviceGraph,
    sources,
    max_iters: Optional[int] = None,
) -> torch.Tensor:
    """Hop distances from every source at once: ``(n, B)`` for ``(B,)``
    sources; column ``i`` equals ``bfs(graph, sources[i])``.  One min-plus
    SpMM relaxes all ``B`` frontiers per superstep, under a shared
    vote-to-halt."""
    n = n_nodes(graph)
    max_iters = n if max_iters is None else max_iters
    dist = one_hot_frontier(
        n, _sources(graph, sources), value=0.0, fill=float("inf"),
        device=graph.device,
    )
    it = 0
    while it < max_iters:
        relaxed = propagate(graph, dist, MIN_PLUS, hop_weight=1.0)
        new = torch.minimum(dist, relaxed)
        changed = bool((new < dist).any().item())
        dist = new
        it += 1
        if not changed:
            break
    return dist


def reachable(
    graph: DeviceGraph,
    source: int,
    max_iters: Optional[int] = None,
    reverse: bool = False,
) -> torch.Tensor:
    """Boolean (0/1) reachability from ``source`` under OR-AND; the
    ``B=1`` column of :func:`reachable_multi`."""
    return reachable_multi(graph, [source], max_iters=max_iters, reverse=reverse)[:, 0]


def reachable_multi(
    graph: DeviceGraph,
    sources,
    max_iters: Optional[int] = None,
    reverse: bool = False,
) -> torch.Tensor:
    """Batched OR-AND reachability: ``(n, B)`` of 0/1 indicators;
    ``reverse=True`` follows edges backwards (via the packed reverse
    operands)."""
    n = n_nodes(graph)
    max_iters = n if max_iters is None else max_iters
    r = one_hot_frontier(n, _sources(graph, sources), device=graph.device)
    it = 0
    while it < max_iters:
        nxt = torch.maximum(r, propagate(graph, r, OR_AND, reverse=reverse))
        changed = bool((nxt > r).any().item())
        r = nxt
        it += 1
        if not changed:
            break
    return r


def connected_components(
    graph: DeviceGraph,
    max_iters: Optional[int] = None,
    undirected: bool = True,
) -> torch.Tensor:
    """Min-label propagation; labels = component representative ids.
    ``undirected=True`` also propagates along reversed edges every
    superstep, so weak components of asymmetric graphs come out right."""
    n = n_nodes(graph)
    max_iters = n if max_iters is None else max_iters
    labels = torch.arange(n, dtype=torch.float32, device=graph.device)
    it = 0
    while it < max_iters:
        nxt = torch.minimum(labels, propagate(graph, labels, MIN_PLUS, hop_weight=0.0))
        if undirected:
            nxt = torch.minimum(
                nxt, propagate(graph, labels, MIN_PLUS, hop_weight=0.0, reverse=True)
            )
        changed = bool((nxt < labels).any().item())
        labels = nxt
        it += 1
        if not changed:
            break
    return labels


# ---------------------------------------------------------------------------
# Common-neighbor counting: on C-DUP, M = B·Bᵀ entries ARE co-occurrence
# counts, so duplication is signal.
# ---------------------------------------------------------------------------

def common_neighbor_counts(graph: DeviceGraph, seeds: torch.Tensor) -> torch.Tensor:
    """Per-node path-multiplicity mass for an indicator seed vector
    ``(n,)`` or batch ``(n, B)``, scored in one SpMM."""
    return propagate(graph, seeds, PLUS_TIMES, allow_duplicates=True)


def common_neighbors_multi(graph: DeviceGraph, query_nodes) -> torch.Tensor:
    """``out[v, i]`` = number of shared virtual entities between ``v`` and
    ``query_nodes[i]`` — the recsys-serving scoring primitive, one
    propagation for the whole batch."""
    seeds = one_hot_frontier(
        n_nodes(graph), _sources(graph, query_nodes), device=graph.device
    )
    return common_neighbor_counts(graph, seeds)


# ---------------------------------------------------------------------------
# Vertex-centric API (paper §3.4) — the superstep loop
# ---------------------------------------------------------------------------

class VertexProgram(NamedTuple):
    """``compute`` folds incoming aggregated messages into vertex state."""

    semiring: Semiring
    to_message: Callable[[torch.Tensor], torch.Tensor]
    compute: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def vertex_program(
    graph: DeviceGraph,
    program: VertexProgram,
    init_state: torch.Tensor,
    max_supersteps: int = 50,
) -> torch.Tensor:
    """Supersteps of ``compute(state, propagate(to_message(state)))`` until
    no vertex moves by 1e-12 or ``max_supersteps`` (one ``.item()`` a
    superstep)."""
    s = init_state
    it = 0
    while it < max_supersteps:
        msgs = propagate(graph, program.to_message(s), program.semiring)
        s_new = program.compute(s, msgs)
        halted = bool(torch.all(torch.abs(s_new - s) < 1e-12).item())
        s = s_new
        it += 1
        if halted:
            break
    return s


def hits(graph: DeviceGraph, num_iters: int = 30) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hubs & authorities by power iteration (duplicate-sensitive)."""
    n = n_nodes(graph)
    h = torch.full((n,), 1.0 / math.sqrt(n), dtype=torch.float32, device=graph.device)
    a = torch.zeros_like(h)
    for _ in range(num_iters):
        a = propagate(graph, h, PLUS_TIMES)            # auth = sum of in-hubs
        a = a / torch.clamp(torch.linalg.vector_norm(a), min=1e-12)
        h = propagate(graph, a, PLUS_TIMES, reverse=True)
        h = h / torch.clamp(torch.linalg.vector_norm(h), min=1e-12)
    return h, a


# ---------------------------------------------------------------------------
# Weighted semiring analytics: edge properties ride on condensed chains as
# per-virtual-layer weights — every incidence step stays an unweighted
# kernelizable SpMM.
# ---------------------------------------------------------------------------

def _relax(graph, x0, semiring, improve, hop_weight, layer_weights, max_iters, reverse):
    """Bellman-Ford style fixpoint: ``x = improve(x, propagate(x))`` until
    no entry improves (one ``.item()`` a superstep) or ``max_iters``."""
    x = x0
    it = 0
    while it < max_iters:
        relaxed = propagate(graph, x, semiring, reverse=reverse, hop_weight=hop_weight,
                            layer_weights=layer_weights)
        new = improve(x, relaxed)
        changed = bool((new != x).any().item())
        x = new
        it += 1
        if not changed:
            break
    return x


def shortest_paths_multi(
    graph: DeviceGraph,
    sources,
    layer_weights=None,
    hop_weight: Optional[float] = None,
    max_iters: Optional[int] = None,
    reverse: bool = False,
) -> torch.Tensor:
    """Batched min-plus shortest paths: ``(n, B)`` distances (inf where
    unreachable), relaxed to a fixed point à la Bellman-Ford.

    ``layer_weights`` (see :func:`~repro_torch.core.engine.propagate`)
    carries non-negative per-virtual-layer costs: a condensed path costs
    the sum of its virtual-node weights, plus ``hop_weight`` per logical
    hop when given (direct real->real edges cost only ``hop_weight``).
    Called with neither, it degrades to hop counting — identical to
    :func:`bfs_multi`.  ``reverse=True`` follows edges backwards (distances
    *to* the sources), as :func:`reachable_multi` does; the JAX package's
    function has no such argument.
    """
    n = n_nodes(graph)
    max_iters = n if max_iters is None else max_iters
    if layer_weights is None and hop_weight is None:
        hop_weight = 1.0
    dist0 = one_hot_frontier(n, _sources(graph, sources), value=0.0,
                             fill=float("inf"), device=graph.device)
    return _relax(graph, dist0, MIN_PLUS, torch.minimum, hop_weight,
                  layer_weights, max_iters, reverse)


def shortest_paths(
    graph: DeviceGraph,
    source: int,
    layer_weights=None,
    hop_weight: Optional[float] = None,
    max_iters: Optional[int] = None,
    reverse: bool = False,
) -> torch.Tensor:
    """Single-source min-plus distances; the ``B=1`` column of
    :func:`shortest_paths_multi`."""
    return shortest_paths_multi(
        graph, [source], layer_weights=layer_weights,
        hop_weight=hop_weight, max_iters=max_iters, reverse=reverse,
    )[:, 0]


def widest_paths_multi(
    graph: DeviceGraph,
    sources,
    layer_capacities=None,
    hop_weight: Optional[float] = None,
    max_iters: Optional[int] = None,
    reverse: bool = False,
) -> torch.Tensor:
    """Batched max-min widest (bottleneck) paths: ``(n, B)`` widths —
    0 where unreachable, ``inf`` at each source.

    ``layer_capacities`` carries non-negative per-virtual-layer
    capacities: a path's width is the min capacity along it, the answer
    the max over paths (:data:`~repro_torch.core.semiring.MAX_MIN`).
    Without capacities every edge has infinite capacity and the result is
    reachability scaled to {0, inf}.  ``reverse=True`` follows edges
    backwards, as in :func:`shortest_paths_multi`.
    """
    n = n_nodes(graph)
    max_iters = n if max_iters is None else max_iters
    w0 = one_hot_frontier(n, _sources(graph, sources), value=float("inf"),
                          fill=0.0, device=graph.device)
    return _relax(graph, w0, MAX_MIN, torch.maximum, hop_weight,
                  layer_capacities, max_iters, reverse)


def widest_paths(
    graph: DeviceGraph,
    source: int,
    layer_capacities=None,
    hop_weight: Optional[float] = None,
    max_iters: Optional[int] = None,
    reverse: bool = False,
) -> torch.Tensor:
    """Single-source max-min widths; the ``B=1`` column of
    :func:`widest_paths_multi`."""
    return widest_paths_multi(
        graph, [source], layer_capacities=layer_capacities,
        hop_weight=hop_weight, max_iters=max_iters, reverse=reverse,
    )[:, 0]


# ---------------------------------------------------------------------------
# Strongly connected components + condensation DAG layering: forward ∧
# backward reachability over pivot batches, on the condensed representation.
# ---------------------------------------------------------------------------

def scc_labels(
    graph: DeviceGraph, batch: int = 32, max_iters: Optional[int] = None
) -> np.ndarray:
    """SCC label per node: the minimum member id of its component.

    Batched forward/backward pivot sweep: each round takes the ``batch``
    lowest unassigned node ids as pivots, computes descendants
    (:func:`reachable_multi`) and ancestors (``reverse=True``, the packed
    reverse operands) for all of them in two batched OR-AND fixpoints,
    and labels each pivot's forward∧backward intersection — exactly its
    SCC.  Pivots are the lowest unassigned ids and whole SCCs are labeled
    at once, so every pivot is the minimum id of its component: labels
    are deterministic and representation-independent.  Each round is
    padded to the full ``batch`` width (repeating its first pivot), so
    every round's frontiers have one shape.  ``batch=1`` is the looped
    single-source oracle.
    """
    n = n_nodes(graph)
    batch = max(1, min(int(batch), n))
    labels = np.full(n, -1, dtype=np.int64)
    while True:
        unassigned = np.flatnonzero(labels < 0)
        if unassigned.size == 0:
            break
        pivots = unassigned[:batch]
        padded = np.concatenate(
            [pivots, np.full(batch - pivots.size, pivots[0], dtype=pivots.dtype)]
        )
        fwd = reachable_multi(graph, padded, max_iters=max_iters)
        bwd = reachable_multi(graph, padded, max_iters=max_iters, reverse=True)
        both = ((fwd > 0) & (bwd > 0)).cpu().numpy()
        for j, p in enumerate(padded.tolist()):
            if labels[p] >= 0:
                continue  # already labeled (same-SCC pivot or pad column)
            members = both[:, j] & (labels < 0)
            labels[members] = p
    return labels


class Condensation(NamedTuple):
    """SCC condensation of a graph: per-node labels, the component DAG,
    and its longest-path-to-sink topological layering (layer 0 = leaf
    components, each higher layer depends only on lower ones)."""

    labels: np.ndarray      # (n,) SCC label = min member id
    component: np.ndarray   # (n,) dense component index, ordered by label
    sizes: np.ndarray       # (k,) members per component
    dag_src: np.ndarray     # inter-component edges (dense ids), deduped
    dag_dst: np.ndarray
    layers: np.ndarray      # (k,) longest path length to a sink

    @property
    def n_components(self) -> int:
        return int(self.sizes.size)


def condensation(
    graph: DeviceGraph,
    labels: Optional[np.ndarray] = None,
    batch: int = 32,
) -> Condensation:
    """Condense SCCs to a DAG and layer it topologically — without
    expanding the graph: the component adjacency comes from ONE batched
    OR-AND propagation of the ``(n, k)`` membership indicator matrix,
    built on the graph's device (column c of the result marks every node
    with an in-edge from component c)."""
    if labels is None:
        labels = scc_labels(graph, batch=batch)
    n = n_nodes(graph)
    uniq, comp = np.unique(labels, return_inverse=True)
    comp = comp.reshape(-1)
    k = uniq.size
    sizes = np.bincount(comp, minlength=k)
    comp_dev = torch.as_tensor(comp, dtype=torch.int64, device=graph.device)
    member = torch.zeros((n, k), dtype=torch.float32, device=graph.device)
    member[torch.arange(n, device=graph.device), comp_dev] = 1.0
    hit = propagate(graph, member, OR_AND)
    del member
    node, from_comp = torch.nonzero(hit > 0, as_tuple=True)
    del hit
    to_comp = comp_dev[node]
    keep = from_comp != to_comp
    # unique (from, to) rows in lexicographic order, as np.unique(axis=0)
    pairs = torch.unique(from_comp[keep] * k + to_comp[keep]).cpu().numpy()
    dag_src, dag_dst = pairs // k, pairs % k
    # longest-path-to-sink layering: sinks stay 0, everything else is
    # 1 + max over successors; monotone relaxation converges within the
    # DAG's longest path length
    layers = np.zeros(k, dtype=np.int64)
    for _ in range(k + 1):
        nxt = np.zeros(k, dtype=np.int64)
        if dag_src.size:
            np.maximum.at(nxt, dag_src, layers[dag_dst] + 1)
        if np.array_equal(nxt, layers):
            break
        layers = nxt
    return Condensation(labels, comp, sizes, dag_src, dag_dst, layers)


# ---------------------------------------------------------------------------
# Triangles & clustering coefficients: two-hop wedge counting needs the
# *quadratic* DEDUP correction — duplicate wedges through shared virtual
# nodes (engine.propagate_wedge).
# ---------------------------------------------------------------------------

def _triangle_block(graph, X, wedge, mode):
    """``t`` of the block's columns: ``½ Σ_w a1·a2`` reduced in float64.
    ``a1`` is a 0/1 adjacency column, so each product is an exact float32
    integer; a hub's sum passes 2^24, where a float32 reduction rounds.
    In float64 per_step counts are exact, and equal the JAX package's
    float32 ones wherever those are (2t < 2^24).  Wedge mode's raw ``M²``
    terms still round in float32 before the reduction, as the JAX
    package's do."""
    a1 = propagate(graph, X, PLUS_TIMES)
    if mode == "wedge":
        a2 = propagate_wedge(graph, X, wedge=wedge)
    else:
        a2 = propagate(graph, a1, PLUS_TIMES)
    return 0.5 * torch.sum(a1 * a2, dim=0, dtype=torch.float64)


def triangle_counts(
    graph: DeviceGraph,
    block: int = 128,
    mode: str = "per_step",
    wedge=None,
) -> np.ndarray:
    """Per-node triangle counts ``t[v] = ½ Σ_w A[v,w]·(A²)[v,w]`` on a
    symmetric simple graph (A = dedup'd adjacency, zero diagonal).

    Runs condensation-native: identity columns in blocks of ``block``
    through two exact ring propagations per block — never materializing
    A.  ``mode='per_step'`` corrects each hop linearly (DEDUP-C);
    ``mode='wedge'`` runs both hops RAW and subtracts the quadratic wedge
    correction once (:func:`~repro_torch.core.engine.propagate_wedge`;
    pass ``wedge`` triples from
    :func:`~repro_torch.core.dedup.build_wedge_correction` to make the
    correction a single sparse pass).  Both modes are byte-identical on
    integer counts.  ``block=1`` is the looped per-node oracle.
    """
    n = n_nodes(graph)
    block = max(1, min(int(block), n))
    dev = graph.device
    wedge_dev = None
    if wedge is not None:
        ws, wd, wm = tuple(wedge)
        wedge_dev = (
            torch.as_tensor(np.asarray(ws), dtype=torch.int64, device=dev),
            torch.as_tensor(np.asarray(wd), dtype=torch.int64, device=dev),
            torch.as_tensor(np.asarray(wm), dtype=torch.float32, device=dev),
        )
        mode = "wedge"
    t = np.zeros(n, dtype=np.float64)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        X = torch.zeros((n, block), dtype=torch.float32, device=dev)
        X[torch.arange(lo, hi, device=dev), torch.arange(hi - lo, device=dev)] = 1.0
        contrib = _triangle_block(graph, X, wedge_dev, mode).cpu().numpy()
        t[lo:hi] += contrib[: hi - lo]
    return t


def clustering_coefficients(
    graph: DeviceGraph,
    block: int = 128,
    mode: str = "per_step",
    wedge=None,
) -> np.ndarray:
    """Local clustering coefficient ``c[v] = 2·t[v] / (deg[v]·(deg[v]−1))``
    (0 where degree < 2), from :func:`triangle_counts` and the exact
    dedup'd degrees (:func:`out_degrees` on a corrected graph)."""
    t = triangle_counts(graph, block=block, mode=mode, wedge=wedge)
    deg = out_degrees(graph).cpu().numpy().astype(np.float64)
    denom = deg * (deg - 1.0)
    return np.where(denom > 0, 2.0 * t / np.maximum(denom, 1.0), 0.0)
