"""Graph algorithms over any device representation (paper §3.4, §6.1.2).

The main-path set of the JAX package's ``repro/core/algorithms.py``:
degrees, PageRank, personalized PageRank, BFS, reachability, connected
components and common-neighbor scores.  Each produces identical results
on EXP / DEDUP-1 / DEDUP-C (duplicate-sensitive) or additionally on raw
C-DUP (duplicate-insensitive: BFS, components, reachability).

The batched variants (:func:`bfs_multi`, :func:`reachable_multi`,
:func:`personalized_pagerank` over a seed batch,
:func:`common_neighbors_multi`) run ``B`` independent analyses as one
``(n, B)`` frontier — one factorized SpMM per superstep — with one
*shared* vote-to-halt across the batch: supersteps continue while any
column is still active, and settled columns are fixed points of their own
updates.  ``lax.while_loop`` / ``fori_loop`` become Python loops; the
vote-to-halt costs one ``.item()`` per superstep.  Frontiers are made on
the graph's device.
"""
from __future__ import annotations

from typing import Optional

import torch

from .engine import DeviceGraph, propagate
from .semiring import MIN_PLUS, OR_AND, PLUS_TIMES

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
