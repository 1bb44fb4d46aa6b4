"""Graph construction: synthetic graphs for the assigned shapes, DimeNet's
triplet builder, batched-molecule collation and a neighbor sampler.

A port of the JAX package's ``data/graphs.py``: the NumPy construction is
the reference's, so every array is byte-identical to its; the batches it
collates are the port's :class:`~repro_torch.models.gnn.GraphBatch` of
tensors on a device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.condensed import BipartiteEdges, build_csr
from ..models.gnn import GraphBatch

__all__ = [
    "random_graph",
    "build_triplets",
    "batch_molecules",
    "NeighborSampler",
    "graph_batch_from_numpy",
]


def random_graph(
    n_nodes: int,
    n_edges: int,
    d_feat: int,
    seed: int = 0,
    with_positions: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Optional[np.ndarray]]:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, size=n_edges)
    dst = rng.integers(0, n_nodes, size=n_edges)
    feats = rng.standard_normal((n_nodes, d_feat)).astype(np.float32)
    pos = (
        rng.standard_normal((n_nodes, 3)).astype(np.float32) * 3.0
        if with_positions
        else None
    )
    return src.astype(np.int32), dst.astype(np.int32), feats, pos


def build_triplets(
    src: np.ndarray, dst: np.ndarray, n_nodes: int, cap: Optional[int] = None
) -> np.ndarray:
    """DimeNet triplets: pairs (edge_kj, edge_ji) with shared middle node j.

    For edge e1 = (k -> j) and e2 = (j -> i), k != i: one triplet.
    Returns (T, 2) int32, truncated to ``cap`` if given (dropping triplets
    only reduces angular terms).
    """
    order = np.argsort(src, kind="stable")  # edges grouped by their source j
    e_by_src = order
    counts = np.bincount(src, minlength=n_nodes)
    starts = np.concatenate([[0], np.cumsum(counts)])
    in_order = np.argsort(dst, kind="stable")  # edges grouped by their dest j
    in_counts = np.bincount(dst, minlength=n_nodes)
    in_starts = np.concatenate([[0], np.cumsum(in_counts)])

    # For each node j: in-edges (k->j) x out-edges (j->i).
    n_tri_per_node = in_counts * counts
    total = int(n_tri_per_node.sum())
    if total == 0:
        return np.empty((0, 2), dtype=np.int32)
    nodes = np.repeat(np.arange(n_nodes), n_tri_per_node)
    offs = np.arange(total) - np.repeat(
        np.cumsum(n_tri_per_node) - n_tri_per_node, n_tri_per_node
    )
    kj_rank = offs // counts[nodes]
    ji_rank = offs % counts[nodes]
    e_kj = in_order[in_starts[nodes] + kj_rank]
    e_ji = e_by_src[starts[nodes] + ji_rank]
    keep = src[e_kj] != dst[e_ji]  # k != i (no backtracking)
    tri = np.stack([e_kj[keep], e_ji[keep]], axis=1).astype(np.int32)
    if cap is not None and tri.shape[0] > cap:
        tri = tri[:cap]
    return tri


def batch_molecules(
    n_mols: int, atoms_per_mol: int, edges_per_mol: int, d_feat: int, seed: int = 0,
    device="cuda",
) -> GraphBatch:
    """Batched small molecules as one padded disjoint union."""
    rng = np.random.default_rng(seed)
    N = n_mols * atoms_per_mol
    src = np.concatenate(
        [
            rng.integers(0, atoms_per_mol, edges_per_mol) + m * atoms_per_mol
            for m in range(n_mols)
        ]
    )
    dst = np.concatenate(
        [
            rng.integers(0, atoms_per_mol, edges_per_mol) + m * atoms_per_mol
            for m in range(n_mols)
        ]
    )
    feats = rng.standard_normal((N, d_feat)).astype(np.float32)
    pos = rng.standard_normal((N, 3)).astype(np.float32) * 2.0
    gid = np.repeat(np.arange(n_mols), atoms_per_mol)
    tri = build_triplets(src, dst, N)
    return graph_batch_from_numpy(
        src, dst, feats, positions=pos, graph_ids=gid, n_graphs=n_mols,
        triplets=tri, device=device,
    )


def graph_batch_from_numpy(
    src, dst, feats, positions=None, graph_ids=None, n_graphs=1, triplets=None,
    device="cuda",
) -> GraphBatch:
    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    n = feats.shape[0]
    e = src.shape[0]
    return GraphBatch(
        nodes=t(feats),
        edge_src=t(src, torch.int32),
        edge_dst=t(dst, torch.int32),
        node_mask=torch.ones((n,), dtype=torch.bool, device=device),
        edge_mask=torch.ones((e,), dtype=torch.bool, device=device),
        positions=None if positions is None else t(positions),
        graph_ids=None if graph_ids is None else t(graph_ids, torch.int32),
        triplets=None if triplets is None else t(triplets, torch.int32),
        triplet_mask=None if triplets is None
        else torch.ones((triplets.shape[0],), dtype=torch.bool, device=device),
        n_graphs=n_graphs,
    )


@dataclasses.dataclass
class NeighborSampler:
    """GraphSAGE fanout sampler over a host CSR (minibatch_lg shape).

    Produces fixed-shape padded subgraphs: seed nodes + per-hop sampled
    neighbors, edges pointing child -> parent (aggregation direction).
    """

    indptr: np.ndarray
    indices: np.ndarray
    fanouts: Sequence[int]
    seed: int = 0

    @classmethod
    def from_edges(
        cls, src: np.ndarray, dst: np.ndarray, n_nodes: int, fanouts, seed=0
    ) -> "NeighborSampler":
        e = BipartiteEdges(
            np.asarray(dst, np.int64), np.asarray(src, np.int64), n_nodes, n_nodes
        )
        csr = build_csr(e)  # row = dst: in-neighbors
        return cls(csr.indptr, csr.indices, list(fanouts), seed)

    def sample(self, seeds: np.ndarray, rng: Optional[np.random.Generator] = None):
        """Returns (node_ids, edge_src, edge_dst, edge_mask, layer_sizes):
        edge ids are positions into node_ids; padded to the fixed fanout
        budget by the seed 0 slot with mask=False."""
        rng = rng or np.random.default_rng(self.seed)
        all_nodes = [np.asarray(seeds, dtype=np.int64)]
        edge_src_parts: List[np.ndarray] = []
        edge_dst_parts: List[np.ndarray] = []
        edge_mask_parts: List[np.ndarray] = []
        frontier = all_nodes[0]
        frontier_offset = 0
        next_offset = frontier.size
        for fanout in self.fanouts:
            deg = self.indptr[frontier + 1] - self.indptr[frontier]
            # sample `fanout` in-neighbors per frontier node (with
            # replacement when deg > 0; padded/masked when deg == 0)
            r = rng.integers(0, 2**31, size=(frontier.size, fanout))
            has = deg > 0
            idx = self.indptr[frontier][:, None] + (
                r % np.maximum(deg, 1)[:, None]
            )
            neigh = self.indices[idx]
            mask = np.broadcast_to(has[:, None], neigh.shape)
            child_pos = next_offset + np.arange(neigh.size)
            parent_pos = frontier_offset + np.repeat(
                np.arange(frontier.size), fanout
            )
            edge_src_parts.append(child_pos)
            edge_dst_parts.append(parent_pos)
            edge_mask_parts.append(mask.reshape(-1))
            flat = neigh.reshape(-1)
            flat = np.where(mask.reshape(-1), flat, 0)
            all_nodes.append(flat)
            frontier = flat
            frontier_offset = next_offset
            next_offset += flat.size
        node_ids = np.concatenate(all_nodes)
        return (
            node_ids,
            np.concatenate(edge_src_parts).astype(np.int32),
            np.concatenate(edge_dst_parts).astype(np.int32),
            np.concatenate(edge_mask_parts),
            [a.size for a in all_nodes],
        )
