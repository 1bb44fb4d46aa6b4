"""Assigned input-shape sets per architecture family.

The JAX package's ``configs/shapes.py``, number for number.  Every
(arch x shape) cell is defined by one of these descriptors; the smoke
run's training phase takes its sizes from here (the dry-run cells that
also read them wait for ``launch/*``, ROADMAP.md Queue 1).

GNN sizes are padded to multiples of 1024 so every tensor divides the
512-way (pod x data x model) edge/node sharding; padding is masked
(GraphBatch.node_mask/edge_mask) and therefore inert.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["LMShape", "GNNShape", "RecShape", "LM_SHAPES", "GNN_SHAPES", "REC_SHAPES"]


@dataclasses.dataclass(frozen=True)
class LMShape:
    name: str
    kind: str              # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


LM_SHAPES: Dict[str, LMShape] = {
    "train_4k": LMShape("train_4k", "train", 4_096, 256),
    "prefill_32k": LMShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": LMShape("decode_32k", "decode", 32_768, 128),
    "long_500k": LMShape("long_500k", "decode", 524_288, 1),
}


def _pad(n: int, m: int = 1024) -> int:
    return -(-n // m) * m


@dataclasses.dataclass(frozen=True)
class GNNShape:
    name: str
    kind: str              # 'train' | 'infer'
    n_nodes: int
    n_edges: int
    d_feat: int
    n_graphs: int = 1      # >1 = batched small graphs (graph-level output)
    # real (unpadded) sizes for bookkeeping
    raw_nodes: int = 0
    raw_edges: int = 0


GNN_SHAPES: Dict[str, GNNShape] = {
    # Cora-scale full-batch: 2,708 nodes / 10,556 edges / 1,433 features
    "full_graph_sm": GNNShape(
        "full_graph_sm", "train", _pad(2_708), _pad(10_556), 1_433,
        raw_nodes=2_708, raw_edges=10_556,
    ),
    # Reddit-scale sampled training: seeds 1,024 fanout 15,10 ->
    # nodes 1,024 + 15,360 + 153,600 = 169,984; edges 15,360 + 153,600.
    "minibatch_lg": GNNShape(
        "minibatch_lg", "train", _pad(169_984), _pad(168_960), 602,
        raw_nodes=169_984, raw_edges=168_960,
    ),
    # ogbn-products full-batch-large
    "ogb_products": GNNShape(
        "ogb_products", "train", _pad(2_449_029), _pad(61_859_140), 100,
        raw_nodes=2_449_029, raw_edges=61_859_140,
    ),
    # batched small molecules: 128 graphs x (30 nodes, 64 edges)
    "molecule": GNNShape(
        "molecule", "train", _pad(30 * 128), _pad(64 * 128), 32, n_graphs=128,
        raw_nodes=30 * 128, raw_edges=64 * 128,
    ),
}

# DimeNet triplet budget per shape (triplets = edges x factor, capped).
TRIPLET_CAP = 16_777_216


def triplet_count(shape: GNNShape, factor: int) -> int:
    return min(_pad(shape.n_edges * factor), TRIPLET_CAP)


@dataclasses.dataclass(frozen=True)
class RecShape:
    name: str
    kind: str              # 'train' | 'score_all' | 'score_cand'
    batch: int
    n_candidates: int = 0


REC_SHAPES: Dict[str, RecShape] = {
    "train_batch": RecShape("train_batch", "train", 65_536),
    "serve_p99": RecShape("serve_p99", "score_all", 512),
    "serve_bulk": RecShape("serve_bulk", "score_all", 262_144),
    "retrieval_cand": RecShape("retrieval_cand", "score_cand", 1, 1_000_000),
}
