"""The paper's own workload: distributed condensed-graph analytics.

PageRank power iteration over a condensed co-occurrence graph (DEDUP-C
exactness), with edges sharded over every mesh axis, at DBLP-2017 scale
(paper Table 1: 1.6M authors / 3M pubs / 8.6M author-pub edges, 17.1M
condensed edges vs 86.2M expanded).  The counts equal the JAX package's
``configs/graphgen_paper.py``; :mod:`repro_torch.launch.distributed_analytics`
and the smoke build the graph from them with App. C.2's
``layered_condensed(n_real, [n_virtual], [n_in_edges − n_virtual] × 2,
symmetric=True)``.
"""
import dataclasses

from .base import DEFAULT_LM_RULES


@dataclasses.dataclass(frozen=True)
class GraphGenConfig:
    name: str = "graphgen-paper"
    n_real: int = 1_638_400          # authors (padded to 1024 multiple)
    n_virtual: int = 2_998_272       # pubs
    n_in_edges: int = 8_650_752      # author->pub
    n_correction: int = 524_288      # duplicated pairs (paper: rare)
    pagerank_iters: int = 20
    dtype: str = "float32"
    sharding_rules: dict = dataclasses.field(
        default_factory=lambda: {
            **DEFAULT_LM_RULES,
            "nodes": ("pod", "data", "model"),
            "edges": ("pod", "data", "model"),
        }
    )


CONFIG = GraphGenConfig()
SMOKE = GraphGenConfig(
    name="graphgen-smoke",
    n_real=1024,
    n_virtual=2048,
    n_in_edges=8192,
    n_correction=512,
    pagerank_iters=3,
)

SHAPE_FAMILY = "graphgen"
