"""meshgraphnet [arXiv:2010.03409]: 15 layers, d_hidden=128, sum
aggregator, 2-layer MLPs.  Encode-process-decode mesh GNN."""
from .base import DEFAULT_LM_RULES, GNNConfig

_GNN_RULES = {
    **DEFAULT_LM_RULES,
    # GNN weights are tiny; spend every mesh axis on edge/node parallelism.
    "nodes": ("pod", "data", "model"),
    "edges": ("pod", "data", "model"),
}

CONFIG = GNNConfig(
    name="meshgraphnet",
    kind="meshgraphnet",
    n_layers=15,
    d_hidden=128,
    mlp_layers=2,
    aggregator="sum",
    d_out=3,
    remat_policy="full",
    sharding_rules=_GNN_RULES,
)

SMOKE = GNNConfig(
    name="meshgraphnet-smoke",
    kind="meshgraphnet",
    n_layers=3,
    d_hidden=32,
    mlp_layers=2,
    d_out=3,
    remat_policy="none",
)

SHAPE_FAMILY = "gnn"
