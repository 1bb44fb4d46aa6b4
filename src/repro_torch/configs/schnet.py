"""schnet [arXiv:1706.08566]: 3 interactions, d_hidden=64, 300 RBF,
cutoff 10 Å — continuous-filter convolutions."""
from .base import DEFAULT_LM_RULES, GNNConfig

_GNN_RULES = {
    **DEFAULT_LM_RULES,
    "nodes": ("pod", "data", "model"),
    "edges": ("pod", "data", "model"),
}

CONFIG = GNNConfig(
    name="schnet",
    kind="schnet",
    n_layers=3,
    d_hidden=64,
    n_rbf=300,
    cutoff=10.0,
    d_out=1,
    remat_policy="full",
    sharding_rules=_GNN_RULES,
)

SMOKE = GNNConfig(
    name="schnet-smoke",
    kind="schnet",
    n_layers=2,
    d_hidden=16,
    n_rbf=24,
    cutoff=6.0,
    d_out=1,
    remat_policy="none",
)

SHAPE_FAMILY = "gnn"
