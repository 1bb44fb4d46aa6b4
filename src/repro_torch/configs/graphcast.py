"""graphcast [arXiv:2212.12794]: 16-layer encode-process-decode mesh GNN,
d_hidden=512, mesh_refinement=6, 227 output variables.

For assigned graph shapes the input feature width comes from the shape
(d_feat); n_vars=227 defines the output head.  The icosahedral multimesh
of the paper is a *graph construction* choice — the processor consumes
whatever edge set the shape provides (DESIGN.md §4)."""
from .base import DEFAULT_LM_RULES, GNNConfig

_GNN_RULES = {
    **DEFAULT_LM_RULES,
    "nodes": ("pod", "data", "model"),
    "edges": ("pod", "data", "model"),
}

CONFIG = GNNConfig(
    name="graphcast",
    kind="graphcast",
    n_layers=16,
    d_hidden=512,
    mlp_layers=2,
    aggregator="sum",
    mesh_refinement=6,
    n_vars=227,
    d_out=227,
    remat_policy="full",
    sharding_rules=_GNN_RULES,
)

SMOKE = GNNConfig(
    name="graphcast-smoke",
    kind="graphcast",
    n_layers=2,
    d_hidden=48,
    mlp_layers=2,
    n_vars=11,
    d_out=11,
    remat_policy="none",
)

SHAPE_FAMILY = "gnn"
