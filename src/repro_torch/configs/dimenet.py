"""dimenet [arXiv:2003.03123]: 6 blocks, d_hidden=128, 8 bilinear,
n_spherical=7, n_radial=6 — directional message passing over triplets.

Triplets (k->j->i edge pairs) are enumerated host-side
(:func:`repro_torch.data.graphs.build_triplets`) with a per-shape budget of
``triplet_factor x n_edges`` capped at 16.7M (noted coverage bound for
the ogb_products shape)."""
from .base import DEFAULT_LM_RULES, GNNConfig

_GNN_RULES = {
    **DEFAULT_LM_RULES,
    "nodes": ("pod", "data", "model"),
    "edges": ("pod", "data", "model"),
}

CONFIG = GNNConfig(
    name="dimenet",
    kind="dimenet",
    n_layers=6,
    d_hidden=128,
    n_bilinear=8,
    n_spherical=7,
    n_radial=6,
    n_rbf=64,
    cutoff=10.0,
    d_out=1,
    triplet_factor=8,
    remat_policy="full",
    sharding_rules=_GNN_RULES,
)

SMOKE = GNNConfig(
    name="dimenet-smoke",
    kind="dimenet",
    n_layers=2,
    d_hidden=16,
    n_bilinear=4,
    n_spherical=3,
    n_radial=2,
    n_rbf=12,
    cutoff=6.0,
    d_out=1,
    remat_policy="none",
)

SHAPE_FAMILY = "gnn"
