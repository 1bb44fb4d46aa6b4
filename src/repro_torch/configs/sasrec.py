"""sasrec [arXiv:1808.09781]: embed_dim=50, 2 blocks, 1 head, seq_len=50,
self-attentive sequential recommendation.

Catalog sized to the retrieval shape (1M items); the item table is the
dominant state, row-sharded over the model axis (recsys EP).  The
paper-faithful embed_dim is 50; ``pad_embed_to=64`` exists as a
beyond-paper MXU-alignment option (see EXPERIMENTS.md §Perf)."""
from .base import DEFAULT_LM_RULES, RecsysConfig

CONFIG = RecsysConfig(
    name="sasrec",
    embed_dim=50,
    n_blocks=2,
    n_heads=1,
    seq_len=50,
    n_items=1_000_000,
    sharding_rules={
        **DEFAULT_LM_RULES,
        "items": "model",
        "ff": None,            # d=50 doesn't divide 16; blocks replicated
    },
)

SMOKE = RecsysConfig(
    name="sasrec-smoke",
    embed_dim=16,
    n_blocks=2,
    n_heads=1,
    seq_len=20,
    n_items=500,
)

SHAPE_FAMILY = "recsys"
