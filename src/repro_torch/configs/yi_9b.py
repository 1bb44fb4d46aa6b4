"""yi-9b [arXiv:2403.04652]: 48L d_model=4096 32H (GQA kv=4) d_ff=11008
vocab=64000 — llama-arch GQA."""
from .base import DEFAULT_LM_RULES, TransformerConfig

CONFIG = TransformerConfig(
    name="yi-9b",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    microbatches=4,
    remat_policy="full",
    sharding_rules={
        **DEFAULT_LM_RULES,
        "heads": "model",
        "kv_heads": None,
        "act_seq": "model",
    },
)

SMOKE = TransformerConfig(
    name="yi-9b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=128,
    microbatches=1,
    remat_policy="none",
)

SHAPE_FAMILY = "lm"
