"""glm4-9b [hf:THUDM/glm-4-9b]: 40L d_model=4096 32H (GQA kv=2)
d_ff=13696 vocab=151552 — RoPE, GQA."""
from .base import DEFAULT_LM_RULES, TransformerConfig

CONFIG = TransformerConfig(
    name="glm4-9b",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    rope_theta=500_000.0,
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
    name="glm4-9b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=128,
    microbatches=1,
    remat_policy="none",
)

SHAPE_FAMILY = "lm"
