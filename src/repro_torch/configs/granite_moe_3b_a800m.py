"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-*-base]: 32L
d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40 experts top-8.

Sharding notes: 24 heads and 40 experts do not divide the 16-way model
axis -> attention heads and the expert axis stay replicated; TP lives on
the per-expert FFN dim (512/16) and the MoE *capacity* dim instead.
"""
from .base import DEFAULT_LM_RULES, MoEConfig, TransformerConfig

CONFIG = TransformerConfig(
    name="granite-moe-3b-a800m",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    moe=MoEConfig(n_experts=40, top_k=8, d_expert=512, capacity_factor=1.25),
    microbatches=8,
    remat_policy="full",
    sharding_rules={
        **DEFAULT_LM_RULES,
        "heads": None,             # 24 % 16 != 0
        "kv_heads": None,
        "experts": None,           # 40 % 16 != 0
        "expert_ff": "model",      # 512 / 16 = 32
        "expert_capacity": "model",
        "ff": "model",
        "vocab": None,             # 49155 is odd-sized; keep replicated
        "act_seq": "model",        # SP residual stream
    },
)

SMOKE = TransformerConfig(
    name="granite-moe-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=64,
    vocab_size=131,
    head_dim=16,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, capacity_factor=2.0),
    microbatches=1,
    remat_policy="none",
)

SHAPE_FAMILY = "lm"
