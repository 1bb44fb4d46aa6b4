"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B]: 48L d_model=2048
16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64 experts top-6."""
from .base import DEFAULT_LM_RULES, MoEConfig, TransformerConfig

CONFIG = TransformerConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, capacity_factor=1.25),
    microbatches=8,
    remat_policy="full",
    sharding_rules={
        **DEFAULT_LM_RULES,
        "heads": "model",         # 16 / 16 = 1
        "kv_heads": "model",      # MHA-style kv=16 shards cleanly
        "experts": "model",       # 64 / 16 = 4 (EP)
        "expert_ff": None,
        "vocab": "model",         # 163840 / 16 = 10240
        "act_seq": "model",       # SP residual stream
    },
)

SMOKE = TransformerConfig(
    name="moonshot-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab_size=160,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=48, capacity_factor=2.0),
    microbatches=1,
    remat_policy="none",
)

SHAPE_FAMILY = "lm"
