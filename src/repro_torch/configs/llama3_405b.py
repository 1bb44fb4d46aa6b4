"""llama3-405b [arXiv:2407.21783]: 126L d_model=16384 128H (GQA kv=8)
d_ff=53248 vocab=128256 — GQA, 128k vocab.

The JAX package's numbers, field for field.  Adafactor (factored second
moment) instead of Adam, 8-way gradient accumulation, a
sequence-parallel residual stream and full remat are the reference's
memory posture for a sharded run; 405.9 B parameters fit no single card,
so the port's smoke serves this config at full width and cut depth.
"""
from .base import DEFAULT_LM_RULES, TransformerConfig

CONFIG = TransformerConfig(
    name="llama3-405b",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=500_000.0,
    microbatches=8,
    remat_policy="full",
    opt_state_dtype="bfloat16",
    grad_accum_dtype="bfloat16",
    sharding_rules={
        **DEFAULT_LM_RULES,
        "heads": "model",       # 128 % 16 == 0
        "kv_heads": None,       # 8 < 16: replicated KV within TP groups
        "act_seq": "model",     # SP: residual stream sharded over model
    },
)

OPTIMIZER = "adafactor"   # factored second moment: the 405B memory saver

SMOKE = TransformerConfig(
    name="llama3-405b-smoke",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=256,
    microbatches=1,
    remat_policy="none",
)

SHAPE_FAMILY = "lm"
