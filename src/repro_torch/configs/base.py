"""Config dataclasses for the architecture families, as plain data.

A self-contained copy of the JAX package's ``configs/base.py``: the same
fields, defaults and parameter counts, so a configuration reads the same
numbers in both packages.  The port reads ``sharding_rules`` where the
reference does: ``launch/train.py`` trains under
``use_mesh_rules(make_host_mesh(), cfg.sharding_rules)``, and
``models/moe.py`` takes its all-to-all dispatch where the ``"experts"``
rule names a mesh dim (:mod:`repro_torch.distributed.sharding`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

__all__ = [
    "MoEConfig",
    "TransformerConfig",
    "GNNConfig",
    "RecsysConfig",
    "DEFAULT_LM_RULES",
]

# Logical axis -> mesh axis (or None = replicate), as in the JAX package.
DEFAULT_LM_RULES: Dict[str, object] = {
    "batch": ("pod", "data"),
    "seq": None,
    "act_seq": None,
    "expert_capacity": None,
    "cache_batch": ("pod", "data"),
    "cache_seq": None,
    "embed": None,
    "embed_param": "data",
    "heads": "model",
    "kv_heads": None,
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "expert_ff": None,
    "edges": ("pod", "data"),
    "nodes": ("pod", "data"),
    "items": "model",
}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int               # per-expert FFN hidden
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01
    dispatch: str = "sort"      # 'sort' | 'a2a'


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    moe: Optional[MoEConfig] = None
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"                 # activation/compute dtype
    param_dtype: str = "float32"
    opt_state_dtype: str = "float32"
    remat_policy: str = "minimal"           # 'none' | 'minimal' | 'full'
    scan_layers: bool = True
    attn_block_q: int = 512                 # flash attention block sizes
    attn_block_kv: int = 1024
    microbatches: int = 1
    grad_accum_dtype: str = "float32"
    sharding_rules: Mapping[str, object] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_LM_RULES)
    )

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def n_params(self) -> int:
        """Total parameter count (embedding + layers [+ experts])."""
        d, hd = self.d_model, self.resolved_head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.moe is not None:
            ff = self.moe.n_experts * 3 * d * self.moe.d_expert + d * self.moe.n_experts
        else:
            ff = 3 * d * self.d_ff
        per_layer = attn + ff + 2 * d
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d

    def n_active_params(self) -> int:
        """Active (per-token) parameters — MoE counts top_k experts."""
        if self.moe is None:
            return self.n_params()
        d = self.d_model
        dense = self.n_params() - self.n_layers * (
            self.moe.n_experts * 3 * d * self.moe.d_expert
        )
        return dense + self.n_layers * self.moe.top_k * 3 * d * self.moe.d_expert


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str                    # 'meshgraphnet' | 'graphcast' | 'schnet' | 'dimenet'
    n_layers: int
    d_hidden: int
    mlp_layers: int = 2
    aggregator: str = "sum"
    n_rbf: int = 300
    cutoff: float = 10.0
    n_spherical: int = 7
    n_radial: int = 6
    n_bilinear: int = 8
    mesh_refinement: int = 0
    n_vars: int = 0
    d_out: int = 1
    triplet_factor: int = 8
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat_policy: str = "minimal"
    sharding_rules: Mapping[str, object] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_LM_RULES)
    )


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    embed_dim: int
    n_blocks: int
    n_heads: int
    seq_len: int
    n_items: int
    dropout: float = 0.0
    pad_embed_to: Optional[int] = None
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    sharding_rules: Mapping[str, object] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_LM_RULES)
    )

    @property
    def d(self) -> int:
        return self.pad_embed_to or self.embed_dim
