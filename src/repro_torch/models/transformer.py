"""Decoder-only transformer LM (dense FFN): GQA + RoPE, with a KV cache.

A port of the JAX package's ``models/transformer.py`` for serving: a
Python loop over the layers (no scan, no remat, no sharding), blockwise
attention through :func:`~repro_torch.models.layers.flash_attention`
(K4 on the card), and a KV cache that prefill fills and decode extends.

Param dict (leaves stacked over layers under ``"layers"``, as in JAX)::

    embed (V, D); layers/{ln1, ln2 (L, D), attn/{wq, wk, wv, wo},
    mlp/{w_gate, w_up, w_down}}; final_norm (D,); lm_head (D, V) unless tied.

Every weight is stored once in the compute dtype ``cfg.dtype`` (bf16 for
the published configs: 18.8 GB for glm4-9b instead of 37.6 GB in
``param_dtype`` float32).  The reference keeps float32 weights and casts
each one to ``cfg.dtype`` right before it uses it (the projections, the
norms' weights, the embedding and the head), so casting once at load
gives the same numbers.

The cache is updated in place: a forward with a cache writes the new keys
and values into ``cache.k`` / ``cache.v`` and returns a :class:`KVCache`
over the same storage with ``length`` advanced.  The MoE FFN
(``cfg.moe``) and the reference's auxiliary MoE loss wait for
``models/moe.py`` (ROADMAP.md, Queue 1 item 3).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..configs.base import TransformerConfig
from .layers import dense_init, flash_attention, rms_norm, rope

__all__ = ["torch_dtype", "init_params", "KVCache", "init_cache", "forward"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _check_dense(cfg: TransformerConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: the MoE FFN is not ported yet (ROADMAP.md, Queue 1 "
            f"item 6: models/moe.py)"
        )


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_params(
    cfg: TransformerConfig, generator: torch.Generator, device="cuda"
) -> Dict:
    """Random weights in ``cfg.dtype`` on ``device``, drawn from
    ``generator`` (which must live on ``device``) one layer at a time, so
    no float32 copy of the whole model is ever held."""
    _check_dense(cfg)
    dt = torch_dtype(cfg.dtype)
    hd = cfg.resolved_head_dim
    D, H, KV, L, Fd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.n_layers, cfg.d_ff
    shapes = {
        ("attn", "wq"): (D, H * hd), ("attn", "wk"): (D, KV * hd),
        ("attn", "wv"): (D, KV * hd), ("attn", "wo"): (H * hd, D),
        ("mlp", "w_gate"): (D, Fd), ("mlp", "w_up"): (D, Fd),
        ("mlp", "w_down"): (Fd, D),
    }
    layers: Dict = {"attn": {}, "mlp": {}}
    for (group, name), (fan_in, fan_out) in shapes.items():
        w = torch.empty((L, fan_in, fan_out), dtype=dt, device=device)
        for i in range(L):
            w[i] = dense_init(generator, fan_in, fan_out, dt, device=device)
        layers[group][name] = w
    layers["ln1"] = torch.ones((L, D), dtype=dt, device=device)
    layers["ln2"] = torch.ones((L, D), dtype=dt, device=device)
    embed = torch.randn((cfg.vocab_size, D), generator=generator, device=device)
    params = {
        "embed": (embed * 0.02).to(dt),
        "layers": layers,
        "final_norm": torch.ones((D,), dtype=dt, device=device),
    }
    del embed
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, D, cfg.vocab_size, dt, device=device)
    return params


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    k: torch.Tensor       # (L, B, max_len, KV, hd)
    v: torch.Tensor
    length: int           # filled prefix, common to every batch row


def init_cache(
    cfg: TransformerConfig, batch: int, max_len: int, device="cuda"
) -> KVCache:
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    dt = torch_dtype(cfg.dtype)
    return KVCache(
        k=torch.zeros(shape, dtype=dt, device=device),
        v=torch.zeros(shape, dtype=dt, device=device),
        length=0,
    )


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _attention(
    lp: Dict,
    x: torch.Tensor,
    cfg: TransformerConfig,
    positions: torch.Tensor,
    cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]],
    cache_len: int,
    kv_len: Optional[torch.Tensor],
) -> torch.Tensor:
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    q = rope((x @ lp["wq"]).reshape(B, T, H, hd), positions, cfg.rope_theta)
    k = rope((x @ lp["wk"]).reshape(B, T, KV, hd), positions, cfg.rope_theta)
    v = (x @ lp["wv"]).reshape(B, T, KV, hd)
    if cache_kv is not None:
        ck, cv = cache_kv                                   # (B, max_len, KV, hd)
        ck[:, cache_len:cache_len + T] = k
        cv[:, cache_len:cache_len + T] = v
        # decode (T == 1) sees every cached position; prefill is causal
        out = flash_attention(
            q, ck, cv, causal=T != 1, q_offset=cache_len, kv_length=kv_len,
            block_q=cfg.attn_block_q, block_kv=cfg.attn_block_kv,
        )
    else:
        out = flash_attention(
            q, k, v, causal=True,
            block_q=cfg.attn_block_q, block_kv=cfg.attn_block_kv,
        )
    return out.reshape(B, T, H * hd) @ lp["wo"]


def _ffn(mlp: Dict, x: torch.Tensor) -> torch.Tensor:
    g = x @ mlp["w_gate"]
    u = x @ mlp["w_up"]
    # jax.nn.silu is x * sigmoid(x) with sigmoid = 1 / (1 + exp(-x)), each
    # op rounded to x's dtype (torch.sigmoid rounds once: other bf16 bits)
    return ((g * (1.0 / (1.0 + torch.exp(-g)))) * u) @ mlp["w_down"]


def forward(
    params: Dict,
    tokens: torch.Tensor,                # (B, T) integer
    cfg: TransformerConfig,
    cache: Optional[KVCache] = None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Returns ``(logits (B, T, V) float32, the advanced cache or None)``.

    With a cache, the ``T`` new tokens sit at positions
    ``cache.length .. cache.length + T - 1`` of every batch row."""
    _check_dense(cfg)
    B, T = tokens.shape
    dev = tokens.device
    cache_len = cache.length if cache is not None else 0
    kv_len = None
    if cache is not None:
        max_len = cache.k.shape[2]
        if cache_len + T > max_len:
            raise ValueError(
                f"cache overflow: {cache_len} cached + {T} new positions > max_len {max_len}"
            )
        kv_len = torch.full((B,), cache_len + T, dtype=torch.int32, device=dev)
    positions = cache_len + torch.arange(T, device=dev)
    x = params["embed"][tokens]
    layers = params["layers"]
    for i in range(cfg.n_layers):
        attn = {name: w[i] for name, w in layers["attn"].items()}
        cache_kv = (cache.k[i], cache.v[i]) if cache is not None else None
        h = _attention(
            attn, rms_norm(x, layers["ln1"][i], cfg.norm_eps), cfg, positions,
            cache_kv, cache_len, kv_len,
        )
        # The reference's compiled layer fuses this residual add into the
        # second norm, which reads the float32 sum before it is rounded to
        # the residual stream's dtype (XLA's excess precision); so here.
        s = x.float() + h.float()
        x = s.to(x.dtype)
        mlp = {name: w[i] for name, w in layers["mlp"].items()}
        x = x + _ffn(mlp, rms_norm(s, layers["ln2"][i], cfg.norm_eps, x.dtype))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head).float()
    new_cache = None
    if cache is not None:
        new_cache = KVCache(k=cache.k, v=cache.v, length=cache_len + T)
    return logits, new_cache
