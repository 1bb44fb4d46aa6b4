"""Decoder-only transformer LM (dense FFN): GQA + RoPE, with a KV cache.

A port of the JAX package's ``models/transformer.py``: a Python loop over
the layers (no scan, no sharding), blockwise attention through
:func:`~repro_torch.models.layers.flash_attention` (K4 on the card; its
training route when the weights require grad), and a KV cache that
prefill fills and decode extends.

Param dict (leaves stacked over layers under ``"layers"``, as in JAX)::

    embed (V, D); layers/{ln1, ln2 (L, D), attn/{wq, wk, wv, wo},
    mlp/{w_gate, w_up, w_down}}; final_norm (D,); lm_head (D, V) unless tied.

Every weight is cast to the compute dtype ``cfg.dtype`` where it is used,
as the reference casts its ``param_dtype`` (float32) weights: training
holds float32 weights (``init_params(..., dtype=torch.float32)``), and
serving holds them in ``cfg.dtype`` already (18.8 GB for glm4-9b instead
of 37.6 GB), where the cast is a no-op.

``cfg.remat_policy != "none"`` recomputes each layer in the backward
(``torch.utils.checkpoint``, non-reentrant): only the layer's input is
kept, and its attention runs K4 again there.

The cache is updated in place: a forward with a cache writes the new keys
and values into ``cache.k`` / ``cache.v`` and returns a :class:`KVCache`
over the same storage with ``length`` advanced.  The MoE FFN
(``cfg.moe``) and the reference's auxiliary MoE loss wait for
``models/moe.py`` (ROADMAP.md, Queue 1 item 1); a dense model's ``aux``
is 0.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

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
            f"item 1: models/moe.py)"
        )


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_params(
    cfg: TransformerConfig, generator: torch.Generator, device="cuda",
    dtype: Optional[torch.dtype] = None,
) -> Dict:
    """Random weights in ``dtype`` (default ``cfg.dtype``, as serving holds
    them; training passes ``cfg.param_dtype``'s) on ``device``, drawn from
    ``generator`` (which must live on ``device``) one layer at a time, so
    no float32 copy of the whole model is ever held beside them."""
    _check_dense(cfg)
    dt = dtype or torch_dtype(cfg.dtype)
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
    q = rope((x @ lp["wq"].to(x.dtype)).reshape(B, T, H, hd), positions, cfg.rope_theta)
    k = rope((x @ lp["wk"].to(x.dtype)).reshape(B, T, KV, hd), positions, cfg.rope_theta)
    v = (x @ lp["wv"].to(x.dtype)).reshape(B, T, KV, hd)
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
    return out.reshape(B, T, H * hd) @ lp["wo"].to(x.dtype)


def _ffn(mlp: Dict, x: torch.Tensor) -> torch.Tensor:
    g = x @ mlp["w_gate"].to(x.dtype)
    u = x @ mlp["w_up"].to(x.dtype)
    # jax.nn.silu is x * sigmoid(x) with sigmoid = 1 / (1 + exp(-x)), each
    # op rounded to x's dtype (torch.sigmoid rounds once: other bf16 bits)
    return ((g * (1.0 / (1.0 + torch.exp(-g)))) * u) @ mlp["w_down"].to(x.dtype)


def forward(
    params: Dict,
    tokens: torch.Tensor,                # (B, T) integer
    cfg: TransformerConfig,
    cache: Optional[KVCache] = None,
) -> Tuple[torch.Tensor, Optional[KVCache], torch.Tensor]:
    """Returns ``(logits (B, T, V) float32, the advanced cache or None,
    aux loss)``; ``aux`` is a float32 zero for a dense model.

    With a cache, the ``T`` new tokens sit at positions
    ``cache.length .. cache.length + T - 1`` of every batch row."""
    _check_dense(cfg)
    B, T = tokens.shape
    dev = tokens.device
    adt = torch_dtype(cfg.dtype)
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
    x = params["embed"][tokens].to(adt)
    layers = params["layers"]

    def layer(x: torch.Tensor, i: int) -> torch.Tensor:
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
        return x + _ffn(mlp, rms_norm(s, layers["ln2"][i], cfg.norm_eps, x.dtype))

    remat = cfg.remat_policy != "none" and cache is None and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        if remat:
            x = torch.utils.checkpoint.checkpoint(layer, x, i, use_reentrant=False)
        else:
            x = layer(x, i)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head.to(x.dtype)).float()
    new_cache = None
    if cache is not None:
        new_cache = KVCache(k=cache.k, v=cache.v, length=cache_len + T)
    return logits, new_cache, torch.zeros((), dtype=torch.float32, device=dev)
