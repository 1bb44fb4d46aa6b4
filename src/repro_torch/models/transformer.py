"""Decoder-only transformer LM: GQA + RoPE, dense or MoE FFN, with a KV
cache.

A port of the JAX package's ``models/transformer.py``: a Python loop over
the layers (no scan), blockwise attention through
:func:`~repro_torch.models.layers.flash_attention` (K4 on the card; its
training route when the weights require grad), and a KV cache that
prefill fills and decode extends.

Param dict (leaves stacked over layers under ``"layers"``, as in JAX)::

    embed (V, D); layers/{ln1, ln2 (L, D), attn/{wq, wk, wv, wo},
    mlp/{w_gate, w_up, w_down} or moe/{router, w_gate, w_up, w_down}};
    final_norm (D,); lm_head (D, V) unless tied.

:func:`logical_axes` gives the same structure with each leaf's logical
axes, which ``train/steps.py`` hands to
:func:`~repro_torch.distributed.sharding.shard` for the gradients.

Every weight is cast to the compute dtype ``cfg.dtype`` where it is used,
as the reference casts its ``param_dtype`` (float32) weights: training
holds float32 weights (``init_params(..., dtype=torch.float32)``), and
serving holds them in ``cfg.dtype`` already (18.8 GB for glm4-9b instead
of 37.6 GB), where the cast is a no-op.

``cfg.remat_policy != "none"`` recomputes each layer in the backward
(:func:`~repro_torch.models.layers.remat`), and its attention runs K4
again there: ``"full"`` keeps only the layer's input, ``"minimal"`` also
the outputs of its matmuls without batch dims (the reference's
``dots_with_no_batch_dims_saveable``).

The forward runs sharded on DTensor params and tokens (the sharded
train step's, :func:`~repro_torch.distributed.sharding.distribute_state`)
under ``use_mesh_rules``: each layer's weights are constrained to their
logical axes (the reference's ``_constrain_lp``), the activations where
the reference constrains them, K4 and the MoE dispatch run on each rank's
shards under ``local_map``, and rope's tables are replicated DTensors
beside DTensor activations (so the backward meets no plain tensor
either; the other constants are 0-d, which DTensor takes as they are).

The cache is updated in place: a forward with a cache writes the new keys
and values into ``cache.k`` / ``cache.v`` and returns a :class:`KVCache`
over the same storage with ``length`` advanced.  The MoE FFN
(:mod:`.moe`, ``cfg.moe``) adds each layer's ``moe_aux_loss +
moe_z_loss`` to ``forward``'s ``aux``, summed over the layers; a dense
model's ``aux`` is 0.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..configs.base import TransformerConfig
from ..distributed.sharding import is_dtensor, shard
from . import moe as moe_lib
from .layers import dense_init, flash_attention, rms_norm, rope
from .layers import remat as remat_fn

__all__ = ["torch_dtype", "init_params", "logical_axes", "KVCache", "init_cache", "forward"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


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
    dt = dtype or torch_dtype(cfg.dtype)
    hd = cfg.resolved_head_dim
    D, H, KV, L, Fd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.n_layers, cfg.d_ff
    shapes = {
        ("attn", "wq"): (D, H * hd), ("attn", "wk"): (D, KV * hd),
        ("attn", "wv"): (D, KV * hd), ("attn", "wo"): (H * hd, D),
    }
    if cfg.moe is None:
        shapes.update({("mlp", "w_gate"): (D, Fd), ("mlp", "w_up"): (D, Fd),
                       ("mlp", "w_down"): (Fd, D)})
    layers: Dict = {}
    for (group, name), (fan_in, fan_out) in shapes.items():
        w = torch.empty((L, fan_in, fan_out), dtype=dt, device=device)
        for i in range(L):
            w[i] = dense_init(generator, fan_in, fan_out, dt, device=device)
        layers.setdefault(group, {})[name] = w
    if cfg.moe is not None:
        layers["moe"] = {}
        for i in range(L):
            for name, w in moe_lib.moe_init(generator, D, cfg.moe, device, dt).items():
                if i == 0:
                    layers["moe"][name] = torch.empty((L,) + tuple(w.shape), dtype=dt,
                                                      device=device)
                layers["moe"][name][i] = w
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


def logical_axes(cfg: TransformerConfig) -> Dict:
    """Same structure as :func:`init_params`, leaves = logical axis tuples."""
    attn = {
        "wq": (None, "embed_param", "heads"),
        "wk": (None, "embed_param", "kv_heads"),
        "wv": (None, "embed_param", "kv_heads"),
        "wo": (None, "heads", "embed_param"),
    }
    if cfg.moe is not None:
        ffn = {"moe": {k: (None,) + v for k, v in moe_lib.moe_logical_axes().items()}}
    else:
        ffn = {
            "mlp": {
                "w_gate": (None, "embed_param", "ff"),
                "w_up": (None, "embed_param", "ff"),
                "w_down": (None, "ff", "embed_param"),
            }
        }
    axes = {
        "embed": ("vocab", "embed_param"),
        "layers": {"attn": attn, **ffn, "ln1": (None, None), "ln2": (None, None)},
        "final_norm": (None,),
    }
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed_param", "vocab")
    return axes


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
    q = shard((x @ lp["wq"].to(x.dtype)).reshape(B, T, H, hd), "batch", "seq", "heads", None)
    k = shard((x @ lp["wk"].to(x.dtype)).reshape(B, T, KV, hd), "batch", "seq", "kv_heads", None)
    v = shard((x @ lp["wv"].to(x.dtype)).reshape(B, T, KV, hd), "batch", "seq", "kv_heads", None)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
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
    out = shard(out, "batch", "seq", "heads", None)
    return shard(out.reshape(B, T, H * hd) @ lp["wo"].to(x.dtype), "batch", "act_seq", "embed")


def _mlp(mlp: Dict, x: torch.Tensor) -> torch.Tensor:
    g = shard(x @ mlp["w_gate"].to(x.dtype), "batch", "seq", "ff")
    u = shard(x @ mlp["w_up"].to(x.dtype), "batch", "seq", "ff")
    # jax.nn.silu is x * sigmoid(x) with sigmoid = 1 / (1 + exp(-x)), each
    # op rounded to x's dtype (torch.sigmoid rounds once: other bf16 bits)
    y = ((g * (1.0 / (1.0 + torch.exp(-g)))) * u) @ mlp["w_down"].to(x.dtype)
    return shard(y, "batch", "act_seq", "embed")


def _layer_weights(layers: Dict, group: str, i: int, cfg: TransformerConfig) -> Dict:
    """Layer ``i``'s weights of ``group``, each constrained to its logical
    axes (the reference's ``_constrain_lp``: a no-op without a mesh)."""
    axes = logical_axes(cfg)["layers"][group]
    return {name: shard(w[i], *axes[name][1:]) for name, w in layers[group].items()}


def _ffn(layers: Dict, i: int, x: torch.Tensor, cfg: TransformerConfig):
    """Layer ``i``'s FFN of ``x`` (B, T, D): ``(y, aux)``, the MoE's
    ``moe_aux_loss + moe_z_loss`` or a float32 zero for a dense layer."""
    if cfg.moe is None:
        mlp = _layer_weights(layers, "mlp", i, cfg)
        return _mlp(mlp, x), torch.zeros((), dtype=torch.float32, device=x.device)
    B, T, D = x.shape
    moe = _layer_weights(layers, "moe", i, cfg)
    y, metrics = moe_lib.moe_apply(moe, x.reshape(B * T, D), cfg.moe)
    return y.reshape(B, T, D), metrics["moe_aux_loss"] + metrics["moe_z_loss"]


def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  A DTensor table is gathered whole and each rank
    looks up its own tokens under ``local_map`` (the table's gradient a
    partial sum over the dims that split the tokens), so the lookup and
    its backward are the plain step's ops on every rank."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    rep = [Replicate()] * mesh.ndim
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in tokens.placements]
    grad = [Partial() if isinstance(p, Shard) else Replicate() for p in rows]
    out = [Shard(0) if isinstance(p, Shard) else Replicate() for p in rows]
    return local_map(lambda t, i: t[i], out_placements=out, in_placements=(rep, rows),
                     in_grad_placements=(grad, rows), device_mesh=mesh)(
        table.redistribute(mesh, rep), tokens.redistribute(mesh, rows))


def forward(
    params: Dict,
    tokens: torch.Tensor,                # (B, T) integer
    cfg: TransformerConfig,
    cache: Optional[KVCache] = None,
) -> Tuple[torch.Tensor, Optional[KVCache], torch.Tensor]:
    """Returns ``(logits (B, T, V) float32, the advanced cache or None,
    aux loss)``; ``aux`` is the MoE layers' losses summed over the layers,
    a float32 zero for a dense model.

    With a cache, the ``T`` new tokens sit at positions
    ``cache.length .. cache.length + T - 1`` of every batch row."""
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
    layers = params["layers"]

    def layer(x: torch.Tensor, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        attn = _layer_weights(layers, "attn", i, cfg)
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
        y, aux = _ffn(layers, i, rms_norm(s, layers["ln2"][i], cfg.norm_eps, x.dtype), cfg)
        return x + y, aux

    remat = cfg.remat_policy != "none" and cache is None and torch.is_grad_enabled()
    x = shard(_embed(params["embed"], tokens).to(adt), "batch", "act_seq", "embed")
    auxs = []
    for i in range(cfg.n_layers):
        if remat:
            x, aux = remat_fn(layer, x, i, save_matmuls=cfg.remat_policy == "minimal")
        else:
            x, aux = layer(x, i)
        auxs.append(aux)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    x = shard(x, "batch", "seq", "embed")
    logits = shard((x @ head.to(x.dtype)).float(), "batch", "seq", "vocab")
    aux = torch.sum(torch.stack(auxs))
    new_cache = None
    if cache is not None:
        new_cache = KVCache(k=cache.k, v=cache.v, length=cache_len + T)
    return logits, new_cache, aux
