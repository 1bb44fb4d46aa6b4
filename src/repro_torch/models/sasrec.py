"""SASRec: self-attentive sequential recommendation (arXiv:1808.09781).

A port of the JAX package's ``models/sasrec.py``.  Config: embed_dim 50,
2 blocks, 1 head, seq_len 50; the item table (``n_items x d``) is the
dominant state.  Attention is K4 on the card at head_dim 50 (the prefill
kernel's element-load path; with grads, its training route with ``lse``).

* :func:`train_loss`       BCE with one sampled negative per position;
* :func:`user_embedding`   encode a behaviour sequence;
* :func:`score_all`        user x full-catalog scores, two-stage top-k;
* :func:`score_candidates` one user against gathered candidates.

Weights are held in ``cfg.param_dtype`` and cast to ``cfg.dtype`` where
they are used, as in the reference.  Scores are float32 sums of the
products of ``cfg.dtype`` values (the reference's
``preferred_element_type=float32``): the port multiplies in float32,
where the products of two bf16 values are exact.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import RecsysConfig
from .layers import dense_init, flash_attention, layer_norm

__all__ = ["init_params", "user_embedding", "train_loss", "score_all", "score_candidates"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def init_params(cfg: RecsysConfig, generator: torch.Generator, device="cuda") -> Dict:
    """Random params in ``cfg.param_dtype`` on ``device``, drawn from
    ``generator`` (which must live on ``device``), in the reference's
    layout (``blocks`` stacked over the blocks)."""
    pdt = _DTYPES[cfg.param_dtype]
    d = cfg.d

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)

    params = {
        "item_embed": (normal(cfg.n_items, d) * 0.02).to(pdt),
        "pos_embed": (normal(cfg.seq_len, d) * 0.02).to(pdt),
        "final_ln": torch.ones((d,), dtype=pdt, device=device),
        "final_ln_b": torch.zeros((d,), dtype=pdt, device=device),
    }
    blocks = []
    for _ in range(cfg.n_blocks):
        blk = {name: dense_init(generator, d, d, pdt, device=device)
               for name in ("wq", "wk", "wv", "w1", "w2")}
        for name in ("ln1", "ln2"):
            blk[name] = torch.ones((d,), dtype=pdt, device=device)
            blk[name + "_b"] = torch.zeros((d,), dtype=pdt, device=device)
        blocks.append(blk)
    params["blocks"] = {k: torch.stack([b[k] for b in blocks]) for k in blocks[0]}
    return params


def user_embedding(params: Dict, seqs: torch.Tensor, cfg: RecsysConfig) -> torch.Tensor:
    """seqs: ``(B, L)`` item ids, 0 = padding.  Returns ``(B, L, d)``
    states in ``cfg.dtype``."""
    adt = _DTYPES[cfg.dtype]
    B, L = seqs.shape
    d = cfg.d
    hd = d // cfg.n_heads
    seqs = seqs.long()
    x = params["item_embed"][seqs].to(adt)
    x = x * math.sqrt(d) + params["pos_embed"][None, :L].to(adt)
    mask = (seqs > 0)[..., None].to(adt)
    x = x * mask
    blocks = params["blocks"]
    for i in range(cfg.n_blocks):
        bp = {k: v[i] for k, v in blocks.items()}
        h = layer_norm(x, bp["ln1"], bp["ln1_b"])
        q = (h @ bp["wq"].to(adt)).reshape(B, L, cfg.n_heads, hd)
        k = (h @ bp["wk"].to(adt)).reshape(B, L, cfg.n_heads, hd)
        v = (h @ bp["wv"].to(adt)).reshape(B, L, cfg.n_heads, hd)
        attn = flash_attention(q, k, v, causal=True, block_q=min(64, L), block_kv=min(64, L))
        x = x + attn.reshape(B, L, d)
        h = layer_norm(x, bp["ln2"], bp["ln2_b"])
        h = torch.relu(h @ bp["w1"].to(adt)) @ bp["w2"].to(adt)
        x = (x + h) * mask
    return layer_norm(x, params["final_ln"], params["final_ln_b"])


def train_loss(
    params: Dict,
    seqs: torch.Tensor,        # (B, L) inputs
    pos_items: torch.Tensor,   # (B, L) next-item targets (0 = pad)
    neg_items: torch.Tensor,   # (B, L) sampled negatives
    cfg: RecsysConfig,
) -> torch.Tensor:
    states = user_embedding(params, seqs, cfg)                 # (B, L, d)
    pe = params["item_embed"][pos_items.long()].to(states.dtype)
    ne = params["item_embed"][neg_items.long()].to(states.dtype)
    pos_logit = torch.sum(states * pe, dim=-1).float()
    neg_logit = torch.sum(states * ne, dim=-1).float()
    mask = (pos_items > 0).to(torch.float32)
    loss = -(F.logsigmoid(pos_logit) + F.logsigmoid(-neg_logit))
    return torch.sum(loss * mask) / torch.clamp(torch.sum(mask), min=1.0)


def score_all(
    params: Dict,
    seqs: torch.Tensor,
    cfg: RecsysConfig,
    top_k: int = 10,
    item_chunks: int = 16,
    batch_chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Last-position user embedding x full catalog -> top-k ``(scores,
    ids)``.  Two-stage top-k, as the reference: a top-k within each of
    ``item_chunks`` slices of the catalog, then one over their winners;
    ``batch_chunk`` scores a large batch ``batch_chunk`` users at a time,
    so the logits held stay ``batch_chunk x n_items``."""
    u = user_embedding(params, seqs, cfg)[:, -1]               # (B, d)
    n_items = params["item_embed"].shape[0]
    while n_items % item_chunks:
        item_chunks -= 1  # smoke-scale catalogs
    chunk = n_items // item_chunks
    table = params["item_embed"].to(u.dtype).float().reshape(item_chunks, chunk, cfg.d)
    offsets = (torch.arange(item_chunks, device=u.device) * chunk)[None, :, None]

    def score_block(u_blk):
        logits = torch.einsum("bd,cnd->bcn", u_blk.float(), table)
        s, i = torch.topk(logits, top_k, dim=-1)                 # (b, chunks, k)
        i = i + offsets
        s2, idx = torch.topk(s.reshape(s.shape[0], -1), top_k, dim=-1)
        ids = torch.gather(i.reshape(i.shape[0], -1), -1, idx)
        return s2, ids.to(torch.int32)

    if batch_chunk is None or u.shape[0] <= batch_chunk:
        return score_block(u)
    parts = [score_block(u[b:b + batch_chunk]) for b in range(0, u.shape[0], batch_chunk)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def score_candidates(
    params: Dict,
    seqs: torch.Tensor,          # (B, L)
    candidates: torch.Tensor,    # (B, n_cand) item ids
    cfg: RecsysConfig,
) -> torch.Tensor:
    """Batched dot against a candidate set (retrieval scoring), float32."""
    u = user_embedding(params, seqs, cfg)[:, -1]
    cand = params["item_embed"][candidates.long()].to(u.dtype)
    return torch.einsum("bd,bnd->bn", u.float(), cand.float())
