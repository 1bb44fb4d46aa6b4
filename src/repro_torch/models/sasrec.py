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
from ..distributed.sharding import is_dtensor, shard
from .layers import dense_init, flash_attention, layer_norm

__all__ = ["init_params", "logical_axes", "user_embedding", "train_loss", "score_all",
           "score_candidates"]

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


def logical_axes(cfg: RecsysConfig) -> Dict:
    """Same structure as :func:`init_params`, leaves = logical axis tuples:
    the item table's rows on ``"items"`` (the recsys config puts them on
    ``"model"``), the blocks' columns on ``"ff"``."""
    blk = {
        "wq": (None, None, "ff"), "wk": (None, None, "ff"),
        "wv": (None, None, "ff"), "w1": (None, None, "ff"),
        "w2": (None, "ff", None),
        "ln1": (None, None), "ln1_b": (None, None),
        "ln2": (None, None), "ln2_b": (None, None),
    }
    return {
        "item_embed": ("items", None),
        "pos_embed": (None, None),
        "blocks": blk,
        "final_ln": (None,),
        "final_ln_b": (None,),
    }


# ---------------------------------------------------------------------------
# the item table split over ranks (the sharded step's "items" rows)
# ---------------------------------------------------------------------------

def _row_range(table) -> Tuple[int, int]:
    from ..distributed.sharding import local_shape_and_offset

    (rows, _), (r0, _) = local_shape_and_offset(table.shape, table.device_mesh,
                                                table.placements)
    return r0, rows


def _lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``.  For a DTensor ``table`` whose rows are split over the
    ranks, each rank looks up the ids that fall in its row range (zeros
    elsewhere), a partial sum over the ranks that split the rows, placed
    as ``ids`` on the others; its gradient stays on the rank's rows.

    The gather is ``F.embedding``: its gradient adds each row's entries in
    the order of ``ids`` on the CPU too (an indexing gather's gradient is a
    CPU ``index_put_`` that adds with atomics across threads, so its bits
    changed from run to run under load)."""
    if not is_dtensor(table):
        return F.embedding(ids.long(), table)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    r0, rows = _row_range(table)
    tp = list(table.placements)
    ip = [Replicate() if isinstance(t, Shard) else p for t, p in zip(tp, ids.placements)]
    out = [Partial() if isinstance(t, Shard) else p for t, p in zip(tp, ip)]
    grad = [t if isinstance(t, Shard) else (Partial() if isinstance(p, Shard) else Replicate())
            for t, p in zip(tp, ip)]

    def local(t, i):
        i = i.long() - r0
        inside = (i >= 0) & (i < rows)
        return F.embedding(i.clamp(0, max(rows - 1, 0)), t) * inside[..., None].to(t.dtype)

    return local_map(local, out_placements=out, in_placements=(tp, ip),
                     in_grad_placements=(grad, ip), device_mesh=mesh)(
        table, ids.redistribute(mesh, ip))


def _pointwise(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for an elementwise ``fn``, on each rank's shard of a DTensor
    (for ops DTensor has no rule for, such as ``logsigmoid``'s backward)."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    pl = [Replicate() if isinstance(p, Partial) else p for p in x.placements]
    return local_map(fn, out_placements=pl, in_placements=(pl,), in_grad_placements=(pl,),
                     device_mesh=x.device_mesh)(x.redistribute(x.device_mesh, pl))


def user_embedding(params: Dict, seqs: torch.Tensor, cfg: RecsysConfig) -> torch.Tensor:
    """seqs: ``(B, L)`` item ids, 0 = padding.  Returns ``(B, L, d)``
    states in ``cfg.dtype``."""
    if is_dtensor(seqs):
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication():
            return _user_embedding(params, seqs, cfg)
    return _user_embedding(params, seqs, cfg)


def _user_embedding(params: Dict, seqs: torch.Tensor, cfg: RecsysConfig) -> torch.Tensor:
    adt = _DTYPES[cfg.dtype]
    B, L = seqs.shape
    d = cfg.d
    hd = d // cfg.n_heads
    seqs = seqs.long()
    x = shard(_lookup(params["item_embed"], seqs).to(adt), "batch", None, None)
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
    pe = _lookup(params["item_embed"], pos_items).to(states.dtype)
    ne = _lookup(params["item_embed"], neg_items).to(states.dtype)
    pos_logit = torch.sum(states * pe, dim=-1).float()
    neg_logit = torch.sum(states * ne, dim=-1).float()
    mask = (pos_items > 0).to(torch.float32)
    loss = -(_pointwise(F.logsigmoid, pos_logit) + _pointwise(F.logsigmoid, -neg_logit))
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
    if is_dtensor(params["item_embed"]):
        return _score_all_sharded(params["item_embed"], u, cfg, top_k, item_chunks,
                                  batch_chunk)
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
    table = params["item_embed"]
    if is_dtensor(table):
        return _score_candidates_sharded(table, u, candidates)
    cand = table[candidates.long()].to(u.dtype)
    return torch.einsum("bd,bnd->bn", u.float(), cand.float())


def _split_dims(table) -> list:
    from torch.distributed.tensor import Shard

    return [i for i, p in enumerate(table.placements)
            if isinstance(p, Shard) and table.device_mesh.size(i) > 1]


def _score_all_sharded(table, u, cfg: RecsysConfig, top_k: int, item_chunks: int,
                       batch_chunk: Optional[int]):
    """:func:`score_all` over an item table whose rows are split over the
    ranks: each rank scores its users' rows against its own items, keeps a
    two-stage top-k of them (the catalog's ``item_chunks`` chunks spread
    over the ranks), and the ranks' winners are gathered and cut to the
    top-k, which is the whole catalog's."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = table.device_mesh
    split = _split_dims(table)
    up = [Replicate() if i in split else (p if isinstance(p, Shard) else Replicate())
          for i, p in enumerate(u.placements)]
    u = u.redistribute(mesh, up)
    r0, rows = _row_range(table)
    n_split = 1
    for i in split:
        n_split *= mesh.size(i)
    chunks = max(1, item_chunks // n_split)
    while rows % chunks:
        chunks -= 1
    t_l = table.to_local().to(u.dtype).float().reshape(chunks, rows // chunks, cfg.d)
    offsets = (r0 + torch.arange(chunks, device=t_l.device) * (rows // chunks))[None, :, None]

    def block(u_blk):
        logits = torch.einsum("bd,cnd->bcn", u_blk.float(), t_l)
        s, i = torch.topk(logits, top_k, dim=-1)
        i = i + offsets
        s2, idx = torch.topk(s.reshape(s.shape[0], -1), top_k, dim=-1)
        ids = torch.gather(i.reshape(i.shape[0], -1), -1, idx)
        for d in split:                      # every rank's winners, then the top-k
            s2 = funcol.all_gather_tensor(s2.t().contiguous(), 0, (mesh, d)).t()
            ids = funcol.all_gather_tensor(ids.t().contiguous(), 0, (mesh, d)).t()
        s3, idx = torch.topk(s2, top_k, dim=-1)
        return s3, torch.gather(ids, -1, idx).to(torch.int32)

    u_l = u.to_local()
    if batch_chunk is None or u_l.shape[0] <= batch_chunk:
        s, i = block(u_l)
    else:
        parts = [block(u_l[b:b + batch_chunk]) for b in range(0, u_l.shape[0], batch_chunk)]
        s, i = torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    B = u.shape[0]
    return (DTensor.from_local(s, mesh, up, run_check=False, shape=(B, top_k),
                               stride=(top_k, 1)),
            DTensor.from_local(i, mesh, up, run_check=False, shape=(B, top_k),
                               stride=(top_k, 1)))


def _score_candidates_sharded(table, u, candidates):
    """:func:`score_candidates` over an item table whose rows are split
    over the ranks: every rank reads all candidate ids, scores those in
    its own rows (0 elsewhere), and the partial scores are summed onto the
    candidates' own split (a reduce-scatter of ``(B, n_cand)`` floats, not
    of the gathered embeddings)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    split = _split_dims(table)
    rep = [Replicate()] * mesh.ndim
    cp = [Replicate() if i in split else p for i, p in enumerate(candidates.placements)]
    up = [Shard(0) if p == Shard(0) else Replicate() for p in cp]     # users as their rows
    out = [Partial() if i in split else p for i, p in enumerate(cp)]
    r0, rows = _row_range(table)

    def local(t, u_l, c):
        i = c.long() - r0
        inside = (i >= 0) & (i < rows)
        cand = t[i.clamp(0, max(rows - 1, 0))].to(u_l.dtype)
        return torch.einsum("bd,bnd->bn", u_l.float(), cand.float()) * inside

    tp = list(table.placements)
    scores = local_map(local, out_placements=out, in_placements=(tp, up, cp),
                       device_mesh=mesh)(table, u.redistribute(mesh, up),
                                         candidates.redistribute(mesh, cp))
    return scores.redistribute(mesh, candidates.placements)
