"""GNN zoo: MeshGraphNet, GraphCast, SchNet, DimeNet.

A port of the JAX package's ``models/gnn.py``.  All message passing is
gather + segment sum over an edge index, as in the reference.  Each sum
adds a segment's values in a fixed order, on every device: the index is
sorted once per graph (the order kept on the :class:`GraphBatch`) and
``torch.segment_reduce`` adds each segment's run, so a step repeats its
bits on the card (``index_add_`` there adds with atomics in no fixed
order).  Of the fixed orders it is the quicker: a sort per graph beats
a segment plan per graph in every GNN step on an H100
(``scripts/gnn_segsum_times.py``).

Input container: :class:`GraphBatch`, one (possibly batched, padded)
graph as tensors.  SchNet and DimeNet need ``positions``; DimeNet needs
``triplets`` (the edge pairs k->j->i of
:func:`repro_torch.data.graphs.build_triplets`).  Masks make padding
inert.  ``cfg.remat_policy != "none"`` recomputes the whole forward in
the backward and keeps the outputs of its matmuls without batch dims
(:func:`~repro_torch.models.layers.remat`), as the reference's
``dots_with_no_batch_dims_saveable`` policy does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import GNNConfig
from ..distributed.sharding import is_dtensor
from .layers import layer_norm, mlp_apply, mlp_init, remat

__all__ = ["GraphBatch", "NODE_FIELDS", "EDGE_FIELDS", "pad_rows", "distribute_graph",
           "init_params", "forward"]

NODE_FIELDS = ("nodes", "node_mask", "positions", "graph_ids")
EDGE_FIELDS = ("edge_src", "edge_dst", "edge_mask", "edge_feat", "triplets", "triplet_mask")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class GraphBatch:
    nodes: torch.Tensor                        # (N, d_in)
    edge_src: torch.Tensor                     # (E,) int32
    edge_dst: torch.Tensor                     # (E,) int32
    node_mask: torch.Tensor                    # (N,) bool
    edge_mask: torch.Tensor                    # (E,) bool
    positions: Optional[torch.Tensor] = None   # (N, 3)
    edge_feat: Optional[torch.Tensor] = None   # (E, d_e)
    graph_ids: Optional[torch.Tensor] = None   # (N,) for batched small graphs
    triplets: Optional[torch.Tensor] = None    # (T, 2) = (edge_kj, edge_ji)
    triplet_mask: Optional[torch.Tensor] = None
    n_graphs: int = 1

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_edges(self) -> int:
        return self.edge_src.shape[0]

    def to(self, device) -> "GraphBatch":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` with zero rows appended up to ``rows`` (false for a mask)."""
    if t.shape[0] >= rows:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0],) + tuple(t.shape[1:]))])


def distribute_graph(g: GraphBatch, rules, mesh) -> GraphBatch:
    """``g`` (the same on every rank) as the sharded step holds it: each
    node array's rows split by the ``"nodes"`` rule and each edge array's
    (triplets included) by ``"edges"``, as DTensors on ``mesh`` (the
    reference cells' ``_gnn_graph_shardings``).  The rows are first padded
    to a multiple of the ranks that split them, as the reference's shapes
    are padded: a padded node or edge is masked out, and a padded triplet
    (edges 0 -> 0) too, so the padding is inert; a node-level target is
    padded alike with :func:`pad_rows` to ``n_nodes``."""
    from torch.distributed.tensor import distribute_tensor

    from ..distributed.sharding import logical_spec, placements_for, split_count

    def padded(n, axis):
        k = split_count(logical_spec((axis,), rules, mesh)[0], mesh)
        return -(-n // k) * k

    n_pad, e_pad = padded(g.n_nodes, "nodes"), padded(g.n_edges, "edges")
    t_pad = padded(g.triplets.shape[0], "edges") if g.triplets is not None else 0
    if g.triplets is not None and g.triplet_mask is None:
        g = dataclasses.replace(g, triplet_mask=torch.ones(
            (g.triplets.shape[0],), dtype=torch.bool, device=g.triplets.device))

    def place(name, t):
        if not isinstance(t, torch.Tensor):
            return t
        axis = "nodes" if name in NODE_FIELDS else "edges"
        rows = n_pad if axis == "nodes" else (t_pad if name.startswith("triplet") else e_pad)
        return distribute_tensor(pad_rows(t, rows), mesh, list(placements_for(
            (axis,) + (None,) * (t.ndim - 1), rules, mesh)))

    return dataclasses.replace(g, **{f.name: place(f.name, getattr(g, f.name))
                                     for f in dataclasses.fields(g)})


def _segment_ids(g: GraphBatch, name: str) -> torch.Tensor:
    return g.triplets[:, 1] if name == "ji" else getattr(g, name)


def _seg_sum(vals: torch.Tensor, g: GraphBatch, name: str, n: int) -> torch.Tensor:
    """Sum of ``vals`` over the ``n`` segments of ``g``'s index ``name``
    (:func:`_local_seg_sum`).  DTensor ``vals`` (rows split as the index
    is: the sharded step's edges or nodes) are summed on each rank over its
    own rows into all ``n`` segments, a partial sum that the next op
    reduces (a reduce-scatter onto node-split rows)."""
    if not is_dtensor(vals):
        return _local_seg_sum(vals, g, name, n)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    ids = _segment_ids(g, name)
    mesh = vals.device_mesh
    vp, ip = list(vals.placements), list(ids.placements)
    return local_map(
        lambda v, i: _local_seg_sum(v, g, name, n, ids=i),
        out_placements=[Partial()] * mesh.ndim, in_placements=(vp, ip),
        in_grad_placements=(vp, ip), device_mesh=mesh)(vals, ids)


def _local_seg_sum(vals: torch.Tensor, g: GraphBatch, name: str, n: int,
                   ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum of ``vals`` over the ``n`` segments of ``g``'s index ``name``
    (``"edge_dst"``, ``"graph_ids"`` or ``"ji"``, the triplets' target
    edges): the values in the index's stable sort order, which is built
    at the first sum and kept on ``g``, each segment's run added in that
    order (edge order within a segment, as ``index_add_`` adds on the
    CPU)."""
    orders = g.__dict__.setdefault("_segment_orders", {})
    if (name, n) not in orders:
        ids = (ids if ids is not None else _segment_ids(g, name)).long()
        # the lengths by a scatter into n slots: a fixed output shape, which a
        # trace over fake tensors can follow (bincount's depends on the ids)
        lengths = torch.zeros(n, dtype=torch.int64, device=ids.device)
        lengths.scatter_add_(0, ids, torch.ones_like(ids))
        orders[name, n] = (torch.argsort(ids, stable=True), lengths)
    order, lengths = orders[name, n]
    return torch.segment_reduce(vals[order], "sum", lengths=lengths, axis=0)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]``.  For a DTensor ``x`` (rows split over the ranks) the
    rows are gathered whole and each rank takes those of its own ``idx``
    rows; the gradient of the gathered ``x`` is a partial sum over the
    ranks that split ``idx``, reduced onto ``x``'s rows."""
    if not is_dtensor(x):
        return x[idx.long()]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    ip = list(idx.placements)
    grad = [Partial() if isinstance(p, Shard) else Replicate() for p in ip]
    return local_map(lambda t, i: t[i.long()], out_placements=ip, in_placements=(rep, ip),
                     in_grad_placements=(grad, ip), device_mesh=mesh)(
        x.redistribute(mesh, rep), idx)


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _rbf(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Gaussian radial basis on [0, cutoff] (SchNet §3)."""
    mu = torch.linspace(0.0, cutoff, n_rbf, dtype=torch.float32, device=dist.device)
    gamma = n_rbf / cutoff
    return torch.exp(-gamma * (dist[:, None] - mu[None, :]) ** 2)


def _edge_geometry(g: GraphBatch):
    rel = _take(g.positions, g.edge_dst) - _take(g.positions, g.edge_src)
    dist = torch.sqrt(torch.clamp(torch.sum(rel * rel, dim=-1), min=1e-12))
    return rel, dist


def _stack(blocks):
    """A list of equal-structured dicts -> one dict of stacked tensors."""
    first = blocks[0]
    if isinstance(first, dict):
        return {k: _stack([b[k] for b in blocks]) for k in first}
    return torch.stack(blocks)


def _block(stacked, i: int):
    if isinstance(stacked, dict):
        return {k: _block(v, i) for k, v in stacked.items()}
    return stacked[i]


# ---------------------------------------------------------------------------
# MeshGraphNet / GraphCast: encode-process-decode, edge+node latents.
# ---------------------------------------------------------------------------

def _epd_init(gen, cfg: GNNConfig, d_in: int, d_edge_in: int, dtype, device):
    h = cfg.d_hidden
    mlp_dims = [h] * cfg.mlp_layers
    params = {
        "node_enc": mlp_init(gen, [d_in] + mlp_dims, dtype, device),
        "edge_enc": mlp_init(gen, [d_edge_in] + mlp_dims, dtype, device),
        "decoder": mlp_init(gen, [h] + mlp_dims[:-1] + [cfg.d_out], dtype, device),
    }
    ones = lambda: torch.ones((h,), dtype=dtype, device=device)     # noqa: E731
    zeros = lambda: torch.zeros((h,), dtype=dtype, device=device)   # noqa: E731
    params["blocks"] = _stack([
        {
            "edge_mlp": mlp_init(gen, [3 * h] + mlp_dims, dtype, device),
            "node_mlp": mlp_init(gen, [2 * h] + mlp_dims, dtype, device),
            "ln_e": ones(), "ln_e_b": zeros(), "ln_n": ones(), "ln_n_b": zeros(),
        }
        for _ in range(cfg.n_layers)
    ])
    return params


def _epd_forward(params, g: GraphBatch, cfg: GNNConfig):
    adt = _DTYPES[cfg.dtype]
    n, e = g.n_nodes, g.n_edges
    h = mlp_apply(params["node_enc"], g.nodes.to(adt))
    if g.edge_feat is not None:
        ef = g.edge_feat.to(adt)
    elif g.positions is not None:
        rel, dist = _edge_geometry(g)
        ef = torch.cat([rel, dist[:, None]], dim=-1).to(adt)
    else:
        # structural fallback: featureless edges
        ef = torch.ones((e, 1), dtype=adt, device=h.device)
    he = mlp_apply(params["edge_enc"], ef)
    emask = g.edge_mask[:, None].to(adt)
    nmask = g.node_mask[:, None].to(adt)

    for i in range(cfg.n_layers):
        bp = _block(params["blocks"], i)
        src_h = _take(h, g.edge_src)
        dst_h = _take(h, g.edge_dst)
        e_upd = mlp_apply(bp["edge_mlp"], torch.cat([he, src_h, dst_h], dim=-1))
        he = layer_norm(he + e_upd * emask, bp["ln_e"], bp["ln_e_b"])
        agg = _seg_sum(he * emask, g, "edge_dst", n)
        if cfg.aggregator == "mean":
            deg = _seg_sum(emask, g, "edge_dst", n)
            agg = agg / torch.clamp(deg, min=1.0)
        n_upd = mlp_apply(bp["node_mlp"], torch.cat([h, agg], dim=-1))
        h = layer_norm(h + n_upd * nmask, bp["ln_n"], bp["ln_n_b"])
    return mlp_apply(params["decoder"], h) * nmask


# ---------------------------------------------------------------------------
# SchNet: continuous-filter convolutions.
# ---------------------------------------------------------------------------

def _schnet_init(gen, cfg: GNNConfig, d_in: int, dtype, device):
    h = cfg.d_hidden
    params = {
        "embed": mlp_init(gen, [d_in, h], dtype, device),
        "out": mlp_init(gen, [h, h, cfg.d_out], dtype, device),
    }
    params["blocks"] = _stack([
        {
            "filter": mlp_init(gen, [cfg.n_rbf, h, h], dtype, device),
            "in_lin": mlp_init(gen, [h, h], dtype, device),
            "post": mlp_init(gen, [h, h, h], dtype, device),
        }
        for _ in range(cfg.n_layers)
    ])
    return params


def _schnet_forward(params, g: GraphBatch, cfg: GNNConfig):
    adt = _DTYPES[cfg.dtype]
    n = g.n_nodes
    if g.positions is None:
        raise ValueError("SchNet needs positions")
    _, dist = _edge_geometry(g)
    rbf = _rbf(dist, cfg.n_rbf, cfg.cutoff).to(adt)
    # smooth cutoff envelope
    env = 0.5 * (torch.cos(math.pi * torch.clamp(dist / cfg.cutoff, 0, 1)) + 1.0)
    emask = (g.edge_mask * (dist < cfg.cutoff)).to(adt) * env.to(adt)
    h = mlp_apply(params["embed"], g.nodes.to(adt))

    for i in range(cfg.n_layers):
        bp = _block(params["blocks"], i)
        w = mlp_apply(bp["filter"], rbf, activation=F.softplus)     # (E, h)
        src = _take(mlp_apply(bp["in_lin"], h), g.edge_src)
        msg = src * w * emask[:, None]
        agg = _seg_sum(msg, g, "edge_dst", n)
        h = h + mlp_apply(bp["post"], agg, activation=F.softplus)

    out = mlp_apply(params["out"], h, activation=F.softplus)
    out = out * g.node_mask[:, None].to(adt)
    if g.graph_ids is not None:
        return _seg_sum(out, g, "graph_ids", g.n_graphs)  # per-molecule energy
    return out


# ---------------------------------------------------------------------------
# DimeNet: directional message passing over edge messages + triplets.
# ---------------------------------------------------------------------------

def _sbf(dist_kj: torch.Tensor, angle: torch.Tensor, cfg: GNNConfig) -> torch.Tensor:
    """Simplified spherical basis: radial sinc-like x angular cos(l theta),
    the reference's n_radial x n_spherical structure."""
    nr, ns = cfg.n_radial, cfg.n_spherical
    dev = dist_kj.device
    freq = torch.arange(1, nr + 1, dtype=torch.float32, device=dev) * math.pi
    d = torch.clamp(dist_kj / cfg.cutoff, 1e-4, 1.0)
    radial = torch.sin(freq * d[:, None]) / d[:, None]               # (T, nr)
    ls = torch.arange(ns, dtype=torch.float32, device=dev)
    angular = torch.cos(ls[None, :] * angle[:, None])                # (T, ns)
    return (radial[:, :, None] * angular[:, None, :]).reshape(dist_kj.shape[0], nr * ns)


def _dimenet_init(gen, cfg: GNNConfig, d_in: int, dtype, device):
    h = cfg.d_hidden
    nb = cfg.n_bilinear
    sbf_dim = cfg.n_radial * cfg.n_spherical
    params = {
        "embed_node": mlp_init(gen, [d_in, h], dtype, device),
        "embed_msg": mlp_init(gen, [2 * h + cfg.n_rbf, h], dtype, device),
        "rbf_out": mlp_init(gen, [cfg.n_rbf, h], dtype, device),
        "out": mlp_init(gen, [h, h, cfg.d_out], dtype, device),
    }
    params["blocks"] = _stack([
        {
            "sbf_lin": mlp_init(gen, [sbf_dim, nb], dtype, device),
            "msg_lin": mlp_init(gen, [h, nb * h], dtype, device),
            "bilinear": (torch.randn((nb, h, h), generator=gen, device=device)
                         / math.sqrt(h)).to(dtype),
            "update": mlp_init(gen, [h, h, h], dtype, device),
        }
        for _ in range(cfg.n_layers)
    ])
    return params


def _bilinear(mk: torch.Tensor, w: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``sum_b a_b * (mk @ W_b)`` per triplet row.  Over DTensors (triplet
    rows split over the ranks, ``W`` replicated) each rank runs it on its
    own rows: DTensor's einsum rule does not keep an uneven row split."""
    def rows(mk, w, a):
        mw = torch.einsum("th,bhg->tbg", mk, w)
        return torch.einsum("tb,tbg->tg", a, mw)

    if not is_dtensor(mk):
        return rows(mk, w, a)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    rp = list(mk.placements)
    wp = [Replicate()] * mk.device_mesh.ndim
    wg = [Partial() if isinstance(p, Shard) else Replicate() for p in rp]
    return local_map(rows, out_placements=rp, in_placements=(rp, wp, rp),
                     in_grad_placements=(rp, wg, rp), device_mesh=mk.device_mesh)(
        mk, w.redistribute(mk.device_mesh, wp), a.redistribute(mk.device_mesh, rp))


def _dimenet_forward(params, g: GraphBatch, cfg: GNNConfig):
    adt = _DTYPES[cfg.dtype]
    if g.positions is None or g.triplets is None:
        raise ValueError("DimeNet needs positions and triplets")
    n, e = g.n_nodes, g.n_edges
    rel, dist = _edge_geometry(g)
    rbf = _rbf(dist, cfg.n_rbf, cfg.cutoff).to(adt)
    emask = g.edge_mask.to(adt)

    h = mlp_apply(params["embed_node"], g.nodes.to(adt))
    src_h = _take(h, g.edge_src)
    dst_h = _take(h, g.edge_dst)
    m = mlp_apply(params["embed_msg"], torch.cat([src_h, dst_h, rbf], dim=-1))
    m = m * emask[:, None]

    # triplet geometry: k->j (edge_kj) then j->i (edge_ji)
    idx_kj = g.triplets[:, 0]
    idx_ji = g.triplets[:, 1]
    tmask = (g.triplet_mask.to(adt) if g.triplet_mask is not None
             else torch.ones((g.triplets.shape[0],), dtype=adt, device=m.device))
    v_kj = _take(rel, idx_kj)
    v_ji = _take(rel, idx_ji)
    cosang = torch.sum(-v_kj * v_ji, dim=-1) / torch.clamp(
        torch.sqrt(torch.sum(v_kj * v_kj, dim=-1)) * torch.sqrt(torch.sum(v_ji * v_ji, dim=-1)),
        min=1e-9)
    angle = torch.arccos(torch.clamp(cosang, -1 + 1e-6, 1 - 1e-6))
    sbf = _sbf(_take(dist, idx_kj), angle, cfg).to(adt)

    for i in range(cfg.n_layers):
        bp = _block(params["blocks"], i)
        a = mlp_apply(bp["sbf_lin"], sbf)                            # (T, nb)
        mk = _take(m, idx_kj)                                        # (T, h)
        # bilinear: sum_b a_b * (mk @ W_b)
        tri_msg = _bilinear(mk, bp["bilinear"].to(m.dtype), a) * tmask[:, None]
        agg = _seg_sum(tri_msg, g, "ji", e)                           # per target edge
        m = m + mlp_apply(bp["update"], agg, activation=_silu)
        m = m * emask[:, None]

    w = mlp_apply(params["rbf_out"], rbf)
    node_out = _seg_sum(m * w * emask[:, None], g, "edge_dst", n)
    out = mlp_apply(params["out"], node_out, activation=_silu)
    out = out * g.node_mask[:, None].to(adt)
    if g.graph_ids is not None:
        return _seg_sum(out, g, "graph_ids", g.n_graphs)
    return out


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def init_params(
    cfg: GNNConfig, generator: torch.Generator, d_in: int, d_edge_in: int = 4,
    device="cuda",
) -> Dict:
    """Random params in ``cfg.param_dtype`` on ``device``, drawn from
    ``generator`` (which must live on ``device``); the layout is the
    reference's (blocks stacked over layers)."""
    dtype = _DTYPES[cfg.param_dtype]
    if cfg.kind in ("meshgraphnet", "graphcast"):
        return _epd_init(generator, cfg, d_in, d_edge_in, dtype, device)
    if cfg.kind == "schnet":
        return _schnet_init(generator, cfg, d_in, dtype, device)
    if cfg.kind == "dimenet":
        return _dimenet_init(generator, cfg, d_in, dtype, device)
    raise ValueError(cfg.kind)


_FORWARD = {
    "meshgraphnet": _epd_forward,
    "graphcast": _epd_forward,
    "schnet": _schnet_forward,
    "dimenet": _dimenet_forward,
}


def forward(params: Dict, g: GraphBatch, cfg: GNNConfig) -> torch.Tensor:
    """The model's output.  Over DTensors (the sharded step's: nodes and
    edges split over the ranks, params replicated) each gather and
    segment sum runs on the rank's own rows (:func:`_take`,
    :func:`_seg_sum`), and the model's plain constants (RBF centres, the
    masks it makes) act as replicated DTensors."""
    fwd = _FORWARD[cfg.kind]
    if is_dtensor(g.nodes):
        from torch.distributed.tensor.experimental import implicit_replication

        run = fwd

        def fwd(p, g, cfg):
            with implicit_replication():
                return run(p, g, cfg)
    if cfg.remat_policy != "none" and torch.is_grad_enabled():
        return remat(lambda p: fwd(p, g, cfg), params, save_matmuls=True)
    return fwd(params, g, cfg)
