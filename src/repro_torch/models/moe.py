"""Mixture-of-Experts layer: top-k routing with sort-based dispatch.

A port of the JAX package's ``models/moe.py``, function for function:

1. router logits -> top-k gates per token (softmax over the selected);
2. (token, expert) slots flattened and stably sorted by expert id;
3. tokens written into an ``(E, C, D)`` capacity buffer (slots past the
   capacity ``C`` dropped), the expert FFNs run as batched products;
4. results weighted by the gates and summed back per token.

Aux losses: load balancing (Switch) + router z-loss.  Where the reference
leaves order to XLA, the port fixes it so that the card repeats its bits:

* **top-k** is a stable descending sort, so tied probabilities pick the
  lower expert id first, as ``jax.lax.top_k`` does;
* **dispatch** writes each kept slot once (``index_put`` on unique
  positions; dropped slots go to a spare row that is cut off), where the
  reference scatter-adds a zero payload at slot ``(0, 0)``: no atomics
  (the gathers back read dropped slots from row 0 and zero them, as the
  reference does, with ``index_select``: see ``_moe_sort``);
* **the combine** puts each token's K contributions back in the order
  the reference's scatter-add meets them (sorted slot order) and adds
  them one after the other in the activation dtype, not with
  ``index_add_`` (atomic on the card).

The expert products are ``torch.bmm``: the gate and up products write
float32 (the reference's ``preferred_element_type``) for the float32
``silu(h_g) * h_u``, and the down product rounds its float32 sums to the
activation dtype once, so on the CPU a bf16 layer equals the reference's
bit for bit.  ``_moe_a2a`` is the expert-parallel dispatch over a
``DeviceMesh``: each rank routes its own block of the tokens, and one
``all_to_all_single`` on the EP dim's group moves them to their experts'
ranks and back, inside an autograd function whose backward is the
reverse exchange.

Profiler ranges: ``repro_torch.moe`` around each layer's
:func:`moe_apply` and ``repro_torch.moe_experts`` around its expert
products, so that a trace splits a layer's device time between the
experts and the routing, sorts, gathers and writes around them.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.distributed as dist
import torch.profiler

from ..configs.base import MoEConfig
from ..distributed.sharding import _ctx, is_dtensor, shard

__all__ = ["moe_init", "moe_apply", "moe_logical_axes", "MOE_RANGE", "EXPERTS_RANGE"]

MOE_RANGE = "repro_torch.moe"
EXPERTS_RANGE = "repro_torch.moe_experts"


def moe_init(
    generator: torch.Generator, d_model: int, cfg: MoEConfig, device="cuda",
    dtype: torch.dtype = torch.float32,
) -> Dict:
    """One layer's MoE weights in ``dtype`` on ``device``, drawn in float32
    from ``generator`` (which must live on ``device``) one leaf at a time:
    ``router`` ``(D, E)`` at ``1/sqrt(D)``, ``w_gate`` / ``w_up``
    ``(E, D, F)`` at ``1/sqrt(D)``, ``w_down`` ``(E, F, D)`` at
    ``1/sqrt(F)``."""
    E, F = cfg.n_experts, cfg.d_expert

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=device) * scale).to(dtype)

    return {
        "router": normal((d_model, E), 1.0 / math.sqrt(d_model)),
        "w_gate": normal((E, d_model, F), 1.0 / math.sqrt(d_model)),
        "w_up": normal((E, d_model, F), 1.0 / math.sqrt(d_model)),
        "w_down": normal((E, F, d_model), 1.0 / math.sqrt(F)),
    }


def moe_logical_axes() -> Dict:
    return {
        "router": ("embed_param", "experts"),
        "w_gate": ("experts", "embed_param", "expert_ff"),
        "w_up": ("experts", "embed_param", "expert_ff"),
        "w_down": ("experts", "expert_ff", "embed_param"),
    }


def _route(params, x: torch.Tensor, cfg: MoEConfig):
    """Router top-k + aux losses (shared by both dispatch paths)."""
    E, K = cfg.n_experts, cfg.top_k
    logits = (x @ params["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k: among equal values the lower index comes first
    gates, eids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eids = gates[:, :K], eids[:, :K]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    density = torch.nn.functional.one_hot(eids[:, 0], E).float().mean(0)
    mean_probs = probs.mean(0)
    aux_loss = cfg.aux_loss_weight * E * torch.sum(density * mean_probs)
    z_loss = 1e-4 * torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return eids, gates, aux_loss, z_loss


def _sort_positions(eids, gates, n_buckets: int, C: int, bucket_of):
    """Sort (token, k)-slots into per-bucket capacity positions.

    Returns ``(bucket, expert, token, gate, pos, keep, order)``, each of
    length ``T*K`` in slot order sorted by bucket (stable), ``pos`` 0
    where not kept, and ``order`` the sort's permutation of the flat
    ``t * K + k`` slots.  ``bucket_of`` maps expert id -> bucket id."""
    T, K = eids.shape
    dev = eids.device
    flat_e = eids.reshape(-1)
    flat_b = bucket_of(flat_e)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    order = torch.argsort(flat_b, stable=True)
    sb, se, st, sg = flat_b[order], flat_e[order], flat_t[order], gates.reshape(-1)[order]
    start = torch.searchsorted(sb, torch.arange(n_buckets, device=dev, dtype=sb.dtype))
    pos = torch.arange(T * K, device=dev) - start[sb]
    keep = pos < C
    return sb, se, st, sg, torch.where(keep, pos, 0), keep, order


def _write_rows(values: torch.Tensor, row: torch.Tensor, n_rows: int) -> torch.Tensor:
    """``(n_rows, D)`` zeros with ``values[i]`` written at ``row[i]``; a
    ``row[i]`` of ``n_rows`` lands on one spare row that is cut off.  Every
    row below ``n_rows`` is written at most once, so the result repeats
    its bits."""
    out = values.new_zeros((n_rows + 1, values.shape[1]))
    return out.index_put((row,), values)[:n_rows]


def _combine(contrib: torch.Tensor, order: torch.Tensor, T: int, K: int) -> torch.Tensor:
    """Each token's sum of its K rows of ``contrib`` (sorted slot order),
    added one after the other in the order the sorted slots meet them, in
    ``contrib``'s dtype (the reference's scatter-add into zeros)."""
    where = torch.empty_like(order)
    where[order] = torch.arange(T * K, device=order.device)
    rows, _ = torch.sort(where.view(T, K), dim=1)
    parts = contrib[rows]                                   # (T, K, D)
    y = parts[:, 0]
    for k in range(1, K):
        y = y + parts[:, k]
    return y


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (batched) with float32 outputs: ``a``'s dtype's products
    added in float32.  On the card, where no gradient is asked for,
    cuBLAS's bf16 product writes float32 (``out_dtype``, which has no
    derivative); elsewhere the operands are widened first (exactly), and
    autograd differentiates that."""
    if a.is_cuda and a.dtype != torch.float32 and not (
            torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _expert_ffn(params, buf: torch.Tensor, dtype: torch.dtype, constrain: bool = True):
    """(E, C, D) capacity buffer through the gated expert FFN."""
    with torch.profiler.record_function(EXPERTS_RANGE):
        h_g = _bmm_f32(buf, params["w_gate"].to(dtype))
        h_u = _bmm_f32(buf, params["w_up"].to(dtype))
        # jax.nn.silu: x * sigmoid(x), sigmoid = 1 / (1 + exp(-x))
        h = (h_g * (1.0 / (1.0 + torch.exp(-h_g))) * h_u).to(dtype)
        if constrain:
            h = shard(h, "experts", "expert_capacity", "expert_ff")
        return torch.bmm(h, params["w_down"].to(dtype))


def _metrics(aux_loss, z_loss, keep) -> Dict[str, torch.Tensor]:
    return {
        "moe_aux_loss": aux_loss,
        "moe_z_loss": z_loss,
        "moe_drop_fraction": 1.0 - torch.mean(keep.float()),
    }


def _moe_sort(params, x: torch.Tensor, cfg: MoEConfig):
    """Baseline: global sort-based dispatch."""
    T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    # Capacity-factor dropping at scale; dropless floor for small token
    # counts (decode / smoke) so serving matches full-context routing.
    C = max(int(T * K / E * cfg.capacity_factor), min(T, 128), 1)
    eids, gates, aux_loss, z_loss = _route(params, x, cfg)
    se, _, st, sg, pos_c, keep, order = _sort_positions(eids, gates, E, C, lambda e: e)
    row = se * C + pos_c
    buf = _write_rows(x[st], torch.where(keep, row, E * C), E * C).view(E, C, D)
    buf = shard(buf, "experts", "expert_capacity", "embed")
    out_buf = _expert_ffn(params, buf, x.dtype).reshape(E * C, D)
    # Dropped slots read row 0 and are zeroed.  index_select's backward
    # adds with atomics, but only kept slots add non-zero values, each to
    # its own row, so the bits repeat; out_buf[...]'s backward would add
    # each row's readers in one serial run, and at a binding capacity most
    # slots read row 0 (0.63 s of a 2.2 s granite training step on an H100).
    expert_out = torch.index_select(out_buf, 0, torch.where(keep, row, 0)) * (
        sg * keep).to(x.dtype)[:, None]
    y = shard(_combine(expert_out, order, T, K), None, "embed")
    return y, _metrics(aux_loss, z_loss, keep)


def _replicated(mesh) -> list:
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim


def _expert_layout(mesh):
    """Placements of the expert products on ``mesh`` under the ambient
    rules: ``(buf, w_gate / w_up, w_down, out, buf grad)``.  A mesh dim
    that the ``"experts"`` rule names splits the buffer, the weights and
    the output over experts (EP: each rank runs its own experts); one that
    ``"expert_ff"`` names (and ``"experts"`` does not) splits the weights
    over ``F`` with the buffer whole, so each rank's down product is a
    partial sum; any other dim holds everything whole."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ..distributed.sharding import _dedup_axes, logical_spec

    _, rules = _ctx()
    spec = _dedup_axes(logical_spec(("experts", None, "expert_ff"), rules or {}, mesh))

    def names(entry):
        return set(entry if isinstance(entry, tuple) else (entry,)) - {None}

    ep, ff = names(spec[0]), names(spec[2])
    lay = []
    for name in mesh.mesh_dim_names:
        if name in ep:
            lay.append((Shard(0), Shard(0), Shard(0), Shard(0), Shard(0)))
        elif name in ff:
            lay.append((Replicate(), Shard(2), Shard(1), Partial(), Partial()))
        else:
            lay.append((Replicate(),) * 5)
    return tuple(list(col) for col in zip(*lay))


def _moe_sort_dtensor(params, x, cfg: MoEConfig):
    """:func:`_moe_sort` of a DTensor ``x`` and DTensor weights (the
    sharded train step's).  The capacity and the drops come from the
    global tokens, as in the reference: the tokens and the router are
    gathered, and each rank routes, sorts and fills the ``(E, C, D)``
    buffer under ``local_map`` (the same work on every rank).  The
    expert products run on each rank's own experts (a mesh dim under
    ``"experts"``, EP) or its ``F`` slice (under ``"expert_ff"``, the
    down product a partial sum), the gathers back and the combine on the
    whole buffer in the reference's scatter order."""
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = max(int(T * K / E * cfg.capacity_factor), min(T, 128), 1)
    rep = _replicated(mesh)
    dt = x.dtype

    def dispatch(x_l, router):
        eids, gates, aux_loss, z_loss = _route({"router": router}, x_l, cfg)
        se, _, st, sg, pos_c, keep, order = _sort_positions(eids, gates, E, C, lambda e: e)
        row = se * C + pos_c
        buf = _write_rows(x_l[st], torch.where(keep, row, E * C), E * C).view(E, C, D)
        drop = 1.0 - torch.mean(keep.float())
        return (buf, (sg * keep).to(dt), torch.where(keep, row, 0), order,
                aux_loss, z_loss, drop)

    buf, w, rows, order, aux_loss, z_loss, drop = local_map(
        dispatch, out_placements=(rep,) * 7, in_placements=(rep, rep), device_mesh=mesh,
    )(x.redistribute(mesh, rep), params["router"].redistribute(mesh, rep))

    buf_p, wgu_p, wd_p, out_p, buf_gp = _expert_layout(mesh)
    # each weight whole on the dims its products do not split (the FSDP
    # gather over "embed_param"), its gradient summed back by the reverse
    wg, wu, wd = (params[n].redistribute(mesh, p) for n, p in
                  (("w_gate", wgu_p), ("w_up", wgu_p), ("w_down", wd_p)))
    out_buf = local_map(
        lambda b, g, u, d: _expert_ffn({"w_gate": g, "w_up": u, "w_down": d}, b, dt,
                                       constrain=False),
        out_placements=out_p, in_placements=(buf_p, wgu_p, wgu_p, wd_p),
        in_grad_placements=(buf_gp, wgu_p, wgu_p, wd_p), device_mesh=mesh,
    )(buf.redistribute(mesh, buf_p), wg, wu, wd)

    def combine(out_l, w_l, rows_l, order_l):
        expert_out = torch.index_select(out_l.reshape(E * C, D), 0, rows_l) * w_l[:, None]
        return _combine(expert_out, order_l, T, K)

    y = local_map(combine, out_placements=rep, in_placements=(rep, rep, rep, rep),
                  device_mesh=mesh)(out_buf.redistribute(mesh, rep), w, rows, order)
    metrics = {"moe_aux_loss": aux_loss, "moe_z_loss": z_loss, "moe_drop_fraction": drop}
    return shard(y, None, "embed"), metrics


def _moe_a2a_dtensor(params, x, cfg: MoEConfig, mesh, ep_axis: str):
    """:func:`_moe_a2a` of a DTensor ``x`` and DTensor weights under
    ``local_map``: the tokens split over every mesh dim in rank order,
    the router whole, each expert weight this rank's block on
    ``ep_axis``.  A weight's gradient is each rank's share summed over
    the other dims (each rank routed its own tokens)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    tok = [Shard(0)] * mesh.ndim
    rep = _replicated(mesh)
    w_p = [Shard(0) if n == ep_axis else Replicate() for n in mesh.mesh_dim_names]
    w_gp = [Shard(0) if n == ep_axis else Partial() for n in mesh.mesh_dim_names]
    names = ("router", "w_gate", "w_up", "w_down")

    def local(x_l, router, wg, wu, wd):
        y, m = _moe_a2a({"router": router, "w_gate": wg, "w_up": wu, "w_down": wd}, x_l,
                        cfg, mesh, ep_axis, mean_grad="local")
        return y, m["moe_aux_loss"], m["moe_z_loss"], m["moe_drop_fraction"]

    y, aux_loss, z_loss, drop = local_map(
        local, out_placements=(tok, rep, rep, rep),
        in_placements=(tok, rep, w_p, w_p, w_p),
        in_grad_placements=(tok, [Partial()] * mesh.ndim, w_gp, w_gp, w_gp),
        device_mesh=mesh,
    )(x.redistribute(mesh, tok), *(params[n].redistribute(mesh, rep if n == "router" else w_p)
                                   for n in names))
    return y, {"moe_aux_loss": aux_loss, "moe_z_loss": z_loss, "moe_drop_fraction": drop}


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal row blocks over ``group``; its
    backward is the same exchange of the gradient (the reverse
    all-to-all)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group``; the gradient of every rank's input is the sum
    of the ranks' output gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _AllReduceLocalGrad(torch.autograd.Function):
    """Sum over ``group`` whose backward passes each rank's gradient
    through unreduced: the sum is one value held on every rank."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _mesh_mean(t: torch.Tensor, mesh, grad: str = "sum") -> torch.Tensor:
    """The mean of ``t`` over every rank of ``mesh`` (the reference's
    ``pmean`` over all axes): a sum over each mesh dim's group in turn,
    divided by the mesh's size.  ``grad='sum'`` all-reduces the gradient
    too (:class:`_AllReduceSum`), ``'local'`` does not
    (:class:`_AllReduceLocalGrad`)."""
    if mesh.size() == 1:
        return t
    fn = _AllReduceSum if grad == "sum" else _AllReduceLocalGrad
    for i, name in enumerate(mesh.mesh_dim_names):
        if mesh.size(i) > 1:
            t = fn.apply(t, mesh.get_group(name))
    return t / mesh.size()


def _moe_a2a(params, x: torch.Tensor, cfg: MoEConfig, mesh, ep_axis: str,
             mean_grad: str = "sum"):
    """Expert-parallel all-to-all dispatch.

    ``x`` is this rank's block of the tokens, which are split over every
    mesh dim in the mesh's rank order (the reference's
    ``P(token_axes, None)`` over all axes); ``params`` are the router
    (whole) and the expert block that this rank holds on ``ep_axis``
    (experts ``[r * E_loc, (r + 1) * E_loc)`` of EP rank ``r``, the
    reference's ``P(ep_axis, None, None)`` shard).  Each rank routes its
    local tokens, buckets them by destination EP rank, and one all-to-all
    over ``ep_axis`` moves ``T_local * K * D`` values there and back.  On
    a one-rank EP dim no collective runs, but the path keeps its own
    capacities ``C`` and ``C2``.  The metrics are averaged over every rank
    of the mesh (``mean_grad='sum'`` sums their gradients over the ranks,
    as when each rank differentiates its own loss; ``'local'`` keeps each
    rank's share, as under ``local_map``, where the mean is one value)."""
    E, K = cfg.n_experts, cfg.top_k
    n_ranks = mesh.size(mesh.mesh_dim_names.index(ep_axis))
    E_loc = E // n_ranks
    if params["w_gate"].shape[0] != E_loc:
        raise ValueError(f"_moe_a2a takes this rank's {E_loc} experts, got "
                         f"{params['w_gate'].shape[0]}")
    group = mesh.get_group(ep_axis) if n_ranks > 1 else None
    rank = mesh.get_local_rank(ep_axis) if n_ranks > 1 else 0
    p_loc = params

    T_loc, D = x.shape
    eids, gates, aux_loss, z_loss = _route(p_loc, x, cfg)
    # capacity of each (destination rank) bucket
    C = max(int(T_loc * K / n_ranks * cfg.capacity_factor), 8)
    sb, se, st, sg, pos_c, keep, order = _sort_positions(
        eids, gates, n_ranks, C, lambda e: torch.div(e, E_loc, rounding_mode="floor"))
    row = torch.where(keep, sb * C + pos_c, n_ranks * C)
    send = _write_rows(x[st], row, n_ranks * C)
    send_e = torch.full((n_ranks * C + 1,), -1, dtype=torch.int64, device=x.device)
    send_e = send_e.index_put((row,), se)[:n_ranks * C]
    # the collective: tokens travel to their expert's EP rank and back
    if group is not None:
        recv, recv_e = _AllToAll.apply(send, group), _exchange(send_e, group)
    else:
        recv, recv_e = send, send_e

    # local dispatch into per-expert capacity slots (all local now)
    le = torch.clamp(recv_e - rank * E_loc, 0, E_loc - 1)
    valid = recv_e >= 0
    key = torch.where(valid, le, E_loc)                      # invalid last
    order2 = torch.argsort(key, stable=True)
    fe, fv = le[order2], valid[order2]
    C2 = max(int(n_ranks * C * cfg.capacity_factor / max(E_loc, 1)), 8)
    start = torch.searchsorted(key[order2], torch.arange(E_loc, device=x.device))
    pos2 = torch.arange(n_ranks * C, device=x.device) - start[fe]
    keep2 = (pos2 >= 0) & (pos2 < C2) & fv
    row2 = fe * C2 + pos2
    buf = _write_rows(recv[order2], torch.where(keep2, row2, E_loc * C2),
                      E_loc * C2).view(E_loc, C2, D)
    out = _expert_ffn(p_loc, buf, x.dtype, constrain=False).reshape(E_loc * C2, D)
    # undo the local dispatch
    vals = torch.index_select(out, 0, torch.where(keep2, row2, 0)) * keep2[:, None].to(x.dtype)
    flat_out = torch.zeros_like(vals).index_put((order2,), vals)
    back = _AllToAll.apply(flat_out, group) if group is not None else flat_out
    contrib = torch.index_select(back, 0, torch.where(keep, sb * C + pos_c, 0)) * (
        sg * keep).to(x.dtype)[:, None]
    y = _combine(contrib, order, T_loc, K)
    metrics = _metrics(aux_loss, z_loss, keep)
    return y, {k: _mesh_mean(v, mesh, mean_grad) for k, v in metrics.items()}


def moe_apply(
    params: Dict, x: torch.Tensor, cfg: MoEConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (T, D) flattened tokens -> (T, D), aux metrics/losses.

    ``cfg.dispatch == "a2a"`` takes :func:`_moe_a2a` under a
    :func:`~repro_torch.distributed.sharding.use_mesh_rules` context whose
    ``"experts"`` rule names a mesh dim that divides the experts; without
    one (or with the ``'sort'`` dispatch) the sort path runs, as in the
    reference.  Both run wherever ``x`` lies.  A DTensor ``x`` (with
    DTensor weights) takes :func:`_moe_sort_dtensor` or
    :func:`_moe_a2a_dtensor`; a plain ``x`` on the a2a path is this rank's
    block of the tokens, with this rank's expert block."""
    sharded = is_dtensor(x)
    with torch.profiler.record_function(MOE_RANGE):
        if cfg.dispatch == "a2a":
            mesh, rules = _ctx()
            if sharded:
                mesh = x.device_mesh
            ep_axis = rules.get("experts") if rules else None
            if (
                mesh is not None
                and isinstance(ep_axis, str)
                and ep_axis in mesh.mesh_dim_names
                and cfg.n_experts % mesh.size(mesh.mesh_dim_names.index(ep_axis)) == 0
            ):
                if sharded:
                    return _moe_a2a_dtensor(params, x, cfg, mesh, ep_axis)
                return _moe_a2a(params, x, cfg, mesh, ep_axis)
            # no mesh / incompatible sharding: fall through to the baseline
        if sharded:
            return _moe_sort_dtensor(params, x, cfg)
        return _moe_sort(params, x, cfg)
