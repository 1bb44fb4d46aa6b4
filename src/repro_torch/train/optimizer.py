"""Optimizers, written out (no optimizer library), as in the JAX package.

A port of the JAX package's ``train/optimizer.py``.  The API is the
gradient-transformation shape: ``init(params) -> state`` and
``update(grads, state, params, step) -> (updates, new_state)``; apply
with :func:`apply_updates`.  Trees are nested dicts of tensors; the step
count is a tensor on the params' device, and a learning-rate schedule is
a function of it.  Every update is computed in float32 and cast to the
state's or the param's dtype, at the reference's rounding points:

* :func:`adamw` with a moment dtype (``bfloat16`` halves the optimizer's
  memory) and an optional weight-decay mask;
* :func:`sgdm`, momentum SGD;
* :func:`adafactor`, the factored second moment (row and column means for
  a matrix instead of a full tensor; Shazeer & Stern, 2018, simplified);
* :func:`clip_by_global_norm`, :func:`cosine_schedule`,
  :func:`linear_warmup`.

Each rule is a per-leaf function applied over the trees (``leaf_update``),
so that a train step can update a large state one leaf at a time
(:func:`repro_torch.train.steps.make_update_fn`).  The rules run on
DTensor leaves as they are (the sharded step's), each op placed by
DTensor, the step's scalars plain tensors beside them.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Union

import torch

from ..distributed.sharding import is_dtensor

__all__ = [
    "Optimizer",
    "adamw",
    "sgdm",
    "adafactor",
    "global_norm",
    "clip_by_global_norm",
    "apply_updates",
    "cosine_schedule",
    "linear_warmup",
    "tree_leaves",
    "tree_map",
    "tree_paths",
    "tree_get",
    "tree_set",
]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Optimizer(NamedTuple):
    init: Callable         # params -> state
    update: Callable       # (grads, state, params, step) -> (updates, new_state)
    # (path, g, {key: state subtree at path}, p, ctx) -> (update, {key: new subtree}),
    # with ctx = prepare(step, params): the step's learning rate and corrections
    leaf_update: Callable
    prepare: Callable


# ---------------------------------------------------------------------------
# trees: nested dicts, leaves in sorted-key order (as jax.tree_util flattens)
# ---------------------------------------------------------------------------

def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def _lr_fn(lr) -> Callable:
    return lr if callable(lr) else (lambda _: lr)


def _step_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def cosine_schedule(base_lr: float, warmup: int, total: int, floor: float = 0.1):
    def lr(step):
        step = _step_f32(step)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)

    return lr


def linear_warmup(base_lr: float, warmup: int):
    return lambda step: base_lr * torch.clamp(_step_f32(step) / max(warmup, 1), max=1.0)


# ---------------------------------------------------------------------------
# norms, clipping, applying
# ---------------------------------------------------------------------------

def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in sorted-key order) of each leaf's
    float32 sum of squares.  Over DTensor leaves the sum is each rank's
    partial sum (``Partial``), reduced once to ``Replicate`` before the
    root, which is a plain tensor, the same on every rank."""
    total = sum(torch.sum(torch.square(g.to(torch.float32))) for g in tree_leaves(tree))
    if is_dtensor(total):
        from torch.distributed.tensor import Replicate

        total = total.redistribute(total.device_mesh,
                                   [Replicate()] * total.device_mesh.ndim).to_local()
    return torch.sqrt(total)


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), tree), norm


def apply_update(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return (p.to(torch.float32) + u.to(torch.float32)).to(p.dtype)


def apply_updates(params, updates):
    return tree_map(apply_update, params, updates)


def _tree_update(leaf_update, prepare):
    """``update(grads, state, params, step)`` from a per-leaf rule: the
    state is ``{key: tree}`` whose trees follow the params' paths (a leaf
    of the params may own a dict of the state, as adafactor's does)."""

    def update(grads, state, params, step):
        ctx = prepare(step, params)
        updates, new_state = {}, {key: {} for key in state}
        for path, g in tree_paths(grads):
            sub = {key: tree_get(state[key], path) for key in state}
            u, new = leaf_update(path, g, sub, tree_get(params, path), ctx)
            tree_set(updates, path, u)
            for key in state:
                tree_set(new_state[key], path, new[key])
        return updates, new_state

    return update


def tree_paths(tree, prefix=()):
    """``(path tuple, leaf)`` pairs in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def tree_set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def adamw(
    lr: Union[Callable, float],
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    moment_dtype: str = "float32",
    decay_mask: Optional[Callable] = None,   # params tree -> tree of bool
) -> Optimizer:
    mdt = _DTYPES[moment_dtype]
    lr_fn = _lr_fn(lr)

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=mdt)  # noqa: E731
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def prepare(step, params):
        t = _step_f32(step) + 1.0
        return {"bc1": 1.0 - b1 ** t, "bc2": 1.0 - b2 ** t, "lr": lr_fn(step),
                "mask": decay_mask(params) if decay_mask is not None else None}

    def leaf_update(path, g, s, p, ctx):
        g32 = g.to(torch.float32)
        m32 = b1 * s["m"].to(torch.float32) + (1 - b1) * g32
        v32 = b2 * s["v"].to(torch.float32) + (1 - b2) * g32 * g32
        use_wd = ctx["mask"] is None or bool(tree_get(ctx["mask"], path))
        wd = weight_decay if use_wd else 0.0
        u = -ctx["lr"] * ((m32 / ctx["bc1"]) / (torch.sqrt(v32 / ctx["bc2"]) + eps)
                          + wd * p.to(torch.float32))
        return u, {"m": m32.to(mdt), "v": v32.to(mdt)}

    return Optimizer(init, _tree_update(leaf_update, prepare), leaf_update, prepare)


def sgdm(lr: Union[Callable, float], momentum: float = 0.9) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"mom": tree_map(torch.zeros_like, params)}

    def prepare(step, params):
        return {"lr": lr_fn(step)}

    def leaf_update(path, g, s, p, ctx):
        m32 = momentum * s["mom"].to(torch.float32) + g.to(torch.float32)
        return -ctx["lr"] * m32, {"mom": m32.to(s["mom"].dtype)}

    return Optimizer(init, _tree_update(leaf_update, prepare), leaf_update, prepare)


def _outer(r: torch.Tensor, c: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``r[..., None] * c[..., None, :]``, the factored second moment made
    whole.  For DTensors it is made in ``like``'s placements: each rank
    multiplies the row means of its rows by the column means of its
    columns (DTensor's broadcasting rule would replicate the product, a
    whole param's worth of float32 on every rank)."""
    if not is_dtensor(like):
        return r[..., None] * c[..., None, :]
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    n = like.ndim
    pr, pc = [], []
    for p in like.placements:
        d = p.dim if isinstance(p, Shard) else None
        pr.append(Shard(d) if d is not None and d < n - 1 else Replicate())
        pc.append(Shard(d) if d is not None and d < n - 2
                  else Shard(n - 2) if d == n - 1 else Replicate())
    mesh = like.device_mesh
    return local_map(lambda a, b: a[..., None] * b[..., None, :],
                     out_placements=list(like.placements), in_placements=(pr, pc),
                     device_mesh=mesh)(r.redistribute(mesh, pr), c.redistribute(mesh, pc))


def adafactor(
    lr: Union[Callable, float],
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
) -> Optimizer:
    """Factored second moment: for a leaf of rank >= 2, row means ``r``
    (over the last axis) and column means ``c`` (over the second last)
    instead of a full tensor; else a full ``v``."""
    lr_fn = _lr_fn(lr)

    def init(params):
        def factored(p):
            if p.ndim >= 2:
                return {
                    "r": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                    "c": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                     device=p.device),
                }
            return {"v": torch.zeros_like(p, dtype=torch.float32)}

        return {"f": tree_map(factored, params)}

    def prepare(step, params):
        t = _step_f32(step) + 1.0
        return {"beta": 1.0 - t ** (-decay), "lr": lr_fn(step)}

    def leaf_update(path, g, s, p, ctx):
        beta = ctx["beta"]
        f = s["f"]
        g32 = g.to(torch.float32)
        sq = g32 * g32 + eps
        if "r" in f:
            r = beta * f["r"] + (1 - beta) * torch.mean(sq, dim=-1)
            c = beta * f["c"] + (1 - beta) * torch.mean(sq, dim=-2)
            denom = (_outer(r, c, g32)
                     / torch.clamp(torch.mean(r, dim=-1, keepdim=True)[..., None], min=eps))
            u = g32 * torch.rsqrt(torch.clamp(denom, min=eps))
            new = {"r": r, "c": c}
        else:
            v = beta * f["v"] + (1 - beta) * sq
            u = g32 * torch.rsqrt(torch.clamp(v, min=eps))
            new = {"v": v}
        rms = torch.sqrt(torch.mean(u * u))
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        return -ctx["lr"] * u, {"f": new}

    return Optimizer(init, _tree_update(leaf_update, prepare), leaf_update, prepare)
