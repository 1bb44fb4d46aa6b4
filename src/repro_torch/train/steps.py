"""Train and serve steps for the LM, GNN and SASRec families.

A port of the JAX package's ``train/steps.py``.  A train step::

    state = {"params": ..., "opt": ..., "step": int32 tensor}
    state, metrics = step(state, batch)

Features, as in the reference: microbatch gradient accumulation
(``microbatches``: the batch split into ``B / mb`` slices along its first
axis, gradients summed in ``accum_dtype`` and divided once, the loss
averaged, the metrics of the last microbatch), optional int8
error-feedback gradient compression (:mod:`repro_torch.distributed.compression`,
its residuals under ``state["grad_err"]``), global-norm clipping, then the
optimizer.

Unlike the reference's pure step, the port's step updates ``state`` in
place and returns it: gradients, then params and optimizer state, are
replaced one leaf at a time, so that at glm4-9b's width the step holds
params, moments and one gradient tree plus one leaf's transients, not two
copies of the state.  The arithmetic is the reference's (the same float32
operations in the same order per leaf).  Gradients come from
``torch.autograd.grad`` on a detached, grad-requiring view of each param;
nothing is traced or compiled.  ``param_axes`` (a tree of logical axes,
``transformer.logical_axes(cfg)`` for the LM step) places each
microbatch's gradients with
:func:`~repro_torch.distributed.sharding.shard` where the reference
constrains them: a no-op outside a mesh context and on a one-device mesh.

The same step runs sharded when the state and the batch are DTensors
(:func:`~repro_torch.distributed.sharding.distribute_state`, the batch
placed by ``batch_placements``) under ``use_mesh_rules``: each gradient
is redistributed to its param's placements (the reduce over ``"data"``:
an all-reduce for a replicated leaf, a reduce-scatter for an FSDP one),
then compressed, clipped by a global norm summed over the ranks, and
applied leaf by leaf, each new leaf kept in its old placements.
Microbatch ``i`` holds the reference's global rows ``[i B / mb, (i + 1)
B / mb)``, whichever rank holds them.  The returned metrics are plain
tensors, the same on every rank.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.profiler

from ..configs.base import GNNConfig, RecsysConfig, TransformerConfig
from ..distributed import compression
from ..distributed.sharding import is_dtensor, shard
from ..models import gnn, sasrec, transformer
from .optimizer import (Optimizer, apply_update, clip_scale, global_norm, tree_get, tree_paths,
                        tree_set)

__all__ = [
    "init_train_state",
    "make_grad_fn",
    "make_update_fn",
    "lm_loss",
    "build_lm_train_step",
    "build_lm_prefill_step",
    "build_lm_decode_step",
    "gnn_loss",
    "build_gnn_train_step",
    "build_gnn_infer_step",
    "sasrec_loss",
    "build_sasrec_train_step",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def init_train_state(params, optimizer: Optimizer) -> Dict:
    first = next(leaf for _, leaf in tree_paths(params))
    return {
        "params": params,
        "opt": optimizer.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def _split(batch, microbatches: int, i: int):
    """Microbatch ``i`` of ``batch``: each tensor's first axis cut into
    ``microbatches`` equal slices (a GNN batch's graph is shared).  A
    DTensor's slice is cut from its global rows and placed as the batch
    was (:func:`_gathered` gathers the rows once per step)."""
    if isinstance(batch, dict):
        return {k: _split(v, microbatches, i) for k, v in batch.items()}
    if isinstance(batch, tuple):                # (global rows, mesh, placements)
        from torch.distributed.tensor import distribute_tensor

        full, mesh, placements = batch
        n = full.shape[0] // microbatches
        return distribute_tensor(full[i * n:(i + 1) * n], mesh, placements,
                                 src_data_rank=None)
    if not isinstance(batch, torch.Tensor):
        return batch
    n = batch.shape[0] // microbatches
    return batch[i * n:(i + 1) * n]


def _gathered(batch):
    """``batch`` with each DTensor replaced by ``(its global rows, mesh,
    placements)`` for :func:`_split`."""
    if isinstance(batch, dict):
        return {k: _gathered(v) for k, v in batch.items()}
    if is_dtensor(batch):
        return batch.full_tensor(), batch.device_mesh, batch.placements
    return batch


def _placed_like(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``new`` in ``old``'s placements where ``old`` is a DTensor."""
    if is_dtensor(old) and tuple(new.placements) != tuple(old.placements):
        return new.redistribute(old.device_mesh, old.placements)
    return new


def _plain(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if is_dtensor(t) else t


def make_grad_fn(
    loss_fn: Callable,                  # (params, batch) -> (loss, metrics)
    microbatches: int = 1,
    accum_dtype: Optional[torch.dtype] = None,
    param_axes=None,
) -> Callable:
    """``fn(params, batch) -> (loss, metrics, grads)``: the reference's
    ``value_and_grad`` with its microbatch accumulation (gradients summed
    in ``accum_dtype``, default float32, then divided once; the loss
    averaged; the last microbatch's metrics), each microbatch's gradients
    placed by ``param_axes`` where given."""

    def grads_of(params, batch):
        paths = list(tree_paths(params))
        leaves = [p.detach().requires_grad_() for _, p in paths]
        tree: Dict = {}
        for (path, _), leaf in zip(paths, leaves):
            tree_set(tree, path, leaf)
        with torch.enable_grad():
            loss, metrics = loss_fn(tree, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        out: Dict = {}
        for (path, p), g in zip(paths, grads):
            g = torch.zeros_like(p) if g is None else g
            if param_axes is not None:
                g = shard(g, *tree_get(param_axes, path))
            tree_set(out, path, _placed_like(g, p))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, out

    def fn(params, batch):
        if microbatches == 1:
            return grads_of(params, batch)
        adt = accum_dtype or torch.float32
        grads, loss = None, 0.0
        batch = _gathered(batch)
        for i in range(microbatches):
            l, metrics, g = grads_of(params, _split(batch, microbatches, i))
            if grads is None:
                grads = {}
                for path, leaf in tree_paths(g):
                    tree_set(grads, path, torch.zeros_like(leaf, dtype=adt))
            for path, leaf in tree_paths(g):
                tree_get(grads, path).add_(leaf.to(adt))
            del g
            loss = loss + l
        for path, leaf in tree_paths(grads):
            tree_set(grads, path, leaf / microbatches)
        return loss / microbatches, metrics, grads

    return fn


def make_update_fn(
    loss_fn: Callable,                  # (params, batch) -> (loss, metrics)
    optimizer: Optimizer,
    clip_norm: float = 1.0,
    microbatches: int = 1,
    compress_grads: bool = False,
    accum_dtype: Optional[torch.dtype] = None,
    param_axes=None,
) -> Callable:
    grad_fn = make_grad_fn(loss_fn, microbatches, accum_dtype, param_axes)

    def step(state, batch):
        params = state["params"]
        loss, metrics, grads = grad_fn(params, batch)
        if compress_grads:
            grads, state["grad_err"] = compression.compress_decompress(
                grads, state.get("grad_err"))
        with torch.profiler.record_function("repro_torch.optimizer_update"):
            gnorm = global_norm(grads)
            scale = clip_scale(gnorm, clip_norm)
            opt = state["opt"]
            ctx = optimizer.prepare(state["step"], params)
            for path, g in tree_paths(grads):
                g = g * scale.to(g.dtype)
                sub = {key: tree_get(opt[key], path) for key in opt}
                p = tree_get(params, path)
                u, new = optimizer.leaf_update(path, g, sub, p, ctx)
                tree_set(params, path, _placed_like(apply_update(p, u), p))
                for key in opt:
                    for sub_path, leaf in tree_paths(new[key]):
                        tree_set(opt[key], path + sub_path,
                                 _placed_like(leaf, tree_get(sub[key], sub_path)))
                tree_set(grads, path, None)
                del g, u, new, sub, p
        state["step"] = state["step"] + 1
        metrics = {k: _plain(v) for k, v in metrics.items()}
        metrics.update({"loss": _plain(loss), "grad_norm": gnorm})
        return state, metrics

    return step


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------

def lm_loss(params, batch: Dict, cfg: TransformerConfig):
    logits, _, aux = transformer.forward(params, batch["tokens"], cfg)
    labels = batch["labels"]
    mask = (labels >= 0).to(torch.float32)
    labels_safe = torch.clamp(labels, min=0).to(torch.int64)
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels_safe[..., None])[..., 0]
    ce = -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    loss = ce + aux
    return loss, {"ce": ce, "aux": aux}


def build_lm_train_step(
    cfg: TransformerConfig,
    optimizer: Optimizer,
    clip_norm: float = 1.0,
    compress_grads: bool = False,
) -> Callable:
    return make_update_fn(
        lambda p, b: lm_loss(p, b, cfg),
        optimizer,
        clip_norm=clip_norm,
        microbatches=cfg.microbatches,
        compress_grads=compress_grads,
        accum_dtype=_DTYPES[cfg.grad_accum_dtype],
        param_axes=transformer.logical_axes(cfg),
    )


def build_lm_prefill_step(cfg: TransformerConfig, max_len: int) -> Callable:
    def prefill(params, tokens):
        cache = transformer.init_cache(cfg, tokens.shape[0], max_len, tokens.device)
        logits, cache, _ = transformer.forward(params, tokens, cfg, cache)
        return logits[:, -1], cache

    return prefill


def build_lm_decode_step(cfg: TransformerConfig) -> Callable:
    def decode(params, cache, token):
        logits, cache, _ = transformer.forward(params, token, cfg, cache)
        return logits[:, -1], cache

    return decode


# ---------------------------------------------------------------------------
# GNN
# ---------------------------------------------------------------------------

def gnn_loss(params, batch: Dict, cfg: GNNConfig):
    g = batch["graph"]
    out = gnn.forward(params, g, cfg)
    target = batch["target"]
    if target.dtype in (torch.int32, torch.int64):  # node classification
        logp = torch.log_softmax(out.float(), dim=-1)
        mask = (target >= 0).to(torch.float32)
        ll = torch.gather(logp, -1, torch.clamp(target, min=0).long()[..., None])[..., 0]
        loss = -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    else:  # regression
        err = (out.float() - target.float()) ** 2
        if out.ndim == 2 and g.graph_ids is None:
            err = err * g.node_mask[:, None].to(torch.float32)
            loss = torch.sum(err) / torch.clamp(torch.sum(g.node_mask), min=1.0)
        else:
            loss = torch.mean(err)
    return loss, {"mse_or_ce": loss}


def build_gnn_train_step(
    cfg: GNNConfig, optimizer: Optimizer, clip_norm: float = 1.0
) -> Callable:
    return make_update_fn(lambda p, b: gnn_loss(p, b, cfg), optimizer, clip_norm=clip_norm)


def build_gnn_infer_step(cfg: GNNConfig) -> Callable:
    def infer(params, graph):
        return gnn.forward(params, graph, cfg)

    return infer


# ---------------------------------------------------------------------------
# SASRec
# ---------------------------------------------------------------------------

def sasrec_loss(params, batch: Dict, cfg: RecsysConfig):
    loss = sasrec.train_loss(params, batch["seqs"], batch["pos"], batch["neg"], cfg)
    return loss, {"bce": loss}


def build_sasrec_train_step(
    cfg: RecsysConfig, optimizer: Optimizer, clip_norm: float = 1.0
) -> Callable:
    return make_update_fn(lambda p, b: sasrec_loss(p, b, cfg), optimizer, clip_norm=clip_norm)
