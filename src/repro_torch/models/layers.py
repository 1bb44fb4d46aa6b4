"""Neural building blocks of the port's models.

Ports of the JAX package's ``models/layers.py``, with its rounding points:
``rms_norm`` and ``layer_norm`` normalize in float32, cast to the input
dtype and then apply the weight (and bias) in that dtype; ``rope``
rotates in float32 (a bf16 input times float32 cos/sin promotes, as in
JAX) and casts once; ``mlp_apply`` casts each weight to the activation's
dtype at use.  :func:`flash_attention` is the K4 wrapper of
:mod:`repro_torch.kernels.flash_attention`, whose training route
(:class:`~repro_torch.kernels.flash_attention.FlashAttentionFn`) carries
the reference's custom backward.  :func:`embedding_bag` is gather +
segment reduce; its sums go through ``index_add_``, which on the card
adds in no fixed order (atomics), so a sum's last bits may change from
run to run there.  :func:`remat` is the reference's ``jax.checkpoint``
under its two policies.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional, Sequence

import torch

from ..distributed.sharding import is_dtensor
from ..kernels.flash_attention import flash_attention

__all__ = [
    "dense_init",
    "rms_norm",
    "layer_norm",
    "gelu",
    "mlp_init",
    "mlp_apply",
    "rope",
    "flash_attention",
    "embedding_bag",
    "remat",
]


def dense_init(
    generator: torch.Generator,
    in_dim: int,
    out_dim: int,
    dtype: torch.dtype = torch.float32,
    scale: Optional[float] = None,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """``N(0, 1) * scale`` weights ``(in_dim, out_dim)`` drawn in float32
    from ``generator`` (on ``device``, which must be the generator's), then
    cast to ``dtype``; ``scale`` defaults to ``1 / sqrt(in_dim)``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=generator, device=device)
    return (w * scale).to(dtype)


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """RMS norm in float32, cast to ``dtype`` (default ``x.dtype``), then
    times ``weight`` in that dtype."""
    dtype = dtype or x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dtype) * weight.to(dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Layer norm with float32 statistics (population variance), cast to
    ``x.dtype``, then times ``weight`` plus ``bias`` in that dtype."""
    dtype = x.dtype
    x32 = x.float()
    centered = x32 - torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(centered * centered, dim=-1, keepdim=True)
    y = centered * torch.rsqrt(var + eps)
    return y.to(dtype) * weight.to(dtype) + bias.to(dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def mlp_init(
    generator: torch.Generator,
    dims: Sequence[int],
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> Dict[str, torch.Tensor]:
    """Plain MLP parameter stack for ``dims = [in, hidden..., out]``:
    ``w{i}`` from :func:`dense_init`, ``b{i}`` zeros."""
    params = {f"w{i}": dense_init(generator, dims[i], dims[i + 1], dtype, device=device)
              for i in range(len(dims) - 1)}
    params.update({f"b{i}": torch.zeros((dims[i + 1],), dtype=dtype, device=device)
                   for i in range(len(dims) - 1)})
    return params


def mlp_apply(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    activation: Callable[[torch.Tensor], torch.Tensor] = gelu,
    final_activation: bool = False,
) -> torch.Tensor:
    n = sum(1 for k in params if k.startswith("w"))
    for i in range(n):
        x = x @ params[f"w{i}"].to(x.dtype) + params[f"b{i}"].to(x.dtype)
        if i < n - 1 or final_activation:
            x = activation(x)
    return x


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, llama split-half convention.

    x: ``(..., T, n_heads, head_dim)``; positions: broadcastable to
    ``(..., T)``.  For a DTensor ``x`` the tables are replicated DTensors
    on its mesh (every rank computes them whole)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    angles = positions[..., :, None].to(torch.float32) * freqs    # (..., T, half)
    cos = torch.cos(angles)[..., :, None, :]                       # (..., T, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    if is_dtensor(x):
        from torch.distributed.tensor import DTensor, Replicate

        rep = [Replicate()] * x.device_mesh.ndim
        cos, sin = (DTensor.from_local(t, x.device_mesh, rep, run_check=False)
                    for t in (cos, sin))
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def embedding_bag(
    table: torch.Tensor,         # (n_items, d)
    indices: torch.Tensor,       # (n_lookups,)
    segment_ids: torch.Tensor,   # (n_lookups,) -> bag id
    num_bags: int,
    mode: str = "sum",
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gather + segment reduce (``sum``, ``mean`` or ``max``; an empty bag
    is 0), as the reference's ``embedding_bag``."""
    rows = table[indices]
    if weights is not None:
        rows = rows * weights[:, None].to(rows.dtype)
    d = rows.shape[1:]
    if mode in ("sum", "mean"):
        s = torch.zeros((num_bags, *d), dtype=rows.dtype, device=rows.device)
        s.index_add_(0, segment_ids, rows)
        if mode == "sum":
            return s
        n = torch.zeros((num_bags,), dtype=rows.dtype, device=rows.device)
        n.index_add_(0, segment_ids, torch.ones_like(segment_ids, dtype=rows.dtype))
        return s / torch.clamp(n, min=1.0)[:, None]
    if mode == "max":
        out = torch.full((num_bags, *d), float("-inf"), dtype=rows.dtype, device=rows.device)
        idx = segment_ids.reshape(-1, *([1] * len(d))).expand_as(rows)
        out = out.scatter_reduce(0, idx, rows, reduce="amax")
        return torch.where(torch.isneginf(out), 0.0, out)
    raise ValueError(mode)


# jax.checkpoint_policies.dots_with_no_batch_dims_saveable: the outputs of
# matmuls without batch dims (bmm has one, and is recomputed)
_SAVED_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _save_matmuls():
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return create_selective_checkpoint_contexts(policy)


@contextlib.contextmanager
def _entered(*managers):
    with contextlib.ExitStack() as stack:
        for m in managers:
            stack.enter_context(m)
        yield


def remat(fn: Callable, *args, save_matmuls: bool):
    """``fn(*args)`` recomputed in the backward (non-reentrant
    ``torch.utils.checkpoint``).  ``save_matmuls`` keeps the outputs of
    ``mm`` / ``addmm`` (the reference's ``dots_with_no_batch_dims_saveable``
    policy) and recomputes the rest; otherwise only the inputs are kept
    (``nothing_saveable``).  The recompute runs under the caller's mesh
    and rules (``use_mesh_rules`` is thread-local, and the card's backward
    runs on autograd's own thread)."""
    import torch.utils.checkpoint

    from ..distributed.sharding import _ctx, use_mesh_rules

    mesh, rules = _ctx()

    def context_fn():
        fwd, rec = (_save_matmuls() if save_matmuls
                    else (contextlib.nullcontext(), contextlib.nullcontext()))
        return fwd, _entered(rec, use_mesh_rules(mesh, rules))

    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             context_fn=context_fn)
