"""Neural building blocks of the LM serving path.

Ports of the JAX package's ``models/layers.py``, with its rounding points:
``rms_norm`` normalizes in float32, casts to the input dtype and then
multiplies by the weight in that dtype; ``rope`` rotates in float32 (a
bf16 input times float32 cos/sin promotes, as in JAX) and casts once.
:func:`flash_attention` is the K4 wrapper of
:mod:`repro_torch.kernels.flash_attention`.  ``layer_norm``, ``mlp_*``,
``embedding_bag`` and the training path's custom backward wait for the
slices that run them (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels.flash_attention import flash_attention

__all__ = ["dense_init", "rms_norm", "rope", "flash_attention"]


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


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, llama split-half convention.

    x: ``(..., T, n_heads, head_dim)``; positions: broadcastable to
    ``(..., T)``."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    angles = positions[..., :, None].to(torch.float32) * freqs    # (..., T, half)
    cos = torch.cos(angles)[..., :, None, :]                       # (..., T, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)
