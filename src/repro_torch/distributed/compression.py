"""Gradient compression: int8 quantization with error feedback.

At many-node scale the cross-node gradient reduce dominates step time
for data-parallel axes.  Error-feedback int8 (1-bit-Adam-family trick,
cf. Seide et al. 2014; Karimireddy et al. 2019) cuts that traffic 4x
versus f32 / 2x versus bf16 with negligible quality loss when the
quantization error is fed back into the next step.

Two entry points, as in the JAX package's ``distributed/compression.py``:

* :func:`compress_decompress` — quantize + dequantize each gradient
  *before* the all-reduce, so the collective moves int8-precision values;
  the error-feedback state threads through the train state (a nested
  dict of tensors).
* :func:`allreduce_int8` — the explicit compressed collective over a
  ``torch.distributed`` group: one all-reduce MAX of the scale, then one
  int32 SUM of the values requantized against the shared scale.

``torch.round`` rounds half to even, as ``jnp.round`` does, so every
result equals the JAX package's bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .world import all_reduce

__all__ = ["quantize_int8", "dequantize_int8", "compress_decompress", "allreduce_int8"]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns ``(q, scale)``, ``scale`` a
    float32 scalar tensor."""
    x32 = x.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(x32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def compress_decompress(grads, err_state: Optional[dict]):
    """Quantize -> dequantize each gradient leaf with error feedback.

    ``grads`` is a tensor or a nested dict of tensors; ``err_state`` the
    residuals of the same shape (``None`` on step 0).  Returns
    ``(dequantized, new_err_state)``.  DTensor leaves (the sharded
    step's) keep their placements: the scale is each leaf's global
    max |g|."""
    if err_state is None:
        err_state = _map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)

    def one(g, e):
        corrected = g.to(torch.float32) + e
        q, s = quantize_int8(corrected)
        deq = dequantize_int8(q, s)
        return deq, corrected - deq

    pairs = _map(one, grads, err_state)
    return _map(lambda p: p[0], pairs), _map(lambda p: p[1], pairs)


def allreduce_int8(x: torch.Tensor, group=None) -> torch.Tensor:
    """Compressed all-reduce over ``group``: each rank contributes int8
    values; the scales are reduced separately (max), and the values are
    requantized against the shared scale so the integer sum is exact.
    Without a group, quantize-dequantize of ``x``."""
    _, s = quantize_int8(x)
    s_max = all_reduce(s.reshape(1).clone(), "max", group)[0]
    q_shared = torch.clamp(
        torch.round(x.to(torch.float32) / s_max), -127, 127
    ).to(torch.int32)
    total = all_reduce(q_shared, "sum", group)
    return total.to(torch.float32) * s_max
