"""GQA flash-attention forward: the CUDA kernel K4, its wrapper and its
plain PyTorch version.

:func:`flash_attention` is the attention of the port's LM path
(:mod:`repro_torch.models.layers` re-exports it).  It computes what the
JAX package's ``layers._flash_impl`` computes, which is the Pallas
``kernels/flash_attention.py::_kernel`` extended by ``q_offset`` (the
absolute position of ``q[:, 0]``) and ``kv_length`` (the valid key prefix
of each batch row): prefill into a KV cache (``causal=True``) and decode
(``Tq == 1``, ``causal=False``) over a ragged key tail alike.

A CPU tensor runs :func:`flash_attention_plain`; a CUDA tensor launches K4
(``csrc/flash_attention.cu``) on the current stream or raises: there is no
fallback.  Every launch adds one to ``LAUNCHES['flash_attention']``; a
call of the plain version on a CUDA tensor (a comparison, never the
wrapper) adds one to ``PLAIN_CUDA_CALLS`` instead, so a run can show that
its attention went through the kernel.

Numbers: scores and softmax sums in float32, ``p`` rounded to the value
type before the P·V product, the output ``acc / max(l, 1e-20)`` cast to
``q.dtype``; a row whose every key is masked gives 0.  ``block_q`` and
``block_kv`` tile the plain version as they tile the reference; the
kernel uses its own tiles (64 query rows, 32 keys), which changes only
the order of float32 sums and where ``p`` is rounded.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

__all__ = [
    "LAUNCHES",
    "PLAIN_CUDA_CALLS",
    "reset_launch_counts",
    "flash_attention",
    "flash_attention_plain",
]

LAUNCHES: Dict[str, int] = {"flash_attention": 0}
# plain-version calls on CUDA tensors (comparisons only; the wrapper never
# makes one)
PLAIN_CUDA_CALLS: Dict[str, int] = {"flash_attention": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GROUP = 64      # query heads per kv head one block can hold
_MAX_HEAD_DIM = 128


def reset_launch_counts() -> None:
    LAUNCHES["flash_attention"] = 0
    PLAIN_CUDA_CALLS["flash_attention"] = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           kv_length: Optional[torch.Tensor]) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"q must be (B, Tq, H, D) and k, v (B, Tk, KV, D); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on B or D")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"H={H} not a multiple of KV={KV}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype: {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v must lie on one device: {q.device}, {k.device}, {v.device}")
    if kv_length is not None:
        if kv_length.shape != (B,) or kv_length.dtype not in (torch.int32, torch.int64):
            raise ValueError(
                f"kv_length must be an int (B,) tensor, got {kv_length.dtype} "
                f"{tuple(kv_length.shape)}"
            )
        if kv_length.device != q.device:
            raise ValueError(f"kv_length is on {kv_length.device}, q on {q.device}")


def flash_attention_plain(
    q: torch.Tensor,             # (B, Tq, H, D)
    k: torch.Tensor,             # (B, Tk, KV, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_length: Optional[torch.Tensor] = None,
    block_q: int = 512,
    block_kv: int = 1024,
) -> torch.Tensor:
    """Plain PyTorch K4: a port of the reference's ``_flash_impl`` (padded
    blocks, online softmax ``(acc, m, l)`` over key blocks in order)."""
    _check(q, k, v, kv_length)
    if q.is_cuda:
        PLAIN_CUDA_CALLS["flash_attention"] += 1
    B, Tq, H, D = q.shape
    _, Tk, KV, _ = k.shape
    G = H // KV
    bq = min(block_q, Tq)
    bkv = min(block_kv, Tk)
    pad_q = (-Tq) % bq
    pad_kv = (-Tk) % bkv
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_kv:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_kv))
    nq, nkv = (Tq + pad_q) // bq, (Tk + pad_kv) // bkv
    qg = q.reshape(B, nq, bq, KV, G, D)
    kg = k.reshape(B, nkv, bkv, KV, D)
    vg = v.reshape(B, nkv, bkv, KV, D)
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    kv_valid = (torch.full((B,), Tk, dtype=torch.int64, device=dev)
                if kv_length is None else kv_length.to(torch.int64))
    neg_inf = torch.tensor(float("-inf"), device=dev)
    blocks = []
    for qi in range(nq):
        qb = qg[:, qi].float()                                   # (B, bq, KV, G, D)
        q_pos = q_offset + qi * bq + torch.arange(bq, device=dev)
        acc = torch.zeros((B, bq, KV, G, D), dtype=torch.float32, device=dev)
        m = torch.full((B, bq, KV, G), float("-inf"), dtype=torch.float32, device=dev)
        l = torch.zeros((B, bq, KV, G), dtype=torch.float32, device=dev)
        for ki in range(nkv):
            kb = kg[:, ki].float()
            vb = vg[:, ki]
            s = torch.einsum("bqkgd,bskd->bqkgs", qb, kb) * scale
            kv_pos = ki * bkv + torch.arange(bkv, device=dev)
            mask = kv_pos[None, :] < kv_valid[:, None]            # (B, bkv)
            if causal:
                mask = mask[:, None, :] & (kv_pos[None, None, :] <= q_pos[None, :, None])
                s = torch.where(mask[:, :, None, None, :], s, neg_inf)
            else:
                s = torch.where(mask[:, None, None, None, :], s, neg_inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isneginf(s), 0.0, p)
            alpha = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqkgs,bskd->bqkgd", p.to(vb.dtype).float(), vb.float()
            )
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-20)
        blocks.append(out.to(q.dtype))
    out = torch.stack(blocks, dim=1).reshape(B, nq * bq, H, D)
    return out[:, :Tq]


def flash_attention(
    q: torch.Tensor,             # (B, Tq, H, D)
    k: torch.Tensor,             # (B, Tk, KV, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_length: Optional[torch.Tensor] = None,
    block_q: int = 512,
    block_kv: int = 1024,
) -> torch.Tensor:
    """Blockwise GQA attention, ``(B, Tq, H, D)`` in ``q.dtype``; never
    materializes ``(Tq, Tk)``.  Query head ``h`` reads kv head ``h // G``.

    ``q_offset``: absolute position of ``q[:, 0]`` (the cache length at
    prefill).  ``kv_length``: ``(B,)`` valid key prefix per batch row, or
    ``None`` for all ``Tk`` keys.  A CPU tensor runs
    :func:`flash_attention_plain`; a CUDA tensor (float32 or bfloat16,
    contiguous, ``D <= 128``, ``H / KV <= 64``) launches K4."""
    _check(q, k, v, kv_length)
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, q_offset=q_offset, kv_length=kv_length,
            block_q=block_q, block_kv=block_kv,
        )
    if q.device.type != "cuda":
        raise ValueError(f"q lies on {q.device}: only cpu and cuda are served")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"K4 takes float32 or bfloat16, got {q.dtype}")
    B, Tq, H, D = q.shape
    _, Tk, KV, _ = k.shape
    if D > _MAX_HEAD_DIM or H // KV > _MAX_GROUP:
        raise ValueError(
            f"K4 takes head_dim <= {_MAX_HEAD_DIM} and at most {_MAX_GROUP} query "
            f"heads per kv head, got D={D}, H/KV={H // KV}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lengths = None
    if kv_length is not None:
        lengths = kv_length.to(torch.int32).contiguous()
    from .build import load

    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = load("flash_attention").flash_attention_launch(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(o.data_ptr()),
        ctypes.c_void_p(lengths.data_ptr() if lengths is not None else 0),
        B, Tq, Tk, H, KV, D, int(q_offset), int(bool(causal)),
        _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(D), q.device.index or 0,
        ctypes.c_void_p(stream),
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    LAUNCHES["flash_attention"] += 1
    return o
