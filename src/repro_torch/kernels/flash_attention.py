"""GQA flash-attention forward: the CUDA kernels of K4, their wrapper and
their plain PyTorch versions.

:func:`flash_attention` is the attention of the port's LM path
(:mod:`repro_torch.models.layers` re-exports it).  It computes what the
JAX package's ``layers._flash_impl`` computes, which is the Pallas
``kernels/flash_attention.py::_kernel`` extended by ``q_offset`` (the
absolute position of ``q[:, 0]``) and ``kv_length`` (the valid key prefix
of each batch row): prefill into a KV cache (``causal=True``) and decode
(``Tq == 1``, ``causal=False``) over a ragged key tail alike.

A CPU tensor runs :func:`flash_attention_plain`.  A CUDA tensor launches
one of K4's kernels on the current stream, chosen by dtype and shape, or
raises: there is no fallback.

========================  ==============================================
bfloat16, ``Tq > 1``      ``csrc/flash_prefill.cu``: mma.sync tensor
                          cores, 128 query rows (the G heads of a kv
                          head at 128 / G positions) x 64-key tiles
bfloat16, ``Tq == 1``     ``csrc/flash_decode.cu``: split-KV partials
                          over key ranges of whole 64-key tiles
                          (:func:`decode_split`), then a combine kernel
float32, any shape        ``csrc/flash_attention.cu``: CUDA-core fp32
                          (TF32 tensor cores cannot hold 2e-5)
========================  ==============================================

Training (no cache: ``q_offset == 0``, ``kv_length is None``, and some
of ``q``, ``k``, ``v`` requiring grad, under grad mode) goes through
:class:`FlashAttentionFn`, the counterpart of the reference's custom-VJP
``layers._flash_train``: its forward launches the same kernels with a
log-sum-exp output (``lse``, natural log, ``+inf`` on a row whose every
key is masked), and its backward is the reference's
``_flash_train_bwd`` in plain PyTorch (:func:`flash_attention_backward_plain`,
which recomputes ``p`` block by block from ``lse``; the reference's
backward is XLA code, not a Pallas kernel).  A call with a cache that
requires grad raises: no call goes through a kernel without autograd.

``LAUNCHES['flash_attention']`` counts wrapper calls on the card, one
per attention call; ``flash_attention_prefill``, ``_decode``,
``_combine`` and ``_f32`` count each kernel's launches, and
``_prefill_lse`` / ``_f32_lse`` the launches that also write ``lse``
(training's forward).  A call of a plain forward on a CUDA tensor (a
comparison, never the wrapper) adds one to
``PLAIN_CUDA_CALLS['flash_attention']`` instead, so a run can show that
its attention went through the kernels; each plain backward on the card
adds one to ``PLAIN_CUDA_CALLS['flash_attention_backward']``.

Numbers: scores and softmax sums in float32, ``p`` rounded to the value
type before the P·V product, the output ``acc / max(l, 1e-20)`` cast to
``q.dtype``; a row whose every key is masked gives 0.  ``block_q`` and
``block_kv`` tile the plain version as they tile the reference; the
kernels use their own tiles (64 keys in bf16, 32 in float32), which
changes only the order of float32 sums and where ``p`` is rounded.
:func:`flash_attention_split_plain` is the decode kernel's arithmetic in
plain PyTorch (``p`` rounded against each split's running max), for the
tests and the smoke run; the main path never calls it.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.profiler

from ..distributed.sharding import is_dtensor

__all__ = [
    "LAUNCHES",
    "PLAIN_CUDA_CALLS",
    "reset_launch_counts",
    "decode_split",
    "FlashAttentionFn",
    "flash_attention",
    "flash_attention_plain",
    "flash_attention_backward_plain",
    "flash_attention_split_plain",
    "sharded_flash_attention",
]

# wrapper calls on the card, then each kernel's launches
LAUNCHES: Dict[str, int] = {
    "flash_attention": 0,
    "flash_attention_prefill": 0,
    "flash_attention_decode": 0,
    "flash_attention_combine": 0,
    "flash_attention_f32": 0,
    "flash_attention_prefill_lse": 0,
    "flash_attention_f32_lse": 0,
}
# plain forwards on CUDA tensors (comparisons only; the wrapper never makes
# one), and plain backwards on CUDA tensors (every training step's)
PLAIN_CUDA_CALLS: Dict[str, int] = {"flash_attention": 0, "flash_attention_backward": 0}

_MAX_GROUP = 64      # query heads per kv head
_MAX_HEAD_DIM = 128
_TILE = 64           # keys per tile of the bf16 kernels
_DECODE_ROWS = 16    # query heads per block of the decode kernel
_LOG2E = 1.4426950408889634


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CUDA_CALLS):
        for key in counts:
            counts[key] = 0


def decode_split(Tk: int, pairs: int, n_sm: int = 132) -> Tuple[int, int]:
    """``(n_split, split_keys)`` of the split-KV decode kernel over a cache
    of ``Tk`` positions, for ``pairs`` blocks per key range (batch rows x kv
    heads x 16-head chunks).  Key ranges are whole 64-key tiles, as few as
    give ``n_split * pairs >= 2 * n_sm`` (two blocks per SM) where the
    cache has that many tiles.  From the cache's static length, never from
    ``kv_length``: that would need a device sync."""
    tiles = max(1, -(-Tk // _TILE))
    need = -(-2 * n_sm // max(1, pairs))
    per_split = max(1, tiles // need)
    return -(-tiles // per_split), _TILE * per_split


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _partials(qb, q_pos, k, v, kv_valid, causal, scale, start, stop, block):
    """Online-softmax state ``(acc, m, l)`` of the query block ``qb``
    (float, ``(B, bq, KV, G, D)``) at positions ``q_pos`` over keys
    ``[start, stop)`` of ``k``, ``v`` in blocks of ``block``, in order, as
    the reference's ``_flash_impl`` walks its key blocks."""
    B, bq, KV, G, D = qb.shape
    dev = qb.device
    neg_inf = torch.tensor(float("-inf"), device=dev)
    acc = torch.zeros((B, bq, KV, G, D), dtype=torch.float32, device=dev)
    m = torch.full((B, bq, KV, G), float("-inf"), dtype=torch.float32, device=dev)
    l = torch.zeros((B, bq, KV, G), dtype=torch.float32, device=dev)
    for k0 in range(start, stop, block):
        kb = k[:, k0:k0 + block].float()
        vb = v[:, k0:k0 + block]
        s = torch.einsum("bqkgd,bskd->bqkgs", qb, kb) * scale
        kv_pos = k0 + torch.arange(block, device=dev)
        mask = kv_pos[None, :] < kv_valid[:, None]                # (B, block)
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
    return acc, m, l


def _pad_keys(k: torch.Tensor, v: torch.Tensor, multiple: int):
    pad = (-k.shape[1]) % multiple
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    return k, v


def _kv_valid(kv_length: Optional[torch.Tensor], B: int, Tk: int, dev) -> torch.Tensor:
    if kv_length is None:
        return torch.full((B,), Tk, dtype=torch.int64, device=dev)
    return kv_length.to(torch.int64)


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
    return_lse: bool = False,
):
    """Plain PyTorch K4: a port of the reference's ``_flash_impl`` (padded
    blocks, online softmax ``(acc, m, l)`` over key blocks in order).
    With ``return_lse``, also each row's log-sum-exp ``m + log(l)``,
    float32 ``(B, Tq, H)``, ``+inf`` where every key is masked."""
    _check(q, k, v, kv_length)
    if q.is_cuda:
        PLAIN_CUDA_CALLS["flash_attention"] += 1
    B, Tq, H, D = q.shape
    _, Tk, KV, _ = k.shape
    G = H // KV
    bq = min(block_q, Tq)
    bkv = min(block_kv, Tk)
    pad_q = (-Tq) % bq
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    k, v = _pad_keys(k, v, bkv)
    nq = (Tq + pad_q) // bq
    qg = q.reshape(B, nq, bq, KV, G, D)
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    kv_valid = _kv_valid(kv_length, B, Tk, dev)
    blocks, lses = [], []
    for qi in range(nq):
        q_pos = q_offset + qi * bq + torch.arange(bq, device=dev)
        acc, m, l = _partials(qg[:, qi].float(), q_pos, k, v, kv_valid, causal, scale,
                              0, k.shape[1], bkv)
        out = acc / torch.clamp(l[..., None], min=1e-20)
        blocks.append(out.to(q.dtype))
        if return_lse:
            lses.append(torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                                    float("inf")))
    out = torch.stack(blocks, dim=1).reshape(B, nq * bq, H, D)[:, :Tq]
    if not return_lse:
        return out
    return out, torch.stack(lses, dim=1).reshape(B, nq * bq, H)[:, :Tq]


def flash_attention_backward_plain(
    q: torch.Tensor,             # (B, Tq, H, D)
    k: torch.Tensor,             # (B, Tk, KV, D)
    v: torch.Tensor,
    out: torch.Tensor,           # (B, Tq, H, D), the forward's output
    lse: torch.Tensor,           # (B, Tq, H) float32, the forward's log-sum-exp
    do: torch.Tensor,            # (B, Tq, H, D), the output's gradient
    *,
    causal: bool = True,
    block_q: int = 512,
    block_kv: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of attention without a cache: a port of the
    reference's ``_flash_train_bwd``.  ``p`` is recomputed per
    ``(block_q, block_kv)`` block from ``lse`` (nothing quadratic is
    saved), ``delta = rowsum(do * out)``, everything in float32 over the
    reference's padding, and the gradients cast to the inputs' dtypes.
    Under ``causal``, a key block that starts past the query block's last
    position is skipped: the reference adds exact zeros there."""
    if q.is_cuda:
        PLAIN_CUDA_CALLS["flash_attention_backward"] += 1
    B, Tq, H, D = q.shape
    _, Tk, KV, _ = k.shape
    G = H // KV
    bq = min(block_q, Tq)
    bkv = min(block_kv, Tk)
    pad_q = (-Tq) % bq
    dev = q.device

    def pad_rows(t, value=0.0):
        return F.pad(t, (0, 0, 0, 0, 0, pad_q), value=value) if pad_q else t

    nq = (Tq + pad_q) // bq
    qg = pad_rows(q).reshape(B, nq, bq, KV, G, D)
    dog = pad_rows(do).reshape(B, nq, bq, KV, G, D)
    outg = pad_rows(out).reshape(B, nq, bq, KV, G, D)
    lseg = pad_rows(lse.reshape(B, Tq, KV, G), float("inf")).reshape(B, nq, bq, KV, G)
    kp, vp = _pad_keys(k, v, bkv)
    Tk_p = kp.shape[1]
    scale = 1.0 / math.sqrt(D)
    dq = torch.empty((B, nq, bq, KV, G, D), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, Tk_p, KV, D), dtype=torch.float32, device=dev)
    dv = torch.zeros((B, Tk_p, KV, D), dtype=torch.float32, device=dev)
    for qi in range(nq):
        qb = qg[:, qi].float()
        dob = dog[:, qi].float()
        lseb = lseg[:, qi]
        deltab = (dob * outg[:, qi].float()).sum(dim=-1)
        q_pos = qi * bq + torch.arange(bq, device=dev)
        dqb = torch.zeros((B, bq, KV, G, D), dtype=torch.float32, device=dev)
        for k0 in range(0, Tk_p, bkv):
            if causal and k0 > qi * bq + bq - 1:
                break
            kb = kp[:, k0:k0 + bkv].float()
            vb = vp[:, k0:k0 + bkv].float()
            s = torch.einsum("bqkgd,bskd->bqkgs", qb, kb) * scale
            kv_pos = k0 + torch.arange(bkv, device=dev)
            mask = (kv_pos < Tk)[None, :]                         # padding keys
            if causal:
                mask = mask & (kv_pos[None, :] <= q_pos[:, None])  # (bq, bkv)
            s = torch.where(mask[None, :, None, None, :], s, float("-inf"))
            p = torch.exp(s - lseb[..., None])        # rows with lse = inf give 0
            p = torch.where(torch.isneginf(s), 0.0, p)
            dp = torch.einsum("bqkgd,bskd->bqkgs", dob, vb)
            ds = p * (dp - deltab[..., None])
            dqb = dqb + scale * torch.einsum("bqkgs,bskd->bqkgd", ds, kb)
            dk[:, k0:k0 + bkv] += scale * torch.einsum("bqkgs,bqkgd->bskd", ds, qb)
            dv[:, k0:k0 + bkv] += torch.einsum("bqkgs,bqkgd->bskd", p, dob)
        dq[:, qi] = dqb
    dq = dq.reshape(B, nq * bq, H, D)[:, :Tq].to(q.dtype)
    return dq, dk[:, :Tk].to(k.dtype), dv[:, :Tk].to(v.dtype)


def flash_attention_split_plain(
    q: torch.Tensor,             # (B, Tq, H, D)
    k: torch.Tensor,             # (B, Tk, KV, D)
    v: torch.Tensor,
    *,
    causal: bool = False,
    q_offset: int = 0,
    kv_length: Optional[torch.Tensor] = None,
    split_keys: Optional[int] = None,
) -> torch.Tensor:
    """The split-KV decode kernel's arithmetic in plain PyTorch: the
    partial ``(acc_s, m_s, l_s)`` of each key range ``[s * split_keys,
    (s + 1) * split_keys)`` in 64-key tiles, then the combine
    ``sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-20)`` with
    ``M = max_s m_s``, cast once.  ``split_keys`` (a multiple of 64)
    defaults to :func:`decode_split`'s on an H100.  For tests and the
    smoke run; the main path never calls it."""
    _check(q, k, v, kv_length)
    if q.is_cuda:
        PLAIN_CUDA_CALLS["flash_attention"] += 1
    B, Tq, H, D = q.shape
    _, Tk, KV, _ = k.shape
    G = H // KV
    if split_keys is None:
        _, split_keys = decode_split(Tk, B * KV * -(-G // _DECODE_ROWS))
    if split_keys <= 0 or split_keys % _TILE:
        raise ValueError(f"split_keys must be a positive multiple of {_TILE}, got {split_keys}")
    k, v = _pad_keys(k, v, split_keys)
    qb = q.reshape(B, Tq, KV, G, D).float()
    q_pos = q_offset + torch.arange(Tq, device=q.device)
    kv_valid = _kv_valid(kv_length, B, Tk, q.device)
    scale = 1.0 / math.sqrt(D)
    parts = [_partials(qb, q_pos, k, v, kv_valid, causal, scale, s0, s0 + split_keys, _TILE)
             for s0 in range(0, k.shape[1], split_keys)]
    acc, m, l = (torch.stack(t) for t in zip(*parts))
    top = m.amax(dim=0)
    top = torch.where(torch.isneginf(top), 0.0, top)
    w = torch.where(torch.isneginf(m), 0.0, torch.exp(m - top))
    num = (w[..., None] * acc).sum(dim=0)
    den = (w * l).sum(dim=0)
    out = num / torch.clamp(den[..., None], min=1e-20)
    return out.to(q.dtype).reshape(B, Tq, H, D)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, q_offset: int,
            kv_length: Optional[torch.Tensor], with_lse: bool):
    """Launch the K4 kernel that ``q``'s dtype and shape select, on the
    current stream; returns ``(out, lse or None)``.  ``with_lse`` (the
    training forward) also writes the float32 ``(B, Tq, H)`` log-sum-exp,
    through the prefill kernel in bf16 whatever ``Tq``."""
    if q.device.type != "cuda":
        raise ValueError(f"q lies on {q.device}: only cpu and cuda are served")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K4 takes float32 or bfloat16, got {q.dtype}")
    B, Tq, H, D = q.shape
    _, Tk, KV, _ = k.shape
    G = H // KV
    if D > _MAX_HEAD_DIM or G > _MAX_GROUP:
        raise ValueError(
            f"K4 takes head_dim <= {_MAX_HEAD_DIM} and at most {_MAX_GROUP} query "
            f"heads per kv head, got D={D}, H/KV={G}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lengths = None
    if kv_length is not None:
        lengths = kv_length.to(torch.int32).contiguous()
    from .build import load

    def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
        return ctypes.c_void_p(t.data_ptr() if t is not None else 0)

    def check(rc: int, kernel: str) -> None:
        if rc != 0:
            raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")
        LAUNCHES[kernel] += 1

    o = torch.empty_like(q)
    lse = (torch.empty((B, Tq, H), dtype=torch.float32, device=q.device)
           if with_lse else None)
    suffix = "_lse" if with_lse else ""
    dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    scale = 1.0 / math.sqrt(D)
    common = (B, Tq, Tk, H, KV, D, int(q_offset), int(bool(causal)))
    if q.dtype == torch.float32:
        check(load("flash_attention").flash_attention_launch(
            ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), ptr(lengths), *common, scale, dev,
            stream,
        ), "flash_attention_f32" + suffix)
    elif Tq > 1 or with_lse:  # the decode kernel writes no lse
        check(load("flash_prefill").flash_prefill_launch(
            ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), ptr(lengths), *common, scale * _LOG2E,
            dev, stream,
        ), "flash_attention_prefill" + suffix)
    else:
        lib = load("flash_decode")
        pairs = B * KV * -(-G // _DECODE_ROWS)
        n_split, split_keys = decode_split(Tk, pairs, _sm_count(dev))
        # one scratch buffer: acc (B, H, n_split, D), then m and l (B, H, n_split)
        n_part = B * H * n_split
        scratch = torch.empty(n_part * (D + 2), dtype=torch.float32, device=q.device)
        part_o = scratch.data_ptr()
        part_m = part_o + 4 * n_part * D
        part_l = part_m + 4 * n_part
        check(lib.flash_decode_launch(
            ptr(q), ptr(k), ptr(v), ptr(lengths), part_o, part_m, part_l, B, Tk, H, KV, D,
            split_keys, n_split, int(q_offset), int(bool(causal)), scale * _LOG2E, dev, stream,
        ), "flash_attention_decode")
        check(lib.flash_combine_launch(
            part_o, part_m, part_l, ptr(o), B * H, D, n_split, dev, stream,
        ), "flash_attention_combine")
    LAUNCHES["flash_attention"] += 1
    return o, lse


class FlashAttentionFn(torch.autograd.Function):
    """Attention without a cache under autograd: the port of the
    reference's ``_flash_train`` custom VJP.  The forward runs K4 with its
    ``lse`` output on a CUDA tensor (the plain version on a CPU one) and
    saves ``(q, k, v, out, lse)``; the backward is
    :func:`flash_attention_backward_plain` on either device."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, block_q: int, block_kv: int):
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, causal=causal, block_q=block_q,
                                             block_kv=block_kv, return_lse=True)
        else:
            out, lse = _launch(q, k, v, causal, 0, None, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.blocks = (causal, block_q, block_kv)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, block_q, block_kv = ctx.blocks
        with torch.profiler.record_function("repro_torch.flash_attention_backward"):
            dq, dk, dv = flash_attention_backward_plain(
                q, k, v, out, lse, do, causal=causal, block_q=block_q, block_kv=block_kv)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,             # (B, Tq, H, D)
    k: torch.Tensor,             # (B, Tk, KV, D)
    v: torch.Tensor,             # (B, Tk, KV, D)
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
    contiguous, ``D <= 128``, ``H / KV <= 64``) launches the K4 kernel its
    dtype and shape select (see the module docstring).  A call without a
    cache whose inputs require grad (grad mode on) goes through
    :class:`FlashAttentionFn`, as the reference's ``train_path`` goes
    through its custom VJP; a call with a cache that requires grad
    raises.

    DTensor ``q``, ``k``, ``v`` (the sharded train step's) run through
    :func:`sharded_flash_attention`: each rank calls this function on its
    own shards."""
    if is_dtensor(q):
        if kv_length is not None or q_offset != 0:
            raise ValueError("attention over a KV cache takes plain tensors, not DTensors")
        return sharded_flash_attention(q, k, v, causal=causal, block_q=block_q,
                                       block_kv=block_kv)
    _check(q, k, v, kv_length)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if kv_length is not None or q_offset != 0:
            raise ValueError(
                "attention over a KV cache (q_offset > 0 or kv_length given) has no "
                "backward: call it without grad, or without a cache to train"
            )
        return FlashAttentionFn.apply(q, k, v, causal, block_q, block_kv)
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, q_offset=q_offset, kv_length=kv_length,
            block_q=block_q, block_kv=block_kv,
        )
    return _launch(q, k, v, causal, q_offset, kv_length, with_lse=False)[0]


def _attention_placements(q, k):
    """Per mesh dim, the placements K4's shards need: ``q`` split over its
    batch (dim 0) or heads (dim 2), or replicated; ``k`` / ``v`` split as
    ``q``'s batch, over their own heads where those line up with ``q``'s
    head blocks (``KV`` divides as ``H`` does), or replicated; and the
    gradient placements of ``k`` / ``v``: ``Partial`` where they are
    replicated beside ``q``'s head split (each rank's query heads add
    their share to the same kv heads)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = q.device_mesh
    H, KV = q.shape[2], k.shape[2]
    qp, kp, kgp = [], [], []
    for i, (a, b) in enumerate(zip(q.placements, k.placements)):
        n = mesh.size(i)
        if a in (Shard(0), Shard(2)) and n > 1:
            qp.append(a)
        else:
            qp.append(Replicate())
        if qp[-1] == Shard(0):
            kp.append(Shard(0))
            kgp.append(Shard(0))
        elif qp[-1] == Shard(2):
            aligned = b == Shard(2) and KV % n == 0 and H % n == 0
            kp.append(Shard(2) if aligned else Replicate())
            kgp.append(Shard(2) if aligned else Partial())
        else:
            kp.append(Replicate())
            kgp.append(Replicate())
    return tuple(qp), tuple(kp), tuple(kgp)


def sharded_flash_attention(
    q, k, v, *, causal: bool = True, block_q: int = 512, block_kv: int = 1024,
):
    """:func:`flash_attention` of DTensor ``q`` ``(B, Tq, H, D)`` and
    ``k``, ``v`` ``(B, Tk, KV, D)`` without a cache, under
    ``torch.distributed.tensor.experimental.local_map``: each rank runs
    K4 (its plain version on a CPU tensor) and :class:`FlashAttentionFn`'s
    backward on its own batch rows and query heads, so no DTensor reaches
    the kernel's ``ctypes`` call or the backward's in-place adds.

    Inputs are redistributed to :func:`_attention_placements`' layout.
    A rank whose query heads are ``[h0, h0 + H_loc)`` reads kv heads
    ``[h0 // G, (h0 + H_loc - 1) // G]`` of its ``k`` / ``v`` shard (``G =
    H / KV``), so that each query head meets its own kv head as in the
    unsharded call; a head split that cuts a group unevenly raises.
    Each rank launches K4 once per call, as the unsharded step does."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    qp, kp, kgp = _attention_placements(q, k)
    q = q.redistribute(mesh, qp)
    k = k.redistribute(mesh, kp)
    v = v.redistribute(mesh, kp)
    G = q.shape[2] // k.shape[2]
    q_shape, q_off = compute_local_shape_and_global_offset(q.shape, mesh, qp)
    k_shape, k_off = compute_local_shape_and_global_offset(k.shape, mesh, kp)
    h0, h_loc, kv0, kv_loc = q_off[2], q_shape[2], k_off[2], k_shape[2]
    lo, hi = h0 // G, (h0 + h_loc - 1) // G + 1
    g_loc = h_loc // (hi - lo) if h_loc else 1
    if h_loc and (lo < kv0 or hi > kv0 + kv_loc or h_loc % (hi - lo) or any(
            (h0 + j) // G - lo != j // g_loc for j in range(h_loc))):
        raise ValueError(
            f"query heads [{h0}, {h0 + h_loc}) of a {G}-head group size cannot meet "
            f"kv heads [{kv0}, {kv0 + kv_loc}) on this rank"
        )

    def local(q_l, k_l, v_l):
        if (lo, hi) != (kv0, kv0 + kv_loc):
            k_l = k_l[:, :, lo - kv0:hi - kv0].contiguous()
            v_l = v_l[:, :, lo - kv0:hi - kv0].contiguous()
        return flash_attention(q_l.contiguous(), k_l, v_l, causal=causal,
                               block_q=block_q, block_kv=block_kv)

    # a tuple of placements would read as one per output: lists here
    qp, kp, kgp = list(qp), list(kp), list(kgp)
    return local_map(local, out_placements=qp, in_placements=(qp, kp, kp),
                     in_grad_placements=(qp, kgp, kgp), device_mesh=mesh)(q, k, v)
