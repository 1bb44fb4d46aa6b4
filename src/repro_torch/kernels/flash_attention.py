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

``LAUNCHES['flash_attention']`` counts wrapper calls on the card, one
per attention call; ``flash_attention_prefill``, ``_decode``,
``_combine`` and ``_f32`` count each kernel's launches.  A call of a
plain version on a CUDA tensor (a comparison, never the wrapper) adds
one to ``PLAIN_CUDA_CALLS`` instead, so a run can show that its
attention went through the kernels.

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

__all__ = [
    "LAUNCHES",
    "PLAIN_CUDA_CALLS",
    "reset_launch_counts",
    "decode_split",
    "flash_attention",
    "flash_attention_plain",
    "flash_attention_split_plain",
]

# wrapper calls on the card, then each kernel's launches
LAUNCHES: Dict[str, int] = {
    "flash_attention": 0,
    "flash_attention_prefill": 0,
    "flash_attention_decode": 0,
    "flash_attention_combine": 0,
    "flash_attention_f32": 0,
}
# plain-version calls on CUDA tensors (comparisons only; the wrapper never
# makes one)
PLAIN_CUDA_CALLS: Dict[str, int] = {"flash_attention": 0}

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
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    k, v = _pad_keys(k, v, bkv)
    nq = (Tq + pad_q) // bq
    qg = q.reshape(B, nq, bq, KV, G, D)
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    kv_valid = _kv_valid(kv_length, B, Tk, dev)
    blocks = []
    for qi in range(nq):
        q_pos = q_offset + qi * bq + torch.arange(bq, device=dev)
        acc, _, l = _partials(qg[:, qi].float(), q_pos, k, v, kv_valid, causal, scale,
                              0, k.shape[1], bkv)
        out = acc / torch.clamp(l[..., None], min=1e-20)
        blocks.append(out.to(q.dtype))
    out = torch.stack(blocks, dim=1).reshape(B, nq * bq, H, D)
    return out[:, :Tq]


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
    contiguous, ``D <= 128``, ``H / KV <= 64``) launches the K4 kernel its
    dtype and shape select (see the module docstring)."""
    _check(q, k, v, kv_length)
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, q_offset=q_offset, kv_length=kv_length,
            block_q=block_q, block_kv=block_kv,
        )
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
    dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    scale = 1.0 / math.sqrt(D)
    common = (B, Tq, Tk, H, KV, D, int(q_offset), int(bool(causal)))
    if q.dtype == torch.float32:
        check(load("flash_attention").flash_attention_launch(
            ptr(q), ptr(k), ptr(v), ptr(o), ptr(lengths), *common, scale, dev, stream,
        ), "flash_attention_f32")
    elif Tq > 1:
        check(load("flash_prefill").flash_prefill_launch(
            ptr(q), ptr(k), ptr(v), ptr(o), ptr(lengths), *common, scale * _LOG2E, dev,
            stream,
        ), "flash_attention_prefill")
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
    return o
