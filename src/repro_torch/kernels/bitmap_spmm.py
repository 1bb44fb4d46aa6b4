"""Bit-packed block-sparse SpMM: the CUDA kernels, their wrappers and their
plain PyTorch versions.

* :func:`bitmap_spmm` — K1 (``op='sum'``) and K2 (``op='min' | 'max'``):
  ``y = B ⊕ x`` over one packed incidence
  (:class:`~repro_torch.kernels.pack.BlockSparseBitmap` layout), source
  ``csrc/bitmap_spmm.cu``.  Replaces the JAX package's Pallas
  ``kernels/bitmap_spmm.py::_kernel``.
* :func:`bitmap_spmm_fused` — K3: ``y = B h − Σ_k 2^k (D_k x)`` over the
  interleaved main/correction stream of
  :func:`~repro_torch.kernels.correction.build_fused_stream`, source
  ``csrc/bitmap_spmm_fused.cu``.  Replaces the Pallas ``_fused_kernel``.

A wrapper takes its plain version only when the frontier lies on the CPU
(the tests' case).  On a CUDA tensor it launches the kernel or raises:
there is no fallback.  Every launch adds one to its kernel's entry in
:data:`LAUNCHES`; plain-version calls count nothing.

Operands: int32 slot/run tables, bitmaps and planes as int32 views of the
packed uint32 words (bit ``j`` of word ``w`` in row ``r`` is source column
``32·w + j``), float32 frontiers ``(rows, F)`` in row-major order.  A
frontier needs no padding: it must hold every source row that a set bit
selects, and the output has ``n_out`` rows (at most 128 per row tile).

The kernels merge partial rows with atomics, so float sums on the card
come out in an order that changes from run to run; integer-valued
frontiers are exact and equal the plain versions bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from .pack import TILE, WORDS

__all__ = [
    "LAUNCHES",
    "reset_launch_counts",
    "bitmap_spmm",
    "bitmap_spmm_plain",
    "bitmap_spmm_fused",
    "bitmap_spmm_fused_plain",
]

# kernel name -> launches since the last reset (plain integers)
LAUNCHES: Dict[str, int] = {
    "bitmap_spmm_sum": 0,
    "bitmap_spmm_min": 0,
    "bitmap_spmm_max": 0,
    "bitmap_spmm_fused": 0,
}

_OP_CODES = {"sum": 0, "min": 1, "max": 2}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Checks shared by both wrappers
# ---------------------------------------------------------------------------

def _check_table(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.dtype != torch.int32 or t.ndim != 1:
        raise ValueError(f"{name} must be a 1-D int32 tensor, got {t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, frontier on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_words(name: str, t: torch.Tensor, device: torch.device, ndim: int) -> None:
    if t.dtype != torch.int32 or t.ndim != ndim or tuple(t.shape[-2:]) != (TILE, WORDS):
        raise ValueError(
            f"{name} must be int32 (..., {TILE}, {WORDS}) words, got "
            f"{t.dtype} {tuple(t.shape)}"
        )
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, frontier on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_frontier(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32 or t.ndim != 2:
        raise ValueError(f"{name} must be a float32 (rows, F) tensor, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} lies on {t.device}: only cpu and cuda are served")


def _check_out(n_out: int, n_rt: int) -> None:
    if not 0 <= n_out <= n_rt * TILE:
        raise ValueError(f"n_out={n_out} outside the {n_rt} row tiles of the pack")


def _check_aligned(name: str, t: torch.Tensor) -> None:
    if t.data_ptr() % 8:
        raise ValueError(f"{name} must start on an 8-byte boundary: the kernel reads word pairs")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU tests; compared with the kernels on the card)
# ---------------------------------------------------------------------------

def _set_bits(words: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(slot, row, col)`` int64 of every set bit of a ``(n, TILE, WORDS)``
    word stack, in (slot, row, col) order."""
    flat = words.reshape(-1)
    nz = torch.nonzero(flat, as_tuple=True)[0]
    vals = flat[nz].to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    word_i, bit = torch.nonzero((vals[:, None] >> shifts) & 1, as_tuple=True)
    w = nz[word_i]
    slot = w // (TILE * WORDS)
    row = (w % (TILE * WORDS)) // WORDS
    col = (w % WORDS) * 32 + bit
    return slot, row, col


def _reduce_rows(
    dst: torch.Tensor, vals: torch.Tensor, n_out: int, op: str, zero: float
) -> torch.Tensor:
    shape = (n_out, vals.shape[1])
    if op == "sum":
        out = torch.zeros(shape, dtype=vals.dtype, device=vals.device)
        return out.index_add_(0, dst, vals)
    init = float("inf") if op == "min" else float("-inf")
    out = torch.full(shape, init, dtype=vals.dtype, device=vals.device)
    out.scatter_reduce_(
        0, dst[:, None].expand_as(vals), vals,
        "amin" if op == "min" else "amax", include_self=False,
    )
    return torch.where(out == init, torch.full_like(out, zero), out)


def _gathered(
    words: torch.Tensor, slot_src: torch.Tensor, slot_row: torch.Tensor,
    x: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dst rows, gathered source rows of x)`` for every set bit."""
    slot, row, col = _set_bits(words)
    dst = slot_row.to(torch.int64)[slot] * TILE + row
    src = slot_src.to(torch.int64)[slot] * TILE + col
    return dst, x.index_select(0, src)


def bitmap_spmm_plain(
    slot_src: torch.Tensor,
    slot_row: torch.Tensor,
    row_start: torch.Tensor,
    row_count: torch.Tensor,
    bitmaps: torch.Tensor,
    x: torch.Tensor,
    n_out: int,
    op: str = "sum",
    zero: float = 0.0,
) -> torch.Tensor:
    """Plain PyTorch K1/K2: unpack the set bits, gather their source rows,
    and ⊕-reduce into destination rows (``index_add_`` for the sum,
    ``scatter_reduce`` for min/max); rows that receive nothing take
    ``zero``, as in the kernel's epilogue.  ``row_start``/``row_count``
    are implied by ``slot_row`` and unused here."""
    del row_start, row_count
    dst, vals = _gathered(bitmaps, slot_src, slot_row, x)
    return _reduce_rows(dst, vals, n_out, op, zero)


def bitmap_spmm_fused_plain(
    kind: torch.Tensor,
    main_src: torch.Tensor,
    corr_src: torch.Tensor,
    main_idx: torch.Tensor,
    corr_idx: torch.Tensor,
    slot_row: torch.Tensor,
    row_start: torch.Tensor,
    row_count: torch.Tensor,
    bitmaps: torch.Tensor,
    planes: torch.Tensor,
    h: torch.Tensor,
    x: torch.Tensor,
    n_out: int,
    plane_weights: Sequence[float],
) -> torch.Tensor:
    """Plain PyTorch K3: the main slots' sum over ``h`` minus
    ``Σ_k w_k · (plane-k sum over x)``."""
    del row_start, row_count
    main = kind == 0
    corr = ~main
    dst, vals = _gathered(
        bitmaps.index_select(0, main_idx[main].to(torch.int64)),
        main_src[main], slot_row[main], h,
    )
    acc = _reduce_rows(dst, vals, n_out, "sum", 0.0)
    corr_planes = planes.index_select(0, corr_idx[corr].to(torch.int64))
    cacc = torch.zeros_like(acc)
    for k, w in enumerate(plane_weights):
        dst, vals = _gathered(
            corr_planes[:, k].contiguous(), corr_src[corr], slot_row[corr], x
        )
        cacc = cacc + float(w) * _reduce_rows(dst, vals, n_out, "sum", 0.0)
    return acc - cacc


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def bitmap_spmm(
    slot_src: torch.Tensor,
    slot_row: torch.Tensor,
    row_start: torch.Tensor,
    row_count: torch.Tensor,
    bitmaps: torch.Tensor,
    x: torch.Tensor,
    n_out: int,
    op: str = "sum",
    zero: float = 0.0,
) -> torch.Tensor:
    """``y = B ⊕ x`` over one packed incidence: ``(n_out, F)`` float32.

    ``op``/``zero`` come from the semiring's ``add_kind``/``zero``.  A CPU
    frontier runs :func:`bitmap_spmm_plain`; a CUDA frontier launches the
    K1/K2 kernel (``csrc/bitmap_spmm.cu``) on the current stream."""
    if op not in _OP_CODES:
        raise ValueError(f"unknown kernel op {op!r}")
    _check_frontier("x", x)
    for name, t in (("slot_src", slot_src), ("slot_row", slot_row),
                    ("row_start", row_start), ("row_count", row_count)):
        _check_table(name, t, x.device)
    _check_words("bitmaps", bitmaps, x.device, 3)
    n_rt = int(row_start.shape[0])
    _check_out(n_out, n_rt)
    if bitmaps.shape[0] != slot_src.shape[0] or slot_row.shape != slot_src.shape:
        raise ValueError("slot tables and bitmaps disagree on the slot count")
    if x.device.type == "cpu":
        return bitmap_spmm_plain(
            slot_src, slot_row, row_start, row_count, bitmaps, x, n_out, op, zero
        )
    from .build import load

    _check_aligned("bitmaps", bitmaps)
    y = torch.empty((n_out, x.shape[1]), dtype=torch.float32, device=x.device)
    rc = load("bitmap_spmm").bitmap_spmm_launch(
        _ptr(slot_src), _ptr(slot_row), _ptr(bitmaps), int(slot_src.shape[0]),
        _ptr(x), _ptr(y), n_out, int(x.shape[1]), _OP_CODES[op], float(zero),
        x.device.index or 0, _stream(x.device),
    )
    if rc != 0:
        raise RuntimeError(f"bitmap_spmm ({op}) launch failed: CUDA error {rc}")
    LAUNCHES[f"bitmap_spmm_{op}"] += 1
    return y


def bitmap_spmm_fused(
    kind: torch.Tensor,
    main_src: torch.Tensor,
    corr_src: torch.Tensor,
    main_idx: torch.Tensor,
    corr_idx: torch.Tensor,
    slot_row: torch.Tensor,
    row_start: torch.Tensor,
    row_count: torch.Tensor,
    bitmaps: torch.Tensor,
    planes: torch.Tensor,
    h: torch.Tensor,
    x: torch.Tensor,
    n_out: int,
    plane_weights: Sequence[float],
) -> torch.Tensor:
    """Fused last-layer SpMM with the DEDUP-C subtraction in the epilogue:
    ``y = B h − D x`` as ``(n_out, F)`` float32, plus-times only.  ``h``
    (the last hidden frontier) and ``x`` (the original input) share the
    feature width.  A CPU frontier runs :func:`bitmap_spmm_fused_plain`; a
    CUDA frontier launches the K3 kernel (``csrc/bitmap_spmm_fused.cu``).
    The kernel weighs plane ``k`` by ``2**k``, the weights
    :func:`~repro_torch.kernels.correction.pack_correction` gives, and
    expects each stored bitmap and plane stack to be named by one slot of
    the stream, as :func:`~repro_torch.kernels.correction.build_fused_stream`
    lays it out."""
    _check_frontier("h", h)
    _check_frontier("x", x)
    if h.shape[1] != x.shape[1] or h.device != x.device:
        raise ValueError(
            f"h and x must share the feature axis and device: "
            f"{tuple(h.shape)} on {h.device} vs {tuple(x.shape)} on {x.device}"
        )
    tables = (("kind", kind), ("main_src", main_src), ("corr_src", corr_src),
              ("main_idx", main_idx), ("corr_idx", corr_idx),
              ("slot_row", slot_row), ("row_start", row_start),
              ("row_count", row_count))
    for name, t in tables:
        _check_table(name, t, x.device)
    _check_words("bitmaps", bitmaps, x.device, 3)
    _check_words("planes", planes, x.device, 4)
    n_planes = int(planes.shape[1])
    if tuple(float(w) for w in plane_weights) != tuple(float(2**k) for k in range(n_planes)):
        raise ValueError("plane_weights must be 2**k for each of the planes")
    n_rt = int(row_start.shape[0])
    _check_out(n_out, n_rt)
    if x.device.type == "cpu":
        return bitmap_spmm_fused_plain(
            kind, main_src, corr_src, main_idx, corr_idx, slot_row,
            row_start, row_count, bitmaps, planes, h, x, n_out, plane_weights,
        )
    from .build import load

    _check_aligned("bitmaps", bitmaps)
    _check_aligned("planes", planes)
    n_main, n_corr = int(bitmaps.shape[0]), int(planes.shape[0])
    y = torch.empty((n_out, x.shape[1]), dtype=torch.float32, device=x.device)
    tables = torch.empty(2 * (n_main + n_corr), dtype=torch.int32, device=x.device)
    rc = load("bitmap_spmm_fused").bitmap_spmm_fused_launch(
        _ptr(kind), _ptr(main_src), _ptr(corr_src), _ptr(main_idx), _ptr(corr_idx),
        _ptr(slot_row), int(kind.shape[0]), _ptr(bitmaps), n_main, _ptr(planes),
        n_corr, n_planes, _ptr(h), _ptr(x), _ptr(y), n_out, int(x.shape[1]),
        _ptr(tables), x.device.index or 0, _stream(x.device),
    )
    if rc != 0:
        raise RuntimeError(f"bitmap_spmm_fused launch failed: CUDA error {rc}")
    LAUNCHES["bitmap_spmm_fused"] += 1
    return y
