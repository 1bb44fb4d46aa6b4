"""The row index of a packed incidence: the CUDA builder, its wrappers and
their plain PyTorch versions.

The SpMM kernels (:mod:`repro_torch.kernels.bitmap_spmm`) read a
destination-row CSR of the set bits instead of the 2 KiB bitmaps.  It is
built once per uploaded graph, on the device, from the byte-identical
packed operands (source ``csrc/bitmap_index.cu``):

* :func:`bitmap_index` — one packed direction
  (:class:`~repro_torch.kernels.pack.BlockSparseBitmap` layout) ->
  ``(row_ptr, col)``: ``row_ptr`` ``(n_rt·128 + 1,)`` int32, ``col``
  ``(nnz,)`` int32, the source row of each set bit, each row's entries in
  slot order, columns ascending within a slot.
* :func:`bitmap_index_fused` — the fused stream of
  :func:`~repro_torch.kernels.correction.build_fused_stream` ->
  ``(row_ptr, col, weight)``: per row the main entries (bits of the layer's
  bitmaps, over ``h``, ``weight`` 0), then the correction entries (present
  cells of the bit-planes, over ``x``, ``weight`` the count
  ``Σ_k 2^k · bit_k`` folded from the planes).

A wrapper takes its plain version when the operands lie on the CPU; on
CUDA tensors it launches the kernel or raises.  Every build on the card
adds one to its entry in :data:`INDEX_BUILDS` (two launches and a scan:
count, ``torch.cumsum``, fill), apart from the SpMM kernels'
``LAUNCHES``: builds happen at upload, before a served run.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from .pack import TILE, WORDS

__all__ = [
    "INDEX_BUILDS",
    "bitmap_index",
    "bitmap_index_plain",
    "bitmap_index_fused",
    "bitmap_index_fused_plain",
]

# builder -> index builds on the card since the process started
INDEX_BUILDS: Dict[str, int] = {"bitmap_index": 0, "bitmap_index_fused": 0}


def _check(name: str, t: torch.Tensor, device: torch.device, ndim: int) -> None:
    if t.dtype != torch.int32 or t.ndim != ndim:
        raise ValueError(f"{name} must be a {ndim}-D int32 tensor, got {t.dtype} {tuple(t.shape)}")
    if ndim > 1 and tuple(t.shape[-2:]) != (TILE, WORDS):
        raise ValueError(f"{name} must hold (..., {TILE}, {WORDS}) words, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the run table on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if ndim > 1 and device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary: the kernel reads 16-byte rows")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _set_bits(words: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(unit, row, col)`` int64 of every set bit of a ``(n, TILE, WORDS)``
    word stack, in (unit, row, col) order."""
    flat = words.reshape(-1)
    nz = torch.nonzero(flat, as_tuple=True)[0]
    vals = flat[nz].to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    word_i, bit = torch.nonzero((vals[:, None] >> shifts) & 1, as_tuple=True)
    w = nz[word_i]
    return w // (TILE * WORDS), (w % (TILE * WORDS)) // WORDS, (w % WORDS) * 32 + bit


def _csr(dst: torch.Tensor, n_rows: int, *cols: torch.Tensor):
    """Stable sort of entries (already in stream order) by destination row:
    ``(row_ptr, *cols)`` as int32."""
    order = torch.argsort(dst, stable=True)
    counts = torch.bincount(dst, minlength=n_rows)
    row_ptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=dst.device)
    row_ptr[1:] = torch.cumsum(counts, 0)
    return (row_ptr.to(torch.int32),) + tuple(c[order].to(torch.int32) for c in cols)


def bitmap_index_plain(
    slot_src: torch.Tensor,
    slot_row: torch.Tensor,
    row_start: torch.Tensor,
    row_count: torch.Tensor,
    bitmaps: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain :func:`bitmap_index`: unpack the set bits in (slot, row, col)
    order and sort them stably by destination row.  Slots are sorted by
    row tile, so this is the run table's order; ``row_start`` /
    ``row_count`` only give the row count."""
    del row_count
    slot, row, col = _set_bits(bitmaps)
    dst = slot_row.to(torch.int64)[slot] * TILE + row
    src = slot_src.to(torch.int64)[slot] * TILE + col
    return _csr(dst, int(row_start.shape[0]) * TILE, src)


def bitmap_index_fused_plain(
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
    plane_weights: Sequence[float],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain :func:`bitmap_index_fused`: the stream's main bits (weight 0)
    and present correction cells (weight = ``Σ_k plane_weights[k] · bit_k``),
    in stream order, sorted stably by destination row."""
    del row_count
    n_planes = int(planes.shape[1])
    slots = torch.arange(kind.shape[0], device=kind.device)
    main, corr = kind == 0, kind == 1
    m_slots, c_slots = slots[main], slots[corr]
    m_unit, m_row, m_col = _set_bits(bitmaps.index_select(0, main_idx[main].to(torch.int64)))
    c_planes = planes.index_select(0, corr_idx[corr].to(torch.int64))
    present = c_planes[:, 0]
    for k in range(1, n_planes):
        present = present | c_planes[:, k]
    c_unit, c_row, c_col = _set_bits(present)
    bits = (c_planes[c_unit, :, c_row, c_col // 32].to(torch.int64) & 0xFFFFFFFF) >> (c_col % 32)[:, None]
    scale = torch.tensor([int(w) for w in plane_weights], dtype=torch.int64, device=bits.device)
    count = ((bits & 1) * scale).sum(dim=1)
    s = torch.cat([m_slots[m_unit], c_slots[c_unit]])
    row = torch.cat([m_row, c_row])
    col = torch.cat([m_col, c_col])
    tile = slot_row.to(torch.int64)[s]
    src = torch.where(main, main_src, corr_src).to(torch.int64)[s] * TILE + col
    weight = torch.cat([torch.zeros_like(m_col), count])
    # stream order: slot, then row and column within it
    order = torch.argsort((s * TILE + row) * TILE + col)
    dst = (tile * TILE + row)[order]
    return _csr(dst, int(row_start.shape[0]) * TILE, src[order], weight[order])


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _row_ptr(counts: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Exclusive scan of the count pass (``counts[0] == 0``) and the entry
    count, read back once per build."""
    row_ptr = torch.cumsum(counts, 0, dtype=torch.int32)
    return row_ptr, int(row_ptr[-1].item())


def bitmap_index(
    slot_src: torch.Tensor,
    slot_row: torch.Tensor,
    row_start: torch.Tensor,
    row_count: torch.Tensor,
    bitmaps: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(row_ptr, col)`` of one packed direction, on the operands'
    device."""
    device = bitmaps.device
    for name, t in (("slot_src", slot_src), ("slot_row", slot_row),
                    ("row_start", row_start), ("row_count", row_count)):
        _check(name, t, device, 1)
    _check("bitmaps", bitmaps, device, 3)
    if device.type == "cpu":
        return bitmap_index_plain(slot_src, slot_row, row_start, row_count, bitmaps)
    if device.type != "cuda":
        raise ValueError(f"operands lie on {device}: only cpu and cuda are served")
    from .build import load

    lib = load("bitmap_index")
    n_rt = int(row_start.shape[0])
    counts = torch.empty(n_rt * TILE + 1, dtype=torch.int32, device=device)
    common = (_ptr(slot_src), _ptr(row_start), _ptr(row_count), _ptr(bitmaps), n_rt)
    tail = (device.index or 0, _stream(device))
    _raise_on(lib.bitmap_index_launch(0, *common, _ptr(counts), None, *tail), "bitmap_index")
    row_ptr, nnz = _row_ptr(counts)
    col = torch.empty(nnz, dtype=torch.int32, device=device)
    _raise_on(lib.bitmap_index_launch(1, *common, _ptr(row_ptr), _ptr(col), *tail),
              "bitmap_index")
    INDEX_BUILDS["bitmap_index"] += 1
    return row_ptr, col


def bitmap_index_fused(
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
    plane_weights: Sequence[float],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(row_ptr, col, weight)`` of the fused stream, on the operands'
    device.  The kernel folds plane ``k`` with weight ``2**k``, the weights
    :func:`~repro_torch.kernels.correction.pack_correction` gives."""
    device = bitmaps.device
    for name, t in (("kind", kind), ("main_src", main_src), ("corr_src", corr_src),
                    ("main_idx", main_idx), ("corr_idx", corr_idx), ("slot_row", slot_row),
                    ("row_start", row_start), ("row_count", row_count)):
        _check(name, t, device, 1)
    _check("bitmaps", bitmaps, device, 3)
    _check("planes", planes, device, 4)
    n_planes = int(planes.shape[1])
    if not 1 <= n_planes <= 31:
        raise ValueError(f"{n_planes} bit-planes: the counts must fit 31 bits")
    if tuple(float(w) for w in plane_weights) != tuple(float(2**k) for k in range(n_planes)):
        raise ValueError("plane_weights must be 2**k for each of the planes")
    if device.type == "cpu":
        return bitmap_index_fused_plain(kind, main_src, corr_src, main_idx, corr_idx, slot_row,
                                        row_start, row_count, bitmaps, planes, plane_weights)
    if device.type != "cuda":
        raise ValueError(f"operands lie on {device}: only cpu and cuda are served")
    from .build import load

    lib = load("bitmap_index")
    n_rt = int(row_start.shape[0])
    counts = torch.empty(n_rt * TILE + 1, dtype=torch.int32, device=device)
    common = (_ptr(kind), _ptr(main_src), _ptr(corr_src), _ptr(main_idx), _ptr(corr_idx),
              _ptr(row_start), _ptr(row_count), _ptr(bitmaps), _ptr(planes), n_planes, n_rt)
    tail = (device.index or 0, _stream(device))
    _raise_on(lib.bitmap_index_fused_launch(0, *common, _ptr(counts), None, None, *tail),
              "bitmap_index_fused")
    row_ptr, nnz = _row_ptr(counts)
    col = torch.empty(nnz, dtype=torch.int32, device=device)
    weight = torch.empty(nnz, dtype=torch.int32, device=device)
    _raise_on(lib.bitmap_index_fused_launch(1, *common, _ptr(row_ptr), _ptr(col), _ptr(weight),
                                            *tail), "bitmap_index_fused")
    INDEX_BUILDS["bitmap_index_fused"] += 1
    return row_ptr, col, weight
