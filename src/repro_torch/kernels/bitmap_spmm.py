"""Bit-packed block-sparse SpMM: the CUDA kernels, their wrappers and their
plain PyTorch versions.

* :func:`bitmap_spmm` — K1 (``op='sum'``) and K2 (``op='min' | 'max'``):
  ``y = B ⊕ x`` over one packed incidence, source ``csrc/bitmap_spmm.cu``.
  Replaces the JAX package's Pallas ``kernels/bitmap_spmm.py::_kernel``.
* :func:`bitmap_spmm_fused` — K3: ``y = B h − D x`` with ``D`` the DEDUP-C
  correction counts, source ``csrc/bitmap_spmm_fused.cu``.  Replaces the
  Pallas ``_fused_kernel``.

The kernels read the row index of :mod:`repro_torch.kernels.bitmap_index`
(``row_ptr``, ``col`` and, for K3, ``weight``: 0 for a main entry over
``h``, the correction count for an entry over ``x``), built once per
uploaded graph from the byte-identical packed operands; they read no
bitmap.  Frontiers are float32 ``(rows, F)`` in row-major order and need no
padding; the output has ``n_out`` rows (``n_out`` at most the index's row
count, 128 per row tile).

Three plain versions sit beside the kernels:

* :func:`bitmap_spmm_plain` / :func:`bitmap_spmm_fused_plain` read the
  **bitmaps** (and bit-planes), not the index: the independent yardstick
  the kernels are held to on the card, so a wrong index is caught.
* :func:`bitmap_spmm_index_plain` / :func:`bitmap_spmm_fused_index_plain`
  mirror the kernels' arithmetic over the index: the same merge-path
  ranges, the same sequential fold within a range, and the same fixed
  order of the carry pass, so they give the kernels' bits on float
  frontiers too.  A wrapper runs its mirror when the frontier lies on the
  CPU (the tests' case); on a CUDA tensor it launches the kernel or
  raises: there is no fallback.

Every launch adds one to its kernel's entry in :data:`LAUNCHES` (a launch
is the range kernel plus its carry pass); plain calls count nothing.  The
kernels merge split rows in a fixed order, without atomics, so float sums
are bit-identical from launch to launch; integer-valued frontiers equal
the plain versions bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from .bitmap_index import _set_bits
from .pack import TILE

__all__ = [
    "LAUNCHES",
    "reset_launch_counts",
    "default_range_items",
    "bitmap_spmm",
    "bitmap_spmm_plain",
    "bitmap_spmm_index_plain",
    "bitmap_spmm_fused",
    "bitmap_spmm_fused_plain",
    "bitmap_spmm_fused_index_plain",
]

# kernel name -> launches since the last reset (plain integers)
LAUNCHES: Dict[str, int] = {
    "bitmap_spmm_sum": 0,
    "bitmap_spmm_min": 0,
    "bitmap_spmm_max": 0,
    "bitmap_spmm_fused": 0,
}

_OP_CODES = {"sum": 0, "min": 1, "max": 2}
_IDENTITY = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}

# features per grid.y block of the kernels (csrc/bitmap_common.cuh)
FEATURE_BLOCK = 32
# chunks the carry pass cuts a row's tails into (csrc/bitmap_common.cuh)
CHUNKS = 32
# lanes the range length is sized for: about two waves of full warps on a
# 132-SM card at F = 32 (8 lanes a group)
_TARGET_LANES = 1 << 18


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _pow2ceil(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def default_range_items(total: int, n_feat: int) -> int:
    """Merged items (row ends + entries) per range for ``total`` items at
    ``n_feat`` features: enough ranges to fill the card with 16-byte
    groups, at least 64 and at most 512 items each (on the H100, 64 for
    the smoke graph's K1/K2 and 128 for its K3 were the fastest of 32 to
    256; ``scripts/spmm_times.py``).  Depends on shapes only, so a graph's
    ranges, and its float sums, repeat exactly."""
    lanes = min(8, _pow2ceil(-(-min(n_feat, FEATURE_BLOCK) // 4)))
    return min(512, max(64, _pow2ceil(-(-total * lanes // _TARGET_LANES))))


# ---------------------------------------------------------------------------
# Checks shared by both wrappers
# ---------------------------------------------------------------------------

def _check_index(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.dtype != torch.int32 or t.ndim != 1:
        raise ValueError(f"{name} must be a 1-D int32 tensor, got {t.dtype} {tuple(t.shape)}")
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


def _check_out(n_out: int, row_ptr: torch.Tensor) -> None:
    n_rows = int(row_ptr.shape[0]) - 1
    if not 0 <= n_out <= n_rows:
        raise ValueError(
            f"n_out={n_out} outside the {n_rows} rows ({n_rows // TILE} row tiles) of the index"
        )


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _grid(frontiers: Sequence[torch.Tensor], n_out: int, nnz: int, items: Optional[int]):
    """``(vec, log_g, range_items, n_groups)`` of a launch: 16-byte gathers
    when every frontier allows them, the smallest group of lanes that covers
    a feature block, and enough ranges to cover every item."""
    n_feat = int(frontiers[0].shape[1])
    vec = 4 if n_feat % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in frontiers) else 1
    lanes = min(FEATURE_BLOCK // vec, _pow2ceil(-(-min(n_feat, FEATURE_BLOCK) // vec)))
    items = items or default_range_items(n_out + nnz, n_feat)
    return vec, lanes.bit_length() - 1, items, -(-(n_out + nnz) // items)


# ---------------------------------------------------------------------------
# Plain PyTorch versions over the bitmaps (compared with the kernels on the card)
# ---------------------------------------------------------------------------

def _reduce_rows(
    dst: torch.Tensor, vals: torch.Tensor, n_out: int, op: str, zero: float
) -> torch.Tensor:
    shape = (n_out, vals.shape[1])
    if op == "sum":
        out = torch.zeros(shape, dtype=vals.dtype, device=vals.device)
        return out.index_add_(0, dst, vals)
    init = _IDENTITY[op]
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
# Plain mirrors of the kernels' arithmetic over the index
# ---------------------------------------------------------------------------

def _combine(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if op == "sum":
        return a + b
    return torch.minimum(a, b) if op == "min" else torch.maximum(a, b)


def _run_pos(seg: torch.Tensor) -> torch.Tensor:
    """Position of each element within its run of equal ``seg`` values."""
    n = int(seg.shape[0])
    at = torch.arange(n, device=seg.device)
    first = torch.ones(n, dtype=torch.bool, device=seg.device)
    first[1:] = seg[1:] != seg[:-1]
    return at - torch.cummax(torch.where(first, at, torch.zeros_like(at)), 0).values


def _fold(seg: torch.Tensor, vals: torch.Tensor, n_seg: int, op: str) -> torch.Tensor:
    """``out[s] = (((identity ⊕ v_0) ⊕ v_1) ⊕ …)`` over the values of each
    segment in order; ``seg`` is sorted, so each segment is one run."""
    out = torch.full((n_seg, vals.shape[1]), _IDENTITY[op], dtype=vals.dtype,
                     device=vals.device)
    if seg.shape[0] == 0:
        return out
    pos = _run_pos(seg)
    order = torch.argsort(pos, stable=True)
    for idx in torch.split(order, torch.bincount(pos).tolist()):
        s = seg[idx]
        out[s] = _combine(op, out[s], vals[idx])
    return out


def _fold_rows(row_ptr: torch.Tensor, items: int, piece_row: torch.Tensor,
               piece_range: torch.Tensor, partial: torch.Tensor, n_out: int, op: str):
    """The carry pass over the pieces' partials (csrc/bitmap_common.cuh,
    ``carry``).  Row r's head is its piece in the range of its end (merged
    item ``row_ptr[r+1] + r``; it may hold no entry) and its T tails the
    ranges from its first entry's (item ``row_ptr[r] + r``) up to the head's.
    The tails fold in CHUNKS chunks of ``ceil(T / CHUNKS)``, and the row is
    identity ⊕ the chunks in order ⊕ the head; a row in one range is its
    one piece."""
    rp = row_ptr.to(torch.int64)
    first = (rp[piece_row] + piece_row) // items
    head = (rp[piece_row + 1] + piece_row) // items
    size = torch.clamp((head - first + CHUNKS - 1) // CHUNKS, min=1)
    chunk = torch.where(piece_range == head, CHUNKS, (piece_range - first) // size)
    key = piece_row * (CHUNKS + 1) + chunk
    new = torch.ones(key.shape[0], dtype=torch.bool, device=key.device)
    new[1:] = key[1:] != key[:-1]
    chunks = _fold(torch.cumsum(new, 0) - 1, partial, int(new.sum()), op)
    return _fold(piece_row[new], chunks, n_out, op)


def _ranges(row_ptr: torch.Tensor, n_out: int, items: int):
    """The kernels' cut of rows ``< n_out`` into merge-path ranges of
    ``items`` items: ``(entries, piece of each entry, row and range of each
    piece, piece count)``, where a piece is the part of a row inside one
    range (entry ``e`` of row ``r`` is merged item ``e + r``)."""
    rp = row_ptr[: n_out + 1].to(torch.int64)
    nnz = int(rp[-1])
    row = torch.repeat_interleave(torch.arange(n_out, device=rp.device), rp[1:] - rp[:-1])
    rng = (torch.arange(nnz, device=rp.device) + row) // items
    new = torch.ones(nnz, dtype=torch.bool, device=rp.device)
    new[1:] = (row[1:] != row[:-1]) | (rng[1:] != rng[:-1])
    piece = torch.cumsum(new, 0) - 1
    return nnz, piece, row[new], rng[new], int(new.sum())


def _finish(op: str, y: torch.Tensor, zero: float) -> torch.Tensor:
    if op == "sum":
        return y
    return torch.where(y == _IDENTITY[op], torch.full_like(y, zero), y)


def bitmap_spmm_index_plain(
    row_ptr: torch.Tensor,
    col: torch.Tensor,
    x: torch.Tensor,
    n_out: int,
    op: str = "sum",
    zero: float = 0.0,
    range_items: Optional[int] = None,
) -> torch.Tensor:
    """The K1/K2 kernel's arithmetic in plain PyTorch: each range's pieces
    folded in entry order, then each row from its pieces as the carry pass
    folds them (:func:`_fold_rows`), then the identity-to-``zero``
    epilogue."""
    items = range_items or default_range_items(n_out + int(col.shape[0]), int(x.shape[1]))
    nnz, piece, piece_row, piece_range, n_pieces = _ranges(row_ptr, n_out, items)
    vals = x.index_select(0, col[:nnz].to(torch.int64))
    partial = _fold(piece, vals, n_pieces, op)
    return _finish(op, _fold_rows(row_ptr, items, piece_row, piece_range, partial, n_out, op),
                   zero)


def bitmap_spmm_fused_index_plain(
    row_ptr: torch.Tensor,
    col: torch.Tensor,
    weight: torch.Tensor,
    h: torch.Tensor,
    x: torch.Tensor,
    n_out: int,
    range_items: Optional[int] = None,
) -> torch.Tensor:
    """The K3 kernel's arithmetic in plain PyTorch: ``acc`` over the main
    entries (weight 0) of ``h`` and ``cacc`` over ``weight · x`` (each
    product rounded once), each folded as
    :func:`bitmap_spmm_index_plain` folds, then ``acc − cacc``."""
    items = range_items or default_range_items(n_out + int(col.shape[0]), int(x.shape[1]))
    nnz, piece, piece_row, piece_range, n_pieces = _ranges(row_ptr, n_out, items)
    c = col[:nnz].to(torch.int64)
    w = weight[:nnz]
    main = (w == 0)[:, None]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    acc_v = torch.where(main, h.index_select(0, torch.where(w == 0, c, 0)), zero)
    corr_v = torch.where(
        main, zero, w.to(x.dtype)[:, None] * x.index_select(0, torch.where(w == 0, 0, c))
    )
    pieces = (row_ptr, items, piece_row, piece_range)
    acc = _fold_rows(*pieces, _fold(piece, acc_v, n_pieces, "sum"), n_out, "sum")
    cacc = _fold_rows(*pieces, _fold(piece, corr_v, n_pieces, "sum"), n_out, "sum")
    return acc - cacc


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def bitmap_spmm(
    row_ptr: torch.Tensor,
    col: torch.Tensor,
    x: torch.Tensor,
    n_out: int,
    op: str = "sum",
    zero: float = 0.0,
    range_items: Optional[int] = None,
) -> torch.Tensor:
    """``y = B ⊕ x`` over one packed incidence's row index: ``(n_out, F)``
    float32.

    ``op``/``zero`` come from the semiring's ``add_kind``/``zero``.  A CPU
    frontier runs :func:`bitmap_spmm_index_plain`; a CUDA frontier launches
    the K1/K2 kernel (``csrc/bitmap_spmm.cu``) and its carry pass on the
    current stream.  ``range_items`` overrides the range length (tests)."""
    if op not in _OP_CODES:
        raise ValueError(f"unknown kernel op {op!r}")
    _check_frontier("x", x)
    _check_index("row_ptr", row_ptr, x.device)
    _check_index("col", col, x.device)
    _check_out(n_out, row_ptr)
    if x.device.type == "cpu":
        return bitmap_spmm_index_plain(row_ptr, col, x, n_out, op, zero, range_items)
    from .build import load

    n_feat = int(x.shape[1])
    y = torch.empty((n_out, n_feat), dtype=torch.float32, device=x.device)
    vec, log_g, items, n_groups = _grid((x,), n_out, int(col.shape[0]), range_items)
    carry_rows = torch.empty(n_groups, dtype=torch.int32, device=x.device)
    carry_vals = torch.empty(2 * n_groups * n_feat, dtype=torch.float32, device=x.device)
    rc = load("bitmap_spmm").bitmap_spmm_launch(
        _ptr(row_ptr), _ptr(col), _ptr(x), _ptr(y), n_out, n_feat, _OP_CODES[op], float(zero),
        vec, log_g, items, n_groups, _ptr(carry_rows), _ptr(carry_vals),
        x.device.index or 0, _stream(x.device),
    )
    if rc != 0:
        raise RuntimeError(f"bitmap_spmm ({op}) launch failed: CUDA error {rc}")
    LAUNCHES[f"bitmap_spmm_{op}"] += 1
    return y


def bitmap_spmm_fused(
    row_ptr: torch.Tensor,
    col: torch.Tensor,
    weight: torch.Tensor,
    h: torch.Tensor,
    x: torch.Tensor,
    n_out: int,
    range_items: Optional[int] = None,
) -> torch.Tensor:
    """Fused last-layer SpMM with the DEDUP-C subtraction in the epilogue:
    ``y = B h − D x`` as ``(n_out, F)`` float32, plus-times only, over the
    fused stream's row index.  ``h`` (the last hidden frontier) and ``x``
    (the original input) share the feature width.  A CPU frontier runs
    :func:`bitmap_spmm_fused_index_plain`; a CUDA frontier launches the K3
    kernel (``csrc/bitmap_spmm_fused.cu``) and its carry pass."""
    _check_frontier("h", h)
    _check_frontier("x", x)
    if h.shape[1] != x.shape[1] or h.device != x.device:
        raise ValueError(
            f"h and x must share the feature axis and device: "
            f"{tuple(h.shape)} on {h.device} vs {tuple(x.shape)} on {x.device}"
        )
    for name, t in (("row_ptr", row_ptr), ("col", col), ("weight", weight)):
        _check_index(name, t, x.device)
    if weight.shape != col.shape:
        raise ValueError("col and weight must name the same entries")
    _check_out(n_out, row_ptr)
    if x.device.type == "cpu":
        return bitmap_spmm_fused_index_plain(row_ptr, col, weight, h, x, n_out, range_items)
    from .build import load

    n_feat = int(x.shape[1])
    y = torch.empty((n_out, n_feat), dtype=torch.float32, device=x.device)
    vec, log_g, items, n_groups = _grid((h, x), n_out, int(col.shape[0]), range_items)
    carry_rows = torch.empty(n_groups, dtype=torch.int32, device=x.device)
    carry_vals = torch.empty(4 * n_groups * n_feat, dtype=torch.float32, device=x.device)
    rc = load("bitmap_spmm_fused").bitmap_spmm_fused_launch(
        _ptr(row_ptr), _ptr(col), _ptr(weight), _ptr(h), _ptr(x), _ptr(y), n_out, n_feat,
        vec, log_g, items, n_groups, _ptr(carry_rows), _ptr(carry_vals),
        x.device.index or 0, _stream(x.device),
    )
    if rc != 0:
        raise RuntimeError(f"bitmap_spmm_fused launch failed: CUDA error {rc}")
    LAUNCHES["bitmap_spmm_fused"] += 1
    return y
