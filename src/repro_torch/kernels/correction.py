"""Bit-plane packing of the DEDUP-C correction + fused-stream assembly.

The DEDUP-C correction is a sparse integer matrix ``D`` of duplicate-path
counts: ring propagation is made exact by ``y = M x − D x`` (paper §4.1).
Until now ``D x`` ran as a separate gather + ``segment_sum`` with the
subtraction applied on the result — a second pass over ``x`` outside the
kernel.  This module feeds the subtraction *into* the fused kernel's
epilogue (DESIGN.md §6); it is the port's byte-identical copy of the JAX
package's module of the same name:

* :func:`pack_correction` decomposes the counts into bit-planes,
  ``D = Σ_k 2^k · D_k`` with each ``D_k`` a 0/1 incidence — so every
  plane packs into the same 128x128 uint32 bitmaps the main kernel
  already streams, and ``D x`` becomes ``Σ_k 2^k (D_k x)``: plain
  bit-packed SpMMs scaled by exact powers of two (the scaling loses no
  float precision, so integer-valued frontiers stay byte-identical to
  the two-pass ``segment_sum`` result).
* :func:`build_fused_stream` interleaves the final layer's incidence
  slots with the correction slots, per destination row tile (main slots
  first, then that tile's correction slots), the layout the JAX
  package's fused kernel walks with two accumulators.  The port's fused
  kernel (:func:`repro_torch.kernels.bitmap_spmm.bitmap_spmm_fused`)
  reads the same operands — main bitmaps add their rows' sums,
  correction planes subtract ``2^k`` times theirs — in one launch.

Host-side numpy only; uploading is the engine's job.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .pack import TILE, WORDS, BlockSparseBitmap

__all__ = ["CorrectionPlanes", "FusedStream", "pack_correction", "build_fused_stream"]


@dataclasses.dataclass
class CorrectionPlanes:
    """Bit-plane packed correction: rows = dst, cols = src, one bitmap
    stack per nonzero block, one plane per count bit.  Unlike
    :class:`~repro_torch.kernels.pack.BlockSparseBitmap` there are *no* pad
    slots — empty row tiles simply contribute no correction slots (the
    fused stream's main slots already visit every row tile)."""

    slot_src: np.ndarray       # (n_slots,) int32 — source tile per block
    slot_row: np.ndarray       # (n_slots,) int32 — dst row tile per block
    row_start: np.ndarray      # (n_rt,) int32
    row_count: np.ndarray      # (n_rt,) int32 — may be zero
    planes: np.ndarray         # (n_slots, n_planes, TILE, WORDS) uint32
    plane_weights: Tuple[float, ...]  # 2**k per plane
    n_dst: int
    n_src: int

    @property
    def n_slots(self) -> int:
        return int(self.slot_src.shape[0])

    @property
    def n_planes(self) -> int:
        return int(self.planes.shape[1])

    @property
    def n_src_tiles(self) -> int:
        return max(-(-self.n_src // TILE), 1)

    @property
    def n_row_tiles(self) -> int:
        return int(self.row_start.shape[0])

    def to_dense(self) -> np.ndarray:
        """Oracle helper: dense (n_dst_pad, n_src_pad) count matrix."""
        dense = np.zeros(
            (self.n_row_tiles * TILE, self.n_src_tiles * TILE), np.float64
        )
        shifts = np.arange(32, dtype=np.uint32)
        for s in range(self.n_slots):
            i, b = int(self.slot_row[s]), int(self.slot_src[s])
            for k, w in enumerate(self.plane_weights):
                bits = (
                    (self.planes[s, k][:, :, None] >> shifts) & 1
                ).reshape(TILE, TILE)
                dense[i * TILE : (i + 1) * TILE, b * TILE : (b + 1) * TILE] += (
                    w * bits
                )
        return dense


def pack_correction(
    cs: np.ndarray, cd: np.ndarray, cm: np.ndarray, n_src: int, n_dst: int
) -> CorrectionPlanes:
    """Pack correction triples (src, dst, count) into bit-planes.

    ``count`` must be positive integers (duplicate-path counts are);
    ``n_planes`` is the bit width of the largest count, so typical
    corrections (counts 1–3) cost one or two planes.
    """
    cs = np.asarray(cs, dtype=np.int64)
    cd = np.asarray(cd, dtype=np.int64)
    cm = np.asarray(cm)
    cmi = cm.astype(np.int64)
    if cs.size and (np.any(cmi <= 0) or np.any(cmi != cm)):
        raise ValueError("correction counts must be positive integers")
    n_rt = max(-(-n_dst // TILE), 1)
    n_st = max(-(-n_src // TILE), 1)
    n_planes = max(int(cmi.max()).bit_length(), 1) if cs.size else 1
    bkey = (cd // TILE) * n_st + (cs // TILE)
    uniq, inv = np.unique(bkey, return_inverse=True)
    n_slots = uniq.size
    slot_row = (uniq // n_st).astype(np.int32)
    slot_src = (uniq % n_st).astype(np.int32)
    row_count = np.bincount(slot_row, minlength=n_rt).astype(np.int32)
    row_start = np.concatenate([[0], np.cumsum(row_count[:-1])]).astype(np.int32)
    r = cd % TILE
    c = cs % TILE
    word = c // 32
    bit = (c % 32).astype(np.uint32)
    flat = np.zeros(n_slots * n_planes * TILE * WORDS, dtype=np.uint32)
    for k in range(n_planes):
        sel = ((cmi >> k) & 1).astype(bool)
        if not sel.any():
            continue
        lin = ((inv[sel] * n_planes + k) * TILE + r[sel]) * WORDS + word[sel]
        np.bitwise_or.at(flat, lin, np.uint32(1) << bit[sel])
    return CorrectionPlanes(
        slot_src=slot_src,
        slot_row=slot_row,
        row_start=row_start,
        row_count=row_count,
        planes=flat.reshape(n_slots, n_planes, TILE, WORDS),
        plane_weights=tuple(float(2**k) for k in range(n_planes)),
        n_dst=n_dst,
        n_src=n_src,
    )


@dataclasses.dataclass
class FusedStream:
    """The combined slot stream the fused kernel walks: per destination
    row tile, the main incidence slots (kind 0) followed by that tile's
    correction slots (kind 1).  ``main_idx``/``corr_idx`` index into the
    respective bitmap/plane stacks; the inactive index of each slot is 0
    (the fetched-but-unused operand is mathematically inert).  Likewise
    ``main_src``/``corr_src`` route the two streamed feature operands
    (``h`` — the last hidden frontier — and ``x`` — the original input)."""

    kind: np.ndarray       # (n_slots,) int32 — 0 main, 1 correction
    main_src: np.ndarray   # (n_slots,) int32 — h source tile
    corr_src: np.ndarray   # (n_slots,) int32 — x source tile
    main_idx: np.ndarray   # (n_slots,) int32 — index into main bitmaps
    corr_idx: np.ndarray   # (n_slots,) int32 — index into corr planes
    slot_row: np.ndarray   # (n_slots,) int32
    row_start: np.ndarray  # (n_rt,) int32
    row_count: np.ndarray  # (n_rt,) int32

    @property
    def n_slots(self) -> int:
        return int(self.kind.shape[0])


def build_fused_stream(
    main: BlockSparseBitmap, corr: CorrectionPlanes
) -> FusedStream:
    """Interleave a layer's packed incidence with the packed correction.

    Both must share the destination space (``n_dst``) — the fused kernel
    writes each output row tile exactly once, after *all* of its main and
    correction slots have accumulated.  The main packing's pad-slot
    invariant (every row tile has ≥ 1 slot) carries over, so first/last
    bookkeeping needs no special cases.
    """
    if main.n_dst != corr.n_dst:
        raise ValueError(
            f"fused stream needs a shared destination space: "
            f"main n_dst={main.n_dst}, correction n_dst={corr.n_dst}"
        )
    if main.n_row_tiles != corr.n_row_tiles:
        raise ValueError("row-tile counts disagree")
    m, c = main.n_slots, corr.n_slots
    rows = np.concatenate([main.slot_row, corr.slot_row]).astype(np.int64)
    kind = np.concatenate(
        [np.zeros(m, np.int32), np.ones(c, np.int32)]
    )
    # stable sort by (row, kind): keeps each group's internal order, puts
    # main slots before correction slots within a row tile
    order = np.argsort(rows * 2 + kind, kind="stable")
    zeros_m = np.zeros(m, np.int32)
    zeros_c = np.zeros(c, np.int32)
    main_idx = np.concatenate([np.arange(m, dtype=np.int32), zeros_c])
    corr_idx = np.concatenate([zeros_m, np.arange(c, dtype=np.int32)])
    main_src = np.concatenate([main.slot_src.astype(np.int32), zeros_c])
    corr_src = np.concatenate([zeros_m, corr.slot_src.astype(np.int32)])
    row_count = (main.row_count + corr.row_count).astype(np.int32)
    row_start = np.concatenate([[0], np.cumsum(row_count[:-1])]).astype(np.int32)
    return FusedStream(
        kind=kind[order],
        main_src=main_src[order],
        corr_src=corr_src[order],
        main_idx=main_idx[order],
        corr_idx=corr_idx[order],
        slot_row=rows[order].astype(np.int32),
        row_start=row_start,
        row_count=row_count,
    )
