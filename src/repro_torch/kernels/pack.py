"""Host-side packing: BipartiteEdges -> bit-packed block-sparse incidence.

The 0/1 incidence matrix of a condensed layer is tiled into 128x128
blocks; only nonzero blocks are stored, each as a 128x4 uint32 bitmap
(2 KiB instead of 64 KiB of float32).  The layout is byte-identical to the
JAX package's ``kernels/pack.py``, so both packages' kernels read the
same operands.

Layout (streamed slot list + run table):
    slot_src  : (n_slots,) int32  — source-tile index per nonzero block
    slot_row  : (n_slots,) int32  — dst row-tile index per nonzero block
    bitmaps   : (n_slots, TILE, TILE//32) uint32; bit ``j`` of word ``w``
                in row ``r`` is column ``32·w + j``
    row_start : (n_row_tiles,) int32 — first slot of each row tile
    row_count : (n_row_tiles,) int32 — slots in each row tile

Slots are sorted by (row tile, source tile), so each row tile's source
blocks form one contiguous run.  Every row tile owns at least one slot
(empty rows get a single all-zero pad bitmap, mathematically inert) so
each output tile is visited and written exactly once.

Admission.  The JAX package admits a layer to its TPU kernel only while
the slot tables fit scalar memory and the streamed window fits VMEM.  The
CUDA kernels use no shared memory: the slot tables stay in device memory
and each thread block reads its own slice of the slot list, so any layer
that packs can be served, whatever its slot count.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.condensed import BipartiteEdges

TILE = 128
WORDS = TILE // 32

# Bit-field widths of pack_bipartite's combined sort key; derived from
# the tile constants so the layout can't silently drift from them.
_R_BITS = TILE.bit_length() - 1          # row-in-tile
_W_BITS = WORDS.bit_length() - 1         # word-in-row
_B_BITS = 5                              # bit-in-word (uint32)

__all__ = [
    "BlockSparseBitmap",
    "pack_bipartite",
    "merge_block_sparse",
    "TILE",
    "WORDS",
]


@dataclasses.dataclass
class BlockSparseBitmap:
    """Destination-major packed incidence: rows = dst, cols = src."""

    slot_src: np.ndarray   # (n_slots,) int32
    slot_row: np.ndarray   # (n_slots,) int32
    bitmaps: np.ndarray    # (n_slots, TILE, WORDS) uint32
    row_start: np.ndarray  # (n_row_tiles,) int32
    row_count: np.ndarray  # (n_row_tiles,) int32
    n_dst: int             # logical rows
    n_src: int             # logical cols

    @property
    def n_slots(self) -> int:
        return int(self.slot_src.shape[0])

    @property
    def n_row_tiles(self) -> int:
        return int(self.row_start.shape[0])

    @property
    def n_src_tiles(self) -> int:
        # min 1: pad slots index source tile 0
        return max(-(-self.n_src // TILE), 1)

    def nbytes(self) -> int:
        return int(
            self.slot_src.nbytes
            + self.slot_row.nbytes
            + self.bitmaps.nbytes
            + self.row_start.nbytes
            + self.row_count.nbytes
        )

    def to_dense(self) -> np.ndarray:
        """Oracle helper: dense (n_dst_pad, n_src_pad) 0/1 matrix."""
        dense = np.zeros(
            (self.n_row_tiles * TILE, self.n_src_tiles * TILE), dtype=np.float32
        )
        shifts = np.arange(32, dtype=np.uint32)
        for s in range(self.n_slots):
            w = self.bitmaps[s]
            if not w.any():
                continue
            bits = ((w[:, :, None] >> shifts) & 1).reshape(TILE, TILE)
            i = int(self.slot_row[s])
            b = int(self.slot_src[s])
            dense[i * TILE : (i + 1) * TILE, b * TILE : (b + 1) * TILE] += bits
        return dense


def _slot_layout(ub_rows: np.ndarray, ub_cols: np.ndarray, n_rt: int):
    """Canonical slot-stream layout from sorted unique (row, src) blocks:
    per row tile, real slots in ascending source order, one all-zero pad
    slot for each empty row tile.  Shared by :func:`pack_bipartite` and
    :func:`merge_block_sparse` so a merged pack is byte-identical to a
    one-shot pack."""
    counts = np.bincount(ub_rows, minlength=n_rt)
    empty = np.flatnonzero(counts == 0)
    all_rows = np.concatenate([ub_rows, empty])
    all_cols = np.concatenate([ub_cols, np.zeros(empty.size, dtype=np.int64)])
    order = np.argsort(all_rows, kind="stable")
    slot_row = all_rows[order].astype(np.int32)
    slot_src = all_cols[order].astype(np.int32)
    n_slots = slot_row.size
    slot_of = np.empty(n_slots, dtype=np.int64)
    slot_of[order] = np.arange(n_slots)
    row_count = np.bincount(slot_row, minlength=n_rt).astype(np.int32)
    row_start = np.concatenate(
        [[0], np.cumsum(row_count[:-1])]
    ).astype(np.int32)
    return slot_row, slot_src, row_start, row_count, slot_of, n_slots


def _popcount(bitmaps: np.ndarray) -> int:
    """Total set bits across a bitmap stack (the packed edge count)."""
    fn = getattr(np, "bitwise_count", None)
    if fn is not None:
        return int(fn(bitmaps).sum())
    return int(np.unpackbits(bitmaps.view(np.uint8)).sum())


def merge_block_sparse(parts: "list[BlockSparseBitmap]") -> BlockSparseBitmap:
    """Merge per-shard packed incidences into one (DESIGN.md §7).

    Every part must pack a disjoint edge subset of the *same* logical
    matrix (equal ``n_dst``/``n_src``).  Slots sharing a (row tile, src
    tile) block are OR-folded; pad slots are dropped and re-derived; the
    canonical slot ordering is rebuilt — so the result is byte-identical
    to packing all edges at once, which is what lets sharded extraction
    build ``DevicePackedLayer`` operands shard-at-a-time without ever
    sorting the full edge list in one shot.  Overlapping edges (the same
    (src, dst) cell set in two parts) are rejected, matching
    :func:`pack_bipartite`'s duplicate check.
    """
    if not parts:
        raise ValueError("merge_block_sparse needs at least one part")
    n_dst, n_src = parts[0].n_dst, parts[0].n_src
    for p in parts:
        if p.n_dst != n_dst or p.n_src != n_src:
            raise ValueError("parts disagree on logical matrix shape")
    n_rt = max(-(-n_dst // TILE), 1)
    n_st = max(-(-n_src // TILE), 1)
    keys, lives = [], []
    total_bits = 0
    for p in parts:
        live = p.bitmaps.reshape(-1, TILE * WORDS).any(axis=1)  # drop pad slots
        keys.append(p.slot_row[live].astype(np.int64) * n_st + p.slot_src[live])
        lives.append(live)
        total_bits += _popcount(p.bitmaps)  # pad slots hold no bit
    uniq = np.unique(np.concatenate(keys)) if keys else np.empty(0, np.int64)
    slot_row, slot_src, row_start, row_count, slot_of, n_slots = _slot_layout(
        uniq // n_st, uniq % n_st, n_rt
    )
    # each part's live blocks go straight to their merged slots (slot_of[j]:
    # the slot of sorted block j), the first part's copied, the others'
    # OR-folded in; a part holds each block once, and pad slots stay zero.
    # Rows of 512 words index faster than (128, 4) blocks.
    bitmaps = np.zeros((n_slots, TILE * WORDS), dtype=np.uint32)
    for i, (p, key, live) in enumerate(zip(parts, keys, lives)):
        dest = slot_of[np.searchsorted(uniq, key)]
        rows = p.bitmaps.reshape(-1, TILE * WORDS)[live]
        if i == 0:
            bitmaps[dest] = rows
        else:
            bitmaps[dest] |= rows
    if _popcount(bitmaps) != total_bits:
        raise ValueError(
            "merge_block_sparse requires disjoint edge shards "
            "(a (src, dst) cell is set in more than one part)"
        )
    return BlockSparseBitmap(
        slot_src=slot_src,
        slot_row=slot_row,
        bitmaps=bitmaps.reshape(n_slots, TILE, WORDS),
        row_start=row_start,
        row_count=row_count,
        n_dst=n_dst,
        n_src=n_src,
    )


def pack_bipartite(
    edges: BipartiteEdges,
    method: str = "reduceat",
    shard_edges: Optional[int] = None,
) -> BlockSparseBitmap:
    """Pack dst-major: y[dst] += x[src]  ==  y = B @ x with B[dst, src]=1.

    Duplicate (src, dst) pairs are rejected with ``ValueError`` — a bitmap
    holds one bit per cell (condensed incidence layers are duplicate-free
    by construction; multiplicity lives across *paths*, not within a
    layer).  One sort by a combined (block, row, word, bit) key yields the
    duplicate check, the block grouping and the word runs, folded with
    one ``np.bitwise_or.reduceat`` pass (the JAX package's default
    ``'reduceat'`` method, the port's only one: ``'scatter'``, the JAX
    package's baseline for ``measure_pack_throughput``, waits for
    ``core/cost.py``, ROADMAP.md Queue 1 item 2, and raises
    ``NotImplementedError``).

    ``shard_edges`` bounds the edges packed in one shot (DESIGN.md §7):
    larger edge lists are packed slice by slice and OR-merged
    *incrementally* with :func:`merge_block_sparse` — byte-identical
    output, with resident packing state bounded by the accumulated packed
    form plus one slice's pack.
    """
    if method == "scatter":
        raise NotImplementedError(
            "pack method 'scatter' is not ported yet (ROADMAP.md, Queue 1 "
            "item 2: core/cost.py with measure_pack_throughput)"
        )
    if method != "reduceat":
        raise ValueError(f"unknown pack method {method!r}")
    if shard_edges is not None and edges.n_edges > shard_edges:
        width = max(int(shard_edges), 1)
        acc: Optional[BlockSparseBitmap] = None
        for lo in range(0, edges.n_edges, width):
            part = pack_bipartite(
                BipartiteEdges(
                    edges.src[lo : lo + width],
                    edges.dst[lo : lo + width],
                    edges.n_src,
                    edges.n_dst,
                ),
            )
            acc = part if acc is None else merge_block_sparse([acc, part])
        assert acc is not None
        return acc
    src = edges.src
    dst = edges.dst
    n_rt = max(-(-edges.n_dst // TILE), 1)
    n_st = max(-(-edges.n_src // TILE), 1)
    bd = dst // TILE
    bs = src // TILE
    r = (dst % TILE).astype(np.int64)
    c = (src % TILE).astype(np.int64)
    word = c // 32
    bit = (c % 32).astype(np.uint32)
    bkey = bd.astype(np.int64) * n_st + bs

    low = _R_BITS + _W_BITS + _B_BITS
    full = (
        (bkey << low)
        | (r << (_W_BITS + _B_BITS))
        | (word << _B_BITS)
        | bit
    )
    order_e = np.argsort(full, kind="stable")
    full_s = full[order_e]
    if full_s.size and np.any(full_s[1:] == full_s[:-1]):
        raise ValueError("pack_bipartite requires duplicate-free edges")
    bkey_s = full_s >> low
    block_bounds = np.flatnonzero(
        np.r_[True, bkey_s[1:] != bkey_s[:-1]]
    ) if bkey_s.size else np.empty(0, dtype=np.int64)
    uniq = bkey_s[block_bounds] if bkey_s.size else np.empty(0, np.int64)

    # pad every empty row tile with one all-zero slot so each output tile
    # is visited (and therefore written) by the kernel
    slot_row, slot_src, row_start, row_count, slot_of, n_slots = _slot_layout(
        uniq // n_st, uniq % n_st, n_rt
    )

    flat = np.zeros(n_slots * TILE * WORDS, dtype=np.uint32)
    if src.size:
        # slot_of is monotone over sorted blocks (pads append after each
        # row's real slots), so the sorted edge order is also sorted by
        # (slot, row, word): reduceat folds each word run
        block_of_edge = np.repeat(
            slot_of[: uniq.size],
            np.diff(np.r_[block_bounds, full_s.size]),
        )
        rw_s = (full_s >> _B_BITS) & (TILE * WORDS - 1)
        lin_s = (block_of_edge << (_R_BITS + _W_BITS)) | rw_s
        starts = np.flatnonzero(np.r_[True, lin_s[1:] != lin_s[:-1]])
        vals_s = np.uint32(1) << bit[order_e]
        flat[lin_s[starts]] = np.bitwise_or.reduceat(vals_s, starts)
    bitmaps = flat.reshape(n_slots, TILE, WORDS)
    return BlockSparseBitmap(
        slot_src=slot_src,
        slot_row=slot_row,
        bitmaps=bitmaps,
        row_start=row_start,
        row_count=row_count,
        n_dst=edges.n_dst,
        n_src=edges.n_src,
    )
