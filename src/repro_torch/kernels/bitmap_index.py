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

A build on the card runs in chunks of each row tile's slots
(:func:`chunk_table`: at most ``U`` 2 KiB units a chunk, a main slot one
unit and a correction slot ``P``), in this sequence: the chunk table
(tensor ops), the count pass (one block a chunk: each row's entry count
and a mask of its non-empty slots), one ``torch.cumsum`` over the counts,
which the count pass lays out in output order, the one read back of the
entry count, and the fill pass (row_ptr, col, weight).
:func:`bitmap_index_chunked_plain` and
:func:`bitmap_index_fused_chunked_plain` run that schedule step by step in
PyTorch, so that the CPU tests hold its arithmetic to the plain versions.

A wrapper takes its plain version when the operands lie on the CPU; on
CUDA tensors it launches the kernels or raises.  Every build on the card
adds one to its entry in :data:`INDEX_BUILDS`, apart from the SpMM
kernels' ``LAUNCHES`` (builds happen at upload, before a served run), and
leaves its grid and chunk count in :data:`LAST_GRID`.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from .pack import TILE, WORDS

__all__ = [
    "CHUNK_UNITS",
    "INDEX_BUILDS",
    "LAST_GRID",
    "chunk_schedule",
    "chunk_table",
    "bitmap_index_chunked_plain",
    "bitmap_index_fused_chunked_plain",
    "bitmap_index",
    "bitmap_index_plain",
    "bitmap_index_fused",
    "bitmap_index_fused_plain",
]

# builder -> index builds on the card since the process started
INDEX_BUILDS: Dict[str, int] = {"bitmap_index": 0, "bitmap_index_fused": 0}

# builder -> (grid, chunks) of its last build on the card: the blocks each
# pass launched, and the chunks the stream's row tiles took of them
LAST_GRID: Dict[str, Tuple[int, int]] = {}

# U: 2 KiB units a chunk of the kernels' grid (a main slot 1, a correction
# slot P), read at each build; at most MAX_CHUNK_SLOTS, since a chunk's slots
# are one bit each in a 32-bit mask
CHUNK_UNITS = 32
MAX_CHUNK_SLOTS = 32


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
# The chunk table and the plain mirror of the kernels' schedule
# ---------------------------------------------------------------------------

def _check_units(chunk_units: int) -> None:
    if not 1 <= chunk_units <= MAX_CHUNK_SLOTS:
        raise ValueError(f"chunk_units={chunk_units}: a chunk holds 1 to {MAX_CHUNK_SLOTS} "
                         "units, one mask bit a slot")


def chunk_table(
    row_start: torch.Tensor,
    row_count: torch.Tensor,
    slot_row: torch.Tensor,
    slot_units: Optional[torch.Tensor],
    n_chunks: int,
    chunk_units: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(base, first)`` int32, on the run table's device: the kernels'
    chunks of each row tile's slot run.

    Chunks are windows of ``U`` units on the stream's unit axis, cut where
    a row tile ends: slot ``s`` of tile ``t`` lies in chunk ``floor(o / U) +
    t``, ``o`` the units of the stream's slots before it (``slot_units``: a
    main slot 1, a correction slot ``P``; ``None``: every slot 1).  Tile
    ``t``'s chunks are ``[base[t-1], base[t])``, ``base[t] = floor(o_end /
    U) + t + 1`` with ``o_end`` the units before the tile's end: one chunk
    more than the windows it touches, empty, where ``U`` divides
    ``o_end``, so a tile with no slot still has one.  ``first``
    (``n_chunks + 1``) gives chunk ``c`` the slots ``[first[c],
    first[c+1])``; chunks from ``base[-1]`` on are empty.  The run table
    must be contiguous from slot 0, as the packers lay it out.

    For one direction (``slot_units=None``) both have closed forms in the
    run table, ``base[t] = (row_start[t] + row_count[t]) // U + t + 1`` and
    the slots ``[(c - t) U, (c - t) U + U)`` of tile ``t``, which the
    kernels evaluate themselves: each op here is a launch on the host's
    clock.  This function gives them as tensors, for the mirror and the
    tests, and builds the fused stream's, whose units need a scan."""
    _check_units(chunk_units)
    U, n_rt, n_slots = chunk_units, int(row_start.shape[0]), int(slot_row.shape[0])
    i32 = dict(dtype=torch.int32, device=row_start.device)
    before = torch.zeros(n_slots + 1, **i32)  # units before each slot, then the total
    if slot_units is None:
        torch.arange(1, n_slots + 1, out=before[1:])
    else:
        torch.cumsum(slot_units, 0, dtype=torch.int32, out=before[1:])
    base = (before.index_select(0, row_start + row_count) // U
            + torch.arange(1, n_rt + 1, **i32))
    key = before[:-1] // U + slot_row  # each slot's chunk
    return base, torch.searchsorted(key, torch.arange(n_chunks + 1, **i32), out_int32=True)


def chunk_schedule(
    slot_row: torch.Tensor,
    row_start: torch.Tensor,
    row_count: torch.Tensor,
    kind: Optional[torch.Tensor] = None,
    planes: Optional[torch.Tensor] = None,
    *,
    chunk_units: Optional[int] = None,
    table: bool = True,
) -> Tuple[int, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``(grid, base, first)``: the kernels' chunks of a stream (its run
    table in the builders' order), at ``chunk_units`` (default
    :data:`CHUNK_UNITS`).  One direction passes no
    ``kind`` / ``planes`` (every slot one unit); in the fused stream a main
    slot is one unit and a correction slot ``P``.  ``grid`` is known on the
    host, ``n_rt + floor(units / U)`` over the stream's units: exact for one
    direction, and for the fused stream a bound that counts one correction
    slot per plane unit.  ``base`` / ``first`` are :func:`chunk_table`'s,
    or ``None`` with ``table=False``."""
    U = CHUNK_UNITS if chunk_units is None else chunk_units
    _check_units(U)
    n_slots = int(slot_row.shape[0])
    slot_units, n_units = None, n_slots
    if kind is not None:
        n_planes = int(planes.shape[1])
        slot_units = kind * (n_planes - 1) + 1
        n_units = n_slots + (n_planes - 1) * int(planes.shape[0])
    grid = int(row_start.shape[0]) + n_units // U
    if not table:
        return grid, None, None
    return (grid, *chunk_table(row_start, row_count, slot_row, slot_units, grid, U))


def _chunked_plain(stream: dict, chunk_units: Optional[int]):
    """The kernels' schedule step by step on the operands' device: the chunk
    table, each (chunk, row)'s count and slot mask, the counts in output
    order and their scan, row_ptr from it, and each entry written at its
    (chunk, row)'s cursor.  ``(row_ptr, col, weight)``."""
    chunk_units = CHUNK_UNITS if chunk_units is None else chunk_units
    row_start, row_count, slot_row = stream["row_start"], stream["row_count"], stream["slot_row"]
    present, src_tile, weight_of = stream["present"], stream["src_tile"], stream["weight_of"]
    device, n_rt, n_slots = row_start.device, int(row_start.shape[0]), int(slot_row.shape[0])
    n_chunks, base, first = chunk_schedule(slot_row, row_start, row_count, stream["kind"],
                                           stream["planes"], chunk_units=chunk_units)
    base, first, chunk = base.long(), first.long(), torch.arange(n_chunks, device=device)
    tile = torch.searchsorted(base, chunk, right=True)  # the kernels' warp search
    real = tile < n_rt
    t = tile.clamp(max=n_rt - 1)
    base0 = torch.cat([base.new_zeros(1), base[:-1]])[t]  # the tile's first chunk
    k, n_tc = chunk - base0, base[t] - base0
    s0, s1 = first[:-1], first[1:]
    if stream["kind"] is None:  # the closed forms the kernels evaluate
        rs, rc = row_start.long(), row_count.long()
        if not torch.equal(base, (rs + rc) // chunk_units + torch.arange(1, n_rt + 1)):
            raise AssertionError("one direction's chunk ends differ from their closed form")
        w = (chunk - t) * chunk_units
        if not (torch.equal(s0[real], torch.maximum(rs[t], w)[real])
                and torch.equal(s1[real], torch.minimum(rs[t] + rc[t], w + chunk_units)[real])):
            raise AssertionError("one direction's chunk slots differ from their closed form")
    if int(base[-1]) > n_chunks:
        raise ValueError(f"{int(base[-1])} chunks exceed the grid's {n_chunks}: the stream "
                         "names more correction slots than it has plane units")
    if int((s1 - s0).sum()) != n_slots or bool((s1 - s0 > MAX_CHUNK_SLOTS).any()):
        raise AssertionError("the chunk table does not cut the slots into runs of 32 at most")
    cid = torch.repeat_interleave(chunk, s1 - s0)  # each slot's chunk
    in_chunk = torch.arange(n_slots, device=device) - s0[cid]
    # pass 1: counts and masks per (chunk, row)
    per_row = torch.zeros(n_slots, TILE, dtype=torch.int64, device=device)
    if n_slots:
        shifts = torch.arange(32, dtype=torch.int64, device=device)
        words = present.to(torch.int64) & 0xFFFFFFFF
        per_row = ((words[..., None] >> shifts) & 1).sum(dim=(2, 3))
    counts = torch.zeros(n_chunks, TILE, dtype=torch.int64, device=device)
    counts.index_add_(0, cid, per_row)
    masks = torch.zeros(n_chunks, TILE, dtype=torch.int64, device=device)
    masks.index_add_(0, cid, (per_row > 0).long() << in_chunk[:, None])
    # the counts in output order (tile, row, chunk), one flat scan
    rows = torch.arange(TILE, device=device)
    at = torch.where(real[:, None], base0[:, None] * TILE + rows * n_tc[:, None] + k[:, None],
                     chunk[:, None] * TILE + rows)
    flat = torch.zeros(n_chunks * TILE, dtype=torch.int64, device=device)
    flat[at.reshape(-1)] = counts.reshape(-1)
    scan = torch.cumsum(flat, 0)
    nnz = int(scan[-1])
    cursor = torch.where(at > 0, scan[(at - 1).clamp(min=0)], 0)
    row_ptr = torch.empty(n_rt * TILE + 1, dtype=torch.int64, device=device)
    head = real & (k == 0)
    row_ptr[(t[head, None] * TILE + rows).reshape(-1)] = cursor[head].reshape(-1)
    row_ptr[-1] = nnz
    # pass 2: each entry at its (chunk, row)'s cursor, slots in mask order,
    # columns ascending within a slot
    slot, row, col = _set_bits(present)
    if bool((((masks[cid[slot], row] >> in_chunk[slot]) & 1) == 0).any()):
        raise AssertionError("an entry lies in a slot its (chunk, row) mask leaves out")
    group = cid[slot] * TILE + row
    order = torch.argsort(group, stable=True)
    group = group[order]
    rank = torch.arange(group.shape[0], device=device)
    rank = rank - torch.searchsorted(group, group)  # entries before it in its group
    pos = cursor[cid[slot[order]], row[order]] + rank
    if not torch.equal(torch.sort(pos).values, torch.arange(nnz, device=device)):
        raise AssertionError("the cursors do not place every entry exactly once")
    out_col = torch.empty(nnz, dtype=torch.int64, device=device)
    out_weight = torch.empty(nnz, dtype=torch.int64, device=device)
    out_col[pos] = (src_tile.long()[slot] * TILE + col)[order]
    out_weight[pos] = weight_of(slot, row, col)[order]
    return row_ptr.to(torch.int32), out_col.to(torch.int32), out_weight.to(torch.int32)


def bitmap_index_chunked_plain(
    slot_src: torch.Tensor,
    slot_row: torch.Tensor,
    row_start: torch.Tensor,
    row_count: torch.Tensor,
    bitmaps: torch.Tensor,
    chunk_units: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain mirror of :func:`bitmap_index`'s kernels: the same chunks,
    counts, scan and cursors, so its output equals
    :func:`bitmap_index_plain`'s byte for byte (the tests hold it so)."""
    stream = {"row_start": row_start, "row_count": row_count, "slot_row": slot_row,
              "kind": None, "planes": None, "present": bitmaps, "src_tile": slot_src,
              "weight_of": lambda s, r, c: torch.zeros_like(c)}
    row_ptr, col, _ = _chunked_plain(stream, chunk_units)
    return row_ptr, col


def bitmap_index_fused_chunked_plain(
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
    chunk_units: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain mirror of :func:`bitmap_index_fused`'s kernels (see
    :func:`bitmap_index_chunked_plain`); the grid is bounded as the wrapper
    bounds it, and a stream that overruns it is refused the same way."""
    n_planes = int(planes.shape[1])
    corr = kind != 0
    c_slots = torch.nonzero(corr).squeeze(1)
    c_planes = planes.index_select(0, corr_idx[c_slots].long())
    union = c_planes[:, 0]
    for q in range(1, n_planes):
        union = union | c_planes[:, q]
    present = bitmaps.index_select(0, torch.where(corr, 0, main_idx).long())
    present[c_slots] = union
    c_of_slot = (torch.cumsum(corr, 0) - 1).clamp(min=0)  # each slot's row of c_planes
    scale = torch.tensor([int(w) for w in plane_weights], dtype=torch.int64, device=kind.device)

    def weight_of(s, r, c):
        is_c = corr[s]
        s, r, c = s[is_c], r[is_c], c[is_c]
        bits = (c_planes[c_of_slot[s], :, r, c // 32].to(torch.int64) & 0xFFFFFFFF) >> (c % 32)[:, None]
        out = torch.zeros(is_c.shape[0], dtype=torch.int64, device=kind.device)
        out[is_c] = ((bits & 1) * scale).sum(dim=1)
        return out

    stream = {"row_start": row_start, "row_count": row_count, "slot_row": slot_row,
              "kind": kind, "planes": planes, "present": present,
              "src_tile": torch.where(corr, corr_src, main_src), "weight_of": weight_of}
    return _chunked_plain(stream, chunk_units)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _build(name: str, stream: tuple, row_start: torch.Tensor, row_count: torch.Tensor,
           slot_row: torch.Tensor, kind: Optional[torch.Tensor] = None,
           planes: Optional[torch.Tensor] = None):
    """The two launches and the scan between them on the operands' device,
    at :data:`CHUNK_UNITS`: ``(row_ptr, col, weight or None)``.  The fused
    stream passes its ``kind`` and ``planes``."""
    from .build import load

    lib = load("bitmap_index")
    fused = kind is not None
    device = row_start.device
    n_rt = int(row_start.shape[0])
    if n_rt == 0:
        LAST_GRID[name] = (0, 0)
        empty = torch.empty(0, dtype=torch.int32, device=device)
        return torch.zeros(1, dtype=torch.int32, device=device), empty, empty if fused else None
    units = CHUNK_UNITS
    # one direction: the kernels evaluate the table's closed forms
    n_chunks, base, first = chunk_schedule(slot_row, row_start, row_count, kind, planes,
                                           chunk_units=units, table=fused)
    counts = torch.empty(n_chunks * TILE + 1, dtype=torch.int32, device=device)
    masks = torch.empty(n_chunks * TILE, dtype=torch.int32, device=device)
    row_ptr = torch.empty(n_rt * TILE + 1, dtype=torch.int32, device=device)
    table = (None if base is None else _ptr(base), None if first is None else _ptr(first),
             n_rt, n_chunks, units)
    n_planes = 1 if planes is None else int(planes.shape[1])
    tail = (device.index or 0, _stream(device))
    _raise_on(lib.bitmap_index_count_launch(*stream, n_planes, *table, _ptr(counts),
                                            _ptr(masks), *tail), name)
    counts.cumsum_(0)
    # the one read back: entries, chunks past the grid, and the fused
    # stream's chunks (one direction's fill the grid)
    back = counts[-2:] if base is None else torch.cat((counts[-2:], base[-1:]))
    nnz, total, *chunks = back.tolist()
    if total != nnz:
        raise ValueError(f"{name}: the stream needs {total - nnz} chunks past the grid: it "
                         "names more correction slots than it has plane units")
    col = torch.empty(nnz, dtype=torch.int32, device=device)
    weight = torch.empty(nnz, dtype=torch.int32, device=device) if fused else None
    _raise_on(lib.bitmap_index_fill_launch(*stream, n_planes, *table, _ptr(counts), _ptr(masks),
                                           nnz, _ptr(row_ptr), _ptr(col),
                                           None if weight is None else _ptr(weight), *tail),
              name)
    INDEX_BUILDS[name] += 1
    LAST_GRID[name] = (n_chunks, chunks[0] if chunks else n_chunks)
    return row_ptr, col, weight


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
    stream = (None, None, None, _ptr(slot_src), None, _ptr(row_start), _ptr(row_count),
              _ptr(bitmaps), None)
    row_ptr, col, _ = _build("bitmap_index", stream, row_start, row_count, slot_row)
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
    :func:`~repro_torch.kernels.correction.pack_correction` gives.  The
    grid is bounded by one correction slot per plane unit, as
    :func:`~repro_torch.kernels.correction.build_fused_stream` lays them
    out; a stream past that bound is refused."""
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
    stream = (_ptr(kind), _ptr(main_idx), _ptr(corr_idx), _ptr(main_src), _ptr(corr_src),
              _ptr(row_start), _ptr(row_count), _ptr(bitmaps), _ptr(planes))
    return _build("bitmap_index_fused", stream, row_start, row_count, slot_row, kind, planes)
