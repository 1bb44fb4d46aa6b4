"""The row-index builders' chunked schedule, on the CPU.

The CUDA builder (``csrc/bitmap_index.cu``) cuts each row tile's slot run
into chunks of at most ``U`` 2 KiB units (:func:`chunk_table`), counts each
(chunk, row), scans the counts in output order and fills each (chunk,
row) from its cursor.  ``bitmap_index_chunked_plain`` /
``bitmap_index_fused_chunked_plain`` run that schedule step by step in
PyTorch; here they are held byte for byte to the plain builders on a
synthetic skewed stream: one row tile many chunks long, a ragged last
chunk, a tile holding only its all-zero pad slot, a tile with no slot, a
tile of correction slots only, and an empty row inside the busy tile, at
P = 1 and P = 31 bit-planes.  The mirror on the DBLP graph's operands is in
``tests/test_torch_spmm_index.py``; the kernels are held to the plain
builders on the same skewed stream on the card in
``tests/test_torch_cuda.py``, which imports :func:`skewed_stream` from here
(this file imports no JAX).
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import bitmap_index as BI
from repro_torch.kernels.pack import TILE, WORDS

# (main slots, correction slots) per row tile: busy, pad only, none, ragged,
# correction only, a few
TILES = [(90, 12), (1, 0), (0, 0), (37, 1), (0, 3), (5, 0)]
BUSY, PAD, NONE, EMPTY_ROW = 0, 1, 2, 7


@functools.lru_cache(maxsize=None)
def skewed_stream(seed: int, n_planes: int, device="cpu") -> dict:
    """One-direction and fused operands over :data:`TILES`: sparse random
    bitmaps (row :data:`EMPTY_ROW` of the busy tile left empty in every
    slot, the pad slot all zero) and correction counts in ``[1, 2**P)``
    stored as ``P`` bit-planes, the largest count among them.  Cached: the
    callers read the tensors and do not write them."""
    rng = np.random.default_rng(seed)
    n_main, n_corr = sum(m for m, _ in TILES), sum(c for _, c in TILES)
    bits = rng.random((n_main, TILE, WORDS * 32)) < 0.004
    cells = rng.random((n_corr, TILE, WORDS * 32)) < 0.05
    counts = rng.integers(1, 2 ** n_planes, (n_corr, TILE, WORDS * 32), dtype=np.int64)
    counts[0, 0, 0], cells[0, 0, 0] = 2 ** n_planes - 1, True
    counts = np.where(cells, counts, 0)
    kind, main_idx, corr_idx, src, slot_row = [], [], [], [], []
    m = c = 0
    for t, (n_m, n_c) in enumerate(TILES):
        row = (slice(m, m + n_m), EMPTY_ROW) if t == BUSY else None
        if row is not None:
            bits[row] = False
            counts[c: c + n_c, EMPTY_ROW] = 0
        if t == PAD:
            bits[m] = False
        kind += [0] * n_m + [1] * n_c
        main_idx += list(range(m, m + n_m)) + [0] * n_c
        corr_idx += [0] * n_m + list(range(c, c + n_c))
        src += sorted(rng.integers(0, 40, n_m).tolist()) + sorted(rng.integers(0, 40, n_c).tolist())
        slot_row += [t] * (n_m + n_c)
        m, c = m + n_m, c + n_c

    def words(b):  # (..., 128, 128) bools -> (..., 128, 4) int32 words, bit j of word w = column 32w + j
        packed = (b.reshape(*b.shape[:-1], WORDS, 32).astype(np.uint64)
                  << np.arange(32, dtype=np.uint64)).sum(-1)
        return torch.from_numpy(packed.astype(np.uint32).view(np.int32)).to(device)

    def ints(a):
        return torch.tensor(np.asarray(a, dtype=np.int32), device=device)

    planes = words(np.stack([(counts >> q) & 1 for q in range(n_planes)], axis=1).astype(bool))
    kind, src, slot_row = np.array(kind), np.array(src), np.array(slot_row)
    run = np.array([n_m + n_c for n_m, n_c in TILES])
    main_run = np.array([n_m for n_m, _ in TILES])
    is_main = kind == 0
    return {
        "direction": (ints(src[is_main]), ints(slot_row[is_main]),
                      ints(np.r_[0, np.cumsum(main_run)[:-1]]), ints(main_run), words(bits)),
        "fused": (ints(kind), ints(np.where(is_main, src, 0)), ints(np.where(is_main, 0, src)),
                  ints(main_idx), ints(corr_idx), ints(slot_row),
                  ints(np.r_[0, np.cumsum(run)[:-1]]), ints(run), words(bits), planes,
                  [float(2 ** q) for q in range(n_planes)]),
    }


@pytest.mark.parametrize("n_planes", [1, 31])
def test_skewed_stream_has_its_cases(n_planes):
    s = skewed_stream(3, n_planes)
    kind, _, _, main_idx, _, slot_row, row_start, row_count, bitmaps, planes, _ = s["fused"]
    plain = BI.bitmap_index_fused_plain(*s["fused"])
    lengths = torch.diff(plain[0])
    assert int(lengths[BUSY * TILE + EMPTY_ROW]) == 0 and int(lengths[:TILE].sum()) > 0
    assert int(lengths[PAD * TILE: (NONE + 1) * TILE].sum()) == 0
    assert row_count.tolist() == [a + b for a, b in TILES]
    assert int(plain[2].max()) == 2 ** n_planes - 1  # the top plane is used
    assert int(bitmaps[int(main_idx[row_start[PAD]])].abs().sum()) == 0  # the pad slot


@pytest.mark.parametrize("units", [1, 5, 32])
@pytest.mark.parametrize("n_planes", [1, 31])
def test_chunk_table_cuts_each_tile(n_planes, units):
    """Chunks are windows of ``U`` units on the stream's unit axis, cut at
    tile ends: a tile whose units span ``[o0, o1)`` gets ``floor(o1 / U) -
    floor(o0 / U) + 1`` chunks, each holding the tile's slots that start in
    its window, in order: at most ``U`` slots and ``U - 1 + P`` units; the
    chunks cover every slot once and the grid's bound is met exactly.  For
    one direction the table equals its closed form in the run table."""
    s = skewed_stream(4, n_planes)
    kind, *_, slot_row, row_start, row_count, bitmaps, planes, _ = s["fused"]
    n_chunks, base, first = BI.chunk_schedule(slot_row, row_start, row_count, kind, planes,
                                              chunk_units=units)
    assert base.dtype == first.dtype == torch.int32
    assert base.shape == (len(TILES),) and first.shape == (n_chunks + 1,)
    assert int(base[-1]) == n_chunks
    u = [n_planes if k else 1 for k in kind.tolist()]
    at = offset = 0
    for t, (n_m, n_c) in enumerate(TILES):
        start, end = offset, offset + n_m + n_c * n_planes
        chunks = range(int(base[t - 1]) if t else 0, int(base[t]))
        assert len(chunks) == end // units - start // units + 1
        for c in chunks:
            s0, s1 = int(first[c]), int(first[c + 1])
            assert s0 == at and s1 - s0 <= min(units, 32)
            for slot in range(s0, s1):
                assert offset // units == c - t
                offset += u[slot]
            assert sum(u[s0:s1]) <= units - 1 + n_planes
            at = s1
        assert offset == end
    assert at == kind.shape[0]
    src, slot_row, row_start, row_count, _ = s["direction"]
    grid, one_base, one_first = BI.chunk_schedule(slot_row, row_start, row_count,
                                                  chunk_units=units)
    assert grid == len(TILES) + int(src.shape[0]) // units
    assert BI.chunk_schedule(slot_row, row_start, row_count, chunk_units=units,
                             table=False) == (grid, None, None)
    ends = (row_start + row_count).long()
    assert torch.equal(one_base.long(), ends // units + torch.arange(1, len(TILES) + 1))
    assert int(one_base[-1]) == grid
    for c in range(grid):
        t = int(torch.searchsorted(one_base, torch.tensor(c, dtype=torch.int32), right=True))
        w = (c - t) * units
        assert int(one_first[c]) == max(int(row_start[t]), w)
        assert int(one_first[c + 1]) == min(int(ends[t]), w + units)


@pytest.mark.parametrize("units", [1, 5, 32])
@pytest.mark.parametrize("n_planes", [1, 31])
def test_chunked_mirror_equals_plain_on_skewed_stream(n_planes, units):
    s = skewed_stream(5, n_planes)
    got = BI.bitmap_index_chunked_plain(*s["direction"], chunk_units=units)
    want = BI.bitmap_index_plain(*s["direction"])
    assert all(a.dtype == torch.int32 and torch.equal(a, b) for a, b in zip(got, want))
    got = BI.bitmap_index_fused_chunked_plain(*s["fused"], chunk_units=units)
    want = BI.bitmap_index_fused_plain(*s["fused"])
    assert all(a.dtype == torch.int32 and torch.equal(a, b) for a, b in zip(got, want))
    assert int(want[1].shape[0]) > 1000


def test_chunked_mirror_refuses_a_stream_past_its_grid():
    """The grid is bounded by one correction slot per plane unit; a stream
    whose correction slots share one unit overruns it and is refused, as
    the wrapper refuses it on the card."""
    s = skewed_stream(6, 31)
    f = list(s["fused"])
    kind = f[0]
    f[4] = torch.zeros_like(f[4])       # every correction slot reads plane unit 0
    f[9] = f[9][:1].contiguous()
    assert int(kind.sum()) > 1
    with pytest.raises(ValueError, match="past the grid|exceed the grid"):
        BI.bitmap_index_fused_chunked_plain(*f)


@pytest.mark.parametrize("units", [0, 33])
def test_chunked_mirrors_refuse_chunk_units_out_of_range(units):
    """A chunk holds 1 to 32 units, one mask bit a slot: the schedule and
    both mirrors refuse any other length."""
    s = skewed_stream(7, 1)
    with pytest.raises(ValueError, match="chunk_units"):
        BI.chunk_schedule(*s["direction"][1:4], chunk_units=units)
    with pytest.raises(ValueError, match="chunk_units"):
        BI.bitmap_index_chunked_plain(*s["direction"], chunk_units=units)
    with pytest.raises(ValueError, match="chunk_units"):
        BI.bitmap_index_fused_chunked_plain(*s["fused"], chunk_units=units)
