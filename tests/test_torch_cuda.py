"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The
file imports neither JAX nor the JAX package, so it runs where only the
port is installed; the suite's ``conftest.py`` imports the JAX package,
so on such a machine run it as

    python -m pytest -q --noconftest tests/test_torch_cuda.py

Operands come from the port's own host half (a small DBLP catalog,
extracted, corrected and packed); the row index is built on the card at
upload.  The SpMM kernels read only the index, and are held to the plain
versions that read the bitmaps: on integer-valued frontiers (with
``inf`` / ``-inf`` where the op allows) bit for bit.  On float frontiers
they repeat the plain mirror of their own arithmetic bit for bit, and two
launches give the same bits.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import dedup, engine, extract
from repro_torch.core.condensed import BipartiteEdges
from repro_torch.data.synth import dblp_catalog
from repro_torch.kernels import bitmap_index as BI
from repro_torch.kernels import bitmap_spmm as K
from repro_torch.kernels.pack import TILE, pack_bipartite
from test_torch_index_chunks import skewed_stream

pytestmark = pytest.mark.cuda

Q1 = """
Nodes(ID, Name) :- Author(ID, Name).
Edges(ID1, ID2) :- AuthorPub(ID1, PubID), AuthorPub(ID2, PubID).
"""

ZERO = {"sum": 0.0, "min": float("inf"), "max": 0.0}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def packed(card):
    g = extract(dblp_catalog(700, 1200, 6.0, seed=5), Q1).graph
    corr = dedup.build_correction(g)
    return engine.to_device_packed(g, correction=corr, backend="cuda", device=card)


def _frontier(rng, n, feat, op):
    x = rng.integers(0, 7, (n, feat)).astype(np.float32)
    if op == "min":
        x[rng.random((n, feat)) < 0.5] = np.inf
    elif op == "max":
        x = (x > 3).astype(np.float32)
        x[rng.random((n, feat)) < 0.2] = -np.inf  # every -inf maps to zero
    return torch.from_numpy(x).cuda()


def _plain_args(ops):
    return ops.slot_src, ops.slot_row, ops.row_start, ops.row_count, ops.bitmaps


def _fused_plain_args(f):
    return (f.kind, f.main_src, f.corr_src, f.main_idx, f.corr_idx, f.slot_row,
            f.row_start, f.row_count, f.bitmaps, f.planes)


def _directions(packed):
    """(operands, n_in, n_out) of both directions of the first chain's layers."""
    for layer in packed.chains[0]:
        yield layer.fwd, layer.n_src, layer.n_dst
        yield layer.rev, layer.n_dst, layer.n_src


def _fused(packed, reverse):
    f = packed.fused_rev if reverse else packed.fused_fwd
    chain = packed.chains[-1]
    return f, (chain[0].n_dst if reverse else chain[-1].n_src)


def test_cuda_index_kernel_matches_plain(packed):
    """The index built on the card at upload equals the plain build, for
    both directions of every layer and both fused streams; a rebuild gives
    the same bytes and counts one build."""
    for ops, _, _ in _directions(packed):
        want = BI.bitmap_index_plain(*_plain_args(ops))
        assert torch.equal(ops.row_ptr, want[0]) and torch.equal(ops.col, want[1])
        before = BI.INDEX_BUILDS["bitmap_index"]
        again = BI.bitmap_index(*_plain_args(ops))
        assert BI.INDEX_BUILDS["bitmap_index"] == before + 1
        assert torch.equal(again[0], ops.row_ptr) and torch.equal(again[1], ops.col)
    for reverse in (False, True):
        f, _ = _fused(packed, reverse)
        want = BI.bitmap_index_fused_plain(*_fused_plain_args(f), f.plane_weights)
        for got, w in zip((f.row_ptr, f.col, f.weight), want):
            assert torch.equal(got, w)
        assert int(f.weight.max()) >= 2 ** (f.planes.shape[1] - 1)


@pytest.mark.parametrize("units", [1, 8, 32])
@pytest.mark.parametrize("n_planes", [1, 31])
def test_cuda_index_chunked_kernels_match_plain_on_skewed_stream(card, monkeypatch, n_planes,
                                                                 units):
    """Both builders' chunked kernels at chunk length ``units``
    (``CHUNK_UNITS``), byte for byte against the plain versions on the
    skewed stream (one tile many chunks long, a ragged last chunk, pad-slot
    and empty tiles, an empty row in the busy tile), and against the CPU
    mirror of their schedule; each build counts once and records the grid
    the schedule gives."""
    monkeypatch.setattr(BI, "CHUNK_UNITS", units)
    s = skewed_stream(5, n_planes, device=card)
    before = dict(BI.INDEX_BUILDS)
    got = BI.bitmap_index(*s["direction"])
    want = BI.bitmap_index_plain(*s["direction"])
    mirror = BI.bitmap_index_chunked_plain(*(t.cpu() for t in s["direction"]), chunk_units=units)
    for a, b, m in zip(got, want, mirror):
        assert a.dtype == torch.int32 and torch.equal(a, b) and torch.equal(a.cpu(), m)
    grid, _, _ = BI.chunk_schedule(*s["direction"][1:4], table=False)
    assert BI.LAST_GRID["bitmap_index"] == (grid, grid)
    fused = s["fused"]
    got = BI.bitmap_index_fused(*fused)
    want = BI.bitmap_index_fused_plain(*fused)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    assert int(got[2].max()) == 2 ** n_planes - 1
    grid, base, _ = BI.chunk_schedule(*fused[5:8], fused[0], fused[9])
    assert BI.LAST_GRID["bitmap_index_fused"] == (grid, int(base[-1]))
    assert BI.INDEX_BUILDS == {k: v + 1 for k, v in before.items()}


def test_cuda_index_refuses_a_stream_past_its_grid(card):
    """A fused stream whose correction slots share one plane unit needs
    more chunks than the grid the wrapper bounds from the planes: the
    build raises after the count pass and counts nothing."""
    f = list(skewed_stream(6, 31, device=card)["fused"])
    f[4] = torch.zeros_like(f[4])
    f[9] = f[9][:1].contiguous()
    before = dict(BI.INDEX_BUILDS)
    with pytest.raises(ValueError, match="past the grid"):
        BI.bitmap_index_fused(*f)
    assert BI.INDEX_BUILDS == before


@pytest.mark.parametrize("feat", [8, 32, 40])
def test_cuda_kernels_match_plain(packed, feat):
    """K1 and K2 over both layers in both directions, and K3 in both
    directions, bit for bit against the plain versions over the bitmaps; 40
    features take two feature blocks, the second one mostly masked."""
    rng = np.random.default_rng(feat)
    for ops, n_in, n_out in _directions(packed):
        for op in ("sum", "min", "max"):
            x = _frontier(rng, n_in, feat, op)
            before = K.LAUNCHES[f"bitmap_spmm_{op}"]
            got = K.bitmap_spmm(ops.row_ptr, ops.col, x, n_out, op=op, zero=ZERO[op])
            assert K.LAUNCHES[f"bitmap_spmm_{op}"] == before + 1
            want = K.bitmap_spmm_plain(*_plain_args(ops), x, n_out, op=op, zero=ZERO[op])
            assert torch.equal(got, want)
    for reverse in (False, True):
        f, n_h = _fused(packed, reverse)
        h = _frontier(rng, n_h, feat, "sum")
        x = _frontier(rng, packed.n_real, feat, "sum")
        before = K.LAUNCHES["bitmap_spmm_fused"]
        got = K.bitmap_spmm_fused(f.row_ptr, f.col, f.weight, h, x, f.n_out)
        assert K.LAUNCHES["bitmap_spmm_fused"] == before + 1
        want = K.bitmap_spmm_fused_plain(*_fused_plain_args(f), h, x, f.n_out, f.plane_weights)
        assert torch.equal(got, want)
    assert packed.fused_fwd.planes.shape[1] >= 2  # several bit-planes


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_cuda_skewed_row_spans_many_ranges(card, op):
    """One destination row with 3000 entries beside light rows: at 32 items
    a range it spans about a hundred ranges, and at 5 every light row is
    split too; the carry pass must give the plain version's bits."""
    rng = np.random.default_rng(8)
    light = np.unique(rng.integers(0, 400, 3000) * 3000 + rng.integers(0, 3000, 3000))
    key = np.unique(np.r_[37 * 3000 + np.arange(3000), light])
    s, d = key % 3000, key // 3000
    ops = engine._upload_operands(pack_bipartite(BipartiteEdges(s, d, 3000, 400)), card)
    for feat in (4, 32, 128):   # 128: the wide route, one group a range
        x = _frontier(rng, 3000, feat, op)
        want = K.bitmap_spmm_plain(*_plain_args(ops), x, 400, op=op, zero=ZERO[op])
        for items in (5, 32, None):
            got = K.bitmap_spmm(ops.row_ptr, ops.col, x, 400, op=op, zero=ZERO[op],
                                range_items=items)
            assert torch.equal(got, want), (feat, items)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_cuda_pad_slots_and_ragged_rows(card, op):
    """Empty upper row tiles (one all-zero pad slot each) come out as the
    semiring zero, and an output that ends inside a row tile is written
    up to its last row only."""
    rng = np.random.default_rng(11)
    key = np.unique(rng.integers(0, 90, 700) * 260 + rng.integers(0, 260, 700))
    s, d = key % 260, key // 260
    bsb = pack_bipartite(BipartiteEdges(s, d, 260, 450))
    ops = engine._upload_operands(bsb, card)
    x = _frontier(rng, 260, 8, op)
    for n_out in (450, bsb.n_row_tiles * TILE):
        got = K.bitmap_spmm(ops.row_ptr, ops.col, x, n_out, op=op, zero=ZERO[op])
        assert got.shape == (n_out, 8)
        want = K.bitmap_spmm_plain(*_plain_args(ops), x, n_out, op=op, zero=ZERO[op])
        assert torch.equal(got, want)
        assert bool((got[128:] == ZERO[op]).all())


def test_cuda_float_frontiers_agree_to_roundoff(packed):
    """On float frontiers each kernel gives the bits of the plain mirror of
    its arithmetic, the same bits on a second launch, and the plain
    versions over the bitmaps to float32 round-off."""
    rng = np.random.default_rng(3)
    for ops, n_in, n_out in _directions(packed):
        x = torch.from_numpy(rng.random((n_in, 32)).astype(np.float32)).cuda()
        for op in ("sum", "min", "max"):
            args = (ops.row_ptr, ops.col, x, n_out, op, ZERO[op])
            got = K.bitmap_spmm(*args)
            assert torch.equal(got, K.bitmap_spmm(*args))
            assert torch.equal(got, K.bitmap_spmm_index_plain(*args))
            torch.testing.assert_close(
                got, K.bitmap_spmm_plain(*_plain_args(ops), x, n_out, op, ZERO[op]),
                rtol=1e-5, atol=1e-6)
    for reverse in (False, True):
        f, n_h = _fused(packed, reverse)
        h = torch.from_numpy(rng.random((n_h, 32)).astype(np.float32)).cuda()
        xr = torch.from_numpy(rng.random((packed.n_real, 32)).astype(np.float32)).cuda()
        args = (f.row_ptr, f.col, f.weight, h, xr, f.n_out)
        got = K.bitmap_spmm_fused(*args)
        assert torch.equal(got, K.bitmap_spmm_fused(*args))
        assert torch.equal(got, K.bitmap_spmm_fused_index_plain(*args))
        torch.testing.assert_close(
            got, K.bitmap_spmm_fused_plain(*_fused_plain_args(f), h, xr, f.n_out,
                                           f.plane_weights), rtol=1e-5, atol=1e-4)


def test_cuda_auto_dispatch_launches_and_matches_segment(packed):
    """``'auto'`` on an sm_90 card sends batched steps to the kernels and
    answers as the segment path does; elsewhere it takes the segment
    path."""
    import dataclasses

    from repro_torch.core import algorithms

    rng = np.random.default_rng(9)
    x = _frontier(rng, packed.n_real, 8, "sum")
    auto = dataclasses.replace(packed, backend="auto")
    seg = dataclasses.replace(packed, backend="segment")
    K.reset_launch_counts()
    got = engine.propagate(auto, x)
    want = engine.propagate(seg, x)
    src = [0, 5, 17, 200]
    got_bfs, want_bfs = algorithms.bfs_multi(auto, src), algorithms.bfs_multi(seg, src)
    got_reach = algorithms.reachable_multi(auto, src)
    want_reach = algorithms.reachable_multi(seg, src)
    on_hopper = torch.cuda.get_device_capability() == (9, 0)
    for name in K.LAUNCHES:
        assert (K.LAUNCHES[name] > 0) == on_hopper, name
    assert torch.equal(got, want)
    assert torch.equal(got_bfs, want_bfs) and torch.equal(got_reach, want_reach)


def test_wrapper_refuses_misaligned_words(packed):
    """The index builder reads each bitmap row as one 16-byte word: words
    off a 16-byte boundary are refused.  The SpMM kernels gather 16 bytes
    at a time only from a 16-byte aligned frontier: one 4 bytes off takes
    the scalar loads and gives the same answer."""
    ops = packed.chains[0][0].fwd
    words = torch.empty(ops.bitmaps.numel() + 1, dtype=torch.int32, device="cuda")
    shifted = words[1:].view(ops.bitmaps.shape)
    shifted.copy_(ops.bitmaps)
    with pytest.raises(ValueError, match="16-byte"):
        BI.bitmap_index(ops.slot_src, ops.slot_row, ops.row_start, ops.row_count, shifted)
    layer = packed.chains[0][0]
    rng = np.random.default_rng(2)
    x = _frontier(rng, layer.n_src, 8, "sum")
    off = torch.empty(x.numel() + 1, device="cuda")[1:].view(x.shape)
    off.copy_(x)
    assert off.data_ptr() % 16 == 4
    assert torch.equal(K.bitmap_spmm(ops.row_ptr, ops.col, off, layer.n_dst),
                       K.bitmap_spmm(ops.row_ptr, ops.col, x, layer.n_dst))


# ---------------------------------------------------------------------------
# The analytics' traffic: 128 feature columns, +inf frontiers, empty rows,
# a two-virtual-layer chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_cuda_kernels_at_128_features(packed, op):
    """K1 / K2 at F = 128 (four feature blocks, the triangle blocks' width)
    over both layers in both directions: bit for bit against the plain
    versions on integer frontiers, and the same bits on a second launch of
    a float frontier."""
    rng = np.random.default_rng(128)
    for ops, n_in, n_out in _directions(packed):
        x = _frontier(rng, n_in, 128, op)
        got = K.bitmap_spmm(ops.row_ptr, ops.col, x, n_out, op=op, zero=ZERO[op])
        assert torch.equal(got, K.bitmap_spmm(ops.row_ptr, ops.col, x, n_out, op=op,
                                              zero=ZERO[op]))
        want = K.bitmap_spmm_plain(*_plain_args(ops), x, n_out, op=op, zero=ZERO[op])
        assert torch.equal(got, want)
        xf = torch.from_numpy(rng.random((n_in, 128)).astype(np.float32)).cuda()
        args = (ops.row_ptr, ops.col, xf, n_out, op, ZERO[op])
        assert torch.equal(K.bitmap_spmm(*args), K.bitmap_spmm(*args))


def test_cuda_fused_at_128_features(packed):
    """K3 at F = 128 in both directions: bit for bit against the plain
    version on integer frontiers, and bit-identical between two launches on
    a float frontier."""
    rng = np.random.default_rng(129)
    for reverse in (False, True):
        f, n_h = _fused(packed, reverse)
        h = _frontier(rng, n_h, 128, "sum")
        x = _frontier(rng, packed.n_real, 128, "sum")
        got = K.bitmap_spmm_fused(f.row_ptr, f.col, f.weight, h, x, f.n_out)
        want = K.bitmap_spmm_fused_plain(*_fused_plain_args(f), h, x, f.n_out, f.plane_weights)
        assert torch.equal(got, want)
        hf = torch.from_numpy(rng.random((n_h, 128)).astype(np.float32)).cuda()
        xf = torch.from_numpy(rng.random((packed.n_real, 128)).astype(np.float32)).cuda()
        args = (f.row_ptr, f.col, f.weight, hf, xf, f.n_out)
        assert torch.equal(K.bitmap_spmm_fused(*args), K.bitmap_spmm_fused(*args))


def _wide_call(packed, kernel, rng, feat):
    """``(fn(frontiers, range_items), float frontiers)`` of one kernel over
    the author -> publication layer (K1 / K2) or the forward fused stream
    (K3), frontiers made by ``rng`` at ``feat`` features."""
    def floats(n):
        return torch.from_numpy(rng.random((n, feat)).astype(np.float32)).cuda()

    if kernel == "fused":
        f, n_h = _fused(packed, False)
        return ((lambda fr, L: K.bitmap_spmm_fused(f.row_ptr, f.col, f.weight, *fr, f.n_out,
                                                   range_items=L)),
                (floats(n_h), floats(packed.n_real)))
    layer = packed.chains[0][0]
    ops = layer.fwd
    return ((lambda fr, L: K.bitmap_spmm(ops.row_ptr, ops.col, *fr, layer.n_dst, kernel,
                                         ZERO[kernel], range_items=L)),
            (floats(layer.n_src),))


@pytest.mark.parametrize("kernel", ["sum", "min", "max", "fused"])
def test_cuda_wide_launch_equals_32_column_slices(packed, kernel):
    """A feature's fold order depends only on the index and the range
    length: one F = 128 launch (the wide route, one group a range) gives,
    on float frontiers, the bits of four F = 32 launches (the 32-feature
    route) on its column slices at the same range length."""
    rng = np.random.default_rng(32)
    fn, fr = _wide_call(packed, kernel, rng, 128)
    for items in (5, 64, 256):
        whole = fn(fr, items)
        parts = [fn(tuple(t[:, c:c + 32].contiguous() for t in fr), items)
                 for c in range(0, 128, 32)]
        assert torch.equal(whole, torch.cat(parts, 1)), items


@pytest.mark.parametrize("feat", [64, 96, 128, 256, 130])
def test_cuda_wide_widths_match_mirror(packed, feat):
    """K1 / K2 / K3 at widths past 32 (the wide route; 130 features take
    4-byte gathers on the 32-feature route): on float frontiers the bits of
    the plain mirror, at short ranges and the default, and the same bits
    from a frontier off a 16-byte boundary (4-byte gathers, the same
    ranges); on integer frontiers the plain versions over the bitmaps."""
    rng = np.random.default_rng(feat)
    for kernel in ("sum", "min", "max", "fused"):
        fn, fr = _wide_call(packed, kernel, rng, feat)
        for items in (7, None):
            got = fn(fr, items)
            if kernel == "fused":
                f, _ = _fused(packed, False)
                want = K.bitmap_spmm_fused_index_plain(f.row_ptr, f.col, f.weight, *fr,
                                                       f.n_out, items)
            else:
                layer = packed.chains[0][0]
                want = K.bitmap_spmm_index_plain(layer.fwd.row_ptr, layer.fwd.col, *fr,
                                                 layer.n_dst, kernel, ZERO[kernel], items)
            assert torch.equal(got, want), (kernel, items)
        off = []
        for t in fr:
            o = torch.empty(t.numel() + 1, device="cuda")[1:].view(t.shape)
            o.copy_(t)
            off.append(o)
        assert torch.equal(fn(tuple(off), None), fn(fr, None)), kernel
    for ops, n_in, n_out in _directions(packed):
        for op in ("sum", "min", "max"):
            x = _frontier(rng, n_in, feat, op)
            got = K.bitmap_spmm(ops.row_ptr, ops.col, x, n_out, op=op, zero=ZERO[op])
            want = K.bitmap_spmm_plain(*_plain_args(ops), x, n_out, op=op, zero=ZERO[op])
            assert torch.equal(got, want), (op, n_in)
    for reverse in (False, True):
        f, n_h = _fused(packed, reverse)
        h = _frontier(rng, n_h, feat, "sum")
        x = _frontier(rng, packed.n_real, feat, "sum")
        got = K.bitmap_spmm_fused(f.row_ptr, f.col, f.weight, h, x, f.n_out)
        want = K.bitmap_spmm_fused_plain(*_fused_plain_args(f), h, x, f.n_out, f.plane_weights)
        assert torch.equal(got, want), reverse


@pytest.mark.parametrize("op", ["min", "max"])
def test_cuda_k2_inf_frontiers_and_empty_rows(card, op):
    """K2 over frontiers full of ``+inf`` (shortest-path fills, widest-path
    sources) with destination rows that receive nothing inside a row tile
    and whole empty tiles: empty rows come out as the semiring zero (``inf``
    for min, 0 for max), ``inf`` is carried through the 16-byte gathers and
    the carry pass, and two launches give the same bits."""
    rng = np.random.default_rng(17)
    n_src, n_dst = 500, 700
    dst = rng.choice(np.r_[np.arange(0, 300, 2), np.arange(520, 600)], 4000)
    key = np.unique(rng.integers(0, n_src, 4000) * n_dst + dst)
    ops = engine._upload_operands(
        pack_bipartite(BipartiteEdges(key // n_dst, key % n_dst, n_src, n_dst)), card)
    for feat in (4, 32, 128):
        x = rng.integers(0, 9, (n_src, feat)).astype(np.float32)
        x[rng.random((n_src, feat)) < (0.9 if op == "min" else 0.3)] = np.inf
        x = torch.from_numpy(x).cuda()
        want = K.bitmap_spmm_plain(*_plain_args(ops), x, n_dst, op=op, zero=ZERO[op])
        for items in (5, None):
            got = K.bitmap_spmm(ops.row_ptr, ops.col, x, n_dst, op=op, zero=ZERO[op],
                                range_items=items)
            assert torch.equal(got, want), (feat, items)
            assert torch.equal(got, K.bitmap_spmm(ops.row_ptr, ops.col, x, n_dst, op=op,
                                                  zero=ZERO[op], range_items=items))
        empty = torch.ones(n_dst, dtype=torch.bool, device="cuda")
        empty[torch.from_numpy(key % n_dst).cuda()] = False
        assert bool((got[empty] == ZERO[op]).all())
        assert bool(torch.isinf(got[~empty]).any())


def test_cuda_two_virtual_layer_chain(card):
    """App. C.2's layered generator (two virtual layers, repeated edges,
    directed): every layer packs its distinct edges, and weighted shortest
    paths forward and reversed, widest paths and SCC labels launch K2 on
    the card and equal the segment path, twice over."""
    import dataclasses

    from repro_torch.core import algorithms
    from repro_torch.data.synth import layered_condensed

    g = layered_condensed(400, [150, 120], [900, 600, 900], seed=4, symmetric=False)
    lay = engine.to_device_packed(g, backend="cuda", device=card)
    seg = dataclasses.replace(lay, backend="segment")
    assert all(layer.repeats for layer in lay.chains[0])
    rng = np.random.default_rng(4)
    lw = ((torch.from_numpy(rng.integers(1, 9, 150).astype(np.float32)).cuda(),
           torch.from_numpy((rng.random(120) * 3).astype(np.float32)).cuda()),)
    src = rng.integers(0, 400, 16)
    K.reset_launch_counts()
    for reverse in (False, True):
        got = algorithms.shortest_paths_multi(lay, src, layer_weights=lw, reverse=reverse)
        assert torch.equal(got, algorithms.shortest_paths_multi(lay, src, layer_weights=lw,
                                                                reverse=reverse))
        assert torch.equal(got, algorithms.shortest_paths_multi(seg, src, layer_weights=lw,
                                                                reverse=reverse))
    wide = algorithms.widest_paths_multi(lay, src, layer_capacities=lw)
    assert torch.equal(wide, algorithms.widest_paths_multi(seg, src, layer_capacities=lw))
    labels = algorithms.scc_labels(lay, batch=32)
    assert np.array_equal(labels, algorithms.scc_labels(seg, batch=32))
    assert K.LAUNCHES["bitmap_spmm_min"] > 0 and K.LAUNCHES["bitmap_spmm_max"] > 0
    assert K.LAUNCHES["bitmap_spmm_sum"] == 0 and K.LAUNCHES["bitmap_spmm_fused"] == 0


# ---------------------------------------------------------------------------
# K4: flash attention
# ---------------------------------------------------------------------------

FLASH_SWEEP = [
    # (B, T, H, KV, D, causal), the shapes of tests/test_kernels.py
    (1, 64, 2, 1, 8, True),
    (2, 128, 4, 2, 16, True),
    (1, 96, 4, 4, 8, False),
    (2, 100, 2, 1, 8, True),
    (1, 256, 8, 2, 32, True),
    (1, 300, 32, 2, 128, True),      # glm4-9b's heads, ragged q tiles
]

# (B, Tq, Tk, H, KV, D, causal, q_offset, kv_length)
FLASH_CACHE = [
    (1, 40, 96, 32, 2, 128, True, 0, [40]),           # prefill into a longer cache
    (2, 12, 64, 8, 2, 64, True, 20, [32, 32]),        # prefill after a prefix
    (4, 1, 130, 32, 2, 128, False, 0, [1, 33, 97, 130]),  # decode, ragged tails
    (2, 1, 40, 6, 2, 50, False, 0, [0, 17]),          # a row with no key; D = 50
]

# float32 with full-precision matmuls in the plain version; bf16 at the
# reference's bound (tests/test_kernels.py)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 0.05}


def _qkv(seed, B, Tq, Tk, H, KV, D, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Tq, H, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, Tk, KV, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, Tk, KV, D), generator=g, device="cuda").to(dtype)
    return q, k, v


@pytest.fixture
def full_fp32():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.parametrize("shape", FLASH_SWEEP)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_flash_attention_sweep(card, full_fp32, shape, dtype):
    from repro_torch.kernels import flash_attention as FA

    B, T, H, KV, D, causal = shape
    q, k, v = _qkv(T + D, B, T, T, H, KV, D, dtype)
    before = FA.LAUNCHES["flash_attention"]
    got = FA.flash_attention(q, k, v, causal=causal)
    assert FA.LAUNCHES["flash_attention"] == before + 1
    want = FA.flash_attention_plain(q, k, v, causal=causal, block_q=64, block_kv=64)
    assert got.dtype == dtype
    assert float((got.float() - want.float()).abs().max()) < FLASH_TOL[dtype]


@pytest.mark.parametrize("case", FLASH_CACHE)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_flash_attention_cache_path(card, full_fp32, case, dtype):
    from repro_torch.kernels import flash_attention as FA

    B, Tq, Tk, H, KV, D, causal, q_offset, kv_length = case
    q, k, v = _qkv(Tk + D, B, Tq, Tk, H, KV, D, dtype)
    lengths = torch.tensor(kv_length, dtype=torch.int32, device="cuda")
    kw = dict(causal=causal, q_offset=q_offset, kv_length=lengths)
    got = FA.flash_attention(q, k, v, **kw)
    want = FA.flash_attention_plain(q, k, v, **kw)
    assert float((got.float() - want.float()).abs().max()) < FLASH_TOL[dtype]
    if 0 in kv_length:
        assert float(got[kv_length.index(0)].abs().max()) == 0.0


def test_cuda_batched_server_runs_k4_and_matches_cpu(card):
    """A small float32 model served on the card gives the CPU's tokens, and
    every attention call of the run launched K4: n_layers per prefill and
    per decode step; the plain version never ran on the card."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer
    from repro_torch.serve.server import BatchedServer, Request

    cfg = dataclasses.replace(registry.get_arch("glm4-9b").SMOKE, dtype="float32")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def to_card(tree):
        return {k: to_card(v) if isinstance(v, dict) else v.cuda() for k, v in tree.items()}

    on_card = to_card(params)

    def requests():
        rng = np.random.default_rng(0)
        return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=int(n)),
                        max_new_tokens=5) for i, n in enumerate([7, 7, 4, 7])]

    want = BatchedServer(params, cfg, batch_slots=3, max_len=32).run(requests())
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        FA.reset_launch_counts()
        got = BatchedServer(on_card, cfg, batch_slots=3, max_len=32).run(requests())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert got == want
    # 4 prefills; two batches of 4 decode steps each (max_new_tokens - 1)
    assert FA.LAUNCHES["flash_attention"] == cfg.n_layers * (4 + 2 * 4)
    assert FA.PLAIN_CUDA_CALLS["flash_attention"] == 0


# ---------------------------------------------------------------------------
# K4's bf16 kernels: tensor-core prefill, split-KV decode + combine
# ---------------------------------------------------------------------------

# element-wise bf16 bound against the plain version (chip_smoke.py's
# K4_BF16_ATOL / K4_BF16_RTOL): one output ulp relative, plus p rounded to
# bf16 against another running max than the plain version's
BF16_ATOL, BF16_RTOL = 2e-3, 2.0 ** -7
# against flash_attention_split_plain, which rounds p at the same points:
# one output ulp, plus the rare p whose bf16 rounding flips because the
# two add the same products in another order (a few 1e-4 at 17 keys)
SPLIT_ATOL = 5e-4


def _within(got, want, atol, rtol=BF16_RTOL):
    diff = (got.float() - want.float()).abs()
    excess = float((diff - atol - rtol * want.float().abs()).max())
    assert excess <= 0.0, f"exceeds {atol} + {rtol} |want| by {excess}"


def _route(q, k, q_offset=0):
    """The prefill route the launcher takes for a bf16 call on 16-byte
    aligned tensors (every tensor ``_qkv`` makes)."""
    from repro_torch.kernels import flash_attention as FA

    pack = FA.prefill_pack(q.shape[1], k.shape[1], q.shape[2] // k.shape[2], q_offset)
    return FA.prefill_route(q.dtype, q.shape, k.shape, pack, True)


def _prefill_once(FA, q, k, v, kw):
    """One prefill through the wrapper: its output, after checking that it
    launched the prefill kernel once, on the route ``prefill_route``
    names, and that a second call gives the same bits."""
    before, routes = dict(FA.LAUNCHES), dict(FA.PREFILL_ROUTES)
    got = FA.flash_attention(q, k, v, **kw)
    assert FA.LAUNCHES["flash_attention_prefill"] == before["flash_attention_prefill"] + 1
    want_routes = dict(routes)
    want_routes[_route(q, k, kw["q_offset"])] += 1
    assert FA.PREFILL_ROUTES == want_routes
    assert torch.equal(FA.flash_attention(q, k, v, **kw), got)
    return got


@pytest.mark.parametrize("D", [8, 16, 64, 128])
@pytest.mark.parametrize("G", [1, 2, 3, 16])
def test_cuda_prefill_kernel_matches_plain(card, D, G):
    """A causal prefill of 100 positions (not a multiple of any tile) after
    30 cached ones, over a 160-position cache with a ragged valid prefix:
    head dims 64 and 128 on the sm90 kernel, 8 and 16 on the mma.sync
    kernel; bit for bit the same over two calls."""
    from repro_torch.kernels import flash_attention as FA

    KV, T, q_offset, Tk = 2, 100, 30, 160
    q, k, v = _qkv(D * 7 + G, 2, T, Tk, G * KV, KV, D, torch.bfloat16)
    assert _route(q, k, 30) == ("sm90" if D in (64, 128) else "mma")
    lengths = torch.tensor([q_offset + T, q_offset + T - 9], dtype=torch.int32, device="cuda")
    kw = dict(causal=True, q_offset=q_offset, kv_length=lengths)
    _within(_prefill_once(FA, q, k, v, kw), FA.flash_attention_plain(q, k, v, **kw), BF16_ATOL)


@pytest.mark.parametrize("shape", [
    # (B, Tq, Tk, H, KV, D, causal, q_offset, kv_length)
    (1, 300, 4128, 32, 2, 128, True, 0, [300]),     # glm4-9b's heads, 8 positions a block
    (2, 65, 65, 4, 4, 128, False, 0, None),         # not causal, one key past a tile
    (1, 129, 129, 12, 2, 64, True, 0, None),        # G = 6: 32 positions, all 192 rows
    (1, 40, 40, 128, 2, 50, True, 0, None),         # G = 64, D = 50 (element loads)
    # the sm90 kernel at D = 64 / 128 and G = 1, 3, 16
    (2, 129, 129, 16, 16, 128, False, 0, None),     # G = 1, not causal, Tq = 129
    (1, 129, 129, 24, 8, 64, True, 0, None),        # G = 3: 64 positions, Tq = 129
    (2, 129, 300, 3, 1, 128, True, 0, [129, 100]),  # G = 3 at D = 128: 126 of 128 rows
    (2, 50, 300, 48, 3, 64, True, 100, [150, 141]),  # G = 16 after a prefix, ragged
    (2, 77, 200, 16, 16, 64, True, 60, [137, 100]),  # G = 1, a row's keys end mid-tile
    (2, 33, 97, 32, 2, 128, False, 64, [97, 40]),   # not causal over a ragged cache
    (1, 40, 40, 128, 2, 128, True, 0, None),        # G = 64: two positions a block
    (1, 40, 40, 128, 2, 64, True, 0, None),         # G = 64 at D = 64: three
    (3, 5, 9, 6, 2, 64, True, 4, None),             # fewer positions than a block
])
def test_cuda_prefill_kernel_edges(card, shape):
    from repro_torch.kernels import flash_attention as FA

    B, Tq, Tk, H, KV, D, causal, q_offset, kv_length = shape
    q, k, v = _qkv(Tq + D, B, Tq, Tk, H, KV, D, torch.bfloat16)
    lengths = (None if kv_length is None
               else torch.tensor(kv_length, dtype=torch.int32, device="cuda"))
    kw = dict(causal=causal, q_offset=q_offset, kv_length=lengths)
    _within(_prefill_once(FA, q, k, v, kw), FA.flash_attention_plain(q, k, v, **kw),
            BF16_ATOL)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 3, 16])
def test_cuda_sm90_prefill_reads_nothing_past_kv_length(card, D, G):
    """The sm90 kernel's TMA boxes read whole key tiles, past kv_length
    too: with NaN in every cache slot past each row's kv_length (a tile
    straddles it in both rows), the output is the output with zeros there,
    bit for bit, and within the bound of the plain version."""
    from repro_torch.kernels import flash_attention as FA

    B, Tq, Tk, KV, q_offset = 2, 70, 400, 2, 110
    q, k, v = _qkv(D + G, B, Tq, Tk, G * KV, KV, D, torch.bfloat16)
    kv_length = [q_offset + Tq, q_offset + Tq - 23]
    lengths = torch.tensor(kv_length, dtype=torch.int32, device="cuda")
    kw = dict(causal=True, q_offset=q_offset, kv_length=lengths)
    zeros_k, zeros_v, nan_k, nan_v = k.clone(), v.clone(), k.clone(), v.clone()
    for row, n in enumerate(kv_length):
        for t in (zeros_k, zeros_v):
            t[row, n:] = 0
        for t in (nan_k, nan_v):
            t[row, n:] = float("nan")
    assert _route(q, k, q_offset) == "sm90"
    with_zeros = _prefill_once(FA, q, zeros_k, zeros_v, kw)
    with_nan = _prefill_once(FA, q, nan_k, nan_v, kw)
    assert not bool(torch.isnan(with_nan).any())
    assert torch.equal(with_nan, with_zeros)
    _within(with_nan, FA.flash_attention_plain(q, zeros_k, zeros_v, **kw), BF16_ATOL)


# (name, B, Tk, H, KV, D, causal, q_offset, kv_length)
DECODE_CASES = [
    ("empty_row", 2, 200, 4, 1, 16, False, 0, [0, 150]),
    ("shorter_than_one_split", 1, 4128, 4, 1, 64, False, 0, [50]),
    ("not_a_multiple_of_the_split", 1, 4128, 16, 1, 128, False, 0, [3000]),
    ("ragged_rows", 4, 260, 8, 2, 16, False, 0, [1, 64, 129, 260]),
    ("g3_d50", 2, 40, 6, 2, 50, False, 0, [0, 17]),
    ("g32_two_head_chunks", 2, 300, 64, 2, 64, False, 0, [300, 201]),
    ("causal_one_query", 1, 200, 4, 1, 16, True, 90, [200]),
    ("main_path", 8, 4128, 32, 2, 128, False, 4099, [4100] * 8),
    ("granite_moe", 8, 4128, 24, 8, 64, False, 4099, [4100] * 8),
    ("moonshot_moe", 8, 4128, 16, 16, 128, False, 4099, [4100] * 8),
]


@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_cuda_decode_kernel_matches_split_and_plain(card, case):
    """The split-KV kernel and its combine: close to the split plain version
    (the same rounding points) and within the element-wise bound of the
    plain version; a row with no valid key is 0."""
    from repro_torch.kernels import flash_attention as FA

    _, B, Tk, H, KV, D, causal, q_offset, kv_length = case
    q, k, v = _qkv(Tk + H + D, B, 1, Tk, H, KV, D, torch.bfloat16)
    lengths = torch.tensor(kv_length, dtype=torch.int32, device="cuda")
    kw = dict(causal=causal, q_offset=q_offset, kv_length=lengths)
    before = dict(FA.LAUNCHES)
    got = FA.flash_attention(q, k, v, **kw)
    assert FA.LAUNCHES["flash_attention_decode"] == before["flash_attention_decode"] + 1
    assert FA.LAUNCHES["flash_attention_combine"] == before["flash_attention_combine"] + 1
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    _, split_keys = FA.decode_split(Tk, B * KV * -(-(H // KV) // 16), n_sm)
    _within(got, FA.flash_attention_split_plain(q, k, v, split_keys=split_keys, **kw),
            SPLIT_ATOL)
    _within(got, FA.flash_attention_plain(q, k, v, **kw), BF16_ATOL)
    for row, n in enumerate(kv_length):
        if n == 0:
            assert float(got[row].abs().max()) == 0.0


def test_cuda_k4_launches_one_kernel_route_per_call(card):
    """bf16 Tq > 1: the prefill kernel; bf16 Tq == 1: the decode kernel and
    its combine; float32: the float32 kernel only.  Each call is one wrapper
    call."""
    from repro_torch.kernels import flash_attention as FA

    routes = [
        (torch.bfloat16, 5, {"flash_attention_prefill": 1}),
        (torch.bfloat16, 1, {"flash_attention_decode": 1, "flash_attention_combine": 1}),
        (torch.float32, 5, {"flash_attention_f32": 1}),
        (torch.float32, 1, {"flash_attention_f32": 1}),
    ]
    for dtype, Tq, kernels in routes:
        q, k, v = _qkv(1, 2, Tq, 70, 8, 2, 32, dtype)
        FA.reset_launch_counts()
        FA.flash_attention(q, k, v, causal=Tq > 1, q_offset=70 - Tq)
        torch.cuda.synchronize()
        want = {key: 0 for key in FA.LAUNCHES}
        want.update(kernels, flash_attention=1)
        assert FA.LAUNCHES == want, (dtype, Tq)
        assert FA.PLAIN_CUDA_CALLS["flash_attention"] == 0


# ---------------------------------------------------------------------------
# K4 on the training path: the lse output, the backward, batches past 65,535
# ---------------------------------------------------------------------------

# (B, T, H, KV, D, causal): glm4-9b's heads at D = 128, SASRec's one head at
# D = 50 (the prefill kernel's element loads), GQA, not causal
LSE_CASES = [
    (1, 300, 32, 2, 128, True),
    (4, 50, 1, 1, 50, True),
    (2, 77, 6, 2, 50, True),
    (2, 65, 4, 4, 128, False),
    (1, 300, 24, 8, 64, True),       # granite's heads on the sm90 kernel, 3 warpgroups
    (2, 200, 16, 16, 128, True),     # moonshot's: G = 1
]
# lse is float32: the float32 kernel sums exactly as the plain version up to
# order; the bf16 kernel's exp2 approximation and order move it by < 1e-3
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}


@pytest.mark.parametrize("case", LSE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_k4_lse_matches_plain(card, full_fp32, case, dtype):
    from repro_torch.kernels import flash_attention as FA

    B, T, H, KV, D, causal = case
    q, k, v = _qkv(T + D + H, B, T, T, H, KV, D, dtype)
    before, routes = dict(FA.LAUNCHES), dict(FA.PREFILL_ROUTES)
    out, lse = FA._launch(q, k, v, causal, 0, None, with_lse=True)
    route = "flash_attention_f32_lse" if dtype == torch.float32 else "flash_attention_prefill_lse"
    assert FA.LAUNCHES[route] == before[route] + 1
    if dtype == torch.bfloat16:  # the training forward's route: sm90 at head dim 64 / 128
        want_routes = dict(routes)
        want_routes[FA.prefill_route(dtype, q.shape, k.shape,
                                     FA.prefill_pack(T, T, H // KV, 0), True)] += 1
        assert FA.PREFILL_ROUTES == want_routes
    want, want_lse = FA.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    assert lse.shape == (B, T, H) and lse.dtype == torch.float32
    assert float((lse - want_lse).abs().max()) < LSE_TOL[dtype]
    if dtype == torch.float32:
        assert float((out - want).abs().max()) < FLASH_TOL[dtype]
    else:
        _within(out, want, BF16_ATOL)
    # the same call without lse gives the same output
    assert torch.equal(FA._launch(q, k, v, causal, 0, None, with_lse=False)[0], out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_k4_lse_is_inf_on_fully_masked_rows(card, dtype):
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _qkv(3, 2, 6, 40, 4, 2, 50, dtype)
    lengths = torch.tensor([0, 17], dtype=torch.int32, device="cuda")
    out, lse = FA._launch(q, k, v, False, 0, lengths, with_lse=True)
    assert torch.isinf(lse[0]).all() and bool((lse[0] > 0).all())
    assert float(out[0].abs().max()) == 0.0
    _, want = FA.flash_attention_plain(q, k, v, causal=False, kv_length=lengths,
                                       return_lse=True)
    assert float((lse[1] - want[1]).abs().max()) < LSE_TOL[dtype]


@pytest.mark.parametrize("case", LSE_CASES[:3])
def test_cuda_flash_backward_matches_cpu(card, full_fp32, case):
    """The float32 training route on the card (K4 with lse, then the
    float32 backward kernel) gives the CPU's gradients (the plain versions);
    one launch of each per call, the plain forward and backward never."""
    from repro_torch.kernels import flash_attention as FA

    B, T, H, KV, D, causal = case
    q, k, v = _qkv(T * 3 + D, B, T, T, H, KV, D, torch.float32)
    do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(9),
                     device="cuda")
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        FA.reset_launch_counts()
        out = FA.flash_attention(*leaves, causal=causal, block_q=64, block_kv=128)
        out.backward(do.to(dev))
        grads[dev] = [out.detach()] + [t.grad for t in leaves]
        if dev == "cuda":
            assert FA.LAUNCHES["flash_attention_f32_lse"] == 1
            assert FA.LAUNCHES["flash_attention_backward_f32"] == 1
            assert FA.PLAIN_CUDA_CALLS == {"flash_attention": 0, "flash_attention_backward": 0}
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert float((got.cpu() - want).abs().max()) < 1e-4 * max(1.0, float(want.abs().max()))


def test_cuda_flash_backward_bf16_against_float32(card, full_fp32):
    """glm4-9b's heads in bf16 through the training route (K4 with lse,
    then the backward kernels): gradients within bf16 round-off of the
    float32 route's (the float32 kernel, then the float32 backward
    kernel)."""
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _qkv(21, 1, 256, 256, 32, 2, 128, torch.float32)
    do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(4),
                     device="cuda")
    grads = {}
    for dtype in (torch.float32, torch.bfloat16):
        leaves = [t.detach().to(dtype).requires_grad_() for t in (q, k, v)]
        FA.reset_launch_counts()
        FA.flash_attention(*leaves, causal=True).backward(do.to(dtype))
        f32 = dtype == torch.float32
        assert FA.LAUNCHES["flash_attention_backward"] == 1
        assert FA.LAUNCHES["flash_attention_backward_f32"] == int(f32)
        assert FA.LAUNCHES["flash_attention_backward_dq"] == int(not f32)
        assert FA.PLAIN_CUDA_CALLS["flash_attention_backward"] == 0
        grads[dtype] = [t.grad.float() for t in leaves]
    for got, want in zip(grads[torch.bfloat16], grads[torch.float32]):
        assert float((got - want).abs().max()) < 0.05 * float(want.abs().max())


# (B, Tq, Tk, H, KV, D, causal): the long route at glm4-9b's and granite's
# groups at short and ragged lengths, G = 1, a group of 48 (more rows than
# a tile's 64 per position run), not causal, and keys past the queries;
# the short route at SASRec's sequences (odd and even counts, D = 50), a
# group of 4 over one kv head (64 rows a sequence), an odd head dim
BWD_CASES = [
    (2, 37, 37, 6, 2, 64, True),
    (1, 130, 130, 48, 3, 64, True),
    (2, 65, 65, 4, 4, 128, False),
    (1, 300, 300, 32, 2, 128, True),
    (3, 100, 100, 3, 1, 128, True),
    (1, 50, 80, 8, 2, 64, True),
    (2, 77, 140, 24, 8, 64, False),
    (1, 50, 50, 1, 1, 50, True),
    (2, 50, 50, 1, 1, 50, True),
    (3, 50, 50, 1, 1, 50, True),
    (3, 50, 50, 1, 1, 50, False),
    (5, 16, 16, 4, 1, 64, True),
    (3, 33, 33, 1, 1, 17, True),
    # the long route's wgmma kernels at their edges: G = 1, 3, 16, 64 at
    # both head dims (row tiles of 64, 21, 4 and 1 positions), Tq = 129
    # (a ragged last row tile), Tk past and short of Tq, past one 128-key
    # tile, not causal, B = 3
    (1, 129, 129, 2, 2, 128, True),
    (2, 129, 129, 3, 3, 64, False),
    (1, 129, 129, 64, 1, 64, True),
    (1, 100, 60, 128, 2, 128, True),
    (2, 129, 200, 16, 1, 64, False),
    (3, 70, 150, 3, 1, 128, True),
    (1, 129, 129, 48, 1, 128, True),
]
# each gradient's relative L2 error and largest element error over its
# largest element (chip_smoke.py's BWD_L2_RTOL / BWD_MAX_RTOL): against the
# plain backward the bf16 rounding of p and ds (up to 2^-9 a product term)
# and of the outputs; against the tiled mirror only ex2.approx and the
# order of fp32 sums remain, with the rounding flips they cause
BWD_TOL = {"plain": (0.01, 0.02), "mirror": (0.004, 0.01)}


def _bwd_within(got, want, tol):
    l2, worst = tol
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a, b = a.float(), b.float()
        assert float((a - b).norm() / b.norm()) <= l2, name
        assert float((a - b).abs().max() / b.abs().max()) <= worst, name


def _bwd_inputs(seed, B, Tq, Tk, H, KV, D, causal):
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _qkv(seed, B, Tq, Tk, H, KV, D, torch.bfloat16)
    do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(seed + 1),
                     device="cuda").to(torch.bfloat16)
    out, lse = FA.flash_attention_op(q, k, v, None, causal, 0, True, 512, 1024)
    return q, k, v, out, lse, do


def _bwd_launches(q, k, splits):
    """The backward's kernel launches of one call: the short route's one,
    or the long route's row statistics, dK / dV and dQ kernels and, where
    the dK / dV rows are split, the reduce."""
    from repro_torch.kernels import flash_attention as FA

    want = {key: 0 for key in FA.LAUNCHES}
    route = FA._backward_kernel(q.dtype, q.shape, k.shape)
    if route in ("short", "f32"):
        want.update({"flash_attention_backward": 1, f"flash_attention_backward_{route}": 1})
    else:
        want.update(flash_attention_backward=1, flash_attention_backward_rowstat=1,
                    flash_attention_backward_dkdv=1, flash_attention_backward_dq=1,
                    flash_attention_backward_reduce=int(splits > 1))
    return want


@pytest.mark.parametrize("case", BWD_CASES, ids=[str(c).replace(" ", "") for c in BWD_CASES])
def test_cuda_backward_kernel_matches_plain_and_mirror(card, full_fp32, case):
    """The backward kernels against the plain backward and their tiled
    mirror; a second run gives the same bits; each kernel of the route
    launched once."""
    from repro_torch.kernels import flash_attention as FA

    B, Tq, Tk, H, KV, D, causal = case
    short = Tq == Tk and KV == 1 and Tq * H <= 64 and D <= 64
    assert FA._backward_kernel(torch.bfloat16, (B, Tq, H, D), (B, Tk, KV, D)) == (
        "short" if short else "long")
    q, k, v, out, lse, do = _bwd_inputs(Tq + H, *case)
    FA.reset_launch_counts()
    got = FA.flash_attention_backward_op(q, k, v, out, lse, do, causal, 512, 1024)[:3]
    torch.cuda.synchronize()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    splits = FA.backward_splits(B, Tq, Tk, H, KV, n_sm, D)
    assert FA.LAUNCHES == _bwd_launches(q, k, splits)
    assert FA.PLAIN_CUDA_CALLS["flash_attention_backward"] == 0
    again = FA.flash_attention_backward_op(q, k, v, out, lse, do, causal, 512, 1024)[:3]
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _bwd_within(got, FA.flash_attention_backward_plain(q, k, v, out, lse, do, causal=causal),
                BWD_TOL["plain"])
    _bwd_within(got, FA.flash_attention_backward_tiled_plain(q, k, v, out, lse, do,
                                                             causal=causal, splits=splits),
                BWD_TOL["mirror"])


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_cuda_backward_kernel_at_each_split_count(card, full_fp32, monkeypatch, splits):
    """The dK / dV kernel cut in 1 to 8 runs of row tiles (the wrapper's
    choice replaced): each within the mirror at the same count, and the
    counts within bf16 round-off of one another."""
    from repro_torch.kernels import flash_attention as FA

    case = (1, 200, 200, 16, 2, 128, True)
    q, k, v, out, lse, do = _bwd_inputs(5, *case)
    monkeypatch.setattr(FA, "backward_splits", lambda *a, **kw: splits)
    FA.reset_launch_counts()
    got = FA.flash_attention_backward_op(q, k, v, out, lse, do, True, 512, 1024)
    assert FA.LAUNCHES == _bwd_launches(q, k, splits)
    assert got[3].numel() == FA.backward_workspace(1, 200, 200, 16, 2, 128, splits,
                                                   torch.bfloat16)
    _bwd_within(got[:3], FA.flash_attention_backward_tiled_plain(
        q, k, v, out, lse, do, causal=True, splits=splits), BWD_TOL["mirror"])
    _bwd_within(got[:3], FA.flash_attention_backward_plain(q, k, v, out, lse, do),
                BWD_TOL["plain"])


def test_cuda_backward_kernel_refuses_what_it_does_not_take(card):
    """float16, a head dim off 64 / 128 over two kv heads, a sequence past
    the short route's one tile at D = 50, a non-contiguous output
    gradient: the launch raises, it never runs the plain version."""
    from repro_torch.kernels import flash_attention as FA

    q, k, v, out, lse, do = _bwd_inputs(3, 1, 40, 40, 4, 2, 64, True)
    plain = FA.PLAIN_CUDA_CALLS["flash_attention_backward"]
    with pytest.raises(ValueError):
        FA._launch_backward(q.half(), k.half(), v.half(), out.half(), lse, do.half(), True)
    with pytest.raises(ValueError):
        FA._launch_backward(q[..., :50].contiguous(), k[..., :50].contiguous(),
                            v[..., :50].contiguous(), out[..., :50].contiguous(), lse,
                            do[..., :50].contiguous(), True)
    with pytest.raises(ValueError):
        FA._launch_backward(*_bwd_inputs(4, 2, 65, 65, 1, 1, 50, True), True)
    with pytest.raises(ValueError):
        FA._launch_backward(q, k, v, out, lse, do.transpose(1, 2).contiguous().transpose(1, 2),
                            True)
    assert FA.PLAIN_CUDA_CALLS["flash_attention_backward"] == plain


def test_cuda_backward_short_route_past_131070_sequences(card, full_fp32):
    """SASRec's sequences (50 positions, one head, D = 50) at 131,073 a
    call: 65,537 blocks of two, the last one sequence alone; the first and
    last sequences against the plain backward and the mirror on those
    sequences alone, and a second run bit for bit."""
    from repro_torch.kernels import flash_attention as FA

    B = 131_073
    q, k, v, out, lse, do = _bwd_inputs(8, B, 50, 50, 1, 1, 50, True)
    FA.reset_launch_counts()
    got = FA.flash_attention_backward_op(q, k, v, out, lse, do, True, 512, 1024)[:3]
    torch.cuda.synchronize()
    assert FA.LAUNCHES == _bwd_launches(q, k, 1)
    again = FA.flash_attention_backward_op(q, k, v, out, lse, do, True, 512, 1024)[:3]
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for rows in (slice(0, 3), slice(65_535, 65_538), slice(B - 3, B)):
        part = [t[rows] for t in (q, k, v, out, lse, do)]
        mine = [g[rows] for g in got]
        _bwd_within(mine, FA.flash_attention_backward_plain(*part, causal=True),
                    BWD_TOL["plain"])
        _bwd_within(mine, FA.flash_attention_backward_tiled_plain(*part, causal=True),
                    BWD_TOL["mirror"])


def test_cuda_backward_long_route_on_a_grid_past_what_the_card_holds(card, full_fp32):
    """glm4-9b's heads (32 over 2, D = 128) at B = 8 x 4096 positions: the
    dK / dV kernel's blocks (512 key tiles of 128 keys x the runs) and the
    dQ kernel's 8,192, far more than the card holds at once; against the
    plain backward and the mirror, and bit for bit twice."""
    from repro_torch.kernels import flash_attention as FA

    case = (8, 4096, 4096, 32, 2, 128, True)
    q, k, v, out, lse, do = _bwd_inputs(12, *case)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    splits = FA.backward_splits(8, 4096, 4096, 32, 2, n_sm, 128)
    plan = FA.sm90_backward_plan(8, 4096, 4096, 32, 2, 128, n_sm)
    assert plan["blocks"] > 2 * n_sm and plan["dq_blocks"] > 2 * n_sm
    FA.reset_launch_counts()
    got = FA.flash_attention_backward_op(q, k, v, out, lse, do, True, 512, 1024)[:3]
    torch.cuda.synchronize()
    assert FA.LAUNCHES == _bwd_launches(q, k, splits)
    again = FA.flash_attention_backward_op(q, k, v, out, lse, do, True, 512, 1024)[:3]
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _bwd_within(got, FA.flash_attention_backward_plain(q, k, v, out, lse, do),
                BWD_TOL["plain"])
    _bwd_within(got, FA.flash_attention_backward_tiled_plain(q, k, v, out, lse, do,
                                                             splits=splits), BWD_TOL["mirror"])


# (B, Tq, Tk, H, KV, D, causal) of the float32 backward kernel: lm-100m's
# training attention first; ragged rows and keys, G = 1 to 64, D = 1, 7, 50
# (4- and 8-byte copies) and 100 / 128 (the wider instantiation), not
# causal, more keys than queries and more queries than keys
F32_BWD_CASES = [
    (4, 128, 128, 8, 4, 64, True),
    (2, 37, 37, 6, 2, 64, True),
    (1, 130, 130, 48, 3, 64, True),
    (2, 65, 65, 4, 4, 128, False),
    (3, 50, 50, 4, 1, 50, True),
    (2, 49, 49, 2, 1, 1, True),
    (3, 65, 65, 6, 2, 7, True),
    (1, 50, 80, 8, 2, 100, True),
    (2, 77, 140, 24, 8, 64, False),
    (1, 40, 20, 4, 2, 64, True),
    (1, 300, 300, 64, 1, 128, True),
]
# chip_smoke.py's BWD_F32_L2_RTOL / BWD_F32_MAX_RTOL: float32 on both sides,
# so only the order of the sums (and expf's last bits) differ, ~3e-7 of a
# gradient between the mirror and the plain version on the CPU
BWD_F32_TOL = (1e-5, 1e-5)


def _f32_bwd_inputs(seed, B, Tq, Tk, H, KV, D, causal):
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _qkv(seed, B, Tq, Tk, H, KV, D, torch.float32)
    do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(seed + 1),
                     device="cuda")
    out, lse = FA.flash_attention_op(q, k, v, None, causal, 0, True, 512, 1024)
    return q, k, v, out, lse, do


@pytest.mark.parametrize("case", F32_BWD_CASES,
                         ids=[str(c).replace(" ", "") for c in F32_BWD_CASES])
def test_cuda_f32_backward_kernel_matches_plain_and_mirror(card, full_fp32, case):
    """The float32 backward kernel against the plain backward and its tiled
    mirror; one launch a call, a second run bit for bit."""
    from repro_torch.kernels import flash_attention as FA

    B, Tq, Tk, H, KV, D, causal = case
    q, k, v, out, lse, do = _f32_bwd_inputs(Tq + H + D, *case)
    FA.reset_launch_counts()
    got = FA.flash_attention_backward_op(q, k, v, out, lse, do, causal, 512, 1024)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == _bwd_launches(q, k, 1)
    assert got[3].numel() == 0 and {g.dtype for g in got[:3]} == {torch.float32}
    again = FA.flash_attention_backward_op(q, k, v, out, lse, do, causal, 512, 1024)[:3]
    assert all(torch.equal(a, b) for a, b in zip(got[:3], again))
    _bwd_within(got[:3], FA.flash_attention_backward_plain(q, k, v, out, lse, do,
                                                           causal=causal), BWD_F32_TOL)
    _bwd_within(got[:3], FA.flash_attention_backward_f32_tiled_plain(q, k, v, out, lse, do,
                                                                     causal=causal),
                BWD_F32_TOL)
    if causal and Tk > Tq:  # keys no query sees
        assert float(got[1][:, Tq:].abs().max()) == 0.0 and float(got[2][:, Tq:].abs().max()) == 0.0


# (B, Tq, Tk, H, KV, D, causal) whose tiles split their walks 4, 2 and 1
# ways over a cluster: lm-100m's (key tile 0's 8 chunks, 2 a rank); one
# head, so three of a cluster's four ranks only pad it, and 150 rows a kv
# head (5 chunks over 4 ranks: 1, 1, 1, 2); 6 heads at D = 100 (DP 128),
# a cluster holding the ranks of two heads
F32_SPLIT_CASES = [
    (4, 128, 128, 8, 4, 64, True),
    (1, 75, 75, 2, 1, 64, True),
    (3, 100, 100, 6, 2, 100, True),
]


@pytest.mark.parametrize("case", F32_SPLIT_CASES,
                         ids=[str(c).replace(" ", "") for c in F32_SPLIT_CASES])
def test_cuda_f32_backward_cluster_split_matches_mirror(card, full_fp32, case):
    """The float32 backward kernel where its tiles' walks are split over a
    cluster's blocks, their shares added in rank order: within 1e-5 of the
    plain backward and of the mirror, which adds them in that order; two
    runs bit for bit; one launch."""
    from repro_torch.kernels import flash_attention as FA

    B, Tq, Tk, H, KV, D, causal = case
    kv_walks, q_walks = FA.f32_backward_walks(Tq, Tk, H, KV, causal)
    target = FA.f32_backward_target(B, KV, kv_walks, q_walks)
    assert {FA.f32_backward_split(n, target) for n in kv_walks + q_walks} > {1}
    q, k, v, out, lse, do = _f32_bwd_inputs(Tq * 3 + D, *case)
    FA.reset_launch_counts()
    got = FA.flash_attention_backward_op(q, k, v, out, lse, do, causal, 512, 1024)[:3]
    torch.cuda.synchronize()
    assert FA.LAUNCHES == _bwd_launches(q, k, 1)
    again = FA.flash_attention_backward_op(q, k, v, out, lse, do, causal, 512, 1024)[:3]
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _bwd_within(got, FA.flash_attention_backward_plain(q, k, v, out, lse, do, causal=causal),
                BWD_F32_TOL)
    _bwd_within(got, FA.flash_attention_backward_f32_tiled_plain(q, k, v, out, lse, do,
                                                                 causal=causal), BWD_F32_TOL)


def test_cuda_f32_backward_kernel_refuses_what_it_does_not_take(card):
    """A head dim past 128, more than 64 query heads a kv head, an lse of
    another shape, a non-contiguous output gradient: the float32 launch
    raises, it never runs the plain version."""
    from repro_torch.kernels import flash_attention as FA

    plain = FA.PLAIN_CUDA_CALLS["flash_attention_backward"]
    q, k, v = _qkv(3, 1, 20, 20, 2, 1, 136, torch.float32)
    lse = torch.zeros((1, 20, 2), device="cuda")
    with pytest.raises(ValueError):
        FA._launch_backward(q, k, v, q, lse, q, True)
    q, k, v = _qkv(3, 1, 20, 20, 128, 1, 8, torch.float32)
    with pytest.raises(ValueError):
        FA._launch_backward(q, k, v, q, torch.zeros((1, 20, 128), device="cuda"), q, True)
    q, k, v, out, lse, do = _f32_bwd_inputs(3, 1, 40, 40, 4, 2, 64, True)
    with pytest.raises(ValueError):
        FA._launch_backward(q, k, v, out, lse[:, :39].contiguous(), do, True)
    with pytest.raises(ValueError):
        FA._launch_backward(q, k, v, out, lse, do.transpose(1, 2).contiguous().transpose(1, 2),
                            True)
    assert FA.PLAIN_CUDA_CALLS["flash_attention_backward"] == plain


def test_cuda_f32_backward_kernel_past_65535_batch_rows(card, full_fp32):
    """65,537 sequences of 50 positions (one head, D = 50): the one 1-D
    grid of 4-block clusters over every sequence; the first, middle and
    last sequences against
    the plain backward and the mirror on those sequences alone, and a
    second run bit for bit."""
    from repro_torch.kernels import flash_attention as FA

    B = 65_537
    q, k, v, out, lse, do = _f32_bwd_inputs(8, B, 50, 50, 1, 1, 50, True)
    FA.reset_launch_counts()
    got = FA.flash_attention_backward_op(q, k, v, out, lse, do, True, 512, 1024)[:3]
    torch.cuda.synchronize()
    assert FA.LAUNCHES == _bwd_launches(q, k, 1)
    again = FA.flash_attention_backward_op(q, k, v, out, lse, do, True, 512, 1024)[:3]
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for rows in (slice(0, 3), slice(65_533, 65_536), slice(B - 3, B)):
        part = [t[rows] for t in (q, k, v, out, lse, do)]
        mine = [g[rows] for g in got]
        _bwd_within(mine, FA.flash_attention_backward_plain(*part, causal=True), BWD_F32_TOL)
        _bwd_within(mine, FA.flash_attention_backward_f32_tiled_plain(*part, causal=True),
                    BWD_F32_TOL)


@pytest.mark.parametrize("dtype,Tq", [(torch.bfloat16, 50), (torch.float32, 50),
                                      (torch.bfloat16, 1)], ids=["prefill", "f32", "decode"])
def test_cuda_k4_launches_past_65535_batch_rows(card, full_fp32, dtype, Tq):
    """SASRec's ``train_batch`` (65,536 sequences of 50, one head, D = 50):
    every K4 kernel walks the batch in chunks of CUDA's 65,535 grid rows,
    and the last row is computed like the first."""
    from repro_torch.kernels import flash_attention as FA

    B, Tk = 65_536, 50
    q, k, v = _qkv(5, B, Tq, Tk, 1, 1, 50, dtype)
    kw = dict(causal=Tq > 1, q_offset=Tk - Tq)
    got = FA.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    rows = torch.tensor([0, 1, 65_534, 65_535], device="cuda")
    want = FA.flash_attention_plain(q[rows], k[rows], v[rows], **kw)
    if dtype == torch.float32:
        assert float((got[rows] - want).abs().max()) < FLASH_TOL[dtype]
    else:
        _within(got[rows], want, BF16_ATOL)
    if Tq > 1:
        _, lse = FA._launch(q, k, v, True, 0, None, with_lse=True)
        _, want_lse = FA.flash_attention_plain(q[rows], k[rows], v[rows], causal=True,
                                               return_lse=True)
        assert float((lse[rows] - want_lse).abs().max()) < LSE_TOL[dtype]


# ---------------------------------------------------------------------------
# K4's float32 kernel at each block size; the bf16 prefill's packed
# sequences and its re-laid staging (a head dim that is not a multiple of 8)
# ---------------------------------------------------------------------------

# (B, Tq, Tk, H, KV, D, causal, q_offset, kv_length)
F32_CASES = [
    (4, 128, 128, 8, 4, 64, True, 0, None),          # lm-100m's training attention
    (2, 50, 50, 1, 1, 50, True, 0, None),            # SASRec's head (8-byte copies)
    (2, 49, 49, 2, 1, 1, True, 0, None),             # D = 1 (4-byte copies)
    (3, 65, 65, 6, 2, 7, True, 0, None),             # D = 7, G = 3: 15 of 16 rows
    (2, 64, 64, 4, 4, 63, False, 0, None),           # D = 63, not causal
    (2, 37, 130, 8, 2, 128, True, 60, [97, 130]),    # after a prefix, ragged kv_length
    (3, 1, 200, 16, 1, 96, False, 0, [0, 77, 200]),  # decode, a row with no key
]
F32_BLOCKS = [(case, rows) for case in F32_CASES for rows in (16, 32, 64)
              if case[3] // case[4] <= rows]


def _lse_within(lse, want, tol):
    """+inf exactly where the plain version has it, finite values within tol."""
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    fin = torch.isfinite(want)
    if bool(fin.any()):
        assert float((lse[fin] - want[fin]).abs().max()) < tol


@pytest.mark.parametrize("case, rows", F32_BLOCKS,
                         ids=[f"{c[:6]}-rows{r}".replace(" ", "") for c, r in F32_BLOCKS])
def test_cuda_f32_kernel_at_each_block_size(card, full_fp32, monkeypatch, case, rows):
    """The float32 kernel with each block size the plan can choose (the
    plan itself picks 16 rows at lm-100m's shape): output within 2e-5 and
    lse within 1e-5 of the plain version, the same output without lse."""
    from repro_torch.kernels import flash_attention as FA

    B, Tq, Tk, H, KV, D, causal, q_offset, kv_length = case
    q, k, v = _qkv(Tk + D + rows, B, Tq, Tk, H, KV, D, torch.float32)
    lengths = (None if kv_length is None
               else torch.tensor(kv_length, dtype=torch.int32, device="cuda"))
    monkeypatch.setattr(FA, "f32_block_rows", lambda *shape: (rows, 0))
    before = dict(FA.LAUNCHES)
    out, lse = FA._launch(q, k, v, causal, q_offset, lengths, with_lse=True)
    assert FA.LAUNCHES["flash_attention_f32_lse"] == before["flash_attention_f32_lse"] + 1
    want, want_lse = FA.flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset,
                                              kv_length=lengths, return_lse=True)
    assert float((out - want).abs().max()) < FLASH_TOL[torch.float32]
    _lse_within(lse, want_lse, LSE_TOL[torch.float32])
    assert torch.equal(FA._launch(q, k, v, causal, q_offset, lengths, with_lse=False)[0], out)
    for row, n in enumerate(kv_length or []):
        if n == 0:
            assert float(out[row].abs().max()) == 0.0


# (B, T, H, KV, D, causal, kv_length): queries are keys (Tq == Tk,
# q_offset == 0), so prefill_pack packs where T * H / KV <= 64
PACK_CASES = [
    (9, 50, 1, 1, 50, True, None),      # SASRec's shape at a small (odd) batch
    (5, 1, 1, 1, 50, True, None),       # T = 1: 128 sequences a block
    (7, 49, 1, 1, 50, True, None),
    (4, 64, 1, 1, 50, True, None),      # two sequences fill the block
    (3, 65, 1, 1, 50, True, None),      # past half a block: never packed
    (6, 50, 1, 1, 1, True, None),       # D = 1
    (6, 50, 1, 1, 7, True, None),       # D = 7: odd rows re-laid 2 bytes at a time
    (6, 50, 1, 1, 63, True, None),
    (5, 20, 2, 1, 50, True, None),      # G = 2 over one kv head: 3 sequences a block
    (5, 20, 4, 2, 50, True, None),      # KV = 2: rows copied and re-laid one by one
    (5, 30, 2, 2, 64, True, None),      # D % 8 == 0: 16-byte copies straight in
    (6, 50, 1, 1, 50, True, [50, 1, 0, 33, 49, 17]),  # ragged kv_length, packed
    (4, 50, 1, 1, 50, False, [50, 10, 0, 49]),        # not causal
]


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
@pytest.mark.parametrize("case", PACK_CASES, ids=[str(c[:5]).replace(" ", "") for c in PACK_CASES])
def test_cuda_prefill_packed_and_relaid_match_plain(card, monkeypatch, case, packed):
    """Whole sequences a block (or one query tile a block, the plan
    overridden to 1), staged straight or re-laid: within the element-wise
    bf16 bound of the plain version, lse within 1e-3, the same output
    without lse, and 0 on a row with no valid key."""
    from repro_torch.kernels import flash_attention as FA

    B, T, H, KV, D, causal, kv_length = case
    q, k, v = _qkv(T * 7 + D + H, B, T, T, H, KV, D, torch.bfloat16)
    lengths = (None if kv_length is None
               else torch.tensor(kv_length, dtype=torch.int32, device="cuda"))
    if not packed:
        monkeypatch.setattr(FA, "prefill_pack", lambda *shape: 1)
    before = dict(FA.LAUNCHES)
    out, lse = FA._launch(q, k, v, causal, 0, lengths, with_lse=True)
    assert FA.LAUNCHES["flash_attention_prefill_lse"] == before["flash_attention_prefill_lse"] + 1
    want, want_lse = FA.flash_attention_plain(q, k, v, causal=causal, kv_length=lengths,
                                              return_lse=True)
    _within(out, want, BF16_ATOL)
    _lse_within(lse, want_lse, LSE_TOL[torch.bfloat16])
    assert torch.equal(FA._launch(q, k, v, causal, 0, lengths, with_lse=False)[0], out)
    for row, n in enumerate(kv_length or []):
        if n == 0:
            assert float(out[row].abs().max()) == 0.0


@pytest.mark.parametrize("shape", [
    # (B, Tq, Tk, H, KV, D, causal, q_offset, kv_length): never packed
    (2, 40, 96, 1, 1, 50, True, 30, [70, 61]),      # after a prefix: one slab a tile
    (2, 40, 96, 4, 2, 50, True, 30, [70, 61]),      # KV = 2: row by row
    (1, 300, 300, 1, 1, 50, True, 0, None),         # five tiles of one long sequence
    (2, 130, 130, 3, 3, 63, False, 0, [130, 64]),   # odd D row by row, not causal
    (2, 77, 77, 1, 1, 7, True, 0, [77, 40]),
])
def test_cuda_prefill_relaid_over_a_cache(card, shape):
    from repro_torch.kernels import flash_attention as FA

    B, Tq, Tk, H, KV, D, causal, q_offset, kv_length = shape
    q, k, v = _qkv(Tq + Tk + D, B, Tq, Tk, H, KV, D, torch.bfloat16)
    lengths = (None if kv_length is None
               else torch.tensor(kv_length, dtype=torch.int32, device="cuda"))
    kw = dict(causal=causal, q_offset=q_offset, kv_length=lengths)
    _within(FA.flash_attention(q, k, v, **kw), FA.flash_attention_plain(q, k, v, **kw),
            BF16_ATOL)


def test_cuda_packed_prefill_walks_batches_past_one_launch(card):
    """Two SASRec sequences a block: 131,073 batch rows take 65,535 blocks
    in a first launch and the last 3 rows in a second; rows on both sides
    of the cut are computed like the first."""
    from repro_torch.kernels import flash_attention as FA

    B, T = 2 * 65_535 + 3, 50
    q, k, v = _qkv(11, B, T, T, 1, 1, 50, torch.bfloat16)
    out, lse = FA._launch(q, k, v, True, 0, None, with_lse=True)
    torch.cuda.synchronize()
    rows = torch.tensor([0, 1, 131_068, 131_069, 131_070, 131_071, 131_072], device="cuda")
    want, want_lse = FA.flash_attention_plain(q[rows], k[rows], v[rows], causal=True,
                                              return_lse=True)
    _within(out[rows], want, BF16_ATOL)
    _lse_within(lse[rows], want_lse, LSE_TOL[torch.bfloat16])


def test_cuda_segment_sums_repeat_their_bits(packed):
    """The segment path sums in a fixed order on the card too: ``hits(30)``
    (1-D frontiers, segment path both ways, DEDUP-C subtraction) run twice
    in default mode gives the same bits, and the segment backend's batched
    PageRank step repeats its bits."""
    import dataclasses

    from repro_torch.core import algorithms

    assert not torch.are_deterministic_algorithms_enabled()
    seg = dataclasses.replace(packed, backend="segment")
    first = algorithms.hits(packed, num_iters=30)
    second = algorithms.hits(seg, num_iters=30)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    x = torch.rand((packed.n_real, 32), device="cuda")
    assert torch.equal(engine.propagate(seg, x), engine.propagate(seg, x))


def test_cuda_sharded_pack_uploads_the_same_bytes(card):
    """``to_device_packed(pack_shard_edges=)`` packs each layer slice by
    slice and OR-merges the slices: the uploaded bitmaps, and the row
    indices built from them on the card, equal an unsharded upload's."""
    import dataclasses

    g = extract(dblp_catalog(700, 1200, 6.0, seed=5), Q1).graph
    corr = dedup.build_correction(g)
    whole = engine.to_device_packed(g, correction=corr, device=card)
    biggest = max(e.n_edges for e in g.chains[0].edges)
    sharded = engine.to_device_packed(g, correction=corr, device=card,
                                      pack_shard_edges=max(biggest // 8, 1))

    def tensors(obj):
        if isinstance(obj, torch.Tensor):
            return [obj]
        if dataclasses.is_dataclass(obj):
            return [t for f in dataclasses.fields(obj) for t in tensors(getattr(obj, f.name))]
        if isinstance(obj, (tuple, list)):
            return [t for v in obj for t in tensors(v)]
        return []

    a, b = tensors(whole), tensors(sharded)
    assert len(a) == len(b) > 20
    assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def _tier_tensors(obj):
    import dataclasses

    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj) for t in _tier_tensors(getattr(obj, f.name))]
    if isinstance(obj, (tuple, list)):
        return [t for v in obj for t in _tier_tensors(v)]
    return []


def test_cuda_tier_runs_k1_k3_and_matches_segment(card):
    """A small tier on the card: every propagating kind launches the
    kernels it needs (K1, K2 min, K2 max, K3), and each answer equals the
    same request served by a tier whose uploads take the segment path."""
    import dataclasses

    from repro_torch.core import algorithms
    from repro_torch.serve import GraphServingTier, ServeRequest
    from repro_torch.serve import tier as tier_mod

    g = extract(dblp_catalog(700, 1200, 6.0, seed=5), Q1).graph
    tier = GraphServingTier(max_batch=8, device=card, result_cache=False)
    tier.add_tenant("dblp", g, packed=True)
    reqs = [ServeRequest(i * 4 + j, "dblp", kind, node)
            for i, kind in enumerate(k for k in tier_mod.KINDS if k != "triangles")
            for j, node in enumerate((3, 17, 41, 99))]
    K.reset_launch_counts()
    got = tier.serve(reqs)
    launches = dict(K.LAUNCHES)
    assert all(v > 0 for v in launches.values()), launches

    t = tier.tenants["dblp"]
    exact = dataclasses.replace(t.device, backend="segment")
    counts = dataclasses.replace(t.counts_device, backend="segment")
    before = dict(K.LAUNCHES)
    for kind in {r.kind for r in reqs}:
        nodes = [r.node for r in reqs if r.kind == kind]
        qids = [r.qid for r in reqs if r.kind == kind]
        width = tier._bucket_width(len(nodes))
        padded = nodes + [nodes[0]] * (width - len(nodes))
        if kind == "bfs":
            want = algorithms.bfs_multi(exact, padded)
        elif kind == "ppr":
            want = algorithms.personalized_pagerank(
                exact, algorithms.one_hot_frontier(g.n_real, padded, device=card))
        elif kind == "common_neighbors":
            want = algorithms.common_neighbors_multi(counts, padded)
        elif kind == "shortest":
            want = algorithms.shortest_paths_multi(exact, padded)
        elif kind == "widest":
            want = algorithms.widest_paths_multi(exact, padded)
        else:  # scc
            labels = algorithms.scc_labels(exact)
            want = torch.from_numpy(
                (labels[:, None] == labels[np.asarray(padded)][None, :]).astype(np.float32))
        want = want.cpu().numpy()
        for i, q in enumerate(qids):
            if kind == "ppr":
                np.testing.assert_allclose(got[q], want[:, i], rtol=1e-5, atol=1e-6)
            else:
                assert np.array_equal(got[q], want[:, i]), (kind, q)
    assert K.LAUNCHES == before, "the segment path launched a kernel"


def test_cuda_tier_reupload_after_eviction_is_byte_equal(card):
    from repro_torch.serve import GraphServingTier, ServeRequest

    g = extract(dblp_catalog(700, 1200, 6.0, seed=5), Q1).graph
    tier = GraphServingTier(max_batch=8, device=card, result_cache=False)
    tier.add_tenant("dblp", g, packed=True)
    first = tier.serve([ServeRequest(0, "dblp", "ppr", 3)])
    t = tier.tenants["dblp"]
    old = [x.clone() for x in _tier_tensors((t.device, t.counts_device))]
    tier.evict_tenant("dblp")
    assert t.device is None and tier.budget.n_evictions == 1
    again = tier.serve([ServeRequest(1, "dblp", "ppr", 3)])
    new = _tier_tensors((t.device, t.counts_device))
    assert t.n_uploads == 2 and len(new) == len(old) > 20
    assert all(a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(new, old))
    assert first[0].tobytes() == again[1].tobytes()


def _nccl_banded_rank(rank, world):
    """Banded PageRank at ``SMOKE``'s counts on the card, inside an NCCL
    group, against the engine's segment-path PageRank on the same upload."""
    import torch.distributed as dist

    from repro_torch.configs.graphgen_paper import SMOKE
    from repro_torch.core import algorithms
    from repro_torch.core.banding import band_partition, make_banded_pagerank
    from repro_torch.launch.distributed_analytics import build_graph

    g = build_graph(SMOKE.n_real, SMOKE.n_virtual, SMOKE.n_in_edges)
    corr = dedup.build_correction(g)
    dev = engine.to_device(g, correction=corr, device="cuda")
    ref = algorithms.pagerank(dev, num_iters=SMOKE.pagerank_iters)
    banded = band_partition(g, corr, 8, algorithms.out_degrees(dev).cpu().numpy())
    K.reset_launch_counts()
    fn = make_banded_pagerank(None, banded.n_real, banded.n_virtual, 8,
                              iters=SMOKE.pagerank_iters)
    got = fn(banded.local(0, 8, "cuda"))
    torch.cuda.synchronize()
    return (dist.get_backend(), got.device.type, float((got[: g.n_real] - ref).abs().max()),
            dict(K.LAUNCHES))


def test_cuda_banded_pagerank_on_an_nccl_world_of_one(card, tmp_path):
    from repro_torch.distributed.world import spawn_world

    backend, where, diff, launches = spawn_world(
        _nccl_banded_rank, 1, backend="nccl", timeout_s=300, store_dir=str(tmp_path))[0]
    assert (backend, where) == ("nccl", "cuda")
    assert diff < 1e-7
    assert not any(launches.values())  # segment sums: K1-K3 never launch


def test_cuda_moe_layer_repeats_its_bits_and_matches_cpu(card):
    """The MoE layer on the card in bf16 at granite's widths: two runs give
    the same bits (no atomics on its path), and the inference route
    (cuBLAS writing float32) and the autograd route (operands widened)
    route alike and agree within the bf16 tolerance, at a capacity that
    drops slots."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe

    # capacity factor 0.5: C = 128 slots an expert under a mean load of 205
    cfg = MoEConfig(n_experts=40, top_k=8, d_expert=512, capacity_factor=0.5)
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = moe.moe_init(gen, 1536, cfg, "cuda", torch.bfloat16)
    x = torch.randn((1024, 1536), generator=gen, device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        first, m = moe.moe_apply(params, x, cfg)
        again, _ = moe.moe_apply(params, x, cfg)
    assert torch.equal(first, again) and float(m["moe_drop_fraction"]) > 0
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    widened, wm = moe.moe_apply(leaves, x, cfg)
    assert float(wm["moe_drop_fraction"]) == float(m["moe_drop_fraction"])
    assert float((widened.float() - first.float()).abs().max()) < 2e-2


def _nccl_sharded_step_rank(rank, world):
    """granite-moe-3b-a800m SMOKE (float32, its ``CONFIG`` rules, minimal
    remat: the recompute runs on autograd's thread): two steps on the
    card, plain, then with its state as DTensors on a (1, 1) mesh over the
    NCCL group of one."""
    import dataclasses

    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import registry
    from repro_torch.distributed import sharding
    from repro_torch.models import transformer
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import steps

    mod = registry.get_arch("granite-moe-3b-a800m")
    cfg = dataclasses.replace(mod.SMOKE, dtype="float32", microbatches=2,
                              remat_policy="minimal",
                              sharding_rules=dict(mod.CONFIG.sharding_rules))
    axes = transformer.logical_axes(cfg)
    mesh = DeviceMesh("cuda", torch.zeros((1, 1), dtype=torch.int64),
                      mesh_dim_names=("data", "model"))
    rules = dict(cfg.sharding_rules)
    gen = torch.Generator(device="cuda").manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen, device="cuda")
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    out = []
    for sharded in (False, True):
        params = transformer.init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                                         "cuda", dtype=torch.float32)
        o = opt_lib.adamw(1e-3)
        state, b = steps.init_train_state(params, o), batch
        if sharded:
            state = sharding.distribute_state(state, axes, rules, mesh)
            rows = sharding.batch_placements(rules, mesh)
            b = sharding.place_tree(batch, {"tokens": rows, "labels": rows}, mesh)
        step = steps.build_lm_train_step(cfg, o)
        ms = []
        with sharding.use_mesh_rules(mesh, rules):
            for _ in range(2):
                state, m = step(state, b)
                ms.append((float(m["loss"]), float(m["grad_norm"])))
        leaves = {"/".join(p): (v.to_local() if sharded else v).cpu()
                  for p, v in opt_lib.tree_paths(state["params"])}
        out.append((ms, leaves))
    return out


def test_cuda_sharded_step_on_an_nccl_mesh_of_one_equals_the_plain_step(card, tmp_path):
    """On a (1, 1) mesh every DTensor op runs the local op of the plain
    step: two steps (2 microbatches each) give the same losses, norms and
    params bit for bit."""
    from repro_torch.distributed.world import spawn_world

    (plain, plain_params), (dt, dt_params) = spawn_world(
        _nccl_sharded_step_rank, 1, backend="nccl", timeout_s=300, store_dir=str(tmp_path))[0]
    assert plain == dt
    for k, v in plain_params.items():
        assert torch.equal(v, dt_params[k]), k


def test_cuda_gnn_step_repeats_its_bits(card):
    """A meshgraphnet step on the card twice from the same state: the same
    loss, norm and params bit for bit (the segment sums add in a fixed
    order; ``index_add_`` would add with atomics)."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.data.graphs import graph_batch_from_numpy, random_graph
    from repro_torch.models import gnn
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import steps

    cfg = dataclasses.replace(registry.get_arch("meshgraphnet").SMOKE, dtype="float32")
    src, dst, feats, pos = random_graph(2000, 30000, 6, seed=1, with_positions=True)
    target = torch.randn((2000, cfg.d_out), generator=torch.Generator().manual_seed(2))
    runs = []
    for _ in range(2):
        g = graph_batch_from_numpy(src, dst, feats, positions=pos, device="cuda")
        params = gnn.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), 6,
                                 device="cuda")
        o = opt_lib.adamw(1e-3)
        state, m = steps.build_gnn_train_step(cfg, o)(
            steps.init_train_state(params, o), {"graph": g, "target": target.cuda()})
        runs.append((float(m["loss"]), float(m["grad_norm"]),
                     {"/".join(p): v.cpu() for p, v in opt_lib.tree_paths(state["params"])}))
    assert runs[0][:2] == runs[1][:2]
    for k, v in runs[0][2].items():
        assert torch.equal(v, runs[1][2][k]), k
