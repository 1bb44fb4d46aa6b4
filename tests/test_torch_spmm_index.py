"""The row index of the packed operands and the plain mirror of the SpMM
kernels' arithmetic over it, on the CPU.

* ``bitmap_index_plain`` / ``bitmap_index_fused_plain`` against the COO
  edges and correction triples the operands were packed from.
* ``bitmap_spmm_index_plain`` / ``bitmap_spmm_fused_index_plain`` (the
  kernels' merge-path ranges, in-range folds and fixed-order carry pass)
  against the bitmap plain versions and against the JAX package's Pallas
  kernels in interpret mode, at the default range length and at short
  ones, where rows span many ranges.

Frontiers are integer-valued where a test says "exactly" (every sum is
exact, so any order gives the same bits); float frontiers are held to
``rtol=1e-5, atol=1e-6``, the tolerance the reference uses for PageRank.
The CUDA builder and kernels are held to these on the card in
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import dedup as ref_dedup
from repro.core import engine as ref_engine
from repro.core import extract as ref_extract
from repro.data.synth import dblp_catalog as ref_dblp_catalog
from repro.kernels.bitmap_spmm import bitmap_spmm_fused_pallas, bitmap_spmm_pallas

from repro_torch.core import dedup, engine, extract
from repro_torch.core.condensed import BipartiteEdges
from repro_torch.core.interop import device_packed_from_arrays, packed_arrays
from repro_torch.data.synth import dblp_catalog
from repro_torch.kernels import bitmap_index as BI
from repro_torch.kernels import bitmap_spmm as K
from repro_torch.kernels.pack import TILE, pack_bipartite

Q1 = """
Nodes(ID, Name) :- Author(ID, Name).
Edges(ID1, ID2) :- AuthorPub(ID1, PubID), AuthorPub(ID2, PubID).
"""

ZERO = {"sum": 0.0, "min": float("inf"), "max": 0.0}
FEAT = 8
FB = 128  # the reference pads the feature axis to its feature block
# range lengths: one item (every row split at every entry), short ranges
# that split most rows, and the wrappers' default
RANGES = [1, 7, None]


@pytest.fixture(scope="module")
def port_graph():
    """A small DBLP graph uploaded to the CPU, with its host half."""
    g = extract(dblp_catalog(300, 500, 6.0, seed=5), Q1).graph
    corr = dedup.build_correction(g)
    return g, corr, engine.to_device_packed(g, correction=corr, backend="cuda", device="cpu")


@pytest.fixture(scope="module")
def ref_pair():
    """(reference DevicePacked, port DevicePacked on the CPU), same operands."""
    cat = ref_dblp_catalog(n_authors=300, n_pubs=500, mean_authors_per_pub=6.0, seed=5)
    g = ref_extract(cat, Q1, mode="condensed").graph
    ref = ref_engine.to_device_packed(g, correction=ref_dedup.build_correction(g),
                                      backend="pallas")
    arrays, meta = packed_arrays(ref)
    return ref, device_packed_from_arrays(arrays, meta, "cpu")


def _frontier(rng, n, op, feat=FEAT):
    x = rng.integers(0, 7, (n, feat)).astype(np.float32)
    if op == "min":
        x[rng.random((n, feat)) < 0.5] = np.inf
    elif op == "max":
        x = (x > 3).astype(np.float32)
        x[rng.random((n, feat)) < 0.2] = -np.inf  # every -inf maps to zero
    return torch.from_numpy(x)


def _csr_of(dst, src, n_rows, *extra):
    """Expected index: entries sorted by (dst, src), as int32."""
    order = np.lexsort((src, dst))
    row_ptr = np.zeros(n_rows + 1, np.int64)
    row_ptr[1:] = np.cumsum(np.bincount(dst, minlength=n_rows))
    return (row_ptr.astype(np.int32), src[order].astype(np.int32),
            *(e[order].astype(np.int32) for e in extra))


def _plain_args(ops):
    return ops.slot_src, ops.slot_row, ops.row_start, ops.row_count, ops.bitmaps


def _fused_plain_args(f):
    return (f.kind, f.main_src, f.corr_src, f.main_idx, f.corr_idx, f.slot_row,
            f.row_start, f.row_count, f.bitmaps, f.planes)


# ---------------------------------------------------------------------------
# The index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("layer", [0, 1])
def test_index_is_the_layers_edges_by_destination(port_graph, layer, reverse):
    """Each row's entries are the layer's edges into it, in stream order:
    slots ascend by source tile and columns within a slot, so sources
    ascend."""
    g, _, dev = port_graph
    e = g.chains[0].edges[layer]
    d = dev.chains[0][layer]
    ops = d.rev if reverse else d.fwd
    src, dst = (e.dst, e.src) if reverse else (e.src, e.dst)
    n_rows = int(ops.row_start.shape[0]) * TILE
    want = _csr_of(np.asarray(dst), np.asarray(src), n_rows)
    got = BI.bitmap_index_plain(*_plain_args(ops))
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        assert np.array_equal(a.numpy(), b)
    assert np.array_equal(ops.row_ptr.numpy(), want[0])  # the uploaded index
    assert np.array_equal(ops.col.numpy(), want[1])


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_fused_index_is_last_layer_then_correction(port_graph, reverse):
    """Per row: the fused layer's edges (weight 0, sources ascending), then
    the correction triples into it (weight = count, sources ascending)."""
    g, corr, dev = port_graph
    cs, cd, cm = (np.asarray(a) for a in corr)
    chain = g.chains[-1].edges
    if reverse:
        e, f = chain[0], dev.fused_rev
        m_src, m_dst, c_src, c_dst = e.dst, e.src, cd, cs
    else:
        e, f = chain[-1], dev.fused_fwd
        m_src, m_dst, c_src, c_dst = e.src, e.dst, cs, cd
    n_rows = int(f.row_start.shape[0]) * TILE
    n_main = len(m_src)
    # main entries sort before correction entries within a row
    kind = np.r_[np.zeros(n_main, np.int64), np.ones(len(c_src), np.int64)]
    dst = np.r_[m_dst, c_dst].astype(np.int64)
    src = np.r_[m_src, c_src].astype(np.int64)
    weight = np.r_[np.zeros(n_main, np.int64), cm.astype(np.int64)]
    order = np.lexsort((src, kind, dst))
    row_ptr = np.zeros(n_rows + 1, np.int64)
    row_ptr[1:] = np.cumsum(np.bincount(dst, minlength=n_rows))
    got = BI.bitmap_index_fused_plain(*_fused_plain_args(f), f.plane_weights)
    assert np.array_equal(got[0].numpy(), row_ptr)
    assert np.array_equal(got[1].numpy(), src[order])
    assert np.array_equal(got[2].numpy(), weight[order])
    assert int(weight.max()) >= 2 ** (f.planes.shape[1] - 1)  # the top plane is used
    for a, b in zip((f.row_ptr, f.col, f.weight), got):
        assert torch.equal(a, b)


def test_index_pad_slots_and_empty_rows():
    """Upper row tiles with no edge hold one all-zero pad slot each: their
    rows are empty in the index, and so are rows of a tile with edges
    that receive none."""
    rng = np.random.default_rng(11)
    key = np.unique(rng.integers(0, 90, 700) * 260 + rng.integers(0, 260, 700))
    s, d = key % 260, key // 260
    bsb = pack_bipartite(BipartiteEdges(s, d, 260, 450))
    ops = engine._upload_operands(bsb, "cpu")
    assert bsb.n_row_tiles == 4 and int(ops.row_count[1:].sum()) == 3  # three pad slots
    want = _csr_of(d, s, 4 * TILE)
    assert np.array_equal(ops.row_ptr.numpy(), want[0])
    assert np.array_equal(ops.col.numpy(), want[1])
    assert np.diff(want[0])[90:].sum() == 0  # the rest of tile 0 and the pad tiles


def test_index_builders_refuse_bad_operands(port_graph):
    _, _, dev = port_graph
    ops = dev.chains[0][0].fwd
    with pytest.raises(ValueError, match="int32"):
        BI.bitmap_index(ops.slot_src.long(), ops.slot_row, ops.row_start, ops.row_count,
                        ops.bitmaps)
    with pytest.raises(ValueError, match="words"):
        BI.bitmap_index(ops.slot_src, ops.slot_row, ops.row_start, ops.row_count,
                        ops.bitmaps.reshape(-1, 64, 8))
    before = dict(BI.INDEX_BUILDS)
    BI.bitmap_index(*_plain_args(ops))
    assert BI.INDEX_BUILDS == before  # the plain version builds nothing on the card


def test_to_device_packed_carries_the_index(port_graph):
    """Both directions of every layer and both fused streams carry their
    index, and ``device_graph_bytes`` counts it beside the packed operands."""
    _, _, dev = port_graph
    for layer in dev.chains[0]:
        for ops in (layer.fwd, layer.rev):
            assert ops.row_ptr.shape[0] == ops.row_start.shape[0] * TILE + 1
            assert ops.col.shape[0] == int(ops.row_ptr[-1]) > 0
            packed = [getattr(ops, k) for k in engine.PACKED_TABLES]
            assert engine.device_graph_bytes(ops) == (
                engine.device_graph_bytes(packed) + 4 * (ops.row_ptr.numel() + ops.col.numel()))
    for f in (dev.fused_fwd, dev.fused_rev):
        assert f.col.shape == f.weight.shape and f.col.shape[0] == int(f.row_ptr[-1])
        stream = [getattr(f, k) for k in engine.FUSED_TABLES]
        index = 4 * (f.row_ptr.numel() + f.col.numel() + f.weight.numel())
        assert engine.device_graph_bytes(f) == engine.device_graph_bytes(stream) + index


# ---------------------------------------------------------------------------
# The mirror of the kernels' arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("items", RANGES, ids=["1", "7", "default"])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_mirror_equals_bitmap_plain_on_integers(port_graph, reverse, op, items):
    _, _, dev = port_graph
    rng = np.random.default_rng(len(op) + 3 * reverse)
    for layer in dev.chains[0]:
        ops = layer.rev if reverse else layer.fwd
        n_in, n_out = (layer.n_dst, layer.n_src) if reverse else (layer.n_src, layer.n_dst)
        x = _frontier(rng, n_in, op)
        want = K.bitmap_spmm_plain(*_plain_args(ops), x, n_out, op, ZERO[op])
        got = K.bitmap_spmm_index_plain(ops.row_ptr, ops.col, x, n_out, op, ZERO[op], items)
        assert torch.equal(got, want)


@pytest.mark.parametrize("items", RANGES, ids=["1", "7", "default"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_fused_mirror_equals_bitmap_plain(port_graph, reverse, items):
    """Exactly on integer frontiers; to float32 round-off on float ones
    (the mirror adds in the kernel's order, the plain version plane by
    plane)."""
    _, _, dev = port_graph
    f = dev.fused_rev if reverse else dev.fused_fwd
    chain = dev.chains[-1]
    n_h = chain[0].n_dst if reverse else chain[-1].n_src
    rng = np.random.default_rng(20 + reverse)
    for integer in (True, False):
        if integer:
            h, x = _frontier(rng, n_h, "sum"), _frontier(rng, dev.n_real, "sum")
        else:
            h = torch.from_numpy(rng.random((n_h, FEAT)).astype(np.float32))
            x = torch.from_numpy(rng.random((dev.n_real, FEAT)).astype(np.float32) / 64)
        want = K.bitmap_spmm_fused_plain(*_fused_plain_args(f), h, x, f.n_out, f.plane_weights)
        got = K.bitmap_spmm_fused_index_plain(f.row_ptr, f.col, f.weight, h, x, f.n_out, items)
        if integer:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("items", RANGES, ids=["1", "7", "default"])
def test_mirror_float_frontiers_within_roundoff(port_graph, items):
    _, _, dev = port_graph
    rng = np.random.default_rng(3)
    layer = dev.chains[0][0]
    x = torch.from_numpy(rng.random((layer.n_src, 16)).astype(np.float32))
    ops = layer.fwd
    for op in ("sum", "min", "max"):
        got = K.bitmap_spmm_index_plain(ops.row_ptr, ops.col, x, layer.n_dst, op, ZERO[op], items)
        want = K.bitmap_spmm_plain(*_plain_args(ops), x, layer.n_dst, op, ZERO[op])
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_mirror_gives_the_same_bits_twice(port_graph):
    """The order of every float sum is fixed by the index and the range
    length, so two calls agree bit for bit (the kernels' launch-to-launch
    property, which tests/test_torch_cuda.py checks on the card)."""
    _, _, dev = port_graph
    rng = np.random.default_rng(4)
    ops = dev.chains[0][1].fwd
    x = torch.from_numpy(rng.random((dev.chains[0][1].n_src, 32)).astype(np.float32))
    n_out = dev.chains[0][1].n_dst
    first = K.bitmap_spmm(ops.row_ptr, ops.col, x, n_out)
    assert torch.equal(first, K.bitmap_spmm(ops.row_ptr, ops.col, x, n_out))
    f = dev.fused_fwd
    h = torch.from_numpy(rng.random((dev.chains[-1][-1].n_src, 32)).astype(np.float32))
    xr = torch.from_numpy(rng.random((dev.n_real, 32)).astype(np.float32))
    a = K.bitmap_spmm_fused(f.row_ptr, f.col, f.weight, h, xr, f.n_out)
    assert torch.equal(a, K.bitmap_spmm_fused(f.row_ptr, f.col, f.weight, h, xr, f.n_out))


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_skewed_row_spans_many_ranges(op):
    """One destination row with 700 entries beside light ones: at 32 items
    a range it spans over 20 ranges, whose partials the carry pass folds in
    range order; at 3 every row is split."""
    rng = np.random.default_rng(8)
    heavy = np.arange(700)
    light_dst = rng.integers(0, 200, 900)
    light_src = rng.integers(0, 700, 900)
    key = np.unique(np.r_[np.full(700, 37) * 700 + heavy, light_dst * 700 + light_src])
    s, d = key % 700, key // 700
    ops = engine._upload_operands(pack_bipartite(BipartiteEdges(s, d, 700, 200)), "cpu")
    assert int(ops.row_ptr[38] - ops.row_ptr[37]) >= 700
    x = _frontier(rng, 700, op, feat=4)
    want = K.bitmap_spmm_plain(*_plain_args(ops), x, 200, op, ZERO[op])
    for items in (3, 32, None):
        got = K.bitmap_spmm_index_plain(ops.row_ptr, ops.col, x, 200, op, ZERO[op], items)
        assert torch.equal(got, want), items


def test_cpu_wrappers_run_the_mirror_and_launch_nothing(port_graph):
    _, _, dev = port_graph
    rng = np.random.default_rng(5)
    layer = dev.chains[0][0]
    x = _frontier(rng, layer.n_src, "sum")
    before = dict(K.LAUNCHES)
    got = K.bitmap_spmm(layer.fwd.row_ptr, layer.fwd.col, x, layer.n_dst, range_items=5)
    assert K.LAUNCHES == before
    assert torch.equal(got, K.bitmap_spmm_index_plain(layer.fwd.row_ptr, layer.fwd.col, x,
                                                      layer.n_dst, range_items=5))


# ---------------------------------------------------------------------------
# Launch shapes by frontier width
# ---------------------------------------------------------------------------

# merged items (row ends + entries) of a small graph, and about those of
# the DBLP smoke graph's author -> publication layer and fused stream
TOTALS = (1_000, 700_000, 4_000_000)
# F -> (vec, log_g) of a 16-byte aligned frontier, and the range length at
# each of TOTALS: F <= 32 as before the wide route; F > 32 with 16-byte
# gathers is the wide route (one group of 16 or 32 lanes owns 128 features)
GRID = {
    1: (1, 0, (64, 64, 64)),
    4: (4, 0, (64, 64, 64)),
    32: (4, 3, (64, 64, 128)),
    64: (4, 4, (64, 64, 64)),
    128: (4, 5, (64, 64, 128)),
    130: (1, 5, (64, 64, 128)),
    256: (4, 5, (64, 64, 128)),
}


def _parent_lanes(vec, feat):
    """Lanes of a group before the wide route: 32 features a block."""
    return min(32 // vec, K._pow2ceil(-(-min(feat, 32) // vec)))


def _parent_range_items(total, feat):
    """The range length before the wide route."""
    lanes = min(8, K._pow2ceil(-(-min(feat, 32) // 4)))
    return min(512, max(64, K._pow2ceil(-(-total * lanes // (1 << 18)))))


@pytest.mark.parametrize("feat", sorted(GRID))
def test_grid_and_range_lengths_by_width(feat):
    """``_grid``'s vector width, group and range length at each width, the
    range length a function of the shapes alone (a frontier off a 16-byte
    boundary takes 4-byte gathers on the 32-feature route, with the same
    ranges, so its float sums keep their bits), and every F <= 32 value the
    one from before the wide route."""
    vec, log_g, lengths = GRID[feat]
    x = torch.zeros((40, feat))
    off = torch.zeros(40 * feat + 1)[1:].view(40, feat)
    assert x.data_ptr() % 16 == 0 and off.data_ptr() % 16 == 4
    for total, items in zip(TOTALS, lengths):
        assert K.default_range_items(total, feat) == items
        groups = -(-total // items)
        assert K._grid((x,), total - 30, 30, None) == (vec, log_g, items, groups)
        assert K._grid((x, x), total - 30, 30, 7) == (vec, log_g, 7, -(-total // 7))
        one = _parent_lanes(1, feat).bit_length() - 1
        assert K._grid((x, off), total - 30, 30, None) == (1, one, items, groups)
        if feat <= 32:
            assert items == _parent_range_items(total, feat)
            assert (1 << log_g) == _parent_lanes(vec, feat)
    if feat > 32 and vec == 4:
        assert (4 << log_g) == min(K.WIDE_BLOCK, K._pow2ceil(feat))


# ---------------------------------------------------------------------------
# Against the JAX package's Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

# frontier widths held against the Pallas kernels: a narrow one, the served
# width and the analytics' 128-column blocks (the kernels' wide route)
PALLAS_FEATS = [FEAT, 32, 128]


@pytest.mark.parametrize("feat", PALLAS_FEATS)
@pytest.mark.parametrize("items", RANGES, ids=["1", "7", "default"])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_mirror_matches_pallas(ref_pair, op, items, feat):
    """The reference's own operands, indexed by the port: the mirror over
    the index equals the Pallas kernel on the bitmaps, pad rows
    included."""
    ref, port = ref_pair
    rl, pl_ = ref.chains[0][1], port.chains[0][1]
    rng = np.random.default_rng(len(op))
    for r_ops, p_ops, n_in in ((rl.fwd, pl_.fwd, pl_.n_src), (rl.rev, pl_.rev, pl_.n_dst)):
        n_rt = int(p_ops.row_start.shape[0])
        x = _frontier(rng, n_in, op, feat)
        xp = np.zeros((-(-n_in // TILE) * TILE, FB), np.float32)
        xp[:n_in, :feat] = x.numpy()
        want = np.asarray(bitmap_spmm_pallas(
            r_ops.slot_src, r_ops.slot_row, r_ops.row_start, r_ops.row_count, r_ops.bitmaps,
            jnp.asarray(xp), n_dst_pad=n_rt * TILE, op=op, zero=ZERO[op],
            feature_block=FB, interpret=True,
        ))[:, :feat]
        got = K.bitmap_spmm_index_plain(p_ops.row_ptr, p_ops.col, x, n_rt * TILE, op,
                                        ZERO[op], items)
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("feat", PALLAS_FEATS)
@pytest.mark.parametrize("items", RANGES, ids=["1", "7", "default"])
def test_fused_mirror_matches_pallas(ref_pair, items, feat):
    ref, port = ref_pair
    rf, pf = ref.fused_fwd, port.fused_fwd
    rng = np.random.default_rng(9)
    n_h = port.chains[-1][-1].n_src
    h = _frontier(rng, n_h, "sum", feat)
    x = _frontier(rng, port.n_real, "sum", feat)
    hp = np.zeros((rf.n_h_pad, FB), np.float32)
    hp[:n_h, :feat] = h.numpy()
    xp = np.zeros((rf.n_x_pad, FB), np.float32)
    xp[: port.n_real, :feat] = x.numpy()
    want = np.asarray(bitmap_spmm_fused_pallas(
        rf.kind, rf.main_src, rf.corr_src, rf.main_idx, rf.corr_idx,
        rf.slot_row, rf.row_start, rf.row_count, rf.bitmaps, rf.planes,
        jnp.asarray(hp), jnp.asarray(xp), n_dst_pad=rf.n_out_pad,
        plane_weights=rf.plane_weights, feature_block=FB, interpret=True,
    ))[:, :feat]
    got = K.bitmap_spmm_fused_index_plain(pf.row_ptr, pf.col, pf.weight, h, x, rf.n_out_pad,
                                          items)
    assert np.array_equal(got.numpy(), want)
