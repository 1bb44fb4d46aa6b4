"""K1, K2 and K3 against the JAX package's Pallas kernels.

On the CPU a wrapper runs the plain mirror of its kernel's arithmetic over
the row index; here that mirror is held against ``bitmap_spmm_pallas`` /
``bitmap_spmm_fused_pallas`` in interpret mode, on identical operands: the
reference's own ``to_device_packed`` output, handed to the port through
``interop.device_packed_from_arrays`` (which builds the index from it).
Frontiers are integer-valued (with ``inf`` / ``-inf`` where the op
allows), so every sum is exact and the comparison is ``np.array_equal``.  The CUDA kernels themselves run only on
the card: ``tests/test_torch_cuda.py`` holds them against these plain
versions there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import dedup as ref_dedup
from repro.core import engine as ref_engine
from repro.core import extract as ref_extract
from repro.core.condensed import BipartiteEdges as RefEdges
from repro.data.synth import dblp_catalog as ref_dblp_catalog
from repro.kernels import pack as ref_pack
from repro.kernels.bitmap_spmm import bitmap_spmm_fused_pallas, bitmap_spmm_pallas

from repro_torch.core.interop import device_packed_from_arrays, packed_arrays
from repro_torch.kernels import bitmap_spmm as K
from repro_torch.kernels.pack import TILE

Q1 = """
Nodes(ID, Name) :- Author(ID, Name).
Edges(ID1, ID2) :- AuthorPub(ID1, PubID), AuthorPub(ID2, PubID).
"""

FEAT = 8
FB = 128  # the reference pads the feature axis to its feature block


@pytest.fixture(scope="module")
def graphs():
    """(reference DevicePacked, port DevicePacked on the CPU), same operands."""
    cat = ref_dblp_catalog(n_authors=300, n_pubs=500, mean_authors_per_pub=6.0, seed=5)
    g = ref_extract(cat, Q1, mode="condensed").graph
    corr = ref_dedup.build_correction(g)
    ref = ref_engine.to_device_packed(g, correction=corr, backend="pallas")
    arrays, meta = packed_arrays(ref)
    return ref, device_packed_from_arrays(arrays, meta, "cpu")


def _frontier(rng, n, op):
    x = rng.integers(0, 7, (n, FEAT)).astype(np.float32)
    if op == "min":
        x[rng.random((n, FEAT)) < 0.5] = np.inf
    elif op == "max":
        x = (x > 3).astype(np.float32)
        x[rng.random((n, FEAT)) < 0.2] = -np.inf  # every -inf maps to zero
    return x


def _ref_spmm(ops, x, n_rt, op, zero):
    n_src_pad = -(-max(x.shape[0], 1) // TILE) * TILE
    xp = np.zeros((n_src_pad, FB), np.float32)
    xp[: x.shape[0], :FEAT] = x
    y = bitmap_spmm_pallas(
        ops.slot_src, ops.slot_row, ops.row_start, ops.row_count, ops.bitmaps,
        jnp.asarray(xp), n_dst_pad=n_rt * TILE, op=op, zero=zero,
        feature_block=FB, interpret=True,
    )
    return np.asarray(y)[:, :FEAT]


def _port_spmm(ops, x, n_out, op, zero):
    return K.bitmap_spmm(ops.row_ptr, ops.col, torch.from_numpy(x), n_out, op=op,
                         zero=zero).numpy()


ZERO = {"sum": 0.0, "min": float("inf"), "max": 0.0}


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("layer", [0, 1])
def test_plain_spmm_matches_pallas(graphs, layer, reverse, op):
    ref, port = graphs
    rl, pl_ = ref.chains[0][layer], port.chains[0][layer]
    r_ops, p_ops = (rl.rev, pl_.rev) if reverse else (rl.fwd, pl_.fwd)
    n_in = pl_.n_dst if reverse else pl_.n_src
    n_rt = int(p_ops.row_start.shape[0])
    rng = np.random.default_rng(layer * 10 + reverse * 3 + len(op))
    x = _frontier(rng, n_in, op)
    want = _ref_spmm(r_ops, x, n_rt, op, ZERO[op])
    before = dict(K.LAUNCHES)
    # the whole padded row range, pad rows included
    got = _port_spmm(p_ops, x, n_rt * TILE, op, ZERO[op])
    assert K.LAUNCHES == before  # the plain version launches nothing
    assert np.array_equal(got, want)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_plain_spmm_pad_slots_match_pallas(op):
    """A layer whose upper row tiles are empty: one all-zero pad slot each,
    whose rows must come out as the semiring zero."""
    from repro_torch.core.condensed import BipartiteEdges
    from repro_torch.core.engine import _upload_operands
    from repro_torch.kernels.pack import pack_bipartite

    rng = np.random.default_rng(11)
    key = np.unique(rng.integers(0, 90, 700) * 260 + rng.integers(0, 260, 700))
    s, d = key % 260, key // 260
    bsb = pack_bipartite(BipartiteEdges(s, d, 260, 450))
    r_ops = ref_engine._upload_operands(ref_pack.pack_bipartite(RefEdges(s, d, 260, 450)))
    p_ops = _upload_operands(bsb, "cpu")
    x = _frontier(rng, 260, op)
    want = _ref_spmm(r_ops, x, bsb.n_row_tiles, op, ZERO[op])
    got = _port_spmm(p_ops, x, bsb.n_row_tiles * TILE, op, ZERO[op])
    assert np.array_equal(got, want)
    assert np.all(got[128:] == ZERO[op])


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_plain_fused_matches_pallas(graphs, reverse):
    ref, port = graphs
    rf = ref.fused_rev if reverse else ref.fused_fwd
    pf = port.fused_rev if reverse else port.fused_fwd
    rng = np.random.default_rng(7 + reverse)
    # h lives on the fused layer's source side: the last layer's input
    # forward, the first layer's output in reverse
    n_h = port.chains[-1][0].n_dst if reverse else port.chains[-1][-1].n_src
    h = rng.integers(0, 7, (n_h, FEAT)).astype(np.float32)
    x = rng.integers(0, 7, (port.n_real, FEAT)).astype(np.float32)
    hp = np.zeros((rf.n_h_pad, FB), np.float32)
    hp[:n_h, :FEAT] = h
    xp = np.zeros((rf.n_x_pad, FB), np.float32)
    xp[: port.n_real, :FEAT] = x
    want = np.asarray(bitmap_spmm_fused_pallas(
        rf.kind, rf.main_src, rf.corr_src, rf.main_idx, rf.corr_idx,
        rf.slot_row, rf.row_start, rf.row_count, rf.bitmaps, rf.planes,
        jnp.asarray(hp), jnp.asarray(xp), n_dst_pad=rf.n_out_pad,
        plane_weights=rf.plane_weights, feature_block=FB, interpret=True,
    ))[:, :FEAT]
    got = K.bitmap_spmm_fused(
        pf.row_ptr, pf.col, pf.weight, torch.from_numpy(h), torch.from_numpy(x),
        rf.n_out_pad,
    ).numpy()
    assert pf.planes.shape[1] >= 2  # several bit-planes are exercised
    assert np.array_equal(got, want)


def test_wrappers_refuse_other_devices_and_bad_operands(graphs):
    from repro_torch.kernels.bitmap_index import bitmap_index_fused

    _, port = graphs
    ops = port.chains[0][0].fwd
    n_out = port.chains[0][0].n_dst
    x = torch.zeros((port.n_real, FEAT), device="meta")
    with pytest.raises(ValueError, match="only cpu and cuda"):
        K.bitmap_spmm(ops.row_ptr, ops.col, x, n_out)
    xf = torch.zeros((port.n_real, FEAT), dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        K.bitmap_spmm(ops.row_ptr, ops.col, xf, n_out)
    x32 = xf.float()
    with pytest.raises(ValueError, match="op"):
        K.bitmap_spmm(ops.row_ptr, ops.col, x32, n_out, op="prod")
    with pytest.raises(ValueError, match="row tiles"):
        K.bitmap_spmm(ops.row_ptr, ops.col, x32, 10**7)
    f = port.fused_fwd
    with pytest.raises(ValueError, match="2\\*\\*k"):
        bitmap_index_fused(
            f.kind, f.main_src, f.corr_src, f.main_idx, f.corr_idx, f.slot_row,
            f.row_start, f.row_count, f.bitmaps, f.planes,
            tuple(3.0 ** k for k in range(f.planes.shape[1])),
        )


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_fused_stream_names_each_bitmap_once(graphs, reverse):
    """The index builder walks the stream's slots, so each stored bitmap
    and plane stack must be named by exactly one slot (a second would
    repeat its entries): true of the reference's streams and of the
    port's."""
    ref, port = graphs
    for fused in ((ref.fused_rev, port.fused_rev) if reverse
                  else (ref.fused_fwd, port.fused_fwd)):
        kind = np.asarray(fused.kind)
        main_idx, corr_idx = np.asarray(fused.main_idx), np.asarray(fused.corr_idx)
        n_main, n_corr = np.asarray(fused.bitmaps).shape[0], np.asarray(fused.planes).shape[0]
        assert np.array_equal(np.sort(main_idx[kind == 0]), np.arange(n_main))
        assert np.array_equal(np.sort(corr_idx[kind == 1]), np.arange(n_corr))


# ---------------------------------------------------------------------------
# public members of the kernels and configs packages, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_dst", [450, 0])
def test_block_sparse_bitmap_max_k_and_nonzero_blocks_equal_the_reference(n_dst):
    from repro_torch.core.condensed import BipartiteEdges
    from repro_torch.kernels.pack import pack_bipartite

    rng = np.random.default_rng(5)
    n = 900 if n_dst else 0
    key = np.unique(rng.integers(0, max(n_dst, 1), n) * 260 + rng.integers(0, 260, n))
    s, d = key % 260, key // 260
    got = pack_bipartite(BipartiteEdges(s, d, 260, n_dst))
    want = ref_pack.pack_bipartite(RefEdges(s, d, 260, n_dst))
    assert (got.max_k, got.n_nonzero_blocks) == (want.max_k, want.n_nonzero_blocks)
    if n_dst:
        assert got.max_k > 1 and 0 < got.n_nonzero_blocks <= got.n_slots


def test_segment_spmm_ref_equals_the_reference():
    from repro.kernels.ref import segment_spmm_ref as ref_segment_spmm

    from repro_torch.kernels.ref import segment_spmm_ref

    rng = np.random.default_rng(6)
    src = rng.integers(0, 70, 500)
    dst = rng.integers(0, 90, 500)
    x = rng.standard_normal((70, 5)).astype(np.float32)
    got = segment_spmm_ref(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(x), 95)
    want = ref_segment_spmm(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(x), 95)
    assert got.shape == (95, 5)
    assert np.allclose(got.numpy(), np.asarray(want))
    assert not got[90:].any()


def test_kernels_and_configs_export_the_reference_names():
    import repro.configs as ref_configs
    import repro.kernels as ref_kernels

    import repro_torch.configs as configs
    import repro_torch.kernels as kernels

    # ops.bitmap_spmm stays in repro_torch.kernels.ops (the module docstring)
    assert set(ref_kernels.__all__) - {"bitmap_spmm"} <= set(kernels.__all__)
    for name in kernels.__all__:
        assert getattr(kernels, name) is not None, name
    assert isinstance(kernels.DEFAULT_CONFIG, kernels.KernelConfig)
    assert all(isinstance(c, kernels.KernelConfig) for c in kernels.CANDIDATES)
    assert configs.__all__ == ref_configs.__all__
    assert set(configs.list_archs()) <= set(ref_configs.list_archs())
    arch = configs.get_arch("glm4-9b")
    assert isinstance(arch.CONFIG, configs.TransformerConfig)
    assert configs.shapes_for("glm4-9b") == ref_configs.shapes_for("glm4-9b")
