"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The
file imports neither JAX nor the JAX package, so it runs where only the
port is installed; the suite's ``conftest.py`` imports the JAX package,
so on such a machine run it as

    python -m pytest -q --noconftest tests/test_torch_cuda.py

Operands come from the port's own host half (a small DBLP catalog,
extracted, corrected and packed); frontiers are integer-valued (with
``inf`` / ``-inf`` where the op allows), so kernel and plain version must
agree bit for bit.  Float frontiers agree to float32 round-off: the
kernels add in another order than ``index_add_``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import dedup, engine, extract
from repro_torch.core.condensed import BipartiteEdges
from repro_torch.data.synth import dblp_catalog
from repro_torch.kernels import bitmap_spmm as K
from repro_torch.kernels.pack import TILE, pack_bipartite

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


def _spmm_args(layer, reverse, x):
    ops = layer.rev if reverse else layer.fwd
    n_out = layer.n_src if reverse else layer.n_dst
    return (ops.slot_src, ops.slot_row, ops.row_start, ops.row_count, ops.bitmaps, x, n_out)


def _fused_args(dev, reverse, h, x):
    f = dev.fused_rev if reverse else dev.fused_fwd
    return (f.kind, f.main_src, f.corr_src, f.main_idx, f.corr_idx, f.slot_row,
            f.row_start, f.row_count, f.bitmaps, f.planes, h, x, f.n_out,
            f.plane_weights)


@pytest.mark.parametrize("feat", [8, 32, 40])
def test_cuda_kernels_match_plain(packed, feat):
    """K1 and K2 over both layers in both directions, and K3 in both
    directions, bit for bit against the plain versions; 40 features take
    two feature blocks, the second one mostly masked."""
    rng = np.random.default_rng(feat)
    for layer in packed.chains[0]:
        for reverse in (False, True):
            n_in = layer.n_dst if reverse else layer.n_src
            for op in ("sum", "min", "max"):
                args = _spmm_args(layer, reverse, _frontier(rng, n_in, feat, op))
                before = K.LAUNCHES[f"bitmap_spmm_{op}"]
                got = K.bitmap_spmm(*args, op=op, zero=ZERO[op])
                assert K.LAUNCHES[f"bitmap_spmm_{op}"] == before + 1
                assert torch.equal(got, K.bitmap_spmm_plain(*args, op=op, zero=ZERO[op]))
    for reverse in (False, True):
        chain = packed.chains[-1]
        n_h = chain[0].n_dst if reverse else chain[-1].n_src
        h = _frontier(rng, n_h, feat, "sum")
        x = _frontier(rng, packed.n_real, feat, "sum")
        fargs = _fused_args(packed, reverse, h, x)
        before = K.LAUNCHES["bitmap_spmm_fused"]
        got = K.bitmap_spmm_fused(*fargs)
        assert K.LAUNCHES["bitmap_spmm_fused"] == before + 1
        assert torch.equal(got, K.bitmap_spmm_fused_plain(*fargs))
    assert packed.fused_fwd.planes.shape[1] >= 2  # several bit-planes


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
        args = (ops.slot_src, ops.slot_row, ops.row_start, ops.row_count,
                ops.bitmaps, x, n_out)
        got = K.bitmap_spmm(*args, op=op, zero=ZERO[op])
        assert got.shape == (n_out, 8)
        assert torch.equal(got, K.bitmap_spmm_plain(*args, op=op, zero=ZERO[op]))
        assert bool((got[128:] == ZERO[op]).all())


def test_cuda_float_frontiers_agree_to_roundoff(packed):
    rng = np.random.default_rng(3)
    layer = packed.chains[0][0]
    x = torch.from_numpy(rng.random((layer.n_src, 16)).astype(np.float32)).cuda()
    args = _spmm_args(layer, False, x)
    torch.testing.assert_close(K.bitmap_spmm(*args), K.bitmap_spmm_plain(*args),
                               rtol=1e-5, atol=1e-6)
    chain = packed.chains[-1]
    h = torch.from_numpy(rng.random((chain[-1].n_src, 16)).astype(np.float32)).cuda()
    xr = torch.from_numpy(rng.random((packed.n_real, 16)).astype(np.float32)).cuda()
    fargs = _fused_args(packed, False, h, xr)
    torch.testing.assert_close(K.bitmap_spmm_fused(*fargs),
                               K.bitmap_spmm_fused_plain(*fargs), rtol=1e-5, atol=1e-4)


def test_cuda_auto_dispatch_launches_and_matches_segment(packed):
    """``'auto'`` on an sm_90 card sends batched steps to the kernels and
    answers as the segment path does; elsewhere it takes the segment
    path."""
    import dataclasses

    rng = np.random.default_rng(9)
    x = _frontier(rng, packed.n_real, 8, "sum")
    auto = dataclasses.replace(packed, backend="auto")
    seg = dataclasses.replace(packed, backend="segment")
    K.reset_launch_counts()
    got = engine.propagate(auto, x)
    want = engine.propagate(seg, x)
    on_hopper = torch.cuda.get_device_capability() == (9, 0)
    assert (K.LAUNCHES["bitmap_spmm_sum"] > 0) == on_hopper
    assert (K.LAUNCHES["bitmap_spmm_fused"] > 0) == on_hopper
    assert torch.equal(got, want)


def test_wrapper_refuses_misaligned_words(packed):
    ops = packed.chains[0][0].fwd
    words = torch.empty(ops.bitmaps.numel() + 1, dtype=torch.int32, device="cuda")
    shifted = words[1:].view(ops.bitmaps.shape)
    x = torch.zeros((packed.chains[0][0].n_src, 8), device="cuda")
    with pytest.raises(ValueError, match="8-byte"):
        K.bitmap_spmm(ops.slot_src, ops.slot_row, ops.row_start, ops.row_count,
                      shifted, x, packed.chains[0][0].n_dst)
