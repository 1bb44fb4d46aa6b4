"""The port's host dedup family against the JAX package's, byte for byte.

The same seeded graphs go through both packages' BITMAP-1/2, the four
DEDUP-1 rewritings, DEDUP-2, the wedge correction, the membership helpers
and the App. C generators.  Everything here is host NumPy/Python in both
packages, so every array, set and iteration order must be identical —
``graphs_identical`` for graphs, ``array_equal`` plus dtype for arrays —
as ``tests/test_dedup_golden.py`` pins the reference's own sizes.
"""
import numpy as np
import pytest

from repro.core import condensed as ref_condensed
from repro.core import dedup as ref_dedup
from repro.core import extract as ref_extract
from repro.data import synth as ref_synth

from repro_torch.core import condensed, dedup, extract
from repro_torch.core.condensed import graphs_identical
from repro_torch.data import synth

Q1 = """
Nodes(ID, Name) :- Author(ID, Name).
Edges(ID1, ID2) :- AuthorPub(ID1, PubID), AuthorPub(ID2, PubID).
"""

# name -> factory over a synth module; tests/test_dedup_golden.py's graphs
# plus a symmetric layered one and a small co-author extraction
GRAPHS = {
    "ba_sparse": lambda m: m.barabasi_albert_condensed(200, 80, 5.0, 2.0, seed=11),
    "ba_dense": lambda m: m.barabasi_albert_condensed(150, 12, 40.0, 8.0, seed=12),
    "layered": lambda m: m.layered_condensed(60, [20, 15], [150, 100, 150], seed=13,
                                             symmetric=False),
    "layered_sym": lambda m: m.layered_condensed(80, [30], [200, 200], seed=3),
}
SYMMETRIC = ["ba_sparse", "ba_dense", "dblp"]


def _graph(name):
    if name == "dblp":
        def cat(m):
            return m.dblp_catalog(150, 260, 6.0, seed=2)
        return (extract(cat(synth), Q1, mode="condensed").graph,
                ref_extract(cat(ref_synth), Q1, mode="condensed").graph)
    return GRAPHS[name](synth), GRAPHS[name](ref_synth)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_generators_give_identical_graphs(name):
    g, rg = _graph(name)
    assert graphs_identical(g, rg)
    assert g.multiplicities()[2].sum() == rg.multiplicities()[2].sum()


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_build_csr_identical(name):
    g, rg = _graph(name)
    for e, re_ in zip(g.chains[0].edges, rg.chains[0].edges):
        got, want = condensed.build_csr(e), ref_condensed.build_csr(re_)
        assert _same(got.indptr, want.indptr) and _same(got.indices, want.indices)
        assert (got.n_src, got.n_dst) == (want.n_src, want.n_dst)


@pytest.mark.parametrize("drop_self_loops", [True, False])
@pytest.mark.parametrize("name", sorted(GRAPHS) + ["dblp"])
def test_wedge_correction_identical(name, drop_self_loops):
    g, rg = _graph(name)
    got = dedup.build_wedge_correction(g, drop_self_loops=drop_self_loops)
    want = ref_dedup.build_wedge_correction(rg, drop_self_loops=drop_self_loops)
    assert all(_same(a, b) for a, b in zip(got, want))
    assert got[0].size > 0


@pytest.mark.parametrize("fn", ["bitmap1", "bitmap2"])
@pytest.mark.parametrize("name", SYMMETRIC + ["layered_sym"])
def test_bitmap_reps_identical(name, fn):
    g, rg = _graph(name)
    got, want = getattr(dedup, fn)(g), getattr(ref_dedup, fn)(rg)
    for field in ("bits", "edge_alive", "pair_ptr", "in_src", "in_dst"):
        assert _same(getattr(got, field), getattr(want, field)), field
    assert (got.nbytes(), got.n_bitmaps, got.n_bits) == (
        want.nbytes(), want.n_bitmaps, want.n_bits)
    for a, b in zip(got.to_dedup_pairs(), want.to_dedup_pairs()):
        assert _same(a, b)


DEDUP1 = [
    "dedup1_naive_virtual_first",
    "dedup1_naive_real_first",
    "dedup1_greedy_real_first",
    "dedup1_greedy_virtual_first",
]


@pytest.mark.parametrize("ordering", ["random", "identity"])
@pytest.mark.parametrize("fn", DEDUP1)
@pytest.mark.parametrize("name", SYMMETRIC)
def test_dedup1_identical(name, fn, ordering):
    g, rg = _graph(name)
    got = getattr(dedup, fn)(g, ordering=ordering)
    want = getattr(ref_dedup, fn)(rg, ordering=ordering)
    assert graphs_identical(got.graph, want.graph)
    assert (got.n_direct_edges, got.n_virtual_edges, got.total_edges) == (
        want.n_direct_edges, want.n_virtual_edges, want.total_edges)


@pytest.mark.parametrize("ordering", ["identity", "random"])
@pytest.mark.parametrize("name", SYMMETRIC)
def test_dedup2_identical(name, ordering):
    g, rg = _graph(name)
    got = dedup.dedup2_greedy(g, ordering=ordering, rng=np.random.default_rng(5))
    want = ref_dedup.dedup2_greedy(rg, ordering=ordering, rng=np.random.default_rng(5))
    assert got.sets == want.sets
    assert got.vv_edges == want.vv_edges
    assert got.pair_multiplicities() == want.pair_multiplicities()
    assert got.neighbor_lists() == want.neighbor_lists()
    assert (got.n_edges, got.nbytes()) == (want.n_edges, want.nbytes())


@pytest.mark.parametrize("name", SYMMETRIC + ["layered", "layered_sym"])
def test_membership_helpers_identical(name):
    g, rg = _graph(name)
    sym = dedup.is_symmetric_single_layer(g)
    assert sym == ref_dedup.is_symmetric_single_layer(rg)
    if not sym:
        with pytest.raises(ValueError, match="symmetric single-layer"):
            dedup.dedup1_greedy_virtual_first(g)
        return
    sets = dedup.membership_sets(g)
    assert sets == ref_dedup.membership_sets(rg)
    pairs = [(0, 3), (5, 1)]
    assert graphs_identical(dedup.graph_from_membership(g.n_real, sets, pairs),
                            ref_dedup.graph_from_membership(rg.n_real, sets, pairs))
