"""The rest of ``core/condensed.py`` and ``univ_catalog``, byte for byte
against the JAX package.

``collapse_to_single_layer`` (paper §5.2.2) composes multi-layer chains
into single-layer ones with the JAX package's edges, keeps every expanded
multiplicity, and refuses a composition past ``max_growth``; the
expansion statistics (``n_paths_expanded``, ``n_edges_expanded``,
``duplication_ratio``, ``expansion_stats``, ``is_single_layer``),
``ExpandedGraph.adjacency_multiplicity`` and ``BipartiteEdges.
sorted_by_src`` equal the JAX package's; a collapsed graph goes through
the dedup family (which keeps its single-layer check) as in
``tests/test_dedup.py``; ``univ_catalog`` draws the JAX package's tables.
"""
import numpy as np
import pytest

from repro.core import condensed as ref_condensed
from repro.core import dedup as ref_dedup
from repro.core.extract import extract as ref_extract
from repro.data import synth as ref_synth

from repro_torch.core import condensed, dedup, extract
from repro_torch.data import synth

Q_TPCH = """
Nodes(ID, Name) :- Customer(ID, Name).
Edges(ID1, ID2) :- Orders(ok1, ID1), LineItem(ok1, pk),
                   Orders(ok2, ID2), LineItem(ok2, pk).
"""
Q_UNIV = """
Nodes(ID, Name) :- Instructor(ID, Name).
Nodes(ID, Name) :- Student(ID, Name).
Edges(ID1, ID2) :- TaughtCourse(ID1, courseId), TookCourse(ID2, courseId).
"""

GRAPHS = {
    "layered": lambda m: m.layered_condensed(120, [40, 30], [300, 200, 300], seed=4,
                                             symmetric=False),
    "layered_sym": lambda m: m.layered_condensed(60, [12, 10], [90, 60, 90], seed=9),
    "tpch": lambda m: (ref_extract if m is ref_synth else extract)(
        m.tpch_catalog(n_customers=80, n_orders=200, n_parts=30, seed=4), Q_TPCH,
        mode="condensed").graph,
    "univ": lambda m: (ref_extract if m is ref_synth else extract)(
        m.univ_catalog(seed=13), Q_UNIV).graph,
}


def _same_array(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _same_graph(port, ref):
    assert port.n_real == ref.n_real and len(port.chains) == len(ref.chains)
    for pc, rc in zip(port.chains, ref.chains):
        assert len(pc.edges) == len(rc.edges)
        for pe, re_ in zip(pc.edges, rc.edges):
            assert (pe.n_src, pe.n_dst) == (re_.n_src, re_.n_dst)
            _same_array(pe.src, re_.src)
            _same_array(pe.dst, re_.dst)
    assert (port.direct is None) == (ref.direct is None)


@pytest.mark.parametrize("keep_layer", [None, 0, 1])
@pytest.mark.parametrize("name", ["layered", "layered_sym", "tpch"])
def test_collapse_to_single_layer_equal(name, keep_layer):
    g, rg = GRAPHS[name](synth), GRAPHS[name](ref_synth)
    flat = condensed.collapse_to_single_layer(g, keep_layer=keep_layer, max_growth=1000.0)
    want = ref_condensed.collapse_to_single_layer(rg, keep_layer=keep_layer,
                                                  max_growth=1000.0)
    _same_graph(flat, want)
    assert flat.is_single_layer() and not g.is_single_layer()
    # every expanded pair keeps its multiplicity
    for a, b in zip(flat.multiplicities(), g.multiplicities()):
        _same_array(a, b)
    assert flat.n_edges_expanded() == g.n_edges_expanded()


def test_collapse_refuses_past_max_growth():
    g, rg = GRAPHS["layered"](synth), GRAPHS["layered"](ref_synth)
    with pytest.raises(ValueError, match="keep multi-layer") as got:
        condensed.collapse_to_single_layer(g, max_growth=1.0)
    with pytest.raises(ValueError) as want:
        ref_condensed.collapse_to_single_layer(rg, max_growth=1.0)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_expansion_statistics_equal(name):
    g, rg = GRAPHS[name](synth), GRAPHS[name](ref_synth)
    assert g.is_single_layer() == rg.is_single_layer()
    assert g.n_paths_expanded() == rg.n_paths_expanded()
    assert g.n_edges_expanded() == rg.n_edges_expanded()
    assert g.duplication_ratio() == rg.duplication_ratio()
    assert g.expansion_stats(chunk_rows=7) == rg.expansion_stats(chunk_rows=7)
    acc, racc = condensed.ExpansionAccounting(), ref_condensed.ExpansionAccounting()
    assert g.expansion_stats(budget_triples=500, accounting=acc) == rg.expansion_stats(
        budget_triples=500, accounting=racc)
    assert (acc.peak_resident_triples, acc.n_chunks) == (
        racc.peak_resident_triples, racc.n_chunks)
    exp, rexp = g.expand(), rg.expand()
    if exp.n <= 400:
        _same_array(exp.adjacency_multiplicity(), rexp.adjacency_multiplicity())
    edges = [e for c in g.chains for e in c.edges] + [g.direct] * (g.direct is not None)
    ref_edges = [e for c in rg.chains for e in c.edges] + [rg.direct] * (rg.direct is not None)
    for pe, re_ in zip(edges, ref_edges):
        ps, rs = pe.sorted_by_src(), re_.sorted_by_src()
        _same_array(ps.src, rs.src)
        _same_array(ps.dst, rs.dst)


def test_collapsed_graph_through_the_dedup_family():
    """The dedup family keeps its single-layer check; a multi-layer graph
    reaches it through ``collapse_to_single_layer``, as in
    ``tests/test_dedup.py``.  TPC-H's "customers who bought the same item"
    is symmetric, and so is its collapse around the middle layer."""
    g, rg = GRAPHS["tpch"](synth), GRAPHS["tpch"](ref_synth)
    with pytest.raises(ValueError):
        dedup.dedup1_greedy_virtual_first(g)
    flat = condensed.collapse_to_single_layer(g, max_growth=1000.0)
    rflat = ref_condensed.collapse_to_single_layer(rg, max_growth=1000.0)
    assert dedup.is_symmetric_single_layer(flat)
    got = dedup.dedup1_greedy_virtual_first(flat)
    want = ref_dedup.dedup1_greedy_virtual_first(rflat)
    _same_graph(got.graph, want.graph)
    assert got.total_edges == want.total_edges
    rep, rrep = dedup.bitmap2(flat), ref_dedup.bitmap2(rflat)
    for a, b in zip(rep.to_dedup_pairs(), rrep.to_dedup_pairs()):
        _same_array(a, b)


@pytest.mark.parametrize("kwargs", [{}, {"n_instructors": 7, "n_students": 40,
                                         "n_courses": 9, "seed": 3}])
def test_univ_catalog_tables_equal(kwargs):
    cat, rcat = synth.univ_catalog(**kwargs), ref_synth.univ_catalog(**kwargs)
    for name in ("Instructor", "Student", "TaughtCourse", "TookCourse"):
        t, rt = cat.table(name), rcat.table(name)
        assert t.column_names == rt.column_names
        for c in t.column_names:
            _same_array(t.column(c), rt.column(c))
