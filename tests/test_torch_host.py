"""The port's host half equals the JAX package's, array for array.

Catalogs, extraction, DEDUP-C correction triples (one-shot, streamed under
a budget, and streamed through the torch device fold), packed incidences,
bit-plane corrections and fused streams are all integer-valued, so every
comparison here is exact (``np.array_equal`` plus dtype).
"""
import dataclasses

import numpy as np
import pytest

from repro.core import dedup as ref_dedup
from repro.core import extract as ref_extract
from repro.data import synth as ref_synth
from repro.kernels import correction as ref_correction
from repro.kernels import pack as ref_pack

from repro_torch.core import dedup, extract
from repro_torch.data import synth
from repro_torch.kernels import correction, pack

Q1 = """
Nodes(ID, Name) :- Author(ID, Name).
Edges(ID1, ID2) :- AuthorPub(ID1, PubID), AuthorPub(ID2, PubID).
"""

Q2 = """
Nodes(ID, Name) :- Customer(ID, Name).
Edges(ID1, ID2) :- Orders(ok1, ID1), LineItem(ok1, pk),
                   Orders(ok2, ID2), LineItem(ok2, pk).
"""

CATALOGS = {
    "dblp": lambda m: m.dblp_catalog(n_authors=400, n_pubs=700,
                                     mean_authors_per_pub=6.0, seed=1),
    "dblp_mean3": lambda m: m.dblp_catalog(n_authors=300, n_pubs=400, seed=4),
    "tpch": lambda m: m.tpch_catalog(seed=2),
}

# (catalog, query, mode): the DBLP Q1 and TPCH Q2 fixtures of the JAX
# package's fused-kernel tests, plus the planner's own 'auto' decisions
FIXTURES = {
    "dblp_q1_condensed": ("dblp", Q1, "condensed"),
    "dblp_q1_auto": ("dblp", Q1, "auto"),
    "dblp_mean3_auto_direct": ("dblp_mean3", Q1, "auto"),
    "tpch_q2_condensed": ("tpch", Q2, "condensed"),
    "tpch_q2_expanded": ("tpch", Q2, "expanded"),
}


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _same_edges(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert (a.n_src, a.n_dst) == (b.n_src, b.n_dst)
    _same(a.src, b.src)
    _same(a.dst, b.dst)


def _same_graph(g, r):
    assert g.n_real == r.n_real and len(g.chains) == len(r.chains)
    for cg, cr in zip(g.chains, r.chains):
        assert len(cg.edges) == len(cr.edges)
        for eg, er in zip(cg.edges, cr.edges):
            _same_edges(eg, er)
    _same_edges(g.direct, r.direct)
    _same(g.node_type, r.node_type)
    assert sorted(g.node_properties) == sorted(r.node_properties)
    for k, v in g.node_properties.items():
        _same(v, r.node_properties[k])


def _graphs(name):
    cat_name, query, mode = FIXTURES[name]
    port = extract(CATALOGS[cat_name](synth), query, mode=mode)
    ref = ref_extract(CATALOGS[cat_name](ref_synth), query, mode=mode)
    return port, ref


@pytest.mark.parametrize("name", sorted(CATALOGS))
def test_catalog_tables_equal(name):
    port, ref = CATALOGS[name](synth), CATALOGS[name](ref_synth)
    assert port.table_names == ref.table_names
    for t in ref.table_names:
        pt, rt = port.table(t), ref.table(t)
        assert pt.column_names == rt.column_names
        for c in rt.column_names:
            _same(pt.column(c), rt.column(c))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_extract_equal(name):
    port, ref = _graphs(name)
    _same_graph(port.graph, ref.graph)
    assert port.dropped_endpoints == ref.dropped_endpoints
    assert [p.describe() for p in port.plans] == [p.describe() for p in ref.plans]
    assert port.graph.n_virtual == ref.graph.n_virtual


def test_extract_mean3_has_no_virtual_layer():
    """At the catalog default of 3 authors per publication the planner
    keeps the AuthorPub self-join eager: direct edges only, nothing to
    pack — why the served slice uses a mean of 6."""
    port, _ = _graphs("dblp_mean3_auto_direct")
    assert port.graph.n_virtual == 0 and port.graph.direct is not None


def test_extract_preprocess_equal():
    cat = CATALOGS["dblp"]
    port = extract(cat(synth), Q1, mode="condensed", preprocess=True)
    ref = ref_extract(cat(ref_synth), Q1, mode="condensed", preprocess=True)
    _same_graph(port.graph, ref.graph)


@pytest.mark.parametrize("knob", ["n_shards", "budget", "spill_dir", "plan"])
def test_extract_unported_pipelines_raise(knob):
    """Plan-driven extraction (``core/cost.py``) is ported: ``plan=``
    alone, or beside another pipeline knob, runs the plan's configuration
    (its sharding overrides ``n_shards``, a caller's ``budget`` is kept in
    place of the plan's caps, a non-spilling plan ignores ``spill_dir``)
    and gives the graph and the budget accounting of the JAX package's
    planned extraction under the same knobs."""
    from repro.core import cost as ref_cost
    from repro.core import planner as ref_planner

    from repro_torch.core import cost, planner

    cat, ref_cat = CATALOGS["dblp"](synth), CATALOGS["dblp"](ref_synth)
    report, ref_report = cost.plan(cat, Q1), ref_cost.plan(ref_cat, Q1)
    cfg = next(c for c, _ in report.ranked if c.n_shards > 1 and not c.spill)
    kwargs = {"plan": dataclasses.replace(report.chosen, config=cfg)}
    ref_kwargs = {"plan": dataclasses.replace(ref_report.chosen, config=cfg)}
    if knob == "n_shards":
        kwargs["n_shards"] = 2
    elif knob == "budget":
        kwargs["budget"] = planner.ExtractionBudget()
        ref_kwargs["budget"] = ref_planner.ExtractionBudget()
    elif knob == "spill_dir":
        kwargs["spill_dir"] = "spill"
    port = extract(cat, Q1, **kwargs)
    ref = ref_extract(ref_cat, Q1, **ref_kwargs)
    _same_graph(port.graph, ref.graph)
    assert port.n_shards == ref.n_shards == cfg.n_shards
    assert port.budget.summary() == ref.budget.summary()
    if knob == "budget":
        assert port.budget is kwargs["budget"]
        assert port.budget.max_resident_rows is None


@pytest.mark.parametrize("name", ["dblp_q1_condensed", "tpch_q2_condensed"])
@pytest.mark.parametrize("drop_self_loops", [True, False])
def test_correction_equal(name, drop_self_loops):
    port, ref = _graphs(name)
    got = dedup.build_correction(port.graph, drop_self_loops=drop_self_loops)
    want = ref_dedup.build_correction(ref.graph, drop_self_loops=drop_self_loops)
    for a, b in zip(got, want):
        _same(a, b)


@pytest.mark.parametrize("budget", [20_000, 60_000])
@pytest.mark.parametrize("device_fold", [False, True])
def test_correction_streaming_equal_under_budget(budget, device_fold):
    port, ref = _graphs("dblp_q1_condensed")
    got = dedup.build_correction_streaming(
        port.graph, budget_triples=budget, device_fold=device_fold, device="cpu"
    )
    want = ref_dedup.build_correction_streaming(ref.graph, budget_triples=budget)
    for a, b in zip(got, want):
        _same(a, b)
    assert got.accounting.n_chunks == want.accounting.n_chunks > 1
    assert (got.accounting.peak_resident_triples
            == want.accounting.peak_resident_triples)
    assert got.accounting.n_merges == want.accounting.n_merges


@pytest.mark.parametrize("name", ["dblp_q1_condensed", "tpch_q2_condensed"])
def test_pack_bipartite_byte_identical(name):
    port, ref = _graphs(name)
    for ep, er in zip(port.graph.chains[0].edges, ref.graph.chains[0].edges):
        for a, b in ((ep, er), (ep.reversed(), er.reversed())):
            try:
                want = ref_pack.pack_bipartite(b)
            except ValueError:  # a layer with duplicate edges: both refuse
                with pytest.raises(ValueError, match="duplicate-free"):
                    pack.pack_bipartite(a)
                continue
            got = pack.pack_bipartite(a)
            for f in ("slot_src", "slot_row", "bitmaps", "row_start", "row_count"):
                _same(getattr(got, f), getattr(want, f))
            assert (got.n_dst, got.n_src) == (want.n_dst, want.n_src)


def test_pack_pad_slots_and_duplicates():
    from repro.core.condensed import BipartiteEdges as RefEdges
    from repro_torch.core.condensed import BipartiteEdges

    rng = np.random.default_rng(3)
    src = rng.integers(0, 300, 500)
    dst = rng.integers(0, 90, 500)  # row tiles 1..3 of 4 stay empty: pad slots
    key = np.unique(dst * 300 + src)
    s, d = key % 300, key // 300
    got = pack.pack_bipartite(BipartiteEdges(s, d, 300, 450))
    want = ref_pack.pack_bipartite(RefEdges(s, d, 300, 450))
    for f in ("slot_src", "slot_row", "bitmaps", "row_start", "row_count"):
        _same(getattr(got, f), getattr(want, f))
    assert not got.bitmaps[got.row_start[1]].any()  # a pad slot
    with pytest.raises(ValueError, match="duplicate-free"):
        pack.pack_bipartite(BipartiteEdges(np.r_[s, s[:1]], np.r_[d, d[:1]], 300, 450))


@pytest.mark.parametrize("name", ["dblp_q1_condensed", "tpch_q2_condensed"])
def test_correction_planes_and_fused_stream_byte_identical(name):
    port, ref = _graphs(name)
    cs, cd, cm = dedup.build_correction(port.graph)
    n = port.graph.n_real
    for a, b in ((cs, cd), (cd, cs)):
        got = correction.pack_correction(a, b, cm, n, n)
        want = ref_correction.pack_correction(a, b, cm, n, n)
        for f in ("slot_src", "slot_row", "row_start", "row_count", "planes"):
            _same(getattr(got, f), getattr(want, f))
        assert got.plane_weights == want.plane_weights
        last = port.graph.chains[-1].edges[-1]
        stream = correction.build_fused_stream(pack.pack_bipartite(last), got)
        ref_last = ref.graph.chains[-1].edges[-1]
        ref_stream = ref_correction.build_fused_stream(
            ref_pack.pack_bipartite(ref_last), want
        )
        for f in ("kind", "main_src", "corr_src", "main_idx", "corr_idx",
                  "slot_row", "row_start", "row_count"):
            _same(getattr(stream, f), getattr(ref_stream, f))
