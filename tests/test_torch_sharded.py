"""Sharded, budgeted extraction of the port against the JAX package's.

Mirrors ``tests/test_extract_sharded.py``: for every shard count — one
shard, a ragged last shard, more shards than rows — the port's sharded
pipeline gives the graph and node space of its own one-shot build and of
the JAX package's, array for array, with budget accounting equal to the
JAX package's field by field; the helpers (``shard_bounds``,
``hash_partition``, ``ShardedTable``, ``merge_chain_shards``,
``merge_block_sparse``) give the JAX package's arrays; and the sharded
device pipeline uploads the operands of a one-shot upload, byte for byte.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import condensed as ref_condensed
from repro.core.extract import extract_sharded as ref_extract_sharded
from repro.core import relational as ref_relational
from repro.core import ExtractionBudget as RefBudget
from repro.data import synth as ref_synth
from repro.kernels import pack as ref_pack

from repro_torch.core import (
    ExtractionBudget,
    ExtractionBudgetError,
    dedup,
    engine,
    extract,
    extract_sharded,
    graphs_identical,
)
from repro_torch.core import condensed, relational
from repro_torch.core.extract import NodeSpace
from repro_torch.data import synth
from repro_torch.data.pipeline import sharded_extract_to_device
from repro_torch.kernels import pack

Q_DBLP = """
Nodes(ID, Name) :- Author(ID, Name).
Edges(ID1, ID2) :- AuthorPub(ID1, PubID), AuthorPub(ID2, PubID).
"""
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

# (catalog maker over a synth module, query): 401 / 701 is indivisible by
# every tested shard count, so the last shard is always ragged
CASES = {
    "dblp": (lambda m: m.dblp_catalog(n_authors=401, n_pubs=701,
                                      mean_authors_per_pub=5.0, seed=11), Q_DBLP),
    "univ": (lambda m: m.univ_catalog(seed=13), Q_UNIV),
    "tpch": (lambda m: m.tpch_catalog(n_customers=150, n_orders=400, n_parts=60,
                                      seed=12), Q_TPCH),
    "tiny": (lambda m: m.dblp_catalog(n_authors=6, n_pubs=5,
                                      mean_authors_per_pub=2.0, seed=14), Q_DBLP),
}


def _same_array(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def _same_edges(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert (a.n_src, a.n_dst) == (b.n_src, b.n_dst)
        _same_array(a.src, b.src)
        _same_array(a.dst, b.dst)


def _same_graph(port, ref):
    """A port CondensedGraph equals a JAX-package one array for array."""
    assert port.n_real == ref.n_real
    assert len(port.chains) == len(ref.chains)
    for pc, rc in zip(port.chains, ref.chains):
        assert len(pc.edges) == len(rc.edges)
        for pe, re_ in zip(pc.edges, rc.edges):
            _same_edges(pe, re_)
    _same_edges(port.direct, ref.direct)
    assert sorted(port.node_properties) == sorted(ref.node_properties)
    for k in port.node_properties:
        _same_array(port.node_properties[k], ref.node_properties[k])
    _same_array(port.node_type, ref.node_type)


def _same_nodes(port, ref):
    _same_array(port.keys, ref.keys)
    _same_array(port.type_ids, ref.type_ids)
    assert port.type_names == ref.type_names


def _same_budget(port, ref):
    """Field by field, the JAX package's accounting."""
    got = dataclasses.asdict(port)
    want = dataclasses.asdict(ref)
    assert got == want
    assert port.summary() == ref.summary()


def _catalogs(case):
    make, q = CASES[case]
    return make(synth), make(ref_synth), q


@pytest.mark.parametrize("spill", [False, True], ids=["resident", "spilled"])
@pytest.mark.parametrize("n_shards", [1, 2, 7])
@pytest.mark.parametrize("case", ["dblp", "univ"])
def test_sharded_parity(case, n_shards, spill, tmp_path):
    cat, ref_cat, q = _catalogs(case)
    kw = {"spill_dir": str(tmp_path / "port")} if spill else {}
    got = extract_sharded(cat, q, n_shards=n_shards, **kw)
    base = extract(cat, q)
    assert graphs_identical(base.graph, got.graph)
    _same_nodes(got.nodes, base.nodes)
    assert got.dropped_endpoints == base.dropped_endpoints
    assert got.n_shards == n_shards and got.budget is not None
    rkw = {"spill_dir": str(tmp_path / "ref")} if spill else {}
    want = ref_extract_sharded(ref_cat, q, n_shards=n_shards, **rkw)
    _same_graph(got.graph, want.graph)
    _same_nodes(got.nodes, want.nodes)
    _same_budget(got.budget, want.budget)
    assert got.summary().keys() == want.summary().keys()


@pytest.mark.parametrize("case,n_shards,mode", [
    ("tiny", 50, "auto"), ("tiny", 50, "condensed"), ("tpch", 2, "condensed"),
    ("dblp", 3, "expanded"),
], ids=["more_shards_than_rows", "more_shards_than_rows_condensed",
        "tpch_multilayer", "dblp_expanded"])
def test_sharded_parity_shapes(case, n_shards, mode):
    cat, ref_cat, q = _catalogs(case)
    got = extract_sharded(cat, q, n_shards=n_shards, mode=mode)
    assert graphs_identical(extract(cat, q, mode=mode).graph, got.graph)
    want = ref_extract_sharded(ref_cat, q, n_shards=n_shards, mode=mode)
    _same_graph(got.graph, want.graph)
    _same_budget(got.budget, want.budget)
    if case == "tpch":
        assert got.graph.chains[0].n_layers == 3


def test_budget_enforced_at_the_observed_peak():
    cat, ref_cat, q = _catalogs("dblp")
    peak = extract_sharded(cat, q, n_shards=4).budget.peak_resident_rows
    ok = extract_sharded(cat, q, n_shards=4, max_resident_rows=peak)
    assert ok.budget.peak_resident_rows == peak
    with pytest.raises(ExtractionBudgetError) as port_err:
        extract_sharded(cat, q, n_shards=4, max_resident_rows=peak - 1)
    with pytest.raises(Exception) as ref_err:
        ref_extract_sharded(ref_cat, q, n_shards=4, max_resident_rows=peak - 1)
    assert str(port_err.value) == str(ref_err.value)


def test_assembly_budget_raises_without_spill_and_spills_with_it(tmp_path):
    cat, _, q = _catalogs("dblp")
    probe = extract_sharded(cat, q, n_shards=7)
    cap = probe.budget.peak_assembly_bytes // 2
    with pytest.raises(ExtractionBudgetError, match="assembly"):
        extract_sharded(cat, q, n_shards=7, max_assembly_bytes=cap)
    got = extract_sharded(cat, q, n_shards=7, max_assembly_bytes=cap,
                          spill_dir=str(tmp_path / "s"))
    assert graphs_identical(probe.graph, got.graph)
    assert got.budget.spilled_bytes > 0 and got.budget.n_spilled_records > 0


def test_budget_object_and_node_space_contract():
    budget = ExtractionBudget(max_resident_rows=10)
    with pytest.raises(ExtractionBudgetError):
        budget.charge(11)
    assert dataclasses.asdict(ExtractionBudget()) == dataclasses.asdict(RefBudget())
    with pytest.raises(ValueError, match="sorted strictly"):
        NodeSpace(np.array([3, 1]), np.zeros(2, np.int32), ["A"])
    empty = NodeSpace(np.array([], np.int64), np.array([], np.int32), ["A"])
    idx, found = empty.lookup(np.array([1, 2]))
    assert not found.any()


@pytest.mark.parametrize("n_rows,n_shards", [(10, 3), (3, 5), (0, 2), (700, 7)])
def test_shard_bounds_and_hash_partition(n_rows, n_shards):
    assert relational.shard_bounds(n_rows, n_shards) == ref_relational.shard_bounds(
        n_rows, n_shards)
    rng = np.random.default_rng(n_rows)
    for values in (rng.integers(-50, 50, n_rows), rng.random(n_rows),
                   np.array([f"k{i % 7}" for i in range(n_rows)])):
        _same_array(relational.hash_partition(values, n_shards),
                    ref_relational.hash_partition(values, n_shards))


@pytest.mark.parametrize("mode", ["rows", "hash"])
def test_sharded_table_equal(mode):
    cat, ref_cat, _ = _catalogs("dblp")
    t, rt = cat.table("AuthorPub"), ref_cat.table("AuthorPub")
    col = t.column_names[0]
    key = col if mode == "hash" else None
    st = relational.ShardedTable(t, 5, mode=mode, key=key)
    rst = ref_relational.ShardedTable(rt, 5, mode=mode, key=key)
    for s in range(5):
        assert st.shard_rows(s) == rst.shard_rows(s)
        for c in t.column_names:
            _same_array(st.shard(s).column(c), rst.shard(s).column(c))
            assert dataclasses.asdict(st.stats(s, c)) == dataclasses.asdict(rst.stats(s, c))
    pubs, rpubs = cat.table("Pub"), ref_cat.table("Pub")
    pub_key = pubs.column_names[0]
    for c in t.column_names:
        _same_array(relational.semi_join(t, pubs, t.column_names[1], pub_key).column(c),
                    ref_relational.semi_join(rt, rpubs, rt.column_names[1],
                                             pub_key).column(c))
    assert relational.estimate_join_output(t, t, col, col) == \
        ref_relational.estimate_join_output(rt, rt, col, col)


@pytest.mark.parametrize("arity", [None, 2, 3])
def test_merge_chain_shards_equal(arity):
    rng = np.random.default_rng(5)
    n_real, shards, port_chains, ref_chains, keys = 40, 5, [], [], []
    for s in range(shards):
        k = np.unique(rng.integers(0, 60, 12))
        keys.append([k])
        e = [(rng.integers(0, n_real, 30), rng.integers(0, k.size, 30), n_real, k.size),
             (rng.integers(0, k.size, 30), rng.integers(0, n_real, 30), k.size, n_real)]
        port_chains.append(condensed.Chain([condensed.BipartiteEdges(*a) for a in e]))
        ref_chains.append(ref_condensed.Chain([ref_condensed.BipartiteEdges(*a) for a in e]))
    got, got_keys = condensed.merge_chain_shards(port_chains, keys, arity=arity)
    want, want_keys = ref_condensed.merge_chain_shards(ref_chains, keys, arity=arity)
    for a, b in zip(got.edges, want.edges):
        _same_edges(a, b)
    for a, b in zip(got_keys, want_keys):
        _same_array(a, b)
    _same_array(condensed.merge_sorted_unique([k[0] for k in keys]),
                ref_condensed.merge_sorted_unique([k[0] for k in keys]))
    single, _ = condensed.merge_chain_shards(port_chains, keys)
    for a, b in zip(got.edges, single.edges):
        _same_edges(a, b)


@pytest.mark.parametrize("shard_edges", [None, 1, 97, 1000])
def test_pack_shard_at_a_time_byte_identical(shard_edges):
    rng = np.random.default_rng(2)
    key = np.unique(rng.integers(0, 300 * 260, 1500))
    e = condensed.BipartiteEdges(key // 260, key % 260, 300, 260)
    re_ = ref_condensed.BipartiteEdges(key // 260, key % 260, 300, 260)
    got = pack.pack_bipartite(e, shard_edges=shard_edges)
    for want in (ref_pack.pack_bipartite(re_, shard_edges=shard_edges),
                 ref_pack.pack_bipartite(re_)):
        for f in ("slot_src", "slot_row", "row_start", "row_count", "bitmaps"):
            _same_array(getattr(got, f), getattr(want, f))
    halves = [pack.pack_bipartite(condensed.BipartiteEdges(e.src[s], e.dst[s], 300, 260))
              for s in (slice(0, 700), slice(700, None))]
    merged = pack.merge_block_sparse(halves)
    rmerged = ref_pack.merge_block_sparse(
        [ref_pack.pack_bipartite(ref_condensed.BipartiteEdges(e.src[s], e.dst[s], 300, 260))
         for s in (slice(0, 700), slice(700, None))])
    _same_array(merged.bitmaps, rmerged.bitmaps)
    with pytest.raises(ValueError, match="disjoint"):
        pack.merge_block_sparse([halves[0], halves[0]])
    with pytest.raises(NotImplementedError, match="item 2"):
        pack.pack_bipartite(e, method="scatter")


def _tensors(obj, prefix=""):
    """Every tensor reachable from a device container, by path."""
    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(_tensors(getattr(obj, f.name), f"{prefix}.{f.name}"))
        return out
    if isinstance(obj, (tuple, list)):
        out = {}
        for i, v in enumerate(obj):
            out.update(_tensors(v, f"{prefix}[{i}]"))
        return out
    return {}


def test_sharded_extract_to_device_uploads_the_one_shot_operands(tmp_path):
    cat, _, q = _catalogs("dblp")
    res, dev = sharded_extract_to_device(
        cat, q, n_shards=3, packed=True, pack_shard_edges=200,
        spill_dir=str(tmp_path / "s"), device="cpu")
    g = extract(cat, q).graph
    assert graphs_identical(g, res.graph)
    want = engine.to_device_packed(g, correction=dedup.build_correction_streaming(g),
                                   device="cpu")
    got_t, want_t = _tensors(dev), _tensors(want)
    assert got_t.keys() == want_t.keys() and len(got_t) > 20
    for k in want_t:
        assert got_t[k].dtype == want_t[k].dtype and torch.equal(got_t[k], want_t[k]), k
    _, flat = sharded_extract_to_device(cat, q, n_shards=2, device="cpu")
    assert isinstance(flat, engine.DeviceCondensed)
    with pytest.raises(NotImplementedError, match="item 1"):
        sharded_extract_to_device(cat, q, 2, delta_log=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 2"):
        sharded_extract_to_device(cat, q, 2, plan=object(), device="cpu")
