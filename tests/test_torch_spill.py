"""Spilled extraction and the serialization formats of the port, against
the JAX package's.

Mirrors ``tests/test_extract_spill.py``: spill records round-trip byte
for byte and are byte-accounted; ``validate`` rejects a partial spill
(no closing manifest, a missing record, uncommitted litter, a lost
record header, a torn payload); ``tree_merge_records`` equals the
single-pass merge at every arity with the JAX package's round count;
``merge_spilled_graph`` rebuilds the graph from disk alone.  The file
formats are the JAX package's: a directory either package's
``save_condensed`` wrote loads in the other as the same graph, spill
records written by one read back in the other, and ``export_edge_list``
writes the same bytes.
"""
import os
import shutil

import numpy as np
import pytest

from repro.core import serialize as ref_serialize
from repro.core.extract import _shard_record_name as ref_record_name
from repro.data import synth as ref_synth

from repro_torch.core import (
    ExtractionBudget,
    ShardSpillStore,
    SpillError,
    extract,
    extract_sharded,
    graphs_identical,
    merge_spilled_graph,
    serialize,
)
from repro_torch.core.dsl import parse
from repro_torch.core.extract import (
    _build_node_space_sharded,
    _extract_shard,
    _plans_info,
    _shard_record_name,
)
from repro_torch.core.serialize import (
    SPILL_MANIFEST,
    ShardAssembly,
    merge_assemblies,
    tree_merge_records,
)
from repro_torch.data import synth

Q_DBLP = """
Nodes(ID, Name) :- Author(ID, Name).
Edges(ID1, ID2) :- AuthorPub(ID1, PubID), AuthorPub(ID2, PubID).
"""
Q_TPCH = """
Nodes(ID, Name) :- Customer(ID, Name).
Edges(ID1, ID2) :- Orders(ok1, ID1), LineItem(ok1, pk),
                   Orders(ok2, ID2), LineItem(ok2, pk).
"""


def _dblp(m):
    # 401/701: indivisible by every tested shard count -> ragged last shard
    return m.dblp_catalog(n_authors=401, n_pubs=701, mean_authors_per_pub=5.0, seed=11)


@pytest.fixture(scope="module")
def dblp():
    return _dblp(synth)


@pytest.fixture(scope="module")
def dblp_shards(dblp):
    """Per-shard assemblies for direct merge-op tests."""
    q = parse(Q_DBLP)
    nodes, _ = _build_node_space_sharded(dblp, q.nodes_rules, 7, None)
    info = _plans_info(dblp, q, "condensed")
    return [_extract_shard(dblp, info, nodes, s, 7, None) for s in range(7)]


def _assemblies_identical(a: ShardAssembly, b) -> bool:
    if sorted(a.chains) != sorted(b.chains) or sorted(a.direct) != sorted(b.direct):
        return False
    if a.dropped != b.dropped:
        return False
    for r in a.chains:
        (ca, ka), (cb, kb) = a.chains[r], b.chains[r]
        if len(ca.edges) != len(cb.edges) or len(ka) != len(kb):
            return False
        for ea, eb in zip(ca.edges, cb.edges):
            if (ea.n_src, ea.n_dst) != (eb.n_src, eb.n_dst):
                return False
            for x, y in ((ea.src, eb.src), (ea.dst, eb.dst)):
                if x.dtype != y.dtype or not np.array_equal(x, y):
                    return False
        for x, y in zip(ka, kb):
            if x.dtype != y.dtype or not np.array_equal(x, y):
                return False
    for r in a.direct:
        for x, y in zip(a.direct[r], b.direct[r]):
            if x.dtype != y.dtype or not np.array_equal(x, y):
                return False
    return True


def _tree_files(root):
    """Relative path -> bytes of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


# -- records -------------------------------------------------------------------

def test_spill_round_trip_byte_identical_per_shard(dblp_shards, tmp_path):
    store = ShardSpillStore(str(tmp_path / "port"))
    ref_store = ref_serialize.ShardSpillStore(str(tmp_path / "ref"))
    for s, assembly in enumerate(dblp_shards):
        name = _shard_record_name(s)
        assert name == ref_record_name(s)
        written = store.write_assembly(name, assembly)
        assert written == assembly.nbytes()
        loaded, nbytes = store.read_assembly(name)
        assert nbytes == written and _assemblies_identical(assembly, loaded)
        # the JAX package reads the port's record as the same assembly
        ref_loaded, ref_nbytes = ref_serialize.ShardSpillStore(
            str(tmp_path / "port"), create=False).read_assembly(name)
        assert ref_nbytes == written and _assemblies_identical(loaded, ref_loaded)
        ref_store.write_assembly(name, ref_loaded)
    assert _tree_files(tmp_path / "port") == _tree_files(tmp_path / "ref")


def test_spill_record_byte_accounting(tmp_path):
    store = ShardSpillStore(str(tmp_path / "spill"))
    arrays = {"a": np.arange(10, dtype=np.int64), "b": np.zeros(3, np.int32)}
    written = store.write_record("rec", arrays, meta={"x": 1})
    assert written == 10 * 8 + 3 * 4
    got, meta, nbytes = store.read_record("rec")
    assert nbytes == written and meta == {"x": 1}
    assert np.array_equal(got["a"], arrays["a"]) and got["b"].dtype == np.int32
    with pytest.raises(SpillError, match="does not exist"):
        ShardSpillStore.open(str(tmp_path / "nope"))


# -- tree-reduce merge ---------------------------------------------------------

@pytest.mark.parametrize("arity", [2, 3])
@pytest.mark.parametrize("n_shards", [1, 2, 7])
def test_tree_merge_records_arity(dblp_shards, tmp_path, n_shards, arity):
    parts = dblp_shards[:n_shards]
    store = ShardSpillStore(str(tmp_path / "s"))
    names = [_shard_record_name(s) for s in range(n_shards)]
    for n, a in zip(names, parts):
        store.write_assembly(n, a)
    budget = ExtractionBudget(spill_enabled=True)
    final, in_memory = tree_merge_records(store, names, arity=arity, budget=budget)
    one_pass = merge_assemblies(list(parts))
    got, _ = store.read_assembly(final)
    assert _assemblies_identical(one_pass, got)
    if n_shards == 1:
        assert (final, in_memory) == (names[0], None)
    else:
        assert _assemblies_identical(one_pass, in_memory)
    assert all(store.has_record(n) for n in names)  # leaves survive
    ref_store = ref_serialize.ShardSpillStore(str(tmp_path / "s"), create=False)
    from repro.core.planner import ExtractionBudget as RefBudget

    rb = RefBudget(spill_enabled=True)
    ref_final, _ = ref_serialize.tree_merge_records(
        ref_store, names, arity=arity, out_prefix="ref_", budget=rb)
    assert budget.n_merge_rounds == rb.n_merge_rounds
    assert budget.merge_peak_resident_bytes == rb.merge_peak_resident_bytes
    with pytest.raises(ValueError):
        tree_merge_records(store, names, arity=1)


@pytest.mark.parametrize("arity", [2, 3])
@pytest.mark.parametrize("n_shards", [1, 2, 7])
def test_spilled_extraction_parity(dblp, tmp_path, n_shards, arity):
    sp = str(tmp_path / "spill")
    got = extract_sharded(dblp, Q_DBLP, n_shards=n_shards, spill_dir=sp, merge_arity=arity)
    assert graphs_identical(extract(dblp, Q_DBLP).graph, got.graph)
    store = ShardSpillStore.open(sp)
    report = store.validate()
    assert report == ref_serialize.ShardSpillStore.open(sp).validate()
    rebuilt, meta = merge_spilled_graph(sp)
    assert graphs_identical(got.graph, rebuilt)


# -- partial spills are rejected ---------------------------------------------------

def _torn_payload(sp):
    rdir = os.path.join(sp, _shard_record_name(1))
    target = next(f for f in sorted(os.listdir(rdir)) if f.endswith(".bin"))
    with open(os.path.join(rdir, target), "r+b") as f:
        f.truncate(3)


DAMAGE = {
    "missing_manifest": (lambda sp: os.remove(os.path.join(sp, SPILL_MANIFEST)), "partial"),
    "missing_record": (lambda sp: shutil.rmtree(os.path.join(sp, _shard_record_name(1))),
                       "missing"),
    "tmp_litter": (lambda sp: os.makedirs(os.path.join(sp, "shard_s00099.tmp-123")),
                   "uncommitted"),
    "lost_header": (lambda sp: os.remove(
        os.path.join(sp, _shard_record_name(0), "record.json")), None),
    "torn_payload": (_torn_payload, "truncated"),
}


@pytest.mark.parametrize("damage", sorted(DAMAGE))
def test_validate_rejects_partial_spills(dblp, tmp_path, damage):
    sp = str(tmp_path / "spill")
    extract_sharded(dblp, Q_DBLP, n_shards=3, spill_dir=sp)
    ShardSpillStore.open(sp).validate()
    hurt, match = DAMAGE[damage]
    hurt(sp)
    with pytest.raises(SpillError, match=match):
        merge_spilled_graph(sp)
    # the JAX package refuses the same directory
    with pytest.raises(Exception):
        ref_serialize.ShardSpillStore.open(sp)


def test_rerun_into_used_dir_invalidates_stale_manifest(dblp, tmp_path):
    sp = str(tmp_path / "spill")
    extract_sharded(dblp, Q_DBLP, n_shards=3, spill_dir=sp)
    ShardSpillStore(sp)  # opening for writing drops the closing manifest
    with pytest.raises(SpillError, match="partial"):
        ShardSpillStore.open(sp)
    res = extract_sharded(dblp, Q_DBLP, n_shards=2, spill_dir=sp)
    assert _shard_record_name(2) not in ShardSpillStore.open(sp).manifest()["records"]
    assert graphs_identical(res.graph, merge_spilled_graph(sp)[0])


# -- formats shared with the JAX package ---------------------------------------------

@pytest.mark.parametrize("case", ["dblp", "tpch"])
def test_save_load_condensed_across_packages(case, tmp_path):
    if case == "dblp":
        make, q = _dblp, Q_DBLP
    else:
        make, q = (lambda m: m.tpch_catalog(n_customers=120, n_orders=300, n_parts=50,
                                            seed=4)), Q_TPCH
    from repro.core.extract import extract as ref_extract

    g = extract(make(synth), q, mode="condensed").graph
    rg = ref_extract(make(ref_synth), q, mode="condensed").graph
    port_dir = serialize.save_condensed(g, str(tmp_path / "port"))
    ref_dir = ref_serialize.save_condensed(rg, str(tmp_path / "ref"))
    assert _tree_files(port_dir) == _tree_files(ref_dir)
    assert graphs_identical(serialize.load_condensed(ref_dir), g)
    back = ref_serialize.load_condensed(port_dir)
    assert back.n_real == g.n_real
    for pc, rc in zip(g.chains, back.chains):
        for pe, re_ in zip(pc.edges, rc.edges):
            assert np.array_equal(pe.src, re_.src) and np.array_equal(pe.dst, re_.dst)


@pytest.mark.parametrize("fmt", ["npz", "txt"])
def test_export_edge_list_byte_equal(dblp, tmp_path, fmt):
    from repro.core.extract import extract as ref_extract

    g = extract(dblp, Q_DBLP).graph
    rg = ref_extract(_dblp(ref_synth), Q_DBLP).graph
    a = serialize.export_edge_list(g, str(tmp_path / f"port.{fmt}"), fmt=fmt)
    b = ref_serialize.export_edge_list(rg, str(tmp_path / f"ref.{fmt}"), fmt=fmt)
    if fmt == "txt":
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    else:
        pa, pb = np.load(a), np.load(b)
        assert sorted(pa.files) == sorted(pb.files)
        for k in pa.files:
            assert pa[k].dtype == pb[k].dtype and np.array_equal(pa[k], pb[k])
    with pytest.raises(ValueError):
        serialize.export_edge_list(g, str(tmp_path / "x"), fmt="csv")
