"""Live graphs under writes in the port against the JAX package's.

Mirrors ``tests/test_delta.py``: the port's ``LiveGraph`` stays
byte-identical (``graphs_identical``) to a fresh ``extract`` of the
mutated tables and to the JAX package's ``LiveGraph`` after the same
deltas, with equal versions; a bad delta is rejected before anything is
logged; a ``DeltaLog`` written by either package replays in the other to
the same graph; a torn append is refused at ``open`` and dropped by
``recover=True``; and ``sharded_extract_to_device(delta_log=)`` uploads
what a fresh build of the mutated tables uploads.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.core import DeltaLog as RefDeltaLog
from repro.core import ExtractionBudget as RefBudget
from repro.core import LiveGraph as RefLiveGraph
from repro.data import synth as ref_synth

from repro_torch.core import (
    DeltaLog,
    ExtractionBudget,
    LiveGraph,
    SpillError,
    apply_delta,
    dedup,
    engine,
    extract,
    graphs_identical,
    mutate_catalog,
)
from repro_torch.core.serialize import SPILL_MANIFEST
from repro_torch.data import synth
from repro_torch.data.pipeline import sharded_extract_to_device

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


def _dblp(module):
    return module.dblp_catalog(n_authors=300, n_pubs=600,
                               mean_authors_per_pub=4.0, seed=0)


def _ap(aids, pids):
    return {"AuthorPub": {"aid": np.asarray(aids, np.int64),
                          "pid": np.asarray(pids, np.int64)}}


# every kind of delta: inserts only, deletes only, a Node-table delete
# (tombstone) with a reinsert of the same key, a table no rule reads (every
# rule untouched), repeated keys in inserts and deletes, and an empty delta
DBLP_STEPS = [
    (_ap([1, 2, 299], [1_000_001, 1_000_001, 1_000_002]), None),
    (None, {"AuthorPub": ("pid", np.array([1_000_003, 1_000_004]))}),
    ({"Author": {"aid": np.array([5, 300]),
                 "name": np.array(["author_5b", "author_300"])}},
     {"Author": ("aid", np.array([5]))}),
    ({"Pub": {"pid": np.array([2_000_000]), "year": np.array([2001])}}, None),
    (_ap([7, 7, 8, 8], [1_000_010, 1_000_010, 1_000_010, 1_000_011]),
     {"AuthorPub": ("aid", np.array([9, 9, 10]))}),
    (None, None),
]


def _ref_delta(ins, dels):
    """The same delta as fresh arrays, so neither package can alias the
    other's inputs."""
    ins2 = None if ins is None else {
        t: {c: np.array(v) for c, v in cols.items()} for t, cols in ins.items()}
    dels2 = None if dels is None else {
        t: (k, np.array(v)) for t, (k, v) in dels.items()}
    return ins2, dels2


@pytest.mark.parametrize("mode", ["auto", "condensed", "expanded"])
def test_delta_sequence_matches_fresh_extract_and_reference(mode):
    cat, ref_cat = _dblp(synth), _dblp(ref_synth)
    live = LiveGraph(cat, Q_DBLP, mode=mode)
    ref_live = RefLiveGraph(ref_cat, Q_DBLP, mode=mode)
    assert graphs_identical(live.graph, ref_live.graph)
    for i, (ins, dels) in enumerate(DBLP_STEPS):
        g, v = live.apply_delta(inserts=ins, deletes=dels)
        rg, rv = ref_live.apply_delta(*_ref_delta(ins, dels))
        cat = mutate_catalog(cat, inserts=ins, deletes=dels)
        assert int(v) == int(rv) == live.version == i + 1
        assert graphs_identical(g, extract(cat, Q_DBLP, mode=mode).graph), i
        assert graphs_identical(g, rg), i
        assert np.array_equal(live.nodes.keys, ref_live.nodes.keys), i


@pytest.mark.parametrize("preprocess", [False, True])
def test_multi_atom_rule_delta(preprocess):
    """Hash-join segments are re-executed in full: still byte-identical
    to the fresh extract and to the JAX package's live graph."""
    cat = synth.tpch_catalog(200, 600, 60, 2.0, seed=1)
    ref_cat = ref_synth.tpch_catalog(200, 600, 60, 2.0, seed=1)
    live = LiveGraph(cat, Q_TPCH, mode="condensed", preprocess=preprocess)
    ref_live = RefLiveGraph(ref_cat, Q_TPCH, mode="condensed", preprocess=preprocess)
    ins = {"LineItem": {"okey": np.array([5_000_001, 5_000_002]),
                        "pkey": np.array([9_000_001, 9_000_002])}}
    dels = {"Orders": ("okey", np.array([5_000_010]))}
    g, _ = live.apply_delta(inserts=ins, deletes=dels)
    rg, _ = ref_live.apply_delta(*_ref_delta(ins, dels))
    want = extract(mutate_catalog(cat, inserts=ins, deletes=dels), Q_TPCH,
                   mode="condensed", preprocess=preprocess).graph
    assert graphs_identical(g, want) and graphs_identical(g, rg)


def test_node_only_delta_reassembles_untouched_rule():
    """A delta to one Nodes relation moves the id space under an Edges
    rule it leaves untouched: the rule re-assembles from cached values,
    with the JAX package's budget counters."""
    cat, ref_cat = synth.univ_catalog(seed=13), ref_synth.univ_catalog(seed=13)
    budget, ref_budget = ExtractionBudget(), RefBudget()
    live = LiveGraph(cat, Q_UNIV, budget=budget)
    ref_live = RefLiveGraph(ref_cat, Q_UNIV, budget=ref_budget)
    key = cat.table("Instructor").column_names[0]
    dels = {"Instructor": (key, cat.table("Instructor").column(key)[:2])}
    g, _ = live.apply_delta(deletes=dels)
    rg, _ = ref_live.apply_delta(*_ref_delta(None, dels))
    assert graphs_identical(g, extract(mutate_catalog(cat, deletes=dels), Q_UNIV).graph)
    assert graphs_identical(g, rg)
    for f in ("delta_rules_reused", "delta_rules_recomputed", "n_delta_applies",
              "delta_rows_inserted", "delta_rows_deleted", "peak_resident_rows"):
        assert getattr(budget, f) == getattr(ref_budget, f), f


def test_module_level_apply_delta_and_result():
    cat = _dblp(synth)
    live = LiveGraph(cat, Q_DBLP)
    g, v = apply_delta(live, inserts=_ap([3], [1_000_002]))
    assert int(v) == 1 and live.result().graph is g
    assert graphs_identical(
        g, extract(mutate_catalog(cat, inserts=_ap([3], [1_000_002])), Q_DBLP).graph)


def test_bad_deltas_rejected_before_logging(tmp_path):
    log = DeltaLog(str(tmp_path / "log"))
    live = LiveGraph(_dblp(synth), Q_DBLP, log=log)
    before = live.graph
    with pytest.raises(KeyError):
        live.apply_delta(inserts={"NoSuchTable": {"x": np.array([1])}})
    with pytest.raises(ValueError, match="column"):
        live.apply_delta(inserts={"Author": {"aid": np.array([999])}})
    with pytest.raises(ValueError, match="key column"):
        live.apply_delta(deletes={"Author": ("nope", np.array([1]))})
    with pytest.raises(ValueError, match="unequal"):
        live.apply_delta(inserts=_ap([1, 2], [1_000_001]))
    assert len(log) == 0 and len(DeltaLog.open(str(tmp_path / "log"))) == 0
    assert live.version == 0 and live.graph is before
    with pytest.raises(ValueError, match="empty delta log"):
        log.append(*DBLP_STEPS[0])
        LiveGraph(_dblp(synth), Q_DBLP, log=log)


def _write_log(log_cls, live_cls, cat, path):
    live = live_cls(cat, Q_DBLP, log=log_cls(str(path)))
    for ins, dels in DBLP_STEPS[:4]:
        live.apply_delta(*_ref_delta(ins, dels))
    return live


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_delta_log_replays_across_packages(writer, tmp_path):
    cat, ref_cat = _dblp(synth), _dblp(ref_synth)
    path = tmp_path / "log"
    if writer == "port":
        wrote = _write_log(DeltaLog, LiveGraph, cat, path)
    else:
        wrote = _write_log(RefDeltaLog, RefLiveGraph, ref_cat, path)
    port = LiveGraph.replay(cat, Q_DBLP, DeltaLog.open(str(path)))
    ref = RefLiveGraph.replay(ref_cat, Q_DBLP, RefDeltaLog.open(str(path)))
    assert port.version == ref.version == wrote.version == 4
    assert graphs_identical(port.graph, wrote.graph)
    assert graphs_identical(port.graph, ref.graph)
    # entries read back in the shapes append took them, in both packages
    for (ins, dels), (rins, rdels) in zip(DeltaLog.open(str(path)).entries(),
                                          RefDeltaLog.open(str(path)).entries()):
        assert sorted(ins) == sorted(rins) and sorted(dels) == sorted(rdels)
        for t in ins:
            for c in ins[t]:
                assert ins[t][c].dtype == rins[t][c].dtype
                assert np.array_equal(ins[t][c], rins[t][c])
        for t in dels:
            assert dels[t][0] == rdels[t][0]
            assert np.array_equal(dels[t][1], rdels[t][1])
    # the replayed graph stays live: the next delta lands in the same log
    port.apply_delta(inserts=_ap([4], [1_000_020]))
    assert len(DeltaLog.open(str(path))) == 5


@pytest.mark.parametrize("package", ["port", "reference"])
def test_torn_append_rejected_then_recovered(package, tmp_path):
    """A record committed but never certified by the manifest (a crash
    between the two writes of an append) is refused at open by both
    packages; ``recover=True`` drops it and the replay lands on the last
    acknowledged graph."""
    cat = _dblp(synth)
    live = _write_log(DeltaLog, LiveGraph, cat, tmp_path / "log")
    acknowledged = live.graph
    store = DeltaLog.open(str(tmp_path / "log")).store
    store.write_record("delta_000004", {"ins0_0": np.array([1])},
                       meta={"index": 4, "inserts": [], "deletes": []})
    log_cls = DeltaLog if package == "port" else RefDeltaLog
    with pytest.raises(Exception, match="torn append"):
        log_cls.open(str(tmp_path / "log"))
    recovered = log_cls(str(tmp_path / "log"), create=False, recover=True)
    assert len(recovered) == 4
    assert not os.path.exists(tmp_path / "log" / "delta_000004")
    relive = LiveGraph.replay(cat, Q_DBLP, DeltaLog.open(str(tmp_path / "log")))
    assert relive.version == 4 and graphs_identical(relive.graph, acknowledged)


def test_uncertified_records_and_wrong_kind_rejected(tmp_path):
    os.makedirs(tmp_path / "log")
    store = DeltaLog(str(tmp_path / "ok")).store
    store.write_record("delta_000000", {"x": np.array([1])}, meta={})
    os.remove(tmp_path / "ok" / SPILL_MANIFEST)
    with pytest.raises(SpillError, match="never certified"):
        DeltaLog(str(tmp_path / "ok"), create=False)
    from repro_torch.core.serialize import ShardSpillStore

    other = ShardSpillStore(str(tmp_path / "s"))
    other.finalize(meta={"kind": "extraction"})
    with pytest.raises(SpillError, match="not a delta log"):
        DeltaLog.open(str(tmp_path / "s"))
    with pytest.raises(IndexError):
        DeltaLog(str(tmp_path / "log")).read(0)


def _uploads_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if dataclasses.is_dataclass(a):
        return all(_uploads_equal(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a) if f.name not in ("plans", "correction_plans"))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_uploads_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("packed", [False, True])
def test_pipeline_resumes_from_base_plus_log(packed, tmp_path):
    """``sharded_extract_to_device(delta_log=)`` uploads, byte for byte,
    what a fresh build of the mutated catalog uploads, stamped with the
    replayed version."""
    cat = _dblp(synth)
    live = _write_log(DeltaLog, LiveGraph, cat, tmp_path / "log")
    res, dev = sharded_extract_to_device(
        cat, Q_DBLP, n_shards=2, packed=packed, device="cpu",
        delta_log=DeltaLog.open(str(tmp_path / "log")),
    )
    assert dev.graph_version == 4 and graphs_identical(res.graph, live.graph)
    mutated = cat
    for ins, dels in DBLP_STEPS[:4]:
        mutated = mutate_catalog(mutated, inserts=ins, deletes=dels)
    fresh = extract(mutated, Q_DBLP).graph
    corr = dedup.build_correction_streaming(fresh)
    to_dev = engine.to_device_packed if packed else engine.to_device
    want = to_dev(fresh, correction=corr, graph_version=4, device="cpu")
    assert _uploads_equal(dev, want)
    with pytest.raises(ValueError, match="either plan= or delta_log="):
        sharded_extract_to_device(cat, Q_DBLP, n_shards=1, plan=object(),
                                  delta_log=DeltaLog.open(str(tmp_path / "log")),
                                  device="cpu")
