"""The port's multi-tenant serving tier against the JAX package's.

Mirrors ``tests/test_serving_tier.py`` with both tiers serving the same
tenants and the same request stream (the port on the CPU): answers per
qid (exact; PPR to the JAX package's ``rtol=1e-5, atol=1e-6``), the
version handoff and the quiesce errors, both caches' stats, the order of
uploads and evictions under budgets built from each package's own device
bytes, a byte-identical re-upload after eviction, the equality classes of
shape signatures, replica placement, and the ``--graphs`` launcher.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import dedup as ref_dedup
from repro.core import engine as ref_engine
from repro.core.delta import LiveGraph as RefLiveGraph
from repro.data import synth as ref_synth
from repro.launch.cells import place_serving_replicas as ref_place
from repro.serve import GraphServingTier as RefTier
from repro.serve import ServeRequest as RefRequest
from repro.core.engine import ResidencyBudget as RefBudget

from repro_torch.core import dedup, engine
from repro_torch.core.delta import LiveGraph
from repro_torch.core.engine import ResidencyBudget, ResidencyError
from repro_torch.data import synth
from repro_torch.launch.cells import ReplicaPlacement, place_serving_replicas
from repro_torch.serve import GraphServingTier, ServeRequest
from repro_torch.serve import tier as tier_mod

ROOT = Path(__file__).resolve().parents[1]
PPR_TOL = dict(rtol=1e-5, atol=1e-6)
Q_DBLP = (
    "Nodes(ID, Name) :- Author(ID, Name).\n"
    "Edges(ID1, ID2) :- AuthorPub(ID1, PubID), AuthorPub(ID2, PubID)."
)


def _sets(n_real, n_virt, avg, seed):
    rng = np.random.default_rng(seed)
    return [
        set(rng.choice(n_real, size=min(max(2, int(rng.poisson(avg))), n_real),
                       replace=False).tolist())
        for _ in range(n_virt)
    ]


# name -> (n_real, n_virt, mean set size, seed)
MEMBERSHIP = {"A": (30, 10, 4, 0), "B": (26, 9, 4, 1), "C": (34, 12, 3, 2)}


def _graphs(module):
    return {n: module.graph_from_membership(r, _sets(r, v, a, s))
            for n, (r, v, a, s) in MEMBERSHIP.items()}


def _weights(g, scale):
    return [[np.arange(1, e.n_dst + 1, dtype=np.float32) * scale
             for e in ch.edges[:-1]] for ch in g.chains]


def _tiers(budgets=None, packed="C", **kw):
    """The port's tier on the CPU and the JAX package's, each over the same
    three membership graphs (those named in ``packed`` packed; C with
    per-layer weights for the weighted kinds)."""
    out = []
    for tier_cls, module, dev_kw in ((GraphServingTier, dedup, {"device": "cpu"}),
                                     (RefTier, ref_dedup, {})):
        budget = None if budgets is None else budgets[len(out)]
        tier = tier_cls(max_batch=8, budget=budget, **dev_kw, **kw)
        for name, g in _graphs(module).items():
            extra = {"packed": name in packed}
            if name == "C":
                extra.update(layer_weights=_weights(g, 1.0),
                             layer_capacities=_weights(g, 2.0))
            tier.add_tenant(name, g, **extra)
        out.append(tier)
    return out


KINDS = tier_mod.KINDS


def _stream(n, seed=5, tenants="ABC"):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = tenants[int(rng.integers(len(tenants)))]
        out.append((i, t, KINDS[int(rng.integers(len(KINDS)))],
                    int(rng.integers(MEMBERSHIP[t][0])), float(i) * 1e-4))
    return out


def _reqs(cls, stream):
    return [cls(qid, t, k, node, arrival_time=at) for qid, t, k, node, at in stream]


def _same_answer(kind, got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if kind == "ppr":
        np.testing.assert_allclose(got, want, **PPR_TOL)
    else:
        assert np.array_equal(got, want)


def _log_residency(tier, log):
    """Record every upload and eviction of ``tier`` by tenant, in order."""
    ensure, evict = tier._ensure_resident, tier._evict_device

    def ensure_logged(t):
        was = t.device is None
        ensure(t)
        if was:
            log.append(("upload", t.name))

    def evict_logged(t, invalidation=False):
        if t.device is not None:
            log.append(("invalidate" if invalidation else "evict", t.name))
        evict(t, invalidation)

    tier._ensure_resident, tier._evict_device = ensure_logged, evict_logged


def test_answers_and_cache_stats_equal_reference():
    stream = _stream(96)
    port, ref = _tiers()
    got = port.serve(_reqs(ServeRequest, stream))
    want = ref.serve(_reqs(RefRequest, stream))
    assert sorted(got) == sorted(want) == list(range(len(stream)))
    for qid, _, kind, _, _ in stream:
        _same_answer(kind, got[qid], want[qid])
    for a, b in ((port.exec_stats, ref.exec_stats), (port.result_stats, ref.result_stats)):
        assert (a.hits, a.misses) == (b.hits, b.misses)
    assert port.exec_stats.evictions == ref.exec_stats.evictions
    assert (port.stats.n_batches, port.stats.occupancy, port.stats.batch_widths_used) == (
        ref.stats.n_batches, ref.stats.occupancy, ref.stats.batch_widths_used)
    # repeats answered from the result cache, in both
    again = _stream(16, seed=5)
    shifted = [(q + 1000, t, k, n, at) for q, t, k, n, at in again]
    port.serve(_reqs(ServeRequest, shifted))
    ref.serve(_reqs(RefRequest, shifted))
    assert port.result_stats.hits == ref.result_stats.hits > 0
    # the executable entries' build counts equal the reference's trace counts
    for key, entry in port._executables.items():
        rkey = next(k for k in ref._executables if k[:2] == key[:2])
        assert entry.traces == ref._executables[rkey].traces, key


@pytest.mark.parametrize("packed", ["", "ABC"])
@pytest.mark.parametrize("fit", [1, 2])
def test_upload_and_eviction_order_under_own_byte_budgets(fit, packed):
    """Budgets that fit the ``fit`` largest tenants with a quarter to
    spare, as ``launch/serve.py --graphs`` builds them, each from its own
    package's device bytes (the port's count the row indices too): the
    two tiers upload and evict in the same order and give the same
    answers (evicted tenants re-upload and answer the same)."""
    free = _tiers(packed=packed)
    for tier in free:
        for name in MEMBERSHIP:
            tier._ensure_resident(tier.tenants[name])
    budgets = []
    for tier in free:
        sizes = sorted(t.resident_bytes for t in tier.tenants.values())
        budgets.append((ResidencyBudget if tier is free[0] else RefBudget)(
            max_device_bytes=int(sum(sizes[-fit:]) * 1.25)))
    port, ref = _tiers(budgets=budgets, packed=packed, result_cache=False)
    logs = ([], [])
    _log_residency(port, logs[0])
    _log_residency(ref, logs[1])
    stream = _stream(64, seed=11)
    got = port.serve(_reqs(ServeRequest, stream))
    want = ref.serve(_reqs(RefRequest, stream))
    assert logs[0] == logs[1]
    assert any(e[0] == "evict" for e in logs[0])
    for f in ("n_uploads", "n_evictions"):
        assert getattr(budgets[0], f) == getattr(budgets[1], f), f
    assert budgets[0].peak_resident_bytes <= budgets[0].max_device_bytes
    for qid, _, kind, _, _ in stream:
        _same_answer(kind, got[qid], want[qid])


def test_reupload_after_eviction_is_byte_identical():
    tier = GraphServingTier(max_batch=4, device="cpu", result_cache=False)
    g = _graphs(dedup)["A"]
    tier.add_tenant("A", g, packed=True)
    first = tier.serve([ServeRequest(i, "A", "ppr", i) for i in range(3)])
    t = tier.tenants["A"]
    old, old_counts = t.device, t.counts_device
    tier.evict_tenant("A")
    assert t.device is None and tier.budget.resident_bytes == 0
    again = tier.serve([ServeRequest(10 + i, "A", "ppr", i) for i in range(3)])
    assert t.n_uploads == 2 and t.device is not old
    for a, b in ((t.device, old), (t.counts_device, old_counts)):
        assert engine.graph_shape_signature(a) == engine.graph_shape_signature(b)
        ta, tb = _tensors(a), _tensors(b)
        assert ta.keys() == tb.keys()
        for k in ta:
            assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), k
    for i in range(3):
        assert first[i].tobytes() == again[10 + i].tobytes()


def _tensors(obj, prefix=""):
    import dataclasses

    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    if dataclasses.is_dataclass(obj):
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


def test_unsatisfiable_budget_and_missing_card_raise(monkeypatch):
    port, _ = _tiers(budgets=[ResidencyBudget(max_device_bytes=64), None])
    with pytest.raises(ResidencyError, match="budget"):
        port.serve([ServeRequest(0, "A", "bfs", 0)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        GraphServingTier(device="cuda")


def _live_pair():
    out = []
    for live_cls, module, tier_cls, kw in (
        (LiveGraph, synth, GraphServingTier, {"device": "cpu"}),
        (RefLiveGraph, ref_synth, RefTier, {}),
    ):
        tier = tier_cls(max_batch=8, **kw)
        for name, seed in (("A", 0), ("B", 1)):
            cat = module.dblp_catalog(n_authors=40, n_pubs=80,
                                      mean_authors_per_pub=3.0, seed=seed)
            tier.add_tenant(name, live_cls(cat, Q_DBLP, mode="condensed"))
        out.append(tier)
    return out


def test_version_handoff_and_quiesce_equal_reference():
    """A delta drains the bumped tenant's in-flight queries against the
    old graph, invalidates only its results, and the answers after it
    carry the new version — in both packages alike."""
    port, ref = _live_pair()
    for tier, cls in ((port, ServeRequest), (ref, RefRequest)):
        tier.serve([cls(0, "A", "bfs", 0), cls(1, "B", "bfs", 0)])
        assert tier.submit(cls(2, "B", "ppr", 3)) is None   # in flight
        tier.tenants["B"].live.apply_delta(inserts={"AuthorPub": {
            "aid": np.array([1], dtype=np.int64),
            "pid": np.array([999_998], dtype=np.int64),
        }})
    hp, hr = port.take_handoff(), ref.take_handoff()
    assert [r.qid for r in hp] == [r.qid for r in hr] == [2]
    assert hp[0].graph_version == hr[0].graph_version == 0
    np.testing.assert_allclose(hp[0].value, hr[0].value, **PPR_TOL)
    assert port.result_stats.invalidated == ref.result_stats.invalidated > 0
    res_p = port.submit(ServeRequest(3, "A", "bfs", 0))
    res_r = ref.submit(RefRequest(3, "A", "bfs", 0))
    assert res_p.cached and res_r.cached                    # A untouched
    assert port.submit(ServeRequest(4, "B", "bfs", 1)) is None
    after_p = {r.qid: r for r in port.drain()}
    ref.submit(RefRequest(4, "B", "bfs", 1))
    after_r = {r.qid: r for r in ref.drain()}
    assert after_p[4].graph_version == after_r[4].graph_version == 1
    assert np.array_equal(after_p[4].value, after_r[4].value)
    for tier, cls in ((port, ServeRequest), (ref, RefRequest)):
        with pytest.raises(ValueError, match="stale"):
            tier.submit(cls(5, "B", "bfs", 0, graph_version=0))
        with pytest.raises(ValueError, match="increase"):
            tier.update_tenant("B", tier.tenants["B"].host, version=1)
        tier.tenants["A"].quiescing = True
        with pytest.raises(ValueError, match="quiescing"):
            tier.submit(cls(6, "A", "bfs", 0))
        assert tier.submit(cls(7, "B", "bfs", 2)) is None   # B still admits
        tier.tenants["A"].quiescing = False
        tier.drain()


def test_submit_validation_errors_equal_reference():
    port, ref = _tiers()
    for bad in ((1, "nope", "bfs", 0), (1, "A", "pagerank_all", 0), (1, "A", "bfs", 10_000)):
        with pytest.raises(ValueError) as ep:
            port.submit(ServeRequest(*bad))
        with pytest.raises(ValueError) as er:
            ref.submit(RefRequest(*bad))
        assert str(ep.value) == str(er.value)
    port.submit(ServeRequest(1, "A", "bfs", 0))
    with pytest.raises(ValueError, match="already pending"):
        port.submit(ServeRequest(1, "A", "ppr", 1))
    with pytest.raises(ValueError, match="tenant 'w'.*chains"):
        port.add_tenant("w", _graphs(dedup)["A"], layer_weights=[[1.0]] * 3)


def test_run_load_equal_reference():
    stream = _stream(40, seed=3)
    port, ref = _tiers()
    rp = port.run_load(_reqs(ServeRequest, stream))
    rr = ref.run_load(_reqs(RefRequest, stream))
    assert sorted((r.qid, r.cached, r.graph_version) for r in rp) == sorted(
        (r.qid, r.cached, r.graph_version) for r in rr)
    by_qid = {r.qid: r for r in rr}
    for r in rp:
        assert r.latency >= 0 and r.done_time >= r.arrival_time
        _same_answer(r.kind, r.value, by_qid[r.qid].value)


def test_shape_signature_classes_equal_reference():
    """Two uploads share a signature in the port exactly when their JAX
    counterparts share one: same-shaped graphs do, version stamps never
    matter, and a different shape, packing or correction separates."""
    sets_a = [{0, 1, 2}, {3, 4, 5}, {6, 7, 8}]
    sets_b = [{0, 1, 3}, {2, 4, 6}, {5, 7, 8}]
    sets_c = [{0, 1, 2, 3}, {3, 4, 5}, {6, 7, 8}]

    def uploads(dmod, emod, kw):
        ga, gb, gc = (dmod.graph_from_membership(12, s) for s in (sets_a, sets_b, sets_c))
        return [
            emod.to_device(ga, **kw), emod.to_device(gb, **kw),
            emod.to_device(gc, **kw),
            emod.with_graph_version(emod.to_device(ga, **kw), 7),
            emod.to_device(ga, correction=dmod.build_correction(ga), **kw),
            emod.to_device_packed(ga, **kw), emod.to_device_packed(gb, **kw),
            emod.to_device_packed(ga, correction=dmod.build_correction(ga), **kw),
        ]

    port = [engine.graph_shape_signature(g) for g in uploads(dedup, engine, {"device": "cpu"})]
    ref = [ref_engine.graph_shape_signature(g) for g in uploads(ref_dedup, ref_engine, {})]
    classes = lambda sigs: [[a == b for b in sigs] for a in sigs]  # noqa: E731
    assert classes(port) == classes(ref)
    assert port[0] == port[1] == port[3] and port[0] != port[2]


@pytest.mark.parametrize("tenants,n_devices,group_size,replicas", [
    (["A", "B", "C"], 8, 2, 2), (["A", "B", "C", "D", "E"], 4, 1, 3),
    (["x"], 1, 1, 1), (["A", "B"], 7, 3, 2),
])
def test_place_serving_replicas_equal_reference(tenants, n_devices, group_size, replicas):
    got = place_serving_replicas(tenants, n_devices, group_size=group_size,
                                 replicas=replicas)
    want = ref_place(tenants, n_devices, group_size=group_size, replicas=replicas)
    assert all(isinstance(p, ReplicaPlacement) for p in got)
    assert [(p.tenant, p.replica, p.devices) for p in got] == [
        (p.tenant, p.replica, p.devices) for p in want]


def test_place_serving_replicas_errors():
    with pytest.raises(ValueError, match="group"):
        place_serving_replicas(["A"], n_devices=2, group_size=4)
    with pytest.raises(ValueError, match="distinct"):
        place_serving_replicas(["A"], n_devices=2, group_size=1, replicas=3)


def test_graphs_launcher_serves_on_cpu(capsys):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--graphs", "3",
         "--requests", "64", "--device", "cpu"],
        env=env, cwd=str(ROOT), capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("served 64 requests over 3 tenants")
    from repro.launch.serve import _serve_graphs

    class Args:
        graphs, requests, slots, replicas, seed = 3, 64, 3, 1, 0

    _serve_graphs(Args)
    want = capsys.readouterr().out.strip().splitlines()[-1]

    def counters(text):  # the byte counts are each package's own
        return [w for w in text.split() if not w.startswith("resident=")]

    assert counters(line) == counters(want)
