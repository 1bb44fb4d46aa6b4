"""The whole slice: catalog -> extract -> DEDUP-C -> packed upload -> batched
serving, in the port against the JAX package.

``GraphQueryServer.from_condensed(packed=True)`` on a small DBLP catalog
(mean 6 authors per publication, so the AuthorPub join is postponed and
the layers pack) answers a mixed ``bfs`` / ``ppr`` / ``common_neighbors``
batch like the reference's server: BFS distances and common-neighbor
counts exactly, personalized PageRank to ``rtol=1e-5, atol=1e-6`` (the
port's ``index_add_`` and XLA's ``segment_sum`` add float32 values in
different orders; 1e-6 is the quickstart's own bar).  The port runs the
``'cuda'`` backend on CPU tensors, i.e. every kernel step through the
kernels' plain versions.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import algorithms as ref_algorithms
from repro.core import dedup as ref_dedup
from repro.core import engine as ref_engine
from repro.core import extract as ref_extract
from repro.data import synth as ref_synth
from repro.serve.server import GraphQuery as RefQuery
from repro.serve.server import GraphQueryServer as RefServer

from repro_torch.core import algorithms, dedup, engine, extract
from repro_torch.data import synth
from repro_torch.serve.server import GraphQuery, GraphQueryServer

Q1 = """
Nodes(ID, Name) :- Author(ID, Name).
Edges(ID1, ID2) :- AuthorPub(ID1, PubID), AuthorPub(ID2, PubID).
"""


def _catalog(m):
    return m.dblp_catalog(n_authors=250, n_pubs=420, mean_authors_per_pub=6.0, seed=7)


@pytest.fixture(scope="module")
def graphs():
    g = extract(_catalog(synth), Q1).graph  # 'auto' planning, as users call it
    rg = ref_extract(_catalog(ref_synth), Q1).graph
    assert g.n_virtual > 0
    return g, rg


@pytest.fixture(scope="module")
def servers(graphs):
    g, rg = graphs
    engine.reset_kernel_dispatch_count()
    port = GraphQueryServer.from_condensed(g, packed=True, backend="cuda", device="cpu")
    ref = RefServer.from_condensed(rg, packed=True)
    return port, ref


def _mixed(n, qcls):
    rng = np.random.default_rng(3)
    nodes = rng.integers(0, n, 18)
    kinds = ["bfs", "ppr", "common_neighbors"]
    return [qcls(i, kinds[i % 3], int(v)) for i, v in enumerate(nodes)]


def test_server_answers_like_reference(graphs, servers):
    g, _ = graphs
    port, ref = servers
    engine.reset_kernel_dispatch_count()
    got, stats = port.run(_mixed(g.n_real, GraphQuery), with_stats=True)
    assert engine.KERNEL_DISPATCH_COUNT > 0
    assert dict(engine.KERNEL_STANDDOWN_COUNT).get("vmem_or_backend", 0) == 0
    want, ref_stats = ref.run(_mixed(g.n_real, RefQuery), with_stats=True)
    assert sorted(got) == sorted(want)
    for q in _mixed(g.n_real, GraphQuery):
        a, b = got[q.qid], np.asarray(want[q.qid])
        assert a.shape == b.shape == (g.n_real,)
        if q.kind == "ppr":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        else:
            assert np.array_equal(a, b), q
    assert stats.batch_widths_used == ref_stats.batch_widths_used
    assert (stats.n_batches, stats.occupancy) == (ref_stats.n_batches, ref_stats.occupancy)
    acc, ref_acc = port.correction_accounting, ref.correction_accounting
    assert acc.n_chunks == ref_acc.n_chunks
    assert acc.peak_resident_triples == ref_acc.peak_resident_triples


def test_every_kernel_runs_on_the_slice(servers, graphs):
    """bfs -> K2 min, ppr -> K1 + K3, common_neighbors -> K1,
    reachable_multi -> K2 max: each kernel step goes through its wrapper."""
    from repro_torch.kernels import bitmap_spmm as K

    g, _ = graphs
    port, _ = servers
    calls = []
    real = (K.bitmap_spmm, K.bitmap_spmm_fused)

    def spy_spmm(*a, op="sum", **k):
        calls.append(op)
        return real[0](*a, op=op, **k)

    def spy_fused(*a, **k):
        calls.append("fused")
        return real[1](*a, **k)

    K.bitmap_spmm, K.bitmap_spmm_fused = spy_spmm, spy_fused
    try:
        port.run(_mixed(g.n_real, GraphQuery)[:6])
        algorithms.reachable_multi(port.graph, [0, 1, 2])
    finally:
        K.bitmap_spmm, K.bitmap_spmm_fused = real
    assert set(calls) == {"sum", "min", "max", "fused"}


def test_algorithms_match_reference(graphs):
    g, rg = graphs
    corr, rcorr = dedup.build_correction(g), ref_dedup.build_correction(rg)
    port = engine.to_device_packed(g, correction=corr, backend="cuda", device="cpu")
    ref = ref_engine.to_device_packed(rg, correction=rcorr)
    np.testing.assert_allclose(
        algorithms.pagerank(port).numpy(),
        np.asarray(ref_algorithms.pagerank(ref)), rtol=1e-5, atol=1e-6,
    )
    for fn in ("out_degrees", "in_degrees", "connected_components"):
        assert np.array_equal(getattr(algorithms, fn)(port).numpy(),
                              np.asarray(getattr(ref_algorithms, fn)(ref))), fn
    src = [0, 5, 17, 200]
    pairs = [
        (algorithms.bfs_multi(port, src), ref_algorithms.bfs_multi(ref, jnp.asarray(src))),
        (algorithms.reachable_multi(port, src),
         ref_algorithms.reachable_multi(ref, jnp.asarray(src))),
        (algorithms.reachable_multi(port, src, reverse=True),
         ref_algorithms.reachable_multi(ref, jnp.asarray(src), reverse=True)),
        (algorithms.bfs(port, 9), ref_algorithms.bfs(ref, 9)),
        (algorithms.reachable(port, 9), ref_algorithms.reachable(ref, 9)),
        (algorithms.bfs_multi(port, src, max_iters=1),
         ref_algorithms.bfs_multi(ref, jnp.asarray(src), max_iters=1)),
    ]
    for a, b in pairs:
        assert np.array_equal(a.numpy(), np.asarray(b))
    seeds = algorithms.one_hot_frontier(g.n_real, src, device="cpu")
    np.testing.assert_allclose(
        algorithms.personalized_pagerank(port, seeds).numpy(),
        np.asarray(ref_algorithms.personalized_pagerank(
            ref, ref_algorithms.one_hot_frontier(g.n_real, jnp.asarray(src)))),
        rtol=1e-5, atol=1e-6,
    )
    counts = engine.to_device_packed(g, drop_self_loops=False, backend="cuda", device="cpu")
    ref_counts = ref_engine.to_device_packed(rg, drop_self_loops=False)
    assert np.array_equal(
        algorithms.common_neighbors_multi(counts, src).numpy(),
        np.asarray(ref_algorithms.common_neighbors_multi(ref_counts, jnp.asarray(src))),
    )


def test_server_rejects_bad_queries(servers, graphs):
    g, _ = graphs
    port, _ = servers
    with pytest.raises(ValueError, match="unknown query kind"):
        port.submit(GraphQuery(1, "triangles", 0))
    with pytest.raises(ValueError, match="out of range"):
        port.submit(GraphQuery(1, "bfs", g.n_real))
    with pytest.raises(ValueError, match="stale graph_version"):
        port.submit(GraphQuery(1, "bfs", 0, graph_version=5))
    with pytest.raises(ValueError, match="already pending"):
        port.run([GraphQuery(2, "bfs", 0), GraphQuery(2, "ppr", 1)])
    assert port.pending == []


def test_update_graph_drains_then_swaps(graphs):
    g, _ = graphs
    server = GraphQueryServer.from_condensed(g, device="cpu")
    server.submit(GraphQuery(0, "bfs", 3))
    before = server.graph
    drained = server.update_graph(server.graph, counts_graph=server.counts_graph)
    assert sorted(drained) == [0] and server.graph_version == 1
    assert server.graph is before and not server.pending
    with pytest.raises(ValueError, match="must increase"):
        server.update_graph(server.graph, graph_version=1)
    server.begin_quiesce()
    with pytest.raises(ValueError, match="quiescing"):
        server.submit(GraphQuery(1, "bfs", 3))
    server.end_quiesce()
    answers = server.run([GraphQuery(1, "bfs", 3, graph_version=1)])
    assert np.array_equal(answers[1], drained[0])


def test_segment_and_kernel_servers_agree(graphs, servers):
    """The same uploaded graphs served through the segment path: the
    comparison the smoke makes on the card."""
    import dataclasses

    g, _ = graphs
    port, _ = servers
    seg = GraphQueryServer(
        dataclasses.replace(port.graph, backend="segment"),
        counts_graph=dataclasses.replace(port.counts_graph, backend="segment"),
    )
    got = port.run(_mixed(g.n_real, GraphQuery))
    want = seg.run(_mixed(g.n_real, GraphQuery))
    for q in _mixed(g.n_real, GraphQuery):
        if q.kind == "ppr":
            np.testing.assert_allclose(got[q.qid], want[q.qid], rtol=1e-5, atol=1e-6)
        else:
            assert np.array_equal(got[q.qid], want[q.qid])
    assert isinstance(port.graph.chains[0][0].src, torch.Tensor)
