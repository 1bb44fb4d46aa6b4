"""The port's analytics library against the JAX package's, on the same graphs.

Each test builds one numpy-seeded graph in both packages and runs the same
call: the port over ``to_device`` (the segment path) and over
``to_device_packed(backend='cuda')`` — on CPU tensors the kernel wrappers
run their plain mirrors, so this is the kernel path's arithmetic — and the
reference over its ``to_device`` (XLA), as ``tests/test_algorithms_golden.py``
runs it.  Integer-valued results (distances with integer weights, SCC
labels, the condensation DAG, triangle counts) must be equal exactly;
fractional min-plus weights too, since both packages add the same float32
values in the same order; HITS and the float vertex program to
``rtol=1e-5, atol=1e-6``.  Where a dense oracle is affordable the answers
are also held to ``tests/oracle.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oracle import (
    clustering_coefficients_ref,
    condensation_ref,
    dense_adjacency,
    scc_labels_ref,
    shortest_paths_ref,
    triangle_counts_ref,
    weighted_dense_ref,
    widest_paths_ref,
)

from repro.core import algorithms as ref_algorithms
from repro.core import dedup as ref_dedup
from repro.core import engine as ref_engine
from repro.core import extract as ref_extract
from repro.core import semiring as ref_semiring
from repro.data import synth as ref_synth
from repro.kernels import ops as ref_ops

from repro_torch.core import algorithms, dedup, engine, extract, semiring
from repro_torch.data import synth
from repro_torch.kernels import ops
from repro_torch.kernels.autotune import (
    CrossoverEntry, CrossoverTable, KernelConfig, batch_bucket, src_bucket)

Q1 = """
Nodes(ID, Name) :- Author(ID, Name).
Edges(ID1, ID2) :- AuthorPub(ID1, PubID), AuthorPub(ID2, PubID).
"""


def _host(name):
    """(port graph, reference graph) from one seed."""
    if name == "dblp":
        def build(m):
            return m.dblp_catalog(150, 260, 6.0, seed=3)
        return (extract(build(synth), Q1, mode="condensed").graph,
                ref_extract(build(ref_synth), Q1, mode="condensed").graph)
    if name == "layered":  # two virtual layers, directed, repeated edges
        def build(m):
            return m.layered_condensed(40, [12, 10], [80, 60, 80], seed=5,
                                       symmetric=False)
    elif name == "asym":  # tests/test_algorithms_golden.py's directed fixture
        def build(m):
            return m.layered_condensed(20, [6], [8, 8], seed=1, symmetric=False)
    else:  # "ba": App. C.1, symmetric
        def build(m):
            return m.barabasi_albert_condensed(120, 40, 6.0, 2.0, seed=11)
    return build(synth), build(ref_synth)


def _build(name):
    g, rg = _host(name)
    corr, rcorr = dedup.build_correction(g), ref_dedup.build_correction(rg)
    return {
        "g": g,
        "rg": rg,
        "segment": engine.to_device(g, correction=corr, device="cpu"),
        "packed": engine.to_device_packed(g, correction=corr, backend="cuda",
                                          device="cpu"),
        "ref": ref_engine.to_device(rg, correction=rcorr),
        "n": g.n_real,
    }


_CACHE = {}


@pytest.fixture(autouse=True)
def one_thread():
    """The plain mirrors run thousands of tiny torch ops a call; one
    intra-op thread keeps them from contending with the other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _case(name):
    if name not in _CACHE:
        _CACHE[name] = _build(name)
    return _CACHE[name]


REPS = ["segment", "packed"]


def _weights(g, kind, seed=0):
    """One weight array per virtual layer: integers in 1..8, or fractions."""
    rng = np.random.default_rng(seed)
    out = []
    for chain in g.chains:
        ws = []
        for size in chain.layer_sizes:
            if kind == "int":
                w = rng.integers(1, 9, size).astype(np.float32)
            else:
                w = (rng.random(size) * 4.0 + 0.25).astype(np.float32)
            ws.append(w)
        out.append(tuple(ws))
    return tuple(out)


def _port_w(lw):
    return None if lw is None else tuple(tuple(torch.from_numpy(w) for w in c) for c in lw)


def _ref_w(lw):
    return None if lw is None else tuple(tuple(jnp.asarray(w) for w in c) for c in lw)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# propagate(layer_weights=) and propagate_wedge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batched", [False, True], ids=["1d", "2d"])
@pytest.mark.parametrize("kind", ["int", "frac"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("sr", ["min_plus", "max_min"])
@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("name", ["dblp", "layered"])
def test_layer_weights_match_reference(name, rep, sr, reverse, kind, batched):
    c = _case(name)
    rng = np.random.default_rng(7)
    shape = (c["n"], 6) if batched else (c["n"],)
    x = rng.integers(0, 9, shape).astype(np.float32)
    x[rng.random(shape) < 0.4] = np.inf if sr == "min_plus" else 0.0
    lw = _weights(c["g"], kind)
    engine.reset_kernel_dispatch_count()
    got = engine.propagate(c[rep], torch.from_numpy(x), getattr(semiring, sr.upper()),
                           reverse=reverse, layer_weights=_port_w(lw))
    want = ref_engine.propagate(c["ref"], jnp.asarray(x),
                                getattr(ref_semiring, sr.upper()), reverse=reverse,
                                layer_weights=_ref_w(lw))
    assert np.array_equal(_np(got), _np(want))
    launched = engine.KERNEL_DISPATCH_COUNT
    if rep == "packed" and batched:
        assert launched == sum(len(ch) for ch in c[rep].chains)
    else:
        assert launched == 0


def test_layer_weights_errors_match_reference():
    c = _case("layered")
    x = np.zeros((c["n"], 2), np.float32)
    lw = _weights(c["g"], "int")
    exp = engine.to_device(c["g"].expand(), device="cpu")
    rexp = ref_engine.to_device(c["rg"].expand())
    calls = [
        ((exp, rexp), "min_plus", lw),
        ((c["packed"], c["ref"]), "plus_times", lw),
        ((c["packed"], c["ref"]), "min_plus", lw + lw),
        ((c["packed"], c["ref"]), "min_plus", ((lw[0][0],),)),
    ]
    for (port, ref), sr, weights in calls:
        with pytest.raises(ValueError) as got:
            engine.propagate(port, torch.from_numpy(x), getattr(semiring, sr.upper()),
                             layer_weights=_port_w(weights))
        with pytest.raises(ValueError) as want:
            ref_engine.propagate(ref, jnp.asarray(x), getattr(ref_semiring, sr.upper()),
                                 layer_weights=_ref_w(weights))
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("triples", [False, True], ids=["on_the_fly", "triples"])
@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("name", ["dblp", "layered"])
def test_propagate_wedge_matches_reference(name, rep, triples, reverse):
    c = _case(name)
    x = np.random.default_rng(2).integers(0, 3, (c["n"], 5)).astype(np.float32)
    w = dedup.build_wedge_correction(c["g"]) if triples else None
    port_w = None if w is None else (torch.from_numpy(w[0]), torch.from_numpy(w[1]),
                                     torch.from_numpy(w[2].astype(np.float32)))
    ref_w = None if w is None else (jnp.asarray(w[0], jnp.int32), jnp.asarray(w[1], jnp.int32),
                                    jnp.asarray(w[2], jnp.float32))
    engine.reset_kernel_dispatch_count()
    got = engine.propagate_wedge(c[rep], torch.from_numpy(x), reverse=reverse, wedge=port_w)
    hops = 2 if triples else 3   # raw M(Mx), and M(Dx) when assembled on the fly
    # ring steps over a layer with repeated edges stay on the segment path
    kernel_layers = sum(not getattr(layer, "repeats", True)
                        for ch in c[rep].chains for layer in ch)
    assert engine.KERNEL_DISPATCH_COUNT == hops * kernel_layers
    assert not engine.KERNEL_STANDDOWN_COUNT  # the raw graph has no correction
    want = ref_engine.propagate_wedge(c["ref"], jnp.asarray(x), reverse=reverse, wedge=ref_w)
    assert np.array_equal(_np(got), _np(want))
    two = engine.propagate(c[rep], engine.propagate(c[rep], torch.from_numpy(x),
                                                   reverse=reverse), reverse=reverse)
    assert torch.equal(got, two)


def test_propagate_wedge_needs_a_correction():
    g = _case("dblp")["g"]
    raw = engine.to_device_packed(g, drop_self_loops=False, device="cpu")
    with pytest.raises(ValueError, match="needs a DEDUP-C correction"):
        engine.propagate_wedge(raw, torch.zeros(g.n_real, 2))
    d1 = dedup.dedup1_greedy_virtual_first(g).graph
    x = torch.from_numpy(np.eye(g.n_real, 4, dtype=np.float32))
    dev = engine.to_device(d1, deduplicated=True, device="cpu")
    assert torch.equal(engine.propagate_wedge(dev, x),
                       engine.propagate(dev, engine.propagate(dev, x)))


# ---------------------------------------------------------------------------
# Weighted paths
# ---------------------------------------------------------------------------

def _oracle_weights(c, kind, lw):
    return weighted_dense_ref(c["rg"], lw, kind=kind)


@pytest.mark.parametrize("kind", [None, "int", "frac"])
@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("name", ["dblp", "layered", "asym"])
def test_shortest_paths_match_reference(name, rep, kind):
    c = _case(name)
    sources = [0, 3, 5, 7]
    lw = None if kind is None else _weights(c["g"], kind, seed=1)
    got = algorithms.shortest_paths_multi(c[rep], sources, layer_weights=_port_w(lw))
    want = ref_algorithms.shortest_paths_multi(c["ref"], jnp.asarray(sources),
                                               layer_weights=_ref_w(lw))
    assert np.array_equal(_np(got), _np(want))
    if kind is None:
        A = dense_adjacency(c["rg"])
        W = np.where(A > 0, 1.0, np.inf)
    else:
        W = _oracle_weights(c, "min_plus", lw)
    np.testing.assert_allclose(_np(got), shortest_paths_ref(W, sources), rtol=1e-6)
    one = algorithms.shortest_paths(c[rep], 5, layer_weights=_port_w(lw))
    assert torch.equal(one, got[:, 2])
    # reverse=True: distances to the sources, the transposed oracle
    back = algorithms.shortest_paths_multi(c[rep], sources, layer_weights=_port_w(lw),
                                           reverse=True)
    np.testing.assert_allclose(_np(back), shortest_paths_ref(W.T, sources), rtol=1e-6)


@pytest.mark.parametrize("kind", [None, "int", "frac"])
@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("name", ["dblp", "layered", "asym"])
def test_widest_paths_match_reference(name, rep, kind):
    c = _case(name)
    sources = [1, 2, 6]
    lw = None if kind is None else _weights(c["g"], kind, seed=4)
    got = algorithms.widest_paths_multi(c[rep], sources, layer_capacities=_port_w(lw))
    want = ref_algorithms.widest_paths_multi(c["ref"], jnp.asarray(sources),
                                             layer_capacities=_ref_w(lw))
    assert np.array_equal(_np(got), _np(want))
    if kind is None:
        C = np.where(dense_adjacency(c["rg"]) > 0, np.inf, 0.0)
    else:
        C = _oracle_weights(c, "max_min", lw)
    assert np.array_equal(_np(got), widest_paths_ref(C, sources).astype(np.float32))
    one = algorithms.widest_paths(c[rep], 2, layer_capacities=_port_w(lw))
    assert torch.equal(one, got[:, 1])
    back = algorithms.widest_paths_multi(c[rep], sources, layer_capacities=_port_w(lw),
                                         reverse=True)
    assert np.array_equal(_np(back), widest_paths_ref(C.T, sources).astype(np.float32))


# ---------------------------------------------------------------------------
# SCC and the condensation DAG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("name", ["layered", "asym", "dblp"])
def test_scc_and_condensation_match_reference(name, rep, batch):
    c = _case(name)
    labels = algorithms.scc_labels(c[rep], batch=batch)
    want = ref_algorithms.scc_labels(c["ref"], batch=batch)
    assert labels.dtype == want.dtype and np.array_equal(labels, want)
    A = dense_adjacency(c["rg"])
    assert np.array_equal(labels, scc_labels_ref(A))
    cond = algorithms.condensation(c[rep], labels=labels)
    rcond = ref_algorithms.condensation(c["ref"], labels=want)
    for field in ("labels", "component", "sizes", "dag_src", "dag_dst", "layers"):
        a, b = getattr(cond, field), getattr(rcond, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    _, comp, sizes, dag, layers = condensation_ref(A)
    assert set(zip(cond.dag_src.tolist(), cond.dag_dst.tolist())) == dag
    assert np.array_equal(cond.layers, layers) and np.array_equal(cond.sizes, sizes)


# ---------------------------------------------------------------------------
# Triangles and clustering coefficients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["per_step", "wedge", "triples"])
@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("name", ["dblp", "ba"])
def test_triangles_and_clustering_match_reference(name, rep, mode):
    c = _case(name)
    wedge = dedup.build_wedge_correction(c["g"]) if mode == "triples" else None
    rwedge = ref_dedup.build_wedge_correction(c["rg"]) if mode == "triples" else None
    mode = "wedge" if mode == "triples" else mode
    # two blocks, the second one partly filled
    t = algorithms.triangle_counts(c[rep], block=100, mode=mode, wedge=wedge)
    want = ref_algorithms.triangle_counts(c["ref"], block=100, mode=mode, wedge=rwedge)
    assert t.dtype == np.float64 and np.array_equal(t, want)
    A = dense_adjacency(c["rg"])
    assert np.array_equal(t, triangle_counts_ref(A))
    if mode != "per_step":
        return
    cc = algorithms.clustering_coefficients(c[rep], block=100)
    assert np.array_equal(cc, ref_algorithms.clustering_coefficients(c["ref"], block=100))
    np.testing.assert_allclose(cc, clustering_coefficients_ref(A), rtol=1e-12)


# ---------------------------------------------------------------------------
# HITS and the vertex-centric loop (1-D frontiers: the segment path)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("name", ["dblp", "layered"])
def test_hits_matches_reference(name, rep):
    c = _case(name)
    engine.reset_kernel_dispatch_count()
    h, a = algorithms.hits(c[rep], num_iters=30)
    assert engine.KERNEL_DISPATCH_COUNT == 0
    rh, ra = ref_algorithms.hits(c["ref"], num_iters=30)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a.numpy(), np.asarray(ra), rtol=1e-5, atol=1e-6)


def _programs(mod, lib, minimum):
    """(min-label propagation, a damped sum) as VertexPrograms of ``mod``."""
    return {
        "labels": mod.VertexProgram(lib.MIN_PLUS, lambda s: s, minimum),
        "damped": mod.VertexProgram(lib.PLUS_TIMES, lambda s: 0.1 * s,
                                    lambda s, m: 0.5 * s + 0.5 * m),
    }


@pytest.mark.parametrize("prog", ["labels", "damped"])
@pytest.mark.parametrize("rep", REPS)
def test_vertex_program_matches_reference(rep, prog):
    c = _case("dblp")
    init = np.arange(c["n"], dtype=np.float32)
    port = _programs(algorithms, semiring, torch.minimum)[prog]
    ref = _programs(ref_algorithms, ref_semiring, jnp.minimum)[prog]
    got = algorithms.vertex_program(c[rep], port, torch.from_numpy(init), max_supersteps=25)
    want = ref_algorithms.vertex_program(c["ref"], ref, jnp.asarray(init), max_supersteps=25)
    if prog == "labels":
        assert np.array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Repeated edges, DEDUP-1 on the device path
# ---------------------------------------------------------------------------

def test_layers_with_repeats_pack_their_distinct_edges():
    """App. C's random layers repeat edges: the JAX package leaves them to
    XLA; the port packs the distinct edges, serves idempotent steps through
    the kernel path and keeps ring steps (which count repeats) on the
    segment path — the answers are the reference's either way."""
    c = _case("layered")
    packed = c["packed"]
    assert all(layer.repeats for layer in packed.chains[0])
    x = np.random.default_rng(0).integers(0, 4, (c["n"], 3)).astype(np.float32)
    for sr, kw, launched in (("or_and", {}, 3), ("plus_times", {"allow_duplicates": True}, 0)):
        engine.reset_kernel_dispatch_count()
        got = engine.propagate(packed, torch.from_numpy(x), getattr(semiring, sr.upper()),
                               **kw)
        assert engine.KERNEL_DISPATCH_COUNT == launched
        want = ref_engine.propagate(c["ref"], jnp.asarray(x),
                                    getattr(ref_semiring, sr.upper()), **kw)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_dedup1_graph_on_the_kernel_path():
    """DEDUP-1 output uploaded packed with ``deduplicated=True``: batched
    PPR runs K1 on every layer and never K3 (no correction), and equals
    the DEDUP-C graph's PPR; BFS agrees exactly; both equal the reference's
    answers on its own DEDUP-1 graph."""
    c = _case("ba")
    d1 = dedup.dedup1_greedy_virtual_first(c["g"])
    rd1 = ref_dedup.dedup1_greedy_virtual_first(c["rg"])
    dev = engine.to_device_packed(d1.graph, deduplicated=True, backend="cuda", device="cpu")
    assert dev.fused_standdown == "no_correction" and dev.correction is None
    sources = [0, 4, 9, 11]
    seeds = algorithms.one_hot_frontier(c["n"], sources, device="cpu")
    engine.reset_kernel_dispatch_count()
    ppr = algorithms.personalized_pagerank(dev, seeds)
    assert dev.direct is not None and d1.n_direct_edges > 0
    # 20 batched steps over both chain layers and the direct edges; the
    # degrees' 1-D step takes the segment path
    assert engine.KERNEL_DISPATCH_COUNT == 20 * (len(dev.chains[0]) + 1)
    assert engine.KERNEL_STANDDOWN_COUNT == {}
    np.testing.assert_allclose(
        ppr.numpy(), algorithms.personalized_pagerank(c["packed"], seeds).numpy(),
        rtol=1e-5, atol=1e-6)
    rdev = ref_engine.to_device(rd1.graph, deduplicated=True)
    want = ref_algorithms.personalized_pagerank(rdev, jnp.asarray(seeds.numpy()))
    np.testing.assert_allclose(ppr.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    bfs = algorithms.bfs_multi(dev, sources)
    assert torch.equal(bfs, algorithms.bfs_multi(c["packed"], sources))
    assert np.array_equal(bfs.numpy(), np.asarray(
        ref_algorithms.bfs_multi(rdev, jnp.asarray(sources))))


# ---------------------------------------------------------------------------
# kernels/ops.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def layer_pair():
    g, rg = _host("dblp")
    e_in, e_out = g.chains[0].edges
    r_in, r_out = rg.chains[0].edges
    return ([ops.PackedLayer.from_edges(e, device="cpu") for e in (e_in, e_out)],
            [ref_ops.PackedLayer.from_edges(e) for e in (r_in, r_out)])


@pytest.mark.parametrize("batched", [False, True], ids=["1d", "2d"])
@pytest.mark.parametrize("backend", ["segment", "cuda", "auto"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("sr", ["plus_times", "min_plus", "max_times", "or_and", "max_min"])
def test_ops_bitmap_spmm_matches_reference(layer_pair, sr, reverse, backend, batched):
    (layer, _), (ref_layer, _) = layer_pair
    n_in = layer.n_dst if reverse else layer.n_src
    shape = (n_in, 7) if batched else (n_in,)
    rng = np.random.default_rng(len(sr))
    x = rng.integers(0, 6, shape).astype(np.float32)
    if sr == "min_plus":
        x[rng.random(shape) < 0.5] = np.inf
    elif sr == "or_and":
        x = (x > 2).astype(np.float32)
    got = ops.bitmap_spmm(layer, torch.from_numpy(x), backend=backend,
                          semiring=getattr(semiring, sr.upper()), reverse=reverse)
    want = ref_ops.bitmap_spmm(ref_layer, jnp.asarray(x), backend="xla",
                               semiring=getattr(ref_semiring, sr.upper()), reverse=reverse)
    assert got.shape == tuple(want.shape) and np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", ["segment", "cuda"])
def test_ops_condensed_two_hop_matches_reference(layer_pair, backend):
    (l_in, l_out), (r_in, r_out) = layer_pair
    x = np.random.default_rng(3).integers(0, 5, (l_in.n_src, 9)).astype(np.float32)
    got = ops.condensed_two_hop(l_in, l_out, torch.from_numpy(x), backend=backend)
    want = ref_ops.condensed_two_hop(r_in, r_out, jnp.asarray(x), backend="xla")
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_ops_dispatch_and_unported_arguments(layer_pair):
    (layer, _), _ = layer_pair
    x = torch.zeros(layer.n_src, 4)
    assert ops.resolve_backend("auto", x) == "segment"          # CPU frontier
    assert ops.resolve_backend("auto", x, packable=False) == "segment"
    assert ops.resolve_backend("cuda", x) == "cuda"
    for bsb, ref in ((layer.bsb, layer.fwd), (layer.bsb_rev, layer.rev)):
        assert np.array_equal(bsb.bitmaps.view(np.int32), ref.bitmaps.numpy())
    one_way = ops.PackedLayer.from_edges(_host("dblp")[0].chains[0].edges[0],
                                         with_reverse=False, device="cpu")
    with pytest.raises(ValueError, match="transposed packing"):
        ops.bitmap_spmm(one_way, torch.zeros(one_way.n_dst, 2), backend="cuda", reverse=True)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.bitmap_spmm(layer, x, backend="xla")
    # the measured-crossover arguments: a table decides 'auto' for the
    # cells it covers, a config pins the kernel's range length
    seg_table = CrossoverTable.from_entries(
        {("sum", src_bucket(layer.n_src), batch_bucket(4)): CrossoverEntry(9.0, 1.0)})
    cuda_table = CrossoverTable.from_entries(
        {("sum", src_bucket(layer.n_src), batch_bucket(4)): CrossoverEntry(1.0, 9.0, 64)})
    assert ops.resolve_backend("auto", x, table=seg_table, n_src=layer.n_src) == "segment"
    assert ops.resolve_backend("auto", x, table=cuda_table, n_src=layer.n_src) == "cuda"
    x_int = torch.from_numpy(np.random.default_rng(0).integers(
        0, 5, (layer.n_src, 4)).astype(np.float32))
    want = ops.bitmap_spmm(layer, x_int, backend="segment")
    assert torch.equal(ops.bitmap_spmm(layer, x_int, backend="cuda",
                                       config=KernelConfig(64)), want)
    with pytest.raises(ValueError, match="range_items"):
        KernelConfig(0)


def test_backends_agree_on_the_analytics():
    """``backend='auto'`` off the card takes the segment path, and every
    analytic gives the same answer on all three backends."""
    c = _case("layered")
    runs = {}
    for backend in ("cuda", "segment", "auto"):
        g = dataclasses.replace(c["packed"], backend=backend)
        engine.reset_kernel_dispatch_count()
        lw = _port_w(_weights(c["g"], "int"))
        runs[backend] = (algorithms.scc_labels(g, batch=8),
                         algorithms.shortest_paths_multi(g, [0, 1], layer_weights=lw))
        assert (engine.KERNEL_DISPATCH_COUNT > 0) == (backend == "cuda")
    for backend in ("segment", "auto"):
        assert np.array_equal(runs[backend][0], runs["cuda"][0])
        assert torch.equal(runs[backend][1], runs["cuda"][1])


def test_per_step_triangles_exact_past_float32_sums():
    """A hub in three cliques of sizes 4101, 3001 and 1001, each clique
    one virtual node: the hub's ``Σ a1·a2`` is Σ (s−1)(s−2) = 26,801,900,
    past 2^24, so a float32 reduction of the block may round.  Per_step
    reduces it in float64: every count is the closed form (a member's
    C(s−1, 2), the hub's sum of them), Σt ≡ 0 (mod 3), and the block's
    result is float64."""
    from math import comb

    from repro_torch.core.condensed import BipartiteEdges, Chain, CondensedGraph

    sizes = (4101, 3001, 1001)
    members, want = [], [sum(comb(s - 1, 2) for s in sizes)]
    nxt = 1
    for v, s in enumerate(sizes):
        others = np.arange(nxt, nxt + s - 1)
        nxt += s - 1
        members.append((np.r_[0, others], v))
        want += [comb(s - 1, 2)] * (s - 1)
    src = np.concatenate([m for m, _ in members])
    dst = np.concatenate([np.full(m.size, v) for m, v in members])
    n = nxt
    g = CondensedGraph(n, [Chain([BipartiteEdges(src, dst, n, len(sizes)),
                                  BipartiteEdges(dst, src, len(sizes), n)])])
    dev = engine.to_device(g, correction=dedup.build_correction(g), device="cpu")
    assert 2 * want[0] > 2 ** 24
    t = algorithms.triangle_counts(dev, block=128)
    assert np.array_equal(t, np.asarray(want, dtype=np.float64))
    assert int(t.sum()) % 3 == 0
    X = torch.zeros((n, 128))
    X[0, 0] = 1.0
    block = algorithms._triangle_block(dev, X, None, "per_step")
    assert block.dtype == torch.float64 and float(block[0]) == want[0]
