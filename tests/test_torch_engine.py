"""``propagate`` of the port against the JAX package's, on the same graphs.

Every kernel semiring, both directions, 1-D and ``(n, B)`` frontiers,
over ``to_device`` (the segment path) and ``to_device_packed`` with the
``'cuda'`` backend — which on CPU tensors runs the kernels' plain
versions — against the reference's ``to_device`` / ``to_device_packed``.
Frontiers are integer-valued (``inf`` where the semiring allows), so the
comparison is exact.  Dispatch is held to the reference's rules: the
kernel count rises under ``'cuda'``, never under ``'segment'`` or under
``'auto'`` off the card, and the fused stand-down reasons are the
reference's strings.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import dedup as ref_dedup
from repro.core import engine as ref_engine
from repro.core import extract as ref_extract
from repro.core import semiring as ref_semiring
from repro.data import synth as ref_synth

from repro_torch.core import dedup, engine, extract, semiring
from repro_torch.data import synth

Q1 = """
Nodes(ID, Name) :- Author(ID, Name).
Edges(ID1, ID2) :- AuthorPub(ID1, PubID), AuthorPub(ID2, PubID).
"""

Q2 = """
Nodes(ID, Name) :- Customer(ID, Name).
Edges(ID1, ID2) :- Orders(ok1, ID1), LineItem(ok1, pk),
                   Orders(ok2, ID2), LineItem(ok2, pk).
"""

SEMIRINGS = ["plus_times", "min_plus", "max_times", "or_and", "max_min"]
B = 5


def _sr(mod, name):
    return getattr(mod, name.upper())


def _build(kind):
    if kind == "dblp":
        args = (lambda m: m.dblp_catalog(300, 500, 6.0, seed=3), Q1)
    else:
        args = (lambda m: m.tpch_catalog(n_customers=200, n_orders=600,
                                         n_parts=80, seed=4), Q2)
    cat, q = args
    g = extract(cat(synth), q, mode="condensed").graph
    rg = ref_extract(cat(ref_synth), q, mode="condensed").graph
    corr, rcorr = dedup.build_correction(g), ref_dedup.build_correction(rg)
    return {
        "port": {
            "exact": engine.to_device(g, correction=corr, device="cpu"),
            "packed": engine.to_device_packed(g, correction=corr, backend="cuda",
                                              device="cpu"),
            "counts": engine.to_device_packed(g, drop_self_loops=False,
                                              backend="cuda", device="cpu"),
            "diag": engine.to_device(g, device="cpu"),
        },
        "ref": {
            "exact": ref_engine.to_device(rg, correction=rcorr),
            "packed": ref_engine.to_device(rg, correction=rcorr),
            "counts": ref_engine.to_device(rg, drop_self_loops=False),
            "diag": ref_engine.to_device(rg),
        },
        "n": g.n_real,
    }


@pytest.fixture(scope="module", params=["dblp", "tpch"])
def graphs(request):
    return _build(request.param)


def _frontier(name, n, batched, seed):
    rng = np.random.default_rng(seed)
    shape = (n, B) if batched else (n,)
    x = rng.integers(0, 7, shape).astype(np.float32)
    if name == "min_plus":
        x[rng.random(shape) < 0.6] = np.inf
    elif name == "or_and":
        x = (x > 4).astype(np.float32)
    elif name == "max_min":
        x[rng.random(shape) < 0.1] = np.inf
    return x


@pytest.mark.parametrize("batched", [False, True], ids=["1d", "2d"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("name", SEMIRINGS)
@pytest.mark.parametrize("rep", ["exact", "packed"])
def test_propagate_matches_reference(graphs, rep, name, reverse, batched):
    x = _frontier(name, graphs["n"], batched, seed=len(name) + reverse)
    engine.reset_kernel_dispatch_count()
    got = engine.propagate(
        graphs["port"][rep], torch.from_numpy(x), _sr(semiring, name), reverse=reverse
    ).numpy()
    want = np.asarray(ref_engine.propagate(
        graphs["ref"][rep], jnp.asarray(x), _sr(ref_semiring, name), reverse=reverse
    ))
    assert got.dtype == np.float32
    assert np.array_equal(got, want)
    packed = graphs["port"][rep]
    if rep == "packed" and batched and packed.chains[0][0].fwd is not None:
        assert engine.KERNEL_DISPATCH_COUNT > 0
    if not batched:
        assert engine.KERNEL_DISPATCH_COUNT == 0  # 1-D steps take the segment path


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("rep", ["counts", "diag"])
def test_ring_on_cdup_matches_reference(graphs, rep, reverse):
    x = _frontier("plus_times", graphs["n"], True, seed=9)
    kw = {"allow_duplicates": True}  # raw C-DUP counts duplicate paths
    got = engine.propagate(graphs["port"][rep], torch.from_numpy(x),
                           semiring.PLUS_TIMES, reverse=reverse, **kw).numpy()
    want = np.asarray(ref_engine.propagate(graphs["ref"][rep], jnp.asarray(x),
                                           ref_semiring.PLUS_TIMES, reverse=reverse,
                                           **kw))
    assert np.array_equal(got, want)


def test_ring_on_cdup_without_dedup_raises(graphs):
    x = torch.ones(graphs["n"])
    with pytest.raises(ValueError, match="duplicate paths"):
        engine.propagate(graphs["port"]["counts"], x, semiring.PLUS_TIMES)


def test_float_frontier_pagerank_step_close(graphs):
    """Non-integer frontiers: the port's index_add_ and XLA's segment_sum
    add float32 values in different orders, and ``M x − D x`` cancels, so
    the bound is float32 round-off of the uncorrected sums ``M x`` (1e-5
    of their largest)."""
    rng = np.random.default_rng(1)
    x = rng.random((graphs["n"], B)).astype(np.float32)
    got = engine.propagate(graphs["port"]["packed"], torch.from_numpy(x)).numpy()
    want = np.asarray(ref_engine.propagate(graphs["ref"]["packed"], jnp.asarray(x)))
    raw = engine.propagate(graphs["port"]["counts"], torch.from_numpy(x),
                           allow_duplicates=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(raw.abs().max()))


def test_backends_agree_and_dispatch_honestly():
    g = _build("dblp")["port"]["packed"]
    import dataclasses

    x = torch.from_numpy(_frontier("plus_times", g.n_real, True, seed=2))
    results = {}
    for backend in ("cuda", "segment", "auto"):
        engine.reset_kernel_dispatch_count()
        results[backend] = engine.propagate(dataclasses.replace(g, backend=backend), x)
        counts = (engine.KERNEL_DISPATCH_COUNT, dict(engine.KERNEL_STANDDOWN_COUNT))
        if backend == "cuda":
            # first layer on K1, last layer + correction on K3
            assert counts == (2, {})
        elif backend == "segment":
            assert counts == (0, {"backend_xla": 1})
        else:  # 'auto' takes the kernels only for CUDA frontiers on sm_90
            assert counts == (0, {"vmem_or_backend": 1})
    assert torch.equal(results["cuda"], results["segment"])
    assert torch.equal(results["cuda"], results["auto"])


def test_standdown_reasons_match_reference():
    cat = lambda m: m.dblp_catalog(300, 500, 6.0, seed=3)  # noqa: E731
    g = extract(cat(synth), Q1, mode="condensed").graph
    rg = ref_extract(cat(ref_synth), Q1, mode="condensed").graph
    port = engine.to_device_packed(g, correction=dedup.build_correction(g),
                                   device="cpu")
    ref = ref_engine.to_device_packed(rg, correction=ref_dedup.build_correction(rg))
    assert port.fused_standdown == ref.fused_standdown == ""
    calls = [
        dict(name="plus_times", batched=True),
        dict(name="plus_times", batched=False),
        dict(name="min_plus", batched=True),
        dict(name="plus_times", batched=True, hop_weight=1.0),
    ]
    engine.reset_kernel_dispatch_count()
    ref_engine.reset_kernel_dispatch_count()
    for c in calls:
        x = _frontier(c["name"], g.n_real, c["batched"], seed=0)
        kw = {"hop_weight": c.get("hop_weight")}
        engine.propagate(port, torch.from_numpy(x), _sr(semiring, c["name"]), **kw)
        ref_engine.propagate(ref, jnp.asarray(x), _sr(ref_semiring, c["name"]), **kw)
    assert engine.KERNEL_STANDDOWN_COUNT == ref_engine.KERNEL_STANDDOWN_COUNT
    counts = engine.to_device_packed(g, drop_self_loops=False, device="cpu")
    assert counts.fused_standdown == "no_correction"


def test_to_device_packed_refuses_unported_options():
    """Every pack method the JAX package has is ported ('scatter' gives
    the bytes of 'reduceat'); unknown methods and backends are refused."""
    g = extract(synth.dblp_catalog(100, 150, 6.0, seed=0), Q1).graph
    a = engine.to_device_packed(g, pack_method="scatter", device="cpu")
    b = engine.to_device_packed(g, device="cpu")
    for la, lb in zip(a.chains[0], b.chains[0]):
        for f in ("slot_src", "slot_row", "row_start", "row_count", "bitmaps",
                  "row_ptr", "col"):
            assert torch.equal(getattr(la.fwd, f), getattr(lb.fwd, f)), f
    with pytest.raises(ValueError, match="unknown pack method"):
        engine.to_device_packed(g, pack_method="bogus", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        engine.to_device_packed(g, backend="pallas", device="cpu")


@pytest.mark.parametrize("name", ["sum", "min", "max"])
def test_segment_reduce_empty_segment_conventions(name):
    sr = {"sum": semiring.PLUS_TIMES, "min": semiring.MIN_PLUS,
          "max": semiring.MAX_TIMES}[name]
    rsr = {"sum": ref_semiring.PLUS_TIMES, "min": ref_semiring.MIN_PLUS,
           "max": ref_semiring.MAX_TIMES}[name]
    vals = np.array([[1.0, -np.inf], [2.0, 5.0], [-np.inf, 3.0]], np.float32)
    seg = np.array([0, 0, 2])
    got = semiring.segment_reduce(sr, torch.from_numpy(vals), torch.from_numpy(seg), 4)
    want = ref_semiring.segment_reduce(rsr, jnp.asarray(vals), jnp.asarray(seg), 4)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))


def _permuted(g, rng):
    """The same condensed graph with every layer's edge list permuted."""
    from repro_torch.core.condensed import BipartiteEdges, Chain, CondensedGraph

    def perm(e):
        p = rng.permutation(e.n_edges)
        return BipartiteEdges(e.src[p], e.dst[p], e.n_src, e.n_dst)

    chains = [Chain([perm(e) for e in c.edges]) for c in g.chains]
    direct = perm(g.direct) if g.direct is not None else None
    return CondensedGraph(g.n_real, chains, direct)


@pytest.mark.parametrize("batched", [False, True], ids=["1d", "batched"])
def test_segment_sum_bits_do_not_depend_on_edge_order(batched):
    """The segment path sums each destination's values in an order fixed
    by the edge set (by destination, then source), so permuting a layer's
    COO edge list, or the correction triples, leaves float outputs bit
    for bit the same, in both directions and on the expanded graph."""
    rng = np.random.default_rng(4)
    g = extract(synth.dblp_catalog(300, 500, 6.0, seed=3), Q1, mode="condensed").graph
    gp = _permuted(g, rng)
    cs, cd, cm = dedup.build_correction(g)
    p = rng.permutation(cs.size)
    shape = (g.n_real, B) if batched else (g.n_real,)
    x = torch.from_numpy(rng.random(shape).astype(np.float32))
    for reverse in (False, True):
        a = engine.propagate(engine.to_device(g, correction=(cs, cd, cm), device="cpu"),
                             x, reverse=reverse)
        b = engine.propagate(engine.to_device(gp, correction=(cs[p], cd[p], cm[p]),
                                              device="cpu"), x, reverse=reverse)
        assert torch.equal(a, b)
        c = engine.propagate(engine.to_device(g, device="cpu"), x, reverse=reverse,
                             allow_duplicates=True)
        d = engine.propagate(engine.to_device(gp, device="cpu"), x, reverse=reverse,
                             allow_duplicates=True)
        assert torch.equal(c, d)
    exp = g.expand()
    q = rng.permutation(exp.n_edges)
    from repro_torch.core.condensed import ExpandedGraph

    expp = ExpandedGraph(exp.src[q], exp.dst[q], exp.multiplicity[q], exp.n)
    assert torch.equal(engine.propagate(engine.to_device(exp, device="cpu"), x),
                       engine.propagate(engine.to_device(expp, device="cpu"), x))
    # and the planned sum is the sum: the index_add_ result to round-off
    vals = x if batched else x[:, None]
    ids = torch.from_numpy(rng.integers(0, 40, g.n_real))
    want = torch.zeros((40,) + tuple(vals.shape[1:])).index_add_(0, ids, vals)
    got = semiring.segment_reduce(semiring.PLUS_TIMES, vals, ids, 40)
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-6)
