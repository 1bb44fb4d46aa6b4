"""The port's distributed extraction and compression against the JAX
package's.

``extraction_shard_range`` and ``merge_schedule`` give the JAX package's
ranges and rounds; ``MultihostSpillExtraction`` driven phase by phase
for simulated processes (as ``tests/test_multihost_spill.py`` drives the
JAX package's) gives, on every process, the graph of the port's and of
the JAX package's ``extract`` and the JAX package's budgets, and a real
2-rank ``gloo`` run of ``run()`` gives it on both ranks; the int8
compression equals the JAX package's bit for bit, its collective against
``shard_map`` over forced host devices.

Spawned ranks run functions of this module, so it imports the JAX
package only inside tests: a rank imports the port alone.  Every world
joins under a timeout that kills its ranks.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import extract, graphs_identical, merge_spilled_graph
from repro_torch.core.serialize import ShardSpillStore
from repro_torch.data import synth
from repro_torch.distributed import compression as C
from repro_torch.distributed.sharding import (
    GRAPH_RULES,
    MultihostSpillExtraction,
    extraction_shard_range,
    merge_schedule,
    shard_frontier,
)
from repro_torch.distributed.world import WorldError, spawn_world

REPO = os.path.join(os.path.dirname(__file__), "..")
WORLD_TIMEOUT_S = 120

Q_DBLP = """
Nodes(ID, Name) :- Author(ID, Name).
Edges(ID1, ID2) :- AuthorPub(ID1, PubID), AuthorPub(ID2, PubID).
"""


def _dblp(m):
    return m.dblp_catalog(n_authors=151, n_pubs=301, mean_authors_per_pub=4.0, seed=5)


def _simulate(cls, catalog, query, n_shards, P, spill_dir):
    """Drive P simulated processes phase by phase over one spill dir."""
    procs = [
        cls(catalog, query, n_shards, spill_dir, process_index=p, process_count=P,
            barrier=lambda name: None)
        for p in range(P)
    ]
    for m in procs:
        m.phase_nodes()
    for m in procs:
        m.phase_shards()
    for r in range(len(procs[0].schedule)):
        for m in procs:
            m.phase_merge_round(r)
    return [m.phase_finish() for m in procs]


def _same_array(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def _same_graph(port, ref):
    """A port CondensedGraph equals a JAX-package one array for array."""
    assert port.n_real == ref.n_real and len(port.chains) == len(ref.chains)
    for pc, rc in zip(port.chains, ref.chains):
        assert len(pc.edges) == len(rc.edges)
        for pe, re_ in zip(pc.edges, rc.edges):
            assert (pe.n_src, pe.n_dst) == (re_.n_src, re_.n_dst)
            _same_array(pe.src, re_.src)
            _same_array(pe.dst, re_.dst)
    assert (port.direct is None) == (ref.direct is None)
    assert sorted(port.node_properties) == sorted(ref.node_properties)
    for k in port.node_properties:
        _same_array(port.node_properties[k], ref.node_properties[k])
    _same_array(port.node_type, ref.node_type)


# -- ranges and schedules -------------------------------------------------------

@pytest.mark.parametrize("P", range(1, 10))
def test_extraction_shard_range_equals_reference(P):
    from repro.distributed.sharding import extraction_shard_range as ref_range

    for n_shards in range(0, 21):
        for p in range(P):
            assert extraction_shard_range(n_shards, p, P) == ref_range(n_shards, p, P)
        with pytest.raises(ValueError):
            extraction_shard_range(n_shards, P, P)
    # no group: process 0 of 1, the full range
    assert extraction_shard_range(7) == range(7)


@pytest.mark.parametrize("n_partials", range(0, 21))
def test_merge_schedule_equals_reference(n_partials):
    from repro.distributed.sharding import merge_schedule as ref_schedule

    assert merge_schedule(n_partials) == ref_schedule(n_partials)


def test_merge_schedule_rejects_negative_and_rules_equal_reference():
    from repro.distributed import sharding as ref

    with pytest.raises(ValueError):
        merge_schedule(-1)
    assert GRAPH_RULES == ref.GRAPH_RULES


# -- multi-process extraction, simulated -----------------------------------------

@pytest.fixture(scope="module")
def catalogs():
    from repro.data import synth as ref_synth

    return _dblp(synth), _dblp(ref_synth)


@pytest.mark.parametrize("n_shards", [1, 4, 7])
@pytest.mark.parametrize("P", [1, 2, 3, 5])
def test_multihost_equals_extract_on_every_process(catalogs, tmp_path, P, n_shards):
    from repro.core import extract as ref_extract
    from repro.distributed.sharding import MultihostSpillExtraction as RefMultihost

    cat, ref_cat = catalogs
    base = extract(cat, Q_DBLP)
    want = ref_extract(ref_cat, Q_DBLP)
    sp = str(tmp_path / "port")
    results = _simulate(MultihostSpillExtraction, cat, Q_DBLP, n_shards, P, sp)
    refs = _simulate(RefMultihost, ref_cat, Q_DBLP, n_shards, P, str(tmp_path / "ref"))
    assert len(results) == P
    for res, ref in zip(results, refs):
        assert graphs_identical(base.graph, res.graph)
        _same_graph(res.graph, want.graph)
        _same_array(res.nodes.keys, want.nodes.keys)
        assert res.dropped_endpoints == base.dropped_endpoints == ref.dropped_endpoints
        assert res.n_shards == n_shards
        assert dataclasses.asdict(res.budget) == dataclasses.asdict(ref.budget)
    # only processes that own shards spill shard records and partials
    names = ShardSpillStore(sp, create=False).list_records()
    assert len([n for n in names if n.startswith("shard_s")]) == n_shards
    assert len([n for n in names if n.startswith("partial_p")]) == min(P, n_shards)


def test_multihost_finalized_spill_remerges_in_both_packages(catalogs, tmp_path):
    from repro.core import merge_spilled_graph as ref_merge

    cat, _ = catalogs
    base = extract(cat, Q_DBLP)
    sp = str(tmp_path / "spill")
    _simulate(MultihostSpillExtraction, cat, Q_DBLP, 6, 3, sp)
    graph, _ = merge_spilled_graph(sp)
    assert graphs_identical(base.graph, graph)
    ref_graph, _ = ref_merge(sp)
    _same_graph(graph, ref_graph)


def test_multihost_run_without_group_is_one_process(catalogs, tmp_path):
    cat, _ = catalogs
    res = MultihostSpillExtraction(cat, Q_DBLP, 4, str(tmp_path / "spill")).run()
    assert (res.n_shards, res.budget.spilled_bytes > 0) == (4, True)
    assert graphs_identical(extract(cat, Q_DBLP).graph, res.graph)


# -- a real 2-rank gloo world ------------------------------------------------------

def _extraction_rank(rank, world, spill_dir):
    """One rank of a real world: ``run()`` with the default barrier, and
    this rank's columns of a frontier."""
    res = MultihostSpillExtraction(_dblp(synth), Q_DBLP, 5, spill_dir).run()
    x = torch.arange(3 * 7, dtype=torch.float32).reshape(3, 7)
    return {"graph": res.graph, "n_shards": res.n_shards,
            "cols": shard_frontier(x).numpy(), "vec": shard_frontier(x[:, 0]).numpy()}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("world")
    return spawn_world(_extraction_rank, 2, (str(d / "spill"),),
                       timeout_s=WORLD_TIMEOUT_S, store_dir=str(d / "store"))


def test_multihost_run_on_two_gloo_ranks_is_byte_identical(two_ranks):
    base = extract(_dblp(synth), Q_DBLP).graph
    for r in two_ranks:
        assert graphs_identical(base, r["graph"]) and r["n_shards"] == 5
    assert graphs_identical(two_ranks[0]["graph"], two_ranks[1]["graph"])


def _world_of_one_rank(rank, world, spill_dir):
    """``run()`` in a world of one: its default barrier still meets the
    group (counted through a wrapper around ``torch.distributed.barrier``)."""
    calls = []
    real = torch.distributed.barrier

    def counted(group=None):
        calls.append(group)
        return real(group)

    torch.distributed.barrier = counted
    try:
        res = MultihostSpillExtraction(_dblp(synth), Q_DBLP, 3, spill_dir).run()
    finally:
        torch.distributed.barrier = real
    return {"graph": res.graph, "barriers": len(calls)}


def test_default_barrier_meets_a_group_of_one(tmp_path):
    from repro_torch.distributed.sharding import _sync_barrier

    _sync_barrier(1)("no group")  # one process, no group: a no-op
    [r] = spawn_world(_world_of_one_rank, 1, (str(tmp_path / "spill"),),
                      timeout_s=WORLD_TIMEOUT_S, store_dir=str(tmp_path / "store"))
    assert r["barriers"] > 0
    assert graphs_identical(extract(_dblp(synth), Q_DBLP).graph, r["graph"])


def test_shard_frontier_column_blocks(two_ranks):
    x = np.arange(3 * 7, dtype=np.float32).reshape(3, 7)
    # 7 columns over 2 ranks: 4 then 3, contiguous; a vector stays whole
    _same_array(two_ranks[0]["cols"], x[:, :4])
    _same_array(two_ranks[1]["cols"], x[:, 4:])
    for r in two_ranks:
        _same_array(r["vec"], x[:, 0])
    t = torch.ones(4, 3)
    assert shard_frontier(t) is t  # no group: the identity
    with pytest.raises(ValueError, match="frontier must be"):
        shard_frontier(torch.ones(2, 2, 2))


# -- int8 compression ----------------------------------------------------------------

def _inputs(seed, shape, scale=3.0):
    """Normal values, led by ties that round half to even once scaled."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    ties = np.float32([127.0, 0.5, -2.5, 63.5])
    n = min(ties.size, x.size)
    x.reshape(-1)[:n] = ties[:n]
    return x


@pytest.mark.parametrize("shape", [(1,), (33,), (8, 16), (3, 5, 7)])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_int8_bits_equal_reference(seed, shape):
    import jax.numpy as jnp
    from repro.distributed import compression as ref

    x = _inputs(seed, shape)
    q, s = C.quantize_int8(torch.from_numpy(x))
    rq, rs = ref.quantize_int8(jnp.asarray(x))
    _same_array(q.numpy(), np.asarray(rq))
    assert np.float32(s.item()).tobytes() == np.asarray(rs, np.float32).tobytes()
    _same_array(C.dequantize_int8(q, s).numpy(), np.asarray(ref.dequantize_int8(rq, rs)))
    # all zeros: the scale's floor keeps the division finite
    qz, sz = C.quantize_int8(torch.zeros(shape))
    assert not qz.any() and sz.item() == np.float32(np.float32(1e-12) / np.float32(127.0))


def test_error_feedback_ten_steps_equal_reference():
    import jax.numpy as jnp
    from repro.distributed import compression as ref

    rng = np.random.default_rng(3)
    err = rerr = None
    for step in range(10):
        grads = {"w": rng.standard_normal((16, 8)).astype(np.float32) * (step + 1),
                 "blk": {"b": rng.standard_normal(8).astype(np.float32),
                         "s": rng.standard_normal(1).astype(np.float32)}}
        deq, err = C.compress_decompress(
            {"w": torch.from_numpy(grads["w"]),
             "blk": {k: torch.from_numpy(v) for k, v in grads["blk"].items()}}, err)
        rdeq, rerr = ref.compress_decompress(
            {"w": jnp.asarray(grads["w"]),
             "blk": {k: jnp.asarray(v) for k, v in grads["blk"].items()}}, rerr)
        for got, want in ((deq, rdeq), (err, rerr)):
            _same_array(got["w"].numpy(), np.asarray(want["w"]))
            for k in ("b", "s"):
                _same_array(got["blk"][k].numpy(), np.asarray(want["blk"][k]))


ALLREDUCE_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.distributed.compression import allreduce_int8
xs = np.load(sys.argv[1])
mesh = jax.make_mesh((4,), ("i",))
fn = shard_map(lambda x: allreduce_int8(x[0], "i")[None], mesh=mesh,
               in_specs=P("i"), out_specs=P("i"))
np.save(sys.argv[2], np.asarray(jax.jit(fn)(xs)))
"""


def _allreduce_rank(rank, world, xs):
    x = torch.from_numpy(xs[rank])
    return C.allreduce_int8(x).numpy(), C.allreduce_int8(x * 0).numpy()


def test_allreduce_int8_on_four_gloo_ranks_equals_shard_map(tmp_path):
    xs = np.stack([_inputs(10 + r, (257,), scale=1.0 + r) for r in range(4)])
    xs[2, 7] = 9.0  # rank 2 holds the largest magnitude: the shared scale
    np.save(tmp_path / "xs.npy", xs)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", ALLREDUCE_SCRIPT, str(tmp_path / "xs.npy"),
         str(tmp_path / "want.npy")],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    want = np.load(tmp_path / "want.npy")
    got = spawn_world(_allreduce_rank, 4, (xs,), timeout_s=WORLD_TIMEOUT_S,
                      store_dir=str(tmp_path / "store"))
    for r, (total, zero) in enumerate(got):
        _same_array(total, want[r])
        assert not zero.any()
    _same_array(got[0][0], got[3][0])


def test_allreduce_int8_without_group_is_quantize_dequantize():
    x = torch.from_numpy(_inputs(5, (1000,)))
    q, s = C.quantize_int8(x)
    assert torch.equal(C.allreduce_int8(x), C.dequantize_int8(q, s))


# -- a world that fails ----------------------------------------------------------------

def _failing_rank(rank, world, how):
    if rank == 1:
        if how == "raise":
            raise ValueError("rank 1 gave up")
        import time

        time.sleep(600)  # hangs: only the timeout ends it
    torch.distributed.barrier()  # rank 0 waits for rank 1 in a collective
    return rank


@pytest.mark.parametrize("how", ["raise", "hang"])
def test_a_failed_rank_fails_the_world_and_kills_the_rest(tmp_path, how):
    import time

    t = time.monotonic()
    with pytest.raises(WorldError) as err:
        spawn_world(_failing_rank, 2, (how,), timeout_s=10, store_dir=str(tmp_path))
    assert time.monotonic() - t < 60
    if how == "raise":
        assert "rank 1 gave up" in str(err.value)
    else:
        assert "timed out after 10" in str(err.value)
