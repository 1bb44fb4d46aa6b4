"""Banded and edge-sharded PageRank of the port against the JAX package.

``band_partition`` gives the JAX package's arrays byte for byte (padding
included, also where the band count does not divide ``n_real``).  Banded
PageRank at world 1 with S bands, and over ``gloo`` worlds of 2 and 4
ranks (S = 8), lies within 1e-7 — the JAX package's own bound
(``tests/test_sharded_paths.py``) — of the JAX package's banded run at 8
forced host devices and of the port's engine PageRank.  Edge-sharded
("flat") PageRank on 4 ranks, then on the 3 ranks that survive a worker's
failure, lies within ``atol=1e-6`` of the engine's (the bound of
``examples/graph_analytics_distributed.py``).

Spawned ranks run functions of this module, so it imports the JAX
package only inside tests.  Every world joins under a timeout that kills
its ranks.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import algorithms, dedup, engine
from repro_torch.core.banding import BAND_FIELDS, band_partition, make_banded_pagerank
from repro_torch.core.semiring import MAX_TIMES, MIN_PLUS, PLUS_TIMES
from repro_torch.data.synth import barabasi_albert_condensed
from repro_torch.distributed.sharding import shard_condensed
from repro_torch.distributed.world import spawn_world

REPO = os.path.join(os.path.dirname(__file__), "..")
WORLD_TIMEOUT_S = 120
ITERS = 15
BANDED_ATOL = 1e-7   # tests/test_sharded_paths.py:41
FLAT_ATOL = 1e-6     # examples/graph_analytics_distributed.py


def _graph(n_real=4096):
    g = barabasi_albert_condensed(n_real, 512, 10.0, 3.0, seed=3)
    corr = dedup.build_correction(g)
    return g, corr, engine.to_device(g, correction=corr, device="cpu")


@pytest.fixture(scope="module")
def graph():
    g, corr, dev = _graph()
    ref = algorithms.pagerank(dev, num_iters=ITERS).numpy()
    deg = algorithms.out_degrees(dev).numpy()
    return g, corr, dev, ref, deg


JAX_BANDED = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import algorithms, dedup, engine
from repro.core.banding import band_partition, make_banded_pagerank
from repro.data.synth import barabasi_albert_condensed

g = barabasi_albert_condensed(4096, 512, 10.0, 3.0, seed=3)
corr = dedup.build_correction(g)
dev = engine.to_device(g, correction=corr)
ref = np.asarray(algorithms.pagerank(dev, num_iters=int(sys.argv[2])))
deg = np.asarray(algorithms.out_degrees(dev))
banded = band_partition(g, corr, 8, deg)
mesh = jax.make_mesh((4, 2), ("data", "model"))
fn = make_banded_pagerank(mesh, ("data", "model"), banded.n_real, banded.n_virtual, 8,
                          iters=int(sys.argv[2]))
sh = NamedSharding(mesh, P(("data", "model")))
args = {k: jax.device_put(jnp.asarray(getattr(banded, k)), sh)
        for k in ("in_src", "in_dst", "out_src", "out_dst",
                  "corr_src", "corr_dst", "corr_cnt", "deg")}
np.savez(sys.argv[1], banded=np.asarray(jax.jit(fn)(args)), engine=ref)
"""


@pytest.fixture(scope="module")
def jax_banded(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax") / "banded.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", JAX_BANDED, str(out), str(ITERS)],
                          capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(out))


# -- band_partition --------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("n_real", [4096, 1001])
def test_band_partition_arrays_equal_reference(n_real, n_shards):
    from repro.core.banding import band_partition as ref_partition
    from repro.data.synth import barabasi_albert_condensed as ref_ba

    g, corr, dev = _graph(n_real)
    deg = algorithms.out_degrees(dev).numpy()
    got = band_partition(g, corr, n_shards, deg)
    want = ref_partition(ref_ba(n_real, 512, 10.0, 3.0, seed=3), corr, n_shards, deg)
    for name in BAND_FIELDS + ("deg",):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    assert (got.n_real, got.n_virtual, got.n_shards) == (want.n_real, want.n_virtual, n_shards)
    assert got.n_real % n_shards == 0 and got.n_real >= n_real


def test_band_partition_refuses_multilayer_chains():
    from repro_torch.data.synth import layered_condensed

    g = layered_condensed(40, [10, 10], [60, 60, 60], seed=0)
    with pytest.raises(ValueError, match="single-layer"):
        band_partition(g, (np.zeros(0, int),) * 3, 2, np.zeros(40, np.float32))


# -- banded PageRank ---------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_banded_world1_matches_engine_and_reference(graph, jax_banded, n_shards):
    g, corr, dev, ref, deg = graph
    banded = band_partition(g, corr, n_shards, deg)
    fn = make_banded_pagerank(None, banded.n_real, banded.n_virtual, n_shards, iters=ITERS)
    args = banded.local(0, n_shards, "cpu")
    got = fn(args).numpy()
    assert got.shape == (banded.n_real,) and np.isfinite(got).all()
    assert np.abs(got[: g.n_real] - ref).max() < BANDED_ATOL
    assert np.abs(got - jax_banded["banded"]).max() < BANDED_ATOL
    # the plans are built once: a second call repeats the bits
    assert np.array_equal(fn(args).numpy(), got)


def test_engine_pagerank_matches_reference(graph, jax_banded):
    assert np.allclose(graph[3], jax_banded["engine"], rtol=1e-5, atol=1e-6)


def _world_rank(rank, world, bands_per_rank):
    """Banded PageRank on ``world × bands_per_rank`` bands, flat PageRank
    on 8 slices, then flat PageRank on the ranks left after worker 3 of
    the scripted supervisor fails."""
    import torch.distributed as dist

    from repro_torch.launch.distributed_analytics import scripted_failure, survivor_ranks

    g, corr, dev = _graph()
    deg = algorithms.out_degrees(dev).numpy()
    n_bands = world * bands_per_rank
    banded = band_partition(g, corr, n_bands, deg)
    fn = make_banded_pagerank(None, banded.n_real, banded.n_virtual, n_bands, iters=ITERS)
    out = {"banded": fn(banded.local(rank, bands_per_rank, "cpu")).numpy()}
    flat = shard_condensed(dev, None, 8 // world)
    out["flat"] = algorithms.pagerank(flat, num_iters=ITERS).numpy()
    sup, (shape, _) = scripted_failure()
    ranks = survivor_ranks(sup.alive_workers, world)
    group = dist.new_group(ranks)
    out["survivor_ranks"] = ranks
    if rank in ranks:
        n_after = int(np.prod(shape))
        sharded = shard_condensed(dev, group, n_after // len(ranks))
        out["survivor_slices"] = n_after
        out["survivors"] = algorithms.pagerank(sharded, num_iters=ITERS).numpy()
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for world, k in ((2, 4), (4, 2)):
        d = tmp_path_factory.mktemp(f"world{world}")
        out[world] = spawn_world(_world_rank, world, (k,), timeout_s=WORLD_TIMEOUT_S,
                                 store_dir=str(d))
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_banded_on_gloo_worlds_matches_engine_and_reference(graph, jax_banded, worlds, world):
    ref = graph[3]
    for r in worlds[world]:
        got = r["banded"]
        assert np.abs(got[: ref.size] - ref).max() < BANDED_ATOL
        assert np.abs(got - jax_banded["banded"]).max() < BANDED_ATOL
        assert np.array_equal(got, worlds[world][0]["banded"])  # every rank gathers it


def test_flat_on_four_ranks_then_three_survivors(graph, worlds):
    ref = graph[3]
    ranks = worlds[4]
    assert ranks[0]["survivor_ranks"] == [0, 1, 2]
    for r in ranks:
        assert np.allclose(r["flat"], ref, rtol=0.0, atol=FLAT_ATOL)
    for r in ranks[:3]:
        assert r["survivor_slices"] == 6
        assert np.allclose(r["survivors"], ref, rtol=0.0, atol=FLAT_ATOL)
    assert "survivors" not in ranks[3]
    # two ranks: rank 1 still hosts worker 2, so both survive with 3 slices each
    assert worlds[2][1]["survivor_ranks"] == [0, 1]
    for r in worlds[2]:
        assert np.allclose(r["survivors"], ref, rtol=0.0, atol=FLAT_ATOL)


# -- flat sharding in one process ------------------------------------------------------

@pytest.mark.parametrize("slices", [1, 3, 8])
def test_flat_slices_in_one_process_match_engine(graph, slices):
    g, corr, dev, ref, _ = graph
    sharded = shard_condensed(dev, None, slices)
    assert sharded.chains[0][0].src.shape[0] == slices
    assert sharded.chains[0][0].n_dst == g.n_virtual + 2  # the two inert dummies
    got = algorithms.pagerank(sharded, num_iters=ITERS).numpy()
    assert np.allclose(got, ref, rtol=0.0, atol=FLAT_ATOL)


@pytest.mark.parametrize("semiring", [MIN_PLUS, MAX_TIMES], ids=lambda s: s.name)
@pytest.mark.parametrize("reverse", [False, True])
def test_flat_slices_idempotent_semirings_exact(graph, semiring, reverse):
    dev = graph[2]
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 9, (dev.n_real, 4))
                         .astype(np.float32))
    want = engine.propagate(dev, x, semiring, reverse=reverse)
    got = engine.propagate(shard_condensed(dev, None, 5), x, semiring, reverse=reverse)
    assert torch.equal(got, want)


@pytest.mark.parametrize("semiring", [PLUS_TIMES, MIN_PLUS], ids=lambda s: s.name)
def test_flat_slices_with_a_hop_weight_match_engine(graph, semiring):
    # the hop weight applies to each rank's partial before the all-reduce;
    # it distributes over the semiring's add, so the answer is the engine's
    dev = graph[2]
    x = torch.from_numpy(np.random.default_rng(1).random((dev.n_real, 3)).astype(np.float32))
    want = engine.propagate(dev, x, semiring, hop_weight=0.5)
    got = engine.propagate(shard_condensed(dev, None, 4), x, semiring, hop_weight=0.5)
    if semiring is MIN_PLUS:
        assert torch.equal(got, want)
    else:
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)


def test_analytics_gate_scales_with_the_vector():
    # at CONFIG's size a PageRank value is near 1 / n_real, under the
    # example's atol: losing a tenth of the mass must still fail the gate
    from repro_torch.launch.distributed_analytics import FLAT_ATOL, VEC_RTOL, _check

    n = 1_638_400
    ref = torch.full((n,), 1.0 / n)
    lost = ref * 0.9
    assert float((lost - ref).abs().max()) < FLAT_ATOL
    with pytest.raises(AssertionError, match="differs"):
        _check("flat PageRank", lost, ref, FLAT_ATOL)
    near = ref * (1 + VEC_RTOL / 10)
    got = _check("flat PageRank", near, ref, FLAT_ATOL)
    assert got["max_abs_diff"] <= got["bound"] == pytest.approx(VEC_RTOL / n)


def test_cuda_backend_on_sharded_graph_raises(graph):
    g, corr, _, _, _ = graph
    packed = engine.to_device_packed(g, correction=corr, backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="whole layers"):
        shard_condensed(packed, None, 2)
    segment = engine.to_device_packed(g, correction=corr, backend="segment", device="cpu")
    sharded = shard_condensed(segment, None, 2)
    assert np.allclose(algorithms.pagerank(sharded, num_iters=ITERS).numpy(), graph[3],
                       rtol=0.0, atol=FLAT_ATOL)
    with pytest.raises(ValueError, match="edge-sharded already"):
        shard_condensed(sharded, None, 2)
