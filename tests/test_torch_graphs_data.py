"""The port's data generators against the JAX package's: byte-identical
NumPy (both packages draw with NumPy from the same seeds), and the
collated tensors equal to the reference's arrays."""
import numpy as np
import pytest
import torch

from repro.configs import shapes as jshapes
from repro.data import graphs as jgraphs
from repro.data import pipeline as jpipeline
from repro_torch.configs import shapes
from repro_torch.data import graphs, pipeline


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if want.dtype == bool:
        assert got.dtype == bool
    else:
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("kw", [dict(vocab_size=128, seq_len=32, global_batch=4),
                                dict(vocab_size=151_552, seq_len=65, global_batch=8, seed=3,
                                     shard_index=1, num_shards=2)])
def test_token_pipeline_is_byte_identical(kw):
    want, got = iter(jpipeline.TokenPipeline(**kw)), iter(pipeline.TokenPipeline(**kw))
    for _ in range(3):
        w, g = next(want), next(got)
        assert set(g) == set(w) == {"tokens", "labels"}
        for k in w:
            _same(g[k], w[k])
    dev = next(pipeline.TokenPipeline(**kw).device_iter("cpu"))
    _same(dev["tokens"], next(iter(jpipeline.TokenPipeline(**kw)))["tokens"])


def test_sasrec_batches_are_byte_identical():
    want = jpipeline.sasrec_batches(5_000, 50, 64, seed=0)
    got = pipeline.sasrec_batches(5_000, 50, 64, seed=0)
    for _ in range(3):
        w, g = next(want), next(got)
        for k in ("seqs", "pos", "neg"):
            _same(g[k], w[k])


def test_random_graph_and_triplets_are_byte_identical():
    for kw in (dict(with_positions=True), dict(with_positions=False)):
        want = jgraphs.random_graph(300, 1_200, 7, seed=4, **kw)
        got = graphs.random_graph(300, 1_200, 7, seed=4, **kw)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                _same(g, w)
    src, dst, _, _ = want
    for cap in (None, 500):
        _same(graphs.build_triplets(src, dst, 300, cap=cap),
              jgraphs.build_triplets(src, dst, 300, cap=cap))
    empty = np.array([0, 1], np.int32)
    _same(graphs.build_triplets(empty, empty + 2, 4), jgraphs.build_triplets(empty, empty + 2, 4))


def test_batch_molecules_and_graph_batch_equal_the_reference():
    want = jgraphs.batch_molecules(6, 10, 25, d_feat=5, seed=2)
    got = graphs.batch_molecules(6, 10, 25, d_feat=5, seed=2, device="cpu")
    assert got.n_graphs == want.n_graphs == 6
    for name in ("nodes", "edge_src", "edge_dst", "node_mask", "edge_mask", "positions",
                 "graph_ids", "triplets", "triplet_mask"):
        _same(getattr(got, name), getattr(want, name))
    assert got.edge_feat is None and want.edge_feat is None
    batch = pipeline.gnn_batch(got, np.ones((6, 1), np.float32))
    assert batch["graph"] is got and batch["target"].shape == (6, 1)


def test_neighbor_sampler_is_byte_identical():
    src, dst, _, _ = jgraphs.random_graph(400, 3_000, 2, seed=8)
    want = jgraphs.NeighborSampler.from_edges(src, dst, 400, fanouts=[5, 3], seed=1)
    got = graphs.NeighborSampler.from_edges(src, dst, 400, fanouts=[5, 3], seed=1)
    _same(got.indptr, want.indptr)
    _same(got.indices, want.indices)
    seeds = np.arange(0, 400, 37)
    w, g = want.sample(seeds), got.sample(seeds)
    for a, b in zip(g[:4], w[:4]):
        _same(a, b)
    assert g[4] == w[4]


def test_shapes_carry_the_reference_numbers():
    assert shapes.LM_SHAPES == {k: shapes.LMShape(**vars(v)) for k, v in
                                jshapes.LM_SHAPES.items()}
    assert shapes.GNN_SHAPES == {k: shapes.GNNShape(**vars(v)) for k, v in
                                 jshapes.GNN_SHAPES.items()}
    assert shapes.REC_SHAPES == {k: shapes.RecShape(**vars(v)) for k, v in
                                 jshapes.REC_SHAPES.items()}
    for name, shape in shapes.GNN_SHAPES.items():
        assert shapes.triplet_count(shape, 8) == jshapes.triplet_count(
            jshapes.GNN_SHAPES[name], 8)
