"""The port's measured crossover against the JAX package's.

Mirrors ``tests/test_kernels_autotune.py``, ``tests/test_crossover_golden.py``
and ``tests/test_dispatch_crossover.py``:

* every ``range_items`` candidate of the K1/K2 wrappers' plain mirror (what
  a CPU frontier runs) equals the JAX package's kernel output (Pallas in
  interpret mode) on integer frontiers, for the sum, min, max and the
  reverse direction;
* buckets, ``lookup``'s nearest-bucket tie rule and the canonical JSON
  round trip (and ``save_crossover_table`` / ``load_crossover_table``);
* under the same injected times, ``measure_crossover`` and
  ``to_device_packed(measure=True)`` record the JAX package's decisions —
  backend, times and the index of the winning candidate — and ``'auto'``
  dispatch then follows the table as the JAX package's does.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import condensed as ref_condensed
from repro.core import engine as ref_engine
from repro.core import semiring as ref_semiring
from repro.kernels import autotune as ref_autotune
from repro.kernels import ops as ref_ops

from repro_torch.core import condensed, dedup, engine, semiring, serialize
from repro_torch.data import synth
from repro_torch.kernels import ops
from repro_torch.kernels.autotune import (
    CANDIDATES,
    DEFAULT_CONFIG,
    CrossoverEntry,
    CrossoverTable,
    KernelConfig,
    autotune_spmm,
    batch_bucket,
    measure_crossover,
    src_bucket,
)

# (n_src, n_dst, edges): ragged tiles, and one spanning several ranges
SHAPES = [(300, 200, 1500), (513, 130, 2600)]
OPS = {"sum": "PLUS_TIMES", "min": "MIN_PLUS", "max": "MAX_TIMES"}


def _edges(n_src, n_dst, n_edges, seed):
    rng = np.random.default_rng(seed)
    key = rng.choice(n_src * n_dst, size=n_edges, replace=False)
    args = (key % n_src, key // n_src, n_src, n_dst)
    return condensed.BipartiteEdges(*args), ref_condensed.BipartiteEdges(*args)


_LAYERS = {}


def _layers(shape):
    if shape not in _LAYERS:
        e, re_ = _edges(*shape, seed=sum(shape))
        _LAYERS[shape] = (ops.PackedLayer.from_edges(e, device="cpu"),
                          ref_ops.PackedLayer.from_edges(re_))
    return _LAYERS[shape]


_REF_OUT = {}


def _ref_kernel(shape, op, batch, reverse):
    """The JAX package's kernel output (interpret mode), computed once."""
    key = (shape, op, batch, reverse)
    if key not in _REF_OUT:
        _, rl = _layers(shape)
        n_in = rl.n_dst if reverse else rl.n_src
        x = np.random.default_rng(batch).integers(0, 7, (n_in, batch)).astype(np.float32)
        y = ref_ops.bitmap_spmm(rl, jnp.asarray(x), backend="pallas", interpret=True,
                                semiring=getattr(ref_semiring, OPS[op]), reverse=reverse)
        _REF_OUT[key] = (x, np.asarray(y))
    return _REF_OUT[key]


@pytest.mark.parametrize("config", CANDIDATES, ids=lambda c: f"items{c.range_items}")
@pytest.mark.parametrize("case", [
    (SHAPES[0], "sum", 1, False), (SHAPES[0], "sum", 32, False),
    (SHAPES[1], "sum", 32, False), (SHAPES[0], "min", 32, False),
    (SHAPES[0], "max", 32, False), (SHAPES[1], "sum", 32, True),
], ids=["sum_b1", "sum_b32", "sum_tall", "min", "max", "reverse"])
def test_candidate_parity_with_reference_kernel(config, case):
    shape, op, batch, reverse = case
    layer, _ = _layers(shape)
    x, want = _ref_kernel(shape, op, batch, reverse)
    got = ops.bitmap_spmm(layer, torch.from_numpy(x), backend="cuda",
                          semiring=getattr(semiring, OPS[op]), reverse=reverse,
                          config=config)
    assert np.array_equal(got.numpy(), want)


def test_kernel_config_and_buckets():
    for bad in (0, -64, 1.5):
        with pytest.raises(ValueError, match="range_items"):
            KernelConfig(bad)
    assert KernelConfig() == DEFAULT_CONFIG and DEFAULT_CONFIG.range_items is None
    assert [c.range_items for c in CANDIDATES] == [64, 128, 256, 512]
    for n in (1, 2, 128, 129, 200, 2**14, 3000, 300_000):
        assert src_bucket(n) == ref_autotune.src_bucket(n)
        assert batch_bucket(n) == ref_autotune.batch_bucket(n)


def _tables(cells):
    """The same cells as a port table and a JAX-package table."""
    port = CrossoverTable.from_entries({k: CrossoverEntry(c, s) for k, (c, s) in cells.items()})
    ref = ref_autotune.CrossoverTable.from_entries(
        {k: ref_autotune.CrossoverEntry(c, s) for k, (c, s) in cells.items()})
    return port, ref


BACKEND = {"pallas": "cuda", "xla": "segment", None: None}


def test_lookup_nearest_bucket_and_ties_match_reference():
    cells = {("sum", 10, 6): (103.0, 57.0), ("sum", 15, 6): (10.0, 1739.0),
             ("sum", 12, 4): (5.0, 6.0), ("sum", 12, 8): (7.0, 6.0),
             ("min", 9, 3): (1.0, 2.0)}
    port, ref = _tables(cells)
    for op in ("sum", "min", "max"):
        for n_src in (1, 300, 1024, 3000, 4096, 20480, 300_000):
            for b in (1, 8, 16, 64, 100, 256, 4096):
                assert port.decide(op, n_src, b) == BACKEND[ref.decide(op, n_src, b)]
                got, want = port.lookup(op, n_src, b), ref.lookup(op, n_src, b)
                assert (got is None) == (want is None)
                if got is not None:
                    assert (got.cuda_us, got.segment_us) == (want.pallas_us, want.xla_us)


def _scripted(cells, n_candidates):
    """A time_fn replaying per-cell scripts: the candidates' times (a
    reference candidate the port lacks is never fastest) then the segment
    path's."""
    seq = []
    for cand, seg in cells:
        seq += list(cand)[:n_candidates] + [1e9] * (n_candidates - len(cand)) + [seg]
    it = iter(seq)
    return lambda fn: next(it)


# per (op, batch) cell in measurement order: candidate times, segment time;
# every selection rule once: last candidate wins, a segment win, a tie
# broken by the smaller candidate, a kernel-on-equal tie
SCRIPT = [((5.0, 4.0, 3.0, 2.0), 10.0), ((1.0, 2.0, 3.0, 4.0), 0.5),
          ((3.0, 1.0, 4.0, 1.0), 9.0), ((2.0, 2.0, 2.0, 2.0), 2.0)]
GOLDEN = {  # key: (backend, range_items, cuda_us, segment_us); n_src 300 -> bucket 9
    ("sum", 9, 3): ("cuda", 512, 2.0e6, 10.0e6),
    ("sum", 9, 6): ("segment", 64, 1.0e6, 0.5e6),
    ("min", 9, 3): ("cuda", 128, 1.0e6, 9.0e6),
    ("min", 9, 6): ("cuda", 64, 2.0e6, 2.0e6),
}


def _index(entry):
    """Index of the winning candidate in its package's CANDIDATES."""
    if isinstance(entry, CrossoverEntry):
        return [c.range_items for c in CANDIDATES].index(entry.range_items)
    return list(ref_autotune.CANDIDATES).index(entry.config)


def _same_decisions(port, ref):
    assert [k for k, _ in port.entries] == [k for k, _ in ref.entries]
    for (_, p), (_, r) in zip(port.entries, ref.entries):
        assert p.backend == BACKEND[r.backend]
        assert (p.cuda_us, p.segment_us) == (r.pallas_us, r.xla_us)
        assert _index(p) == _index(r)


def test_scripted_measurement_golden_and_equal_to_reference(tmp_path):
    layer, ref_layer = _layers(SHAPES[0])
    kw = dict(ops=("sum", "min"), batch_sizes=(8, 64))
    table = measure_crossover(layer, time_fn=_scripted(SCRIPT, 4), **kw)
    ref_table = ref_autotune.measure_crossover(ref_layer, time_fn=_scripted(SCRIPT, 5), **kw)
    _same_decisions(table, ref_table)
    for key, e in table.entries:
        assert (e.backend, e.range_items, e.cuda_us, e.segment_us) == GOLDEN[key]
    # canonical JSON, stable under a round trip and through serialize
    text = table.to_json()
    again = CrossoverTable.from_json(text)
    assert again == table and again.to_json() == text
    path = serialize.save_crossover_table(table, str(tmp_path / "crossover.json"))
    assert serialize.load_crossover_table(path) == table
    want = ref_table.to_json().replace('"pallas_us"', '"cuda_us"').replace(
        '"xla_us"', '"segment_us"')
    assert _cells(text) == _cells(want)
    with pytest.raises(ValueError, match="version"):
        CrossoverTable.from_json('{"version": 2, "cells": []}')


def _cells(text):
    """(op, buckets, times) of every cell of a table's JSON, in order."""
    import json

    return [(c["op"], c["src_bucket"], c["batch_bucket"], c["cuda_us"], c["segment_us"])
            for c in json.loads(text)["cells"]]


def test_autotune_picks_fastest_deterministically():
    layer, _ = _layers(SHAPES[0])
    calls = []

    def ascending(fn):
        calls.append(fn)
        return float(len(calls))

    best, timings = autotune_spmm(layer, 32, time_fn=ascending)
    assert best == CANDIDATES[0] and set(timings) == set(CANDIDATES)
    calls.clear()

    def descending(fn):
        calls.append(fn)
        return float(len(CANDIDATES) - len(calls) + 1)

    best, _ = autotune_spmm(layer, 32, time_fn=descending)
    assert best == CANDIDATES[-1]
    # the default timer runs every candidate on the CPU layer (its mirror)
    best, timings = autotune_spmm(layer, 4)
    assert best in CANDIDATES and all(t > 0 for t in timings.values())


def _graphs():
    """A C-DUP counts graph (no correction, no repeated edges) in both
    packages, for measured packing."""
    from repro.core.extract import extract as ref_extract
    from repro.data import synth as ref_synth
    from repro_torch.core import extract

    q = """
    Nodes(ID, Name) :- Author(ID, Name).
    Edges(ID1, ID2) :- AuthorPub(ID1, PubID), AuthorPub(ID2, PubID).
    """
    make = lambda m: m.dblp_catalog(200, 300, 5.0, seed=6)  # noqa: E731
    return extract(make(synth), q).graph, ref_extract(make(ref_synth), q).graph


def test_measured_packing_records_the_reference_tables():
    g, rg = _graphs()
    # per direction (forward then reverse, layer by layer): (sum, B=8), (sum, B=64)
    n_dirs = 2 * len(g.chains[0].edges)
    mk = dict(ops=("sum",), batch_sizes=(8, 64))
    dev = engine.to_device_packed(
        g, drop_self_loops=False, measure=True, device="cpu",
        measure_kwargs=dict(mk, time_fn=_scripted(SCRIPT[:2] * n_dirs, 4)))
    ref = ref_engine.to_device_packed(
        rg, drop_self_loops=False, measure=True,
        measure_kwargs=dict(mk, time_fn=_scripted(SCRIPT[:2] * n_dirs, 5)))
    for layer, rlayer in zip(dev.chains[0], ref.chains[0]):
        _same_decisions(layer.fwd.crossover, rlayer.fwd.crossover)
        _same_decisions(layer.rev.crossover, rlayer.rev.crossover)
    # 'auto' follows the table as the JAX package's does: B = 8 is a
    # measured kernel cell (dispatches on the CPU frontier too), B = 64 a
    # segment cell (never dispatches)
    for b in (8, 64):
        x = np.random.default_rng(b).integers(0, 4, (g.n_real, b)).astype(np.float32)
        engine.reset_kernel_dispatch_count()
        ref_engine.reset_kernel_dispatch_count()
        for reverse in (False, True):
            got = engine.propagate(dev, torch.from_numpy(x), reverse=reverse,
                                   allow_duplicates=True)
            want = ref_engine.propagate(ref, jnp.asarray(x), reverse=reverse,
                                        allow_duplicates=True)
            assert np.array_equal(got.numpy(), np.asarray(want))
        assert engine.KERNEL_DISPATCH_COUNT == ref_engine.KERNEL_DISPATCH_COUNT
        assert (engine.KERNEL_DISPATCH_COUNT > 0) == (b == 8)


def _inject(packed, table):
    chains = tuple(
        tuple(dataclasses.replace(layer, fwd=dataclasses.replace(layer.fwd, crossover=table),
                                  rev=dataclasses.replace(layer.rev, crossover=table))
              for layer in chain)
        for chain in packed.chains)
    fused = {k: (None if getattr(packed, k) is None
                 else dataclasses.replace(getattr(packed, k), crossover=table))
             for k in ("fused_fwd", "fused_rev")}
    return dataclasses.replace(packed, chains=chains, **fused)


@pytest.mark.parametrize("verdict", ["segment", "cuda"])
def test_engine_auto_follows_an_injected_table(verdict):
    g, _ = _graphs()
    packed = engine.to_device_packed(g, correction=dedup.build_correction(g), device="cpu")
    times = (5000.0, 10.0) if verdict == "segment" else (10.0, 5000.0)
    table = CrossoverTable.from_entries({
        (op, src_bucket(g.n_real), batch_bucket(8)): CrossoverEntry(*times, 128)
        for op in ("sum", "min")})
    measured = _inject(packed, table)
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 5, (g.n_real, 8)).astype(
        np.float32))
    want = engine.propagate(engine.to_device(g, correction=dedup.build_correction(g),
                                             device="cpu"), x)
    for sr in (semiring.PLUS_TIMES, semiring.MIN_PLUS):
        engine.reset_kernel_dispatch_count()
        got = engine.propagate(measured, x, sr)
        assert (engine.KERNEL_DISPATCH_COUNT > 0) == (verdict == "cuda")
        if sr is semiring.PLUS_TIMES:
            assert torch.equal(got, want)
            assert engine.KERNEL_STANDDOWN_COUNT == (
                {"measured_segment": 1} if verdict == "segment" else {})
    # without a table, 'auto' off the card takes the segment path
    engine.reset_kernel_dispatch_count()
    engine.propagate(packed, x)
    assert engine.KERNEL_DISPATCH_COUNT == 0
    # an unmeasured op leaves the rule unchanged
    engine.reset_kernel_dispatch_count()
    engine.propagate(measured, x, semiring.MAX_TIMES)
    assert engine.KERNEL_DISPATCH_COUNT == 0


def test_packed_layer_measure_and_resolve_backend():
    e, _ = _edges(260, 180, 900, seed=2)
    layer = ops.PackedLayer.from_edges(e, measure=True, measure_batch_sizes=(8, 64),
                                       device="cpu")
    assert len(layer.crossover) == 2
    for (op, sb, bb), entry in layer.crossover.entries:
        assert layer.crossover.decide(op, 2 ** sb, 2 ** bb) == entry.backend
        x = torch.zeros(260, 2 ** bb)
        assert ops.resolve_backend("auto", x, table=layer.crossover, n_src=260) == entry.backend
        assert ops.resolve_backend("segment", x, table=layer.crossover, n_src=260) == "segment"
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 5, (260, 8)).astype(np.float32))
    assert torch.equal(ops.bitmap_spmm(layer, x), ops.bitmap_spmm(layer, x, backend="segment"))
