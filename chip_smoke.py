#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # the full run: DBLP 50K authors / 100K pubs
    python3 chip_smoke.py --quick    # a first check of changed kernels (~1 min)

Phases, each of which fails the run (non-zero exit, no result line):

1. Setup: build every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once) and print the card's name and
   power limit.
2. Small input: a small DBLP graph served through the kernels agrees with
   NumPy dense-expansion oracles (BFS and common neighbors exactly,
   personalized PageRank to float32 round-off).
3. Main path: ``dblp_catalog(mean_authors_per_pub=6.0)`` -> ``extract`` ->
   ``GraphQueryServer.from_condensed(packed=True)`` with ``'auto'``
   dispatch (the upload builds every row index on the card: its builds
   are counted, and all of them are run and timed once more against the
   uploaded bytes, ``stages.index_build_s``), ``run`` of 32 ``bfs`` + 32
   ``ppr`` + 32 ``common_neighbors`` queries and one ``reachable_multi``
   batch of 32.  Launch counts are zeroed just before and read just
   after; every kernel must have launched (at the full size exactly
   ``FULL_LAUNCHES``), no ``'vmem_or_backend'`` stand-down may occur, and the
   answers must equal those of the same graphs served by the segment
   path on the card (PPR to ``rtol=1e-5, atol=1e-6``: the two paths add
   float32 values in different orders).
   One more run of the same batches under ``torch.profiler`` gives the
   device time by kernel and the card's idle share.
4. Kernels: at the main path's operands, K1-K3 against their plain
   PyTorch versions over the bitmaps (integer frontiers, byte-equal),
   twice on a float frontier (the same bits) and against the plain mirror
   of their arithmetic over the index; the index builder against its plain
   version (byte-equal).  Each with its time, the plain version's time, a
   bound (the larger of the bytes these inputs need at 3.35 TB/s and the
   float32 operations at 67 TFLOP/s; ``layout_bound_ms`` counts every
   bitmap byte instead, the earlier design's reads) and, for K1 and K3,
   one ``torch.sparse.mm`` call on a CSR of the same function.
5. LM serving: K4 against its plain version on small and cache-path
   shapes (the main path's prefill and decode among them) in float32 to
   2e-5 and bf16 to 0.05; glm4-9b at full width in bf16 with random
   weights serves 16 requests (8 x 4096 + 8 x 1024 prompt tokens, 32 new
   each) on 8 slots, with K4 launched at every attention call and the
   plain attention never: the tensor-core prefill kernel n_layers x
   prefills times, the split-KV decode kernel and its combine n_layers x
   decode steps times each, the float32 kernel never; the last-position
   logits of one prefill through K4 and through the plain attention
   agree; a profiled prefill and decode step; K4's rows at the prefill
   and decode shapes, held to the plain version element by element in
   bf16, the decode row timed over four distinct caches in turn (cold
   L2) with its warm time logged beside; the count of tensor-core
   instructions in the bf16 kernels' SASS where ``cuobjdump`` exists.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  A copy of the measurements goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

QUERY = """
Nodes(ID, Name) :- Author(ID, Name).
Edges(ID1, ID2) :- AuthorPub(ID1, PubID), AuthorPub(ID2, PubID).
"""

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
TPU_KERNEL = "src/repro/kernels/bitmap_spmm.py"
# (authors, pubs, batch) of the full run, and the graph kernels' launches in
# its served run: K1 at PPR's first layer and common neighbours, K2 min at
# BFS, K2 max at reachable_multi, K3 at PPR's last layer
FULL_GRAPH = (50_000, 100_000, 32)
INDEX_FIELDS = ("row_ptr", "col", "weight")
FULL_LAUNCHES = {"bitmap_spmm_sum": 22, "bitmap_spmm_min": 10, "bitmap_spmm_max": 10,
                 "bitmap_spmm_fused": 20}
CSRC = "src/repro_torch/kernels/csrc"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


# device-side spin (clock cycles, ~0.1 s on an H100) that holds the stream
# while the host enqueues a timed run
HOLD_CYCLES = 200_000_000


def time_device_and_host(fn, reps: int, warmup: int = 2):
    """``(device ms, host ms)`` per call of ``fn``.  The ``reps`` calls are
    queued behind a device-side spin (``torch.cuda._sleep``), so the CUDA
    events around them time the card's work and not the host's launch
    rate: a call whose host cost exceeds its device time (K4's decode) is
    otherwise timed at the host's pace.  The host ms is the enqueue time;
    if it outlasts the spin, the queue ran dry and the device time includes
    host gaps, which is logged."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    held, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    held.record()
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t) * 1e3
    end.record()
    torch.cuda.synchronize()
    if host_ms > held.elapsed_time(start):
        log(f"  (timing: the host took {host_ms:.1f} ms to enqueue {reps} calls, longer "
            f"than the {held.elapsed_time(start):.1f} ms hold: device time includes host gaps)")
    return start.elapsed_time(end) / reps, host_ms / reps


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    return time_device_and_host(fn, reps, warmup)[0]


# ---------------------------------------------------------------------------
# Phase 2: small input against NumPy dense oracles
# ---------------------------------------------------------------------------

def small_input_check(seed: int) -> None:
    import numpy as np

    from repro_torch.core import extract
    from repro_torch.data.synth import dblp_catalog
    from repro_torch.serve.server import GraphQuery, GraphQueryServer

    g = extract(dblp_catalog(400, 700, 6.0, seed=seed), QUERY).graph
    n = g.n_real
    s, d, m = g.multiplicities()
    mult = np.zeros((n, n), dtype=np.float64)
    np.add.at(mult, (s, d), m)
    adj = (mult > 0).astype(np.float64)
    np.fill_diagonal(adj, 0.0)
    server = GraphQueryServer.from_condensed(g, packed=True, device="cuda")
    nodes = [int(v) for v in np.random.default_rng(seed).integers(0, n, 8)]
    kinds = ("bfs", "ppr", "common_neighbors")
    queries = [GraphQuery(i * 3 + k, kind, v)
               for i, v in enumerate(nodes) for k, kind in enumerate(kinds)]
    got = server.run(queries)
    deg = adj.sum(axis=1)
    for i, v in enumerate(nodes):
        dist = np.full(n, np.inf)
        dist[v] = 0.0
        frontier = np.zeros(n, dtype=bool)
        frontier[v] = True
        hop = 0
        while frontier.any():
            hop += 1
            nxt = (adj[frontier].sum(axis=0) > 0) & np.isinf(dist)
            dist[nxt] = hop
            frontier = nxt
        seeds = np.zeros(n)
        seeds[v] = 1.0
        x = seeds.copy()
        for _ in range(server.ppr_iters):
            contrib = np.where(deg > 0, x / np.maximum(deg, 1.0), 0.0)
            y = adj.T @ contrib + np.where(deg > 0, 0.0, x).sum() * seeds
            x = (1 - server.damping) * seeds + server.damping * y
        if not np.array_equal(got[i * 3], dist):
            raise AssertionError(f"small input: bfs from {v} disagrees with the oracle")
        if not np.allclose(got[i * 3 + 1], x, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"small input: ppr from {v} disagrees with the oracle")
        if not np.array_equal(got[i * 3 + 2], mult[v]):
            raise AssertionError(
                f"small input: common_neighbors of {v} disagrees with the oracle"
            )
    log(f"small input: {len(queries)} answers equal the dense oracles (n={n})")


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

def serve_queries(server, nodes, reach_nodes):
    from repro_torch.core import algorithms
    from repro_torch.serve.server import GraphQuery

    queries = []
    for kind in ("bfs", "ppr", "common_neighbors"):
        for v in nodes:
            queries.append(GraphQuery(len(queries), kind, int(v)))
    answers, stats = server.run(queries, with_stats=True)
    reach = algorithms.reachable_multi(server.graph, reach_nodes).cpu().numpy()
    return queries, answers, reach, stats


def compare_answers(queries, got, ref, reach, reach_ref) -> None:
    import numpy as np

    for q in queries:
        a, b = got[q.qid], ref[q.qid]
        if q.kind == "ppr":
            ok = np.allclose(a, b, rtol=1e-5, atol=1e-6) and np.isfinite(a).all()
        else:
            ok = np.array_equal(a, b)
        if not ok:
            raise AssertionError(f"{q.kind} query {q.qid}: kernel path != segment path")
    if not np.array_equal(reach, reach_ref):
        raise AssertionError("reachable_multi: kernel path != segment path")


def profile_serve(server, nodes, reach_nodes):
    """Device time by kernel over one more run of the served batches:
    the wall time, the summed kernel time and the share of the wall time
    the card sat idle.  Launches made here do not count as the main
    path's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import bitmap_spmm as K

    before = dict(K.LAUNCHES)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        serve_queries(server, nodes, reach_nodes)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    K.LAUNCHES.update(before)
    by_kernel, calls = {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 1e6
        calls[e.key] = calls.get(e.key, 0) + e.count
    busy_s = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    # device launches of the graph kernels, by kind (the names' prefixes)
    graph = {kind: sum(n for key, n in calls.items() if key.startswith(f"void bitmap_spmm::{kind}<"))
             for kind in ("spmm_kernel", "carry_kernel", "fused_kernel", "fused_carry_kernel")}
    return {
        "wall_s": wall_s,
        "device_busy_s": busy_s if by_kernel else None,
        "idle_share": 1.0 - busy_s / wall_s if by_kernel else None,
        "top_kernels_s": dict(top),
        "graph_kernel_launches": graph,
        "bitmap_kernels_s": sum(t for key, t in by_kernel.items() if "bitmap_spmm::" in key),
        "memcpy_dtoh_s": sum(t for key, t in by_kernel.items() if "DtoH" in key),
    }


# ---------------------------------------------------------------------------
# Phase 4: kernels against their plain versions
# ---------------------------------------------------------------------------

def set_bits(words) -> int:
    import torch

    flat = words.reshape(-1)
    vals = flat[flat != 0].to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, device=words.device, dtype=torch.int64)
    return int(((vals[:, None] >> shifts) & 1).sum().item())


def popcounts(words):
    """Set bits of each 32-bit word (an int32 tensor), as int64."""
    import torch

    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def plane_skew(fused):
    """How K3's correction bits are spread: the most set bits in one 2 KiB
    plane, and the plane bits of the heaviest output row tile against all
    of them (per-unit counts in chunks, so no large temporaries)."""
    import torch

    n_corr, n_planes = int(fused.planes.shape[0]), int(fused.planes.shape[1])
    units = fused.planes.reshape(n_corr * n_planes, -1)
    bits = torch.cat([popcounts(units[i:i + 65536]).sum(dim=1)
                      for i in range(0, units.shape[0], 65536)])
    corr = fused.kind == 1
    tile_of = torch.empty(n_corr, dtype=torch.int64, device=bits.device)
    tile_of[fused.corr_idx[corr].to(torch.int64)] = fused.slot_row[corr].to(torch.int64)
    n_rt = int(fused.row_start.shape[0])
    per_tile = torch.zeros(n_rt, dtype=torch.int64, device=bits.device).index_add_(
        0, tile_of.repeat_interleave(n_planes), bits)
    return {"max_bits_per_plane": int(bits.max().item()),
            "top_row_tile_plane_bits": int(per_tile.max().item()),
            "row_tiles": n_rt}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def index_bytes(graph) -> int:
    """Device bytes of a packed graph's row indices."""
    return sum(nbytes(*(getattr(ops, k) for k in INDEX_FIELDS if hasattr(ops, k)))
               for ops in all_operands(graph))


def all_operands(graph):
    """Every PackedOperands and FusedOperands of a packed graph."""
    layers = [layer for chain in graph.chains for layer in chain]
    if graph.direct is not None:
        layers.append(graph.direct)
    out = [ops for layer in layers for ops in (layer.fwd, layer.rev) if ops is not None]
    return out + [f for f in (graph.fused_fwd, graph.fused_rev) if f is not None]


def rebuild_indices(graphs) -> float:
    """Seconds to build every row index of ``graphs`` again on the card (the
    upload-time work), each rebuild held to the uploaded bytes."""
    import torch

    from repro_torch.core import engine
    from repro_torch.kernels import bitmap_index as BI

    before = dict(BI.INDEX_BUILDS)
    torch.cuda.synchronize()
    t = time.perf_counter()
    rebuilt = []
    for graph in graphs:
        for ops in all_operands(graph):
            if isinstance(ops, engine.FusedOperands):
                tables = [getattr(ops, k) for k in engine.FUSED_TABLES]
                rebuilt.append((ops, BI.bitmap_index_fused(*tables, ops.plane_weights)))
            else:
                tables = [getattr(ops, k) for k in engine.PACKED_TABLES]
                rebuilt.append((ops, BI.bitmap_index(*tables)))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    BI.INDEX_BUILDS.update(before)
    for ops, index in rebuilt:
        if not all(torch.equal(getattr(ops, k), v) for k, v in zip(INDEX_FIELDS, index)):
            raise AssertionError("a rebuilt row index differs from the uploaded one")
    return seconds


def bound(n_bytes: int, n_ops: int):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_repeats(name, fn) -> None:
    """Two launches on a float frontier give the same bits."""
    import torch

    first = fn()
    if not torch.equal(first, fn()):
        raise AssertionError(f"{name}: two launches on a float frontier differ")


def spmm_row(name, source, line, launches, y, y_plain, ms, plain_ms, need, layout,
             library_ms, mirror_err, shape) -> dict:
    b_ms, b_by = bound(*need)
    return {
        "name": name, "route": "cuda", "source": f"{CSRC}/{source}",
        "replaces": f"{TPU_KERNEL}:{line}", "launches": launches,
        "max_abs_err": float((y - y_plain).abs().nan_to_num(0.0).max().item()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "layout_bound_ms": bound(*layout)[0], "library_ms": library_ms,
        "shape": {**shape, "float_repeat_bit_identical": True,
                  "float_vs_mirror_max_abs_err": mirror_err},
    }


def kernel_rows(graph, launches, reps: int, seed: int):
    """K1, K2 and K3 at the main path's operands (F = 32) against their plain
    versions over the bitmaps, exactly on integer frontiers; on a float
    frontier twice (same bits) and against the plain mirror of their
    arithmetic.  ``bound_ms`` counts the bytes these inputs need (the
    index, each source and output row once); ``layout_bound_ms`` every
    bitmap byte the earlier design read."""
    import numpy as np
    import torch

    from repro_torch.kernels import bitmap_spmm as K

    rng = np.random.default_rng(seed)
    layer = graph.chains[0][0]          # author -> pub: ppr's and bfs's first layer
    ops = layer.fwd
    n_src, n_out = layer.n_src, layer.n_dst
    feat = 32
    ints = torch.from_numpy(rng.integers(0, 7, (n_src, feat)).astype(np.float32)).cuda()
    with_inf = ints.clone()
    with_inf[torch.from_numpy(rng.random((n_src, feat)) < 0.5).cuda()] = float("inf")
    zero_one = (ints > 3).to(torch.float32)
    floats = torch.from_numpy(rng.random((n_src, feat)).astype(np.float32)).cuda()
    nnz = int(ops.row_ptr[n_out].item())
    index = (ops.row_ptr[: n_out + 1], ops.col)
    rows = []
    cases = [("sum", ints, 0.0), ("min", with_inf, float("inf")), ("max", zero_one, 0.0)]
    for op, x, zero in cases:
        idx_args = (ops.row_ptr, ops.col)
        plain_args = (ops.slot_src, ops.slot_row, ops.row_start, ops.row_count, ops.bitmaps)
        before = dict(K.LAUNCHES)
        y = K.bitmap_spmm(*idx_args, x, n_out, op=op, zero=zero)
        y_plain = K.bitmap_spmm_plain(*plain_args, x, n_out, op=op, zero=zero)
        torch.cuda.synchronize()
        if not torch.equal(y, y_plain):
            raise AssertionError(f"bitmap_spmm {op}: kernel != plain version")
        check_repeats(f"bitmap_spmm {op}",
                      lambda: K.bitmap_spmm(*idx_args, floats, n_out, op=op, zero=zero))
        mirror_err = float((K.bitmap_spmm(*idx_args, floats, n_out, op=op, zero=zero)
                            - K.bitmap_spmm_index_plain(*idx_args, floats, n_out, op=op,
                                                        zero=zero)).abs().max().item())
        ms = time_ms(lambda: K.bitmap_spmm(*idx_args, x, n_out, op=op, zero=zero), reps)
        plain_ms = time_ms(lambda: K.bitmap_spmm_plain(*plain_args, x, n_out, op=op, zero=zero),
                           3, 1)
        K.LAUNCHES.update(before)  # comparison launches are not main-path launches
        library_ms = None
        if op == "sum":
            csr = torch.sparse_coo_tensor(
                torch.stack([layer.dst, layer.src]),
                torch.ones(layer.src.shape[0], device=x.device),
                (n_out, n_src),
            ).coalesce().to_sparse_csr()
            library_ms = time_ms(lambda: torch.sparse.mm(csr, x), reps)
        rows.append(spmm_row(
            f"bitmap_spmm_{op}", "bitmap_spmm.cu", 77, launches[f"bitmap_spmm_{op}"], y,
            y_plain, ms, plain_ms, (nbytes(*index, x, y), nnz * feat),
            (nbytes(*plain_args, x, y), nnz * feat), library_ms, mirror_err,
            {"n_src": n_src, "n_out": n_out, "features": feat,
             "slots": int(ops.slot_src.shape[0]), "entries": nnz}))
    fused = graph.fused_fwd
    n_h = graph.chains[-1][-1].n_src
    h = torch.from_numpy(rng.integers(0, 7, (n_h, feat)).astype(np.float32)).cuda()
    xr = torch.from_numpy(rng.integers(0, 7, (graph.n_real, feat)).astype(np.float32)).cuda()
    hf = torch.from_numpy(rng.random((n_h, feat)).astype(np.float32)).cuda()
    xf = torch.from_numpy(rng.random((graph.n_real, feat)).astype(np.float32)).cuda()
    f_idx = (fused.row_ptr, fused.col, fused.weight)
    f_plain = (fused.kind, fused.main_src, fused.corr_src, fused.main_idx, fused.corr_idx,
               fused.slot_row, fused.row_start, fused.row_count, fused.bitmaps, fused.planes)
    before = dict(K.LAUNCHES)
    y = K.bitmap_spmm_fused(*f_idx, h, xr, fused.n_out)
    y_plain = K.bitmap_spmm_fused_plain(*f_plain, h, xr, fused.n_out, fused.plane_weights)
    torch.cuda.synchronize()
    if not torch.equal(y, y_plain):
        raise AssertionError("bitmap_spmm_fused: kernel != plain version")
    check_repeats("bitmap_spmm_fused", lambda: K.bitmap_spmm_fused(*f_idx, hf, xf, fused.n_out))
    mirror_err = float((K.bitmap_spmm_fused(*f_idx, hf, xf, fused.n_out)
                        - K.bitmap_spmm_fused_index_plain(*f_idx, hf, xf, fused.n_out))
                       .abs().max().item())
    ms = time_ms(lambda: K.bitmap_spmm_fused(*f_idx, h, xr, fused.n_out), reps)
    plain_ms = time_ms(lambda: K.bitmap_spmm_fused_plain(*f_plain, h, xr, fused.n_out,
                                                         fused.plane_weights), 3, 1)
    K.LAUNCHES.update(before)
    # library: one torch.sparse.mm of the CSR [B | -D] (the last layer's
    # incidence beside the weighted correction) against the stacked [h; x]
    last = graph.chains[-1][-1]
    cs, cd, cm = graph.correction
    k3_csr = torch.sparse_coo_tensor(
        torch.stack([torch.cat([last.dst, cd]), torch.cat([last.src, n_h + cs])]),
        torch.cat([torch.ones(last.src.shape[0], device=xr.device), -cm]),
        (fused.n_out, n_h + graph.n_real),
    ).coalesce().to_sparse_csr()
    stacked = torch.cat([h, xr])
    y_lib = torch.sparse.mm(k3_csr, stacked)
    torch.cuda.synchronize()
    if not torch.equal(y_lib, y_plain):
        raise AssertionError("K3's library call computes another function")
    k3_library_ms = time_ms(lambda: torch.sparse.mm(k3_csr, stacked), reps)
    del k3_csr, stacked, y_lib
    n_planes = int(fused.planes.shape[1])
    n_corr = int(fused.planes.shape[0])
    f_nnz = int(fused.row_ptr[fused.n_out].item())
    corr_entries = int((fused.weight != 0).sum().item())
    main_bits, corr_bits = f_nnz - corr_entries, set_bits(fused.planes)
    # one add per main entry, a multiply and an add per correction entry,
    # one subtract per output
    f_ops = feat * (main_bits + 2 * corr_entries + fused.n_out)
    need = nbytes(fused.row_ptr[: fused.n_out + 1], *f_idx[1:], h, xr, y)
    layout = nbytes(*f_plain[:5], f_plain[6], f_plain[7], fused.bitmaps, fused.planes, h, xr, y)
    rows.append(spmm_row(
        "bitmap_spmm_fused", "bitmap_spmm_fused.cu", 190, launches["bitmap_spmm_fused"], y,
        y_plain, ms, plain_ms, (need, f_ops), (layout, f_ops), k3_library_ms, mirror_err,
        {"n_h": n_h, "n_out": fused.n_out, "features": feat,
         "slots": int(fused.kind.shape[0]), "correction_slots": n_corr,
         "planes": n_planes, "main_entries": main_bits, "correction_entries": corr_entries,
         "plane_bits": corr_bits, **plane_skew(fused)}))
    return rows


def index_rows(graph, builds: dict, reps: int) -> list:
    """The upload-time index builder at the main path's operands (the
    author -> publication layer and the forward fused stream) against its
    plain version, byte for byte.  ``launches``: the builds the served
    graphs' upload made."""
    import torch

    from repro_torch.kernels import bitmap_index as BI

    ops, fused = graph.chains[0][0].fwd, graph.fused_fwd
    cases = [
        ("bitmap_index", 77, BI.bitmap_index, BI.bitmap_index_plain,
         (ops.slot_src, ops.slot_row, ops.row_start, ops.row_count, ops.bitmaps),
         (ops.row_ptr, ops.col)),
        ("bitmap_index_fused", 190, BI.bitmap_index_fused, BI.bitmap_index_fused_plain,
         (fused.kind, fused.main_src, fused.corr_src, fused.main_idx, fused.corr_idx,
          fused.slot_row, fused.row_start, fused.row_count, fused.bitmaps, fused.planes,
          fused.plane_weights),
         (fused.row_ptr, fused.col, fused.weight)),
    ]
    rows = []
    for name, line, fn, plain, args, uploaded in cases:
        before = dict(BI.INDEX_BUILDS)
        got, want = fn(*args), plain(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: kernel != plain version")
        if not all(torch.equal(a, b) for a, b in zip(got, uploaded)):
            raise AssertionError(f"{name}: a rebuild differs from the uploaded index")
        err = max(float((a.double() - b.double()).abs().max().item()) if a.numel() else 0.0
                  for a, b in zip(got, want))
        ms = time_ms(lambda: fn(*args), reps)
        plain_ms = time_ms(lambda: plain(*args), 2, 1)
        BI.INDEX_BUILDS.update(before)
        words = [t for t in args if isinstance(t, torch.Tensor)]
        b_ms, b_by = bound(nbytes(*words, *got), 0)
        rows.append({
            "name": name, "route": "cuda", "source": f"{CSRC}/bitmap_index.cu",
            "replaces": f"{TPU_KERNEL}:{line}", "launches": builds[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "layout_bound_ms": b_ms, "library_ms": None,
            "shape": {"entries": int(got[1].shape[0]), "rows": int(got[0].shape[0]) - 1,
                      "index_bytes": nbytes(*got)},
        })
    return rows


# ---------------------------------------------------------------------------
# Phase 5: LM serving (glm4-9b at full width) with K4
# ---------------------------------------------------------------------------

# (B, T, H, KV, D, causal): tests/test_kernels.py's FLASH_SWEEP
FLASH_SWEEP = [
    (1, 64, 2, 1, 8, True),
    (2, 128, 4, 2, 16, True),
    (1, 96, 4, 4, 8, False),
    (2, 100, 2, 1, 8, True),
    (1, 256, 8, 2, 32, True),
]
# (B, Tq, Tk, H, KV, D, causal, q_offset, kv_length): the cache path
FLASH_CACHE = [
    (1, 300, 4128, 32, 2, 128, True, 0, [300]),        # prefill into a longer cache
    (2, 64, 600, 32, 2, 128, True, 200, [264, 264]),   # prefill after a prefix
    (8, 1, 4128, 32, 2, 128, False, 0, [4097, 4100, 1, 0, 33, 4128, 2049, 77]),
    (1, 4096, 4128, 32, 2, 128, True, 0, [4096]),      # the main path's prefill
]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 0.05}   # tests/test_kernels.py:138
BF16_OPS_PER_S = 989e12                           # H100 SXM dense bf16
FLASH_TPU_KERNEL = "src/repro/kernels/flash_attention.py:34"
# last-position logits of a 4096-token prefill, K4 against the plain
# attention, both bf16 end to end: the max abs difference may be this
# share of the largest |logit| (40 layers of bf16 round-off apart)
LOGITS_RTOL = 0.05
# K4 in bf16 at the main path's shapes, element by element against the
# plain version: |got - want| <= K4_BF16_ATOL + K4_BF16_RTOL * |want|.
# RTOL is one bf16 unit in the last place of the output (both round it
# once); ATOL covers p rounded to bf16 against a different running max.
# A late row of a 4096-token prefill averages thousands of keys, so its
# outputs are a few hundredths: a dropped key tile hides under the 0.05 of
# FLASH_TOL, not under this bound.
K4_BF16_RTOL = 2.0 ** -7
K4_BF16_ATOL = 2e-3
# (long prompt, short prompt, new tokens) of the served LM run; --quick
# takes the second for a first check of a changed kernel (weights stay
# full width).  The cache holds the long prompt and its new tokens.
LM_FULL = (4096, 1024, 32)
# distinct decode-shape caches K4's decode row is timed over in turn: 4 x
# 33.8 MB at the full run's shape, well past the 50 MB L2
DECODE_CACHES = 4
LM_QUICK = (256, 64, 4)


def flash_small_check() -> dict:
    """K4 against its plain version on the sweep and the cache-path shapes,
    float32 (full-precision matmuls) and bf16.  Launch counts made here
    are restored: they are comparisons, not the main path's."""
    import torch

    from repro_torch.kernels import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")
    before = dict(FA.LAUNCHES), dict(FA.PLAIN_CUDA_CALLS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    cases = [(B, T, T, H, KV, D, c, 0, None) for B, T, H, KV, D, c in FLASH_SWEEP]
    for dname, tol in FLASH_TOL.items():
        dtype = getattr(torch, dname)
        for B, Tq, Tk, H, KV, D, causal, q_off, kv_len in cases + FLASH_CACHE:
            q = torch.randn((B, Tq, H, D), generator=gen, device="cuda").to(dtype)
            k = torch.randn((B, Tk, KV, D), generator=gen, device="cuda").to(dtype)
            v = torch.randn((B, Tk, KV, D), generator=gen, device="cuda").to(dtype)
            lengths = (None if kv_len is None
                       else torch.tensor(kv_len, dtype=torch.int32, device="cuda"))
            kw = dict(causal=causal, q_offset=q_off, kv_length=lengths)
            got = FA.flash_attention(q, k, v, **kw)
            want = FA.flash_attention_plain(q, k, v, **kw)
            err = float((got.float() - want.float()).abs().max().item())
            shape = (B, Tq, Tk, H, KV, D, causal, q_off)
            if not err < tol:
                raise AssertionError(f"K4 {dname} {shape}: max abs err {err} >= {tol}")
            worst[dname] = max(worst.get(dname, 0.0), err)
    FA.LAUNCHES.update(before[0])
    FA.PLAIN_CUDA_CALLS.update(before[1])
    log(f"K4 small check: {2 * len(cases + FLASH_CACHE)} cases within tolerance; "
        f"worst {json.dumps(worst)} (tolerances {json.dumps(FLASH_TOL)})")
    return worst


def lm_requests(cfg, seed: int, long_len: int, short_len: int, n_each: int, new_tokens: int):
    import numpy as np

    from repro_torch.serve.server import Request

    rng = np.random.default_rng(seed)
    lengths = [long_len] * n_each + [short_len] * n_each
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=n),
                    max_new_tokens=new_tokens) for i, n in enumerate(lengths)]


def device_time_by_kind(prof) -> dict:
    """Seconds of device time in K4, in matrix products (cuBLAS / CUTLASS
    kernels) and in everything else."""
    from torch.autograd import DeviceType

    out = {"k4_s": 0.0, "gemm_s": 0.0, "other_s": 0.0, "k4_by_kernel_s": {}}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = e.key.lower()
        if "flash_" in name:  # flash_prefill / flash_decode / flash_combine kernels
            kind = "k4_s"
        elif any(w in name for w in ("gemm", "nvjet", "cutlass", "xmma", "sm90_")):
            kind = "gemm_s"
        else:
            kind = "other_s"
        out[kind] += us / 1e6
        if kind == "k4_s":
            by = out["k4_by_kernel_s"]
            by[e.key] = by.get(e.key, 0.0) + us / 1e6
    return out


def profile_lm(server, requests) -> dict:
    """One profiled prefill (the first request) and, once every slot is
    full, one profiled decode step: wall time, device time by kind and the
    idle share.  Launches made here do not count as the main path's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as FA

    before = dict(FA.LAUNCHES)
    out = {}
    slots = len(server.slots)
    for phase in ("prefill", "decode"):
        if phase == "decode":
            for r in requests[1:slots]:
                server.admit(r)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            if phase == "prefill":
                server.admit(requests[0])
            else:
                server.step()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t
        kinds = device_time_by_kind(prof)
        busy = kinds["k4_s"] + kinds["gemm_s"] + kinds["other_s"]
        out[phase] = {"wall_s": wall_s, **kinds, "device_busy_s": busy,
                      "idle_share": 1.0 - busy / wall_s}
    FA.LAUNCHES.update(before)
    return out


def k4_row(name, source, q, caches, kw, pairs, launches, reps) -> dict:
    """K4 at one main-path shape: time, plain time, SDPA time, bound.
    ``caches`` holds distinct ``(k, v)`` pairs of one shape: K4 and SDPA
    are timed over them in turn, so that with more bytes than the 50 MB L2
    every call finds its keys and values cold, as the served run's
    attention does after reading a layer's weights; the warm time on the
    first pair alone is logged beside it.  ``pairs`` counts the (batch
    row, query, key) triples whose score the masks keep: the causal half
    for prefill, every valid key for decode."""
    import itertools

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA

    k, v = caches[0]
    before = dict(FA.LAUNCHES), dict(FA.PLAIN_CUDA_CALLS)
    got = FA.flash_attention(q, k, v, **kw)
    want = FA.flash_attention_plain(q, k, v, **kw)
    diff = (got.float() - want.float()).abs()
    err = float(diff.max().item())
    excess = float((diff - K4_BF16_RTOL * want.float().abs()).max().item())
    log(f"{name}: K4 against plain, max abs err {err}, largest |err| - "
        f"{K4_BF16_RTOL} |plain| {excess} (tolerance {K4_BF16_ATOL})")
    if not excess <= K4_BF16_ATOL:
        raise AssertionError(f"K4 {name}: |err| exceeds {K4_BF16_ATOL} + "
                             f"{K4_BF16_RTOL} |plain| by up to {excess - K4_BF16_ATOL}")

    def rotated(fn, pairs_):
        turn = itertools.count()
        return lambda: fn(*pairs_[next(turn) % len(pairs_)])

    attend = lambda k_, v_: FA.flash_attention(q, k_, v_, **kw)  # noqa: E731
    ms, host_ms = time_device_and_host(rotated(attend, caches), reps)
    warm_ms = time_ms(lambda: attend(k, v), reps)
    plain_ms = time_ms(lambda: FA.flash_attention_plain(q, k, v, **kw), 3, 1)
    FA.LAUNCHES.update(before[0])
    FA.PLAIN_CUDA_CALLS.update(before[1])
    B, Tq, H, D = q.shape
    n_valid = int(kw["kv_length"].max().item())
    # SDPA over the valid keys (every row of these shapes holds n_valid)
    qs = q.transpose(1, 2).contiguous()
    sdpa_caches = [(k_[:, :n_valid].transpose(1, 2).contiguous(),
                    v_[:, :n_valid].transpose(1, 2).contiguous()) for k_, v_ in caches]
    sdpa = lambda k_, v_: F.scaled_dot_product_attention(  # noqa: E731
        qs, k_, v_, is_causal=kw["causal"], enable_gqa=True)
    library_ms = time_ms(rotated(sdpa, sdpa_caches), reps)
    library_warm_ms = time_ms(lambda: sdpa(*sdpa_caches[0]), reps)
    del sdpa_caches
    kv_bytes = 2 * B * n_valid * k.shape[2] * D * k.element_size()
    n_bytes = 2 * nbytes(q) + kv_bytes
    n_ops = 4 * H * D * pairs
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / BF16_OPS_PER_S * 1e3
    b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    rotation = sum(nbytes(k_, v_) for k_, v_ in caches)
    log(f"{name}: K4 {ms:.4f} ms over {len(caches)} caches in turn ({rotation / 1e6:.1f} MB), "
        f"warm on one {warm_ms:.4f} ms, host {host_ms:.4f} ms a call; SDPA "
        f"{library_ms:.4f} ms in turn, warm {library_warm_ms:.4f} ms")
    return {
        "name": name, "route": "cuda", "source": f"{CSRC}/{source}",
        "replaces": FLASH_TPU_KERNEL, "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": library_ms,
        "shape": {"q": list(q.shape), "kv": list(k.shape), "kv_valid": n_valid,
                  "causal": kw["causal"], "q_offset": kw["q_offset"],
                  "dtype": str(q.dtype), "pairs": pairs, "bytes": n_bytes,
                  "flops": n_ops, "bf16_excess_over_rtol": excess,
                  "caches_in_turn": len(caches), "bytes_in_turn": rotation,
                  "warm_ms": warm_ms, "library_warm_ms": library_warm_ms,
                  "host_ms": host_ms},
    }


def k4_rows(T, max_len, H, KV, hd, launches, reps, seed) -> list:
    """K4's two rows at the served run's shapes: a causal prefill of ``T``
    tokens into a ``max_len`` cache, and a decode step of 8 slots over
    ``T + 4`` cached positions, timed over ``DECODE_CACHES`` distinct
    caches in turn.  ``launches``: the served run's per-kernel counts."""
    import torch

    from repro_torch.kernels import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    rows = [k4_row(
        "flash_attention_prefill", "flash_prefill.cu", randn(1, T, H, hd),
        [(randn(1, max_len, KV, hd), randn(1, max_len, KV, hd))],
        dict(causal=True, q_offset=0,
             kv_length=torch.full((1,), T, dtype=torch.int32, device="cuda")),
        T * (T + 1) // 2, launches["flash_attention_prefill"], reps)]
    kv = T + 4
    rows.append(k4_row(
        "flash_attention_decode", "flash_decode.cu", randn(8, 1, H, hd),
        [(randn(8, max_len, KV, hd), randn(8, max_len, KV, hd))
         for _ in range(DECODE_CACHES)],
        dict(causal=False, q_offset=kv - 1,
             kv_length=torch.full((8,), kv, dtype=torch.int32, device="cuda")),
        8 * kv, launches["flash_attention_decode"], reps))
    n_split, split_keys = FA.decode_split(
        max_len, 8 * KV * -(-(H // KV) // 16),
        torch.cuda.get_device_properties(0).multi_processor_count)
    rows[-1]["shape"].update(combine_launches=launches["flash_attention_combine"],
                             n_split=n_split, split_keys=split_keys,
                             decode_blocks=n_split * KV * 8)
    return rows


def graph_atomic_counts() -> dict:
    """Atomic and reduction instructions in the SASS of the graph SpMM
    libraries, where the toolkit has ``cuobjdump``: global ones (``ATOMG``,
    ``RED``) must be absent; the carry pass's one shared-memory integer
    ``ATOMS`` is counted beside them."""
    import re

    from repro_torch.kernels import build

    tool = cuobjdump()
    if tool is None:
        return {}
    counts = {}
    for name in ("bitmap_spmm", "bitmap_spmm_fused"):
        sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                              capture_output=True, text=True, check=True).stdout
        counts[name] = {op: len(re.findall(rf"\b{op}\.", sass))
                        for op in ("ATOMG", "RED", "REDG", "ATOM", "ATOMS")}
        if any(counts[name][op] for op in ("ATOMG", "RED", "REDG", "ATOM")):
            raise AssertionError(f"{name}: global atomics in the SASS: {counts[name]}")
    log(f"SASS atomics of the graph SpMMs: {json.dumps(counts)}")
    return counts


def cuobjdump():
    import shutil

    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = shutil.which("cuobjdump") or os.path.join(home, "bin", "cuobjdump")
    if not os.path.exists(tool):
        log("cuobjdump not found: no SASS instruction counts")
        return None
    return tool


def mma_instruction_counts() -> dict:
    """``HMMA`` / ``HGMMA`` instructions in the SASS of K4's bf16 libraries,
    where the toolkit has ``cuobjdump``; empty where it has none."""
    import re

    from repro_torch.kernels import build

    tool = cuobjdump()
    if tool is None:
        return {}
    counts = {}
    for name in ("flash_prefill", "flash_decode"):
        sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                              capture_output=True, text=True, check=True).stdout
        counts[name] = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HMMA", "HGMMA")}
    log(f"SASS tensor-core instructions: {json.dumps(counts)}")
    return counts


def lm_phase(args) -> dict:
    """glm4-9b (CONFIG: 40 layers, d_model 4096, vocab 151552) in bf16
    with random weights: 16 requests through ``BatchedServer.run`` on 8
    slots, counted K4 launches, the K4-vs-plain logits check, a profile
    and K4's rows."""
    import unittest.mock

    import numpy as np
    import torch

    from repro_torch.configs import glm4_9b
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer
    from repro_torch.serve.server import BatchedServer

    cfg = glm4_9b.CONFIG
    rec = {"config": {"name": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                      "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                      "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size, "dtype": cfg.dtype,
                      "n_params": cfg.n_params()}}
    rec["k4_small_worst_err"] = flash_small_check()

    t = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = transformer.init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t

    def leaves(tree):
        for v in tree.values():
            yield from leaves(v) if isinstance(v, dict) else (v,)

    rec["weight_bytes"] = nbytes(*leaves(params))
    log(f"glm4-9b: {cfg.n_params():,} parameters, {rec['weight_bytes'] / 1e9:.2f} GB of "
        f"bf16 weights, drawn in {rec['init_s']:.1f} s")

    long_len, short_len, new_tokens = LM_QUICK if args.quick else LM_FULL
    max_len, n_each = long_len + new_tokens, 8
    server = BatchedServer(params, cfg, batch_slots=8, max_len=max_len)
    requests = lm_requests(cfg, args.seed, long_len, short_len,
                           n_each, new_tokens)
    prefill_s = {long_len: [], short_len: []}
    step_s, step_len = [], []
    split = {"prefill": 0, "decode": 0}
    admit, step = server.admit, server.step

    def timed_admit(req):
        torch.cuda.synchronize()
        n0, t0 = FA.LAUNCHES["flash_attention"], time.perf_counter()
        ok = admit(req)
        torch.cuda.synchronize()
        prefill_s[int(req.prompt.size)].append(time.perf_counter() - t0)
        split["prefill"] += FA.LAUNCHES["flash_attention"] - n0
        return ok

    def timed_step():
        length = server._active_length()
        torch.cuda.synchronize()
        n0, t0 = FA.LAUNCHES["flash_attention"], time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        step_len.append(length)
        split["decode"] += FA.LAUNCHES["flash_attention"] - n0

    server.admit, server.step = timed_admit, timed_step

    # -- the run whose launches count ---------------------------------------
    FA.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = server.run(requests)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    launches = FA.LAUNCHES["flash_attention"]
    plain_calls = FA.PLAIN_CUDA_CALLS["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    server.admit, server.step = admit, step

    n_prefill = sum(len(v) for v in prefill_s.values())
    n_steps = len(step_s)
    log(f"served {len(out)} requests ({n_each} x {long_len} + {n_each} x "
        f"{short_len} prompt tokens, {new_tokens} new each) in {run_s:.2f} s: "
        f"{n_prefill} prefills, {n_steps} decode steps, {launches} K4 launches, "
        f"{plain_calls} plain attention calls on the card")
    if sorted(out) != list(range(2 * n_each)):
        raise AssertionError(f"served {sorted(out)}")
    for rid, toks in out.items():
        if len(toks) != new_tokens or not all(0 <= t_ < cfg.vocab_size for t_ in toks):
            raise AssertionError(f"request {rid}: {len(toks)} tokens {toks[:4]}...")
    if n_prefill != 2 * n_each or n_steps != 2 * (new_tokens - 1):
        raise AssertionError(f"{n_prefill} prefills / {n_steps} steps: deferral broke")
    if launches != cfg.n_layers * (n_prefill + n_steps):
        raise AssertionError(
            f"K4 launched {launches} times, not n_layers x (prefills + steps) = "
            f"{cfg.n_layers * (n_prefill + n_steps)}")
    if plain_calls:
        raise AssertionError(f"the plain attention ran {plain_calls} times on the card")
    kernel_launches = {key: n for key, n in FA.LAUNCHES.items() if key != "flash_attention"}
    expected = {"flash_attention_prefill": cfg.n_layers * n_prefill,
                "flash_attention_decode": cfg.n_layers * n_steps,
                "flash_attention_combine": cfg.n_layers * n_steps,
                "flash_attention_f32": 0}
    log(f"K4 kernel launches: {json.dumps(kernel_launches)}")
    if kernel_launches != expected:
        raise AssertionError(f"K4 kernel launches {kernel_launches}, expected {expected}")

    long_steps = [s for s, n in zip(step_s, step_len) if n >= long_len]
    short_steps = [s for s, n in zip(step_s, step_len) if n < long_len]
    rec.update({
        "requests": len(out), "slots": 8, "max_len": max_len,
        "prompt_tokens": [long_len, short_len], "new_tokens": new_tokens,
        "run_s": run_s, "generated_tokens_per_s": len(out) * new_tokens / run_s,
        "prefill_s_mean": {str(n): float(np.mean(v)) for n, v in prefill_s.items()},
        "prefill_s_first": {str(n): v[0] for n, v in prefill_s.items()},
        "decode_ms_per_step_mean": {
            f"kv~{long_len}": 1e3 * float(np.mean(long_steps)),
            f"kv~{short_len}": 1e3 * float(np.mean(short_steps))},
        "prefills": n_prefill, "decode_steps": n_steps, "k4_launches": launches,
        "k4_launches_split": dict(split), "k4_kernel_launches": kernel_launches,
        "plain_attention_cuda_calls": plain_calls,
        "peak_memory_bytes": peak,
    })
    log(f"prefill s/request: {json.dumps(rec['prefill_s_mean'])}; decode ms/step at 8 "
        f"slots: {json.dumps(rec['decode_ms_per_step_mean'])}; "
        f"{rec['generated_tokens_per_s']:.1f} generated tokens/s; peak memory "
        f"{peak / 1e9:.2f} GB")

    # -- the same 4096-token prefill through K4 and through the plain attention
    prompt = torch.as_tensor(requests[0].prompt, device="cuda")[None, :]
    logits = {}
    with torch.inference_mode():
        for which in ("k4", "plain"):
            cache = transformer.init_cache(cfg, 1, max_len, "cuda")
            attention = FA.flash_attention if which == "k4" else FA.flash_attention_plain
            with unittest.mock.patch.object(transformer, "flash_attention", attention):
                full, _ = transformer.forward(params, prompt, cfg, cache)
            logits[which] = full[0, -1].clone()
            del full, cache
    FA.reset_launch_counts()
    err = float((logits["k4"] - logits["plain"]).abs().max().item())
    scale = float(logits["plain"].abs().max().item())
    same_argmax = int(logits["k4"].argmax()) == int(logits["plain"].argmax())
    log(f"last-position logits, K4 vs plain attention on the card: max abs err {err:.5f} "
        f"(largest |logit| {scale:.4f}, tolerance {LOGITS_RTOL} x that); argmax agrees: "
        f"{same_argmax}")
    if not (np.isfinite(err) and err <= LOGITS_RTOL * scale):
        raise AssertionError(f"K4 logits differ from the plain attention's by {err}")
    rec["logits_check"] = {"max_abs_err": err, "max_abs_logit": scale,
                           "rtol": LOGITS_RTOL, "argmax_agrees": same_argmax}

    rec["profile"] = profile_lm(server, lm_requests(
        cfg, args.seed + 1, long_len, short_len, n_each, new_tokens))
    log(f"profiled prefill / decode step: {json.dumps(rec['profile'])}")

    # -- K4 rows at the main path's shapes --------------------------------------
    rows = k4_rows(long_len, max_len, cfg.n_heads, cfg.n_kv_heads,
                   cfg.resolved_head_dim, kernel_launches, args.reps, args.seed)
    rec["sass"] = mma_instruction_counts()
    for r in rows:
        log(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']}, SDPA {r['library_ms']:.4f}), "
            f"{r['launches']} launches in the served run")
    rec["kernels"] = rows
    return rec


def graph_phases(args, record) -> list:
    """Phases 2-4: the small oracle check, the served main path with its
    profile, and the graph kernels' rows."""
    import numpy as np
    import torch

    from repro_torch.core import engine, extract
    from repro_torch.data.synth import dblp_catalog
    from repro_torch.kernels import bitmap_index as BI
    from repro_torch.kernels import bitmap_spmm as K
    from repro_torch.serve.server import GraphQueryServer

    small_input_check(args.seed)

    # -- main path: setup (host stages) ------------------------------------
    stages = {}
    t = time.perf_counter()
    catalog = dblp_catalog(args.authors, args.pubs, 6.0, seed=args.seed)
    stages["catalog_s"] = time.perf_counter() - t
    t = time.perf_counter()
    res = extract(catalog, QUERY)
    g = res.graph
    stages["extract_s"] = time.perf_counter() - t
    if g.n_virtual == 0:
        raise AssertionError("extraction postponed no join: nothing to pack")
    builds_before = dict(BI.INDEX_BUILDS)
    t = time.perf_counter()
    server = GraphQueryServer.from_condensed(g, packed=True, device="cuda")
    torch.cuda.synchronize()
    stages["correction_pack_upload_s"] = time.perf_counter() - t
    builds = {k: v - builds_before[k] for k, v in BI.INDEX_BUILDS.items()}
    exact, counts = server.graph, server.counts_graph
    stages["index_build_s"] = rebuild_indices((exact, counts))
    held = {"exact": engine.device_graph_bytes(exact),
            "counts": engine.device_graph_bytes(counts),
            "exact_index": index_bytes(exact), "counts_index": index_bytes(counts)}
    log(f"index builds at upload: {json.dumps(builds)} (inside correction_pack_upload_s); "
        f"all of them again: {stages['index_build_s']:.4f} s")
    log(f"graph: {g!r}; plan {res.plans[0].describe()}")
    log(f"correction: {len(server.graph.correction[0])} triples, "
        f"{exact.fused_fwd.planes.shape[1]} planes; fused standdown {exact.fused_standdown!r}")
    log(f"host stages (s): {json.dumps(stages)}")
    log(f"device bytes held: {json.dumps(held)}")

    rng = np.random.default_rng(args.seed)
    nodes = rng.integers(0, g.n_real, args.batch)
    reach_nodes = rng.integers(0, g.n_real, args.batch)

    # -- main path: the run whose launches count ---------------------------
    K.reset_launch_counts()
    engine.reset_kernel_dispatch_count()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    queries, got, reach, stats = serve_queries(server, nodes, reach_nodes)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t
    launches = dict(K.LAUNCHES)
    standdowns = dict(engine.KERNEL_STANDDOWN_COUNT)
    log(f"served {len(queries)} queries in {stats.n_batches} batches + "
        f"reachable_multi({args.batch}) in {serve_s:.3f} s")
    log(f"launches: {json.dumps(launches)}; stand-downs: {json.dumps(standdowns)}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    if (args.authors, args.pubs, args.batch) == FULL_GRAPH and launches != FULL_LAUNCHES:
        raise AssertionError(f"launches {launches}, expected {FULL_LAUNCHES} at this size")
    if standdowns.get("vmem_or_backend"):
        raise AssertionError("the fused kernel stood down for 'vmem_or_backend'")

    seg = GraphQueryServer(
        dataclasses.replace(exact, backend="segment"),
        counts_graph=dataclasses.replace(counts, backend="segment"),
    )
    before = dict(K.LAUNCHES)
    t = time.perf_counter()
    _, ref, reach_ref, _ = serve_queries(seg, nodes, reach_nodes)
    torch.cuda.synchronize()
    segment_s = time.perf_counter() - t
    if K.LAUNCHES != before:
        raise AssertionError("the segment backend launched a kernel")
    compare_answers(queries, got, ref, reach, reach_ref)
    log(f"answers equal the segment path's (segment run {segment_s:.3f} s)")
    for q in queries:
        a = got[q.qid]
        if a.shape != (g.n_real,) or (q.kind != "bfs" and not np.isfinite(a).all()):
            raise AssertionError(f"malformed answer for {q}")

    prof = profile_serve(server, nodes, reach_nodes)
    log(f"profiled serve: {json.dumps(prof)}")
    # each wrapper call is one range kernel and one carry pass, nothing else
    k12 = sum(launches[f"bitmap_spmm_{op}"] for op in ("sum", "min", "max"))
    want = {"spmm_kernel": k12, "carry_kernel": k12,
            "fused_kernel": launches["bitmap_spmm_fused"],
            "fused_carry_kernel": launches["bitmap_spmm_fused"]}
    if prof["device_busy_s"] is not None and prof["graph_kernel_launches"] != want:
        raise AssertionError(f"graph kernels launched {prof['graph_kernel_launches']} times "
                             f"in the profiled run, expected {want}")

    rows = kernel_rows(exact, launches, args.reps, args.seed)
    log(f"K3 operands: {json.dumps(rows[-1]['shape'])}")
    rows += index_rows(exact, builds, max(args.reps // 4, 2))
    record["graph_sass_atomics"] = graph_atomic_counts()
    for r in rows:
        log(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']}, layout bound "
            f"{r['layout_bound_ms']:.4f}, library {r['library_ms']})")

    record.update({
        "stages": stages, "device_bytes": held,
        "serve_s": serve_s, "segment_s": segment_s, "serve_profile": prof,
        "launches": launches, "index_builds": builds,
        "standdowns": standdowns, "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "graph": {"n_real": g.n_real, "n_virtual": g.n_virtual,
                  "edges_condensed": g.n_edges_condensed,
                  "correction_triples": len(server.graph.correction[0])},
    })
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--authors", type=int, default=50_000)
    ap.add_argument("--pubs", type=int, default=100_000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--quick", action="store_true",
                    help="a first check of changed kernels: DBLP 3000 authors / 6000 "
                         "pubs and 256 / 64-token prompts with 4 new tokens")
    args = ap.parse_args()
    if args.quick:
        args.authors, args.pubs = 3000, 6000

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from repro_torch.kernels import build

    record = {}
    t0 = time.perf_counter()
    build.build_all()
    record["build_s"] = time.perf_counter() - t0
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} cc {torch.cuda.get_device_capability(0)}")
    log(f"kernels built in {record['build_s']:.1f} s")
    for name in build.LIBRARIES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    rows = graph_phases(args, record)
    torch.cuda.empty_cache()
    lm = lm_phase(args)
    rows += lm.pop("kernels")
    record.update({"card": card, "lm": lm, "args": vars(args), "kernels": rows})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("layout_bound_ms",)
    print(json.dumps({"kernels": [{k: r[k] for k in keys + extra if k in r} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
