#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # the full run: DBLP 50K authors / 100K pubs

Phases, each of which fails the run (non-zero exit, no result line):

1. Setup: build every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once) and print the card's name and
   power limit.
2. Small input: a small DBLP graph served through the kernels agrees with
   NumPy dense-expansion oracles (BFS and common neighbors exactly,
   personalized PageRank to float32 round-off).
3. Main path: ``dblp_catalog(mean_authors_per_pub=6.0)`` -> ``extract`` ->
   ``GraphQueryServer.from_condensed(packed=True)`` with ``'auto'``
   dispatch, ``run`` of 32 ``bfs`` + 32 ``ppr`` + 32 ``common_neighbors``
   queries and one ``reachable_multi`` batch of 32.  Launch counts are
   zeroed just before and read just after; every kernel must have
   launched, no ``'vmem_or_backend'`` stand-down may occur, and the
   answers must equal those of the same graphs served by the segment
   path on the card (PPR to ``rtol=1e-5, atol=1e-6``: the two paths add
   float32 values in different orders).
   One more run of the same batches under ``torch.profiler`` gives the
   device time by kernel and the card's idle share.
4. Kernels: at the main path's operands, each kernel against its plain
   PyTorch version on the card (integer frontiers, byte-equal), with its
   time, the plain version's time, a bound (the larger of the bytes at
   3.35 TB/s and its float32 operations at 67 TFLOP/s) and, for K1, one
   ``torch.sparse.mm`` call on a CSR of the same incidence.

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
CSRC = "src/repro_torch/kernels/csrc"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 1e6
    busy_s = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {
        "wall_s": wall_s,
        "device_busy_s": busy_s if by_kernel else None,
        "idle_share": 1.0 - busy_s / wall_s if by_kernel else None,
        "top_kernels_s": dict(top),
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


def bound(n_bytes: int, n_ops: int):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_rows(graph, launches, reps: int, seed: int):
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
    bits = set_bits(ops.bitmaps)
    tables = (ops.slot_src, ops.row_start, ops.row_count, ops.bitmaps)
    rows = []
    cases = [("sum", ints, 0.0), ("min", with_inf, float("inf")), ("max", zero_one, 0.0)]
    for op, x, zero in cases:
        args = (ops.slot_src, ops.slot_row, ops.row_start, ops.row_count, ops.bitmaps, x, n_out)
        before = dict(K.LAUNCHES)
        y = K.bitmap_spmm(*args, op=op, zero=zero)
        y_plain = K.bitmap_spmm_plain(*args, op=op, zero=zero)
        torch.cuda.synchronize()
        if not torch.equal(y, y_plain):
            raise AssertionError(f"bitmap_spmm {op}: kernel != plain version")
        ms = time_ms(lambda: K.bitmap_spmm(*args, op=op, zero=zero), reps)
        plain_ms = time_ms(lambda: K.bitmap_spmm_plain(*args, op=op, zero=zero), 3, 1)
        K.LAUNCHES.update(before)  # comparison launches are not main-path launches
        b_ms, b_by = bound(nbytes(*tables, x, y), bits * feat)
        library_ms = None
        if op == "sum":
            csr = torch.sparse_coo_tensor(
                torch.stack([layer.dst, layer.src]),
                torch.ones(layer.src.shape[0], device=x.device),
                (n_out, n_src),
            ).coalesce().to_sparse_csr()
            library_ms = time_ms(lambda: torch.sparse.mm(csr, x), reps)
        name = f"bitmap_spmm_{op}"
        rows.append({
            "name": name, "route": "cuda", "source": f"{CSRC}/bitmap_spmm.cu",
            "replaces": f"{TPU_KERNEL}:77", "launches": launches[name],
            "max_abs_err": float((y - y_plain).abs().nan_to_num(0.0).max().item()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms,
            "shape": {"n_src": n_src, "n_out": n_out, "features": feat,
                      "slots": int(ops.slot_src.shape[0]), "set_bits": bits},
        })
    fused = graph.fused_fwd
    n_h = graph.chains[-1][-1].n_src
    h = torch.from_numpy(rng.integers(0, 7, (n_h, feat)).astype(np.float32)).cuda()
    xr = torch.from_numpy(rng.integers(0, 7, (graph.n_real, feat)).astype(np.float32)).cuda()
    fargs = (fused.kind, fused.main_src, fused.corr_src, fused.main_idx, fused.corr_idx,
             fused.slot_row, fused.row_start, fused.row_count, fused.bitmaps,
             fused.planes, h, xr, fused.n_out, fused.plane_weights)
    before = dict(K.LAUNCHES)
    y = K.bitmap_spmm_fused(*fargs)
    y_plain = K.bitmap_spmm_fused_plain(*fargs)
    torch.cuda.synchronize()
    if not torch.equal(y, y_plain):
        raise AssertionError("bitmap_spmm_fused: kernel != plain version")
    ms = time_ms(lambda: K.bitmap_spmm_fused(*fargs), reps)
    plain_ms = time_ms(lambda: K.bitmap_spmm_fused_plain(*fargs), 3, 1)
    K.LAUNCHES.update(before)
    n_planes = int(fused.planes.shape[1])
    n_corr = int(fused.planes.shape[0])
    main_bits, corr_bits = set_bits(fused.bitmaps), set_bits(fused.planes)
    f_bytes = nbytes(fused.kind, fused.main_src, fused.corr_src, fused.main_idx,
                     fused.corr_idx, fused.row_start, fused.row_count,
                     fused.bitmaps, fused.planes, h, xr, y)
    # one add per main bit, a multiply-add per plane bit, one subtract per output
    f_ops = feat * (main_bits + 2 * corr_bits + fused.n_out)
    b_ms, b_by = bound(f_bytes, f_ops)
    rows.append({
        "name": "bitmap_spmm_fused", "route": "cuda",
        "source": f"{CSRC}/bitmap_spmm_fused.cu", "replaces": f"{TPU_KERNEL}:190",
        "launches": launches["bitmap_spmm_fused"],
        "max_abs_err": float((y - y_plain).abs().max().item()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
        "shape": {"n_h": n_h, "n_out": fused.n_out, "features": feat,
                  "slots": int(fused.kind.shape[0]), "correction_slots": n_corr,
                  "planes": n_planes, "main_bits": main_bits, "plane_bits": corr_bits,
                  **plane_skew(fused)},
    })
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--authors", type=int, default=50_000)
    ap.add_argument("--pubs", type=int, default=100_000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from repro_torch.core import algorithms, engine, extract
    from repro_torch.data.synth import dblp_catalog
    from repro_torch.kernels import bitmap_spmm as K
    from repro_torch.kernels import build
    from repro_torch.serve.server import GraphQueryServer

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
    t = time.perf_counter()
    server = GraphQueryServer.from_condensed(g, packed=True, device="cuda")
    torch.cuda.synchronize()
    stages["correction_pack_upload_s"] = time.perf_counter() - t
    exact, counts = server.graph, server.counts_graph
    held = {"exact": engine.device_graph_bytes(exact),
            "counts": engine.device_graph_bytes(counts)}
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

    rows = kernel_rows(exact, launches, args.reps, args.seed)
    log(f"K3 operands: {json.dumps(rows[-1]['shape'])}")
    for r in rows:
        log(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']}, library {r['library_ms']})")

    record.update({
        "card": card, "stages": stages, "device_bytes": held,
        "serve_s": serve_s, "segment_s": segment_s, "serve_profile": prof,
        "launches": launches,
        "standdowns": standdowns, "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "graph": {"n_real": g.n_real, "n_virtual": g.n_virtual,
                  "edges_condensed": g.n_edges_condensed,
                  "correction_triples": len(server.graph.correction[0])},
        "args": vars(args), "kernels": rows,
    })
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
