#!/usr/bin/env python3
"""The row-index builders, chunked against the serial schedule they replace,
at the DBLP smoke graph's operands on one GPU.

    python3 scripts/index_times.py [--authors N] [--pubs N] [--seed S] [--reps N]
                                   [--units 8,16,32] [--pairs 2]

Builds the graph as ``chip_smoke.py``'s main path does (``dblp_catalog``,
``extract``, the streamed DEDUP-C correction, the packed upload) and takes
the two operands ``chip_smoke.py``'s index rows time: the author ->
publication layer (``bitmap_index``) and the forward fused stream
(``bitmap_index_fused``).  It builds ``scripts/ab/bitmap_index_serial.cu``
(the serial schedule: one block per row tile) with ``nvcc`` for ``sm_90a``
into ``build/ab_index/`` and times, in device milliseconds per build (queued
behind a device-side spin, as ``chip_smoke.py`` times; each build reads its
entry count back once, so host gaps after that read count too), the serial
and the shipped chunked builders in turns, serial, chunked, chunked, serial,
``--pairs`` times, then the chunked builders at each chunk length of
``--units`` (set as ``bitmap_index.CHUNK_UNITS``), each also under
``torch.profiler`` (device ms by kernel, the host ms of the costliest host
ops, wall ms a build and the card's idle share of it), as is the serial
builder.  Every build is held to the plain version and to the uploaded
index byte for byte.  Prints one JSON line per builder with the card's name
and power limit, each time, the bound (each input byte read once and each
output byte written once, over 3.35 TB/s) and the bytes a millisecond.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402  (imports no kernel at import time)


def build_serial():
    from repro_torch.kernels import build

    out = os.path.join(ROOT, "build", "ab_index")
    os.makedirs(out, exist_ok=True)
    lib_path = os.path.join(out, "libbitmap_index_serial.so")
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib_path,
                        os.path.join(ROOT, "scripts", "ab", "bitmap_index_serial.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}\n{r.stderr}")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib = ctypes.CDLL(lib_path)
    for name, args in {"bitmap_index_launch": [I] + [P] * 4 + [I] + [P] * 2 + [I, P],
                       "bitmap_index_fused_launch": [I] + [P] * 9 + [I] * 2 + [P] * 3 + [I, P]
                       }.items():
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = I
    return lib


def serial_build(lib, fused: bool, args):
    """The serial schedule's wrapper as it shipped: count pass, scan, one
    read back, fill pass."""
    import torch

    from repro_torch.kernels.bitmap_index import _ptr, _raise_on, _stream

    if fused:
        kind, main_src, corr_src, main_idx, corr_idx, _, row_start, row_count, bitmaps, planes, _ = args
    else:
        slot_src, _, row_start, row_count, bitmaps = args
    device = bitmaps.device
    n_rt = int(row_start.shape[0])
    counts = torch.empty(n_rt * 128 + 1, dtype=torch.int32, device=device)
    tail = (device.index or 0, _stream(device))
    if fused:
        common = (_ptr(kind), _ptr(main_src), _ptr(corr_src), _ptr(main_idx), _ptr(corr_idx),
                  _ptr(row_start), _ptr(row_count), _ptr(bitmaps), _ptr(planes),
                  int(planes.shape[1]), n_rt)
        _raise_on(lib.bitmap_index_fused_launch(0, *common, _ptr(counts), None, None, *tail),
                  "serial")
    else:
        common = (_ptr(slot_src), _ptr(row_start), _ptr(row_count), _ptr(bitmaps), n_rt)
        _raise_on(lib.bitmap_index_launch(0, *common, _ptr(counts), None, *tail), "serial")
    row_ptr = torch.cumsum(counts, 0, dtype=torch.int32)
    nnz = int(row_ptr[-1].item())
    col = torch.empty(nnz, dtype=torch.int32, device=device)
    if not fused:
        _raise_on(lib.bitmap_index_launch(1, *common, _ptr(row_ptr), _ptr(col), *tail), "serial")
        return row_ptr, col
    weight = torch.empty(nnz, dtype=torch.int32, device=device)
    _raise_on(lib.bitmap_index_fused_launch(1, *common, _ptr(row_ptr), _ptr(col), _ptr(weight),
                                            *tail), "serial")
    return row_ptr, col, weight


def profile_split(fn, reps: int) -> dict:
    """Device ms per build by kernel name over ``reps`` builds, and the
    share of the builds' wall time the card was idle."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / reps
    split, host = {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            host[e.key[:60]] = e.self_cpu_time_total / 1e3 / reps
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        key = e.key.split("(")[0][:60]
        split[key] = split.get(key, 0.0) + us / 1e3 / reps
    busy = sum(split.values())
    top_host = dict(sorted(host.items(), key=lambda kv: -kv[1])[:8])
    return {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1 - busy / wall_ms,
            "kernels_ms": dict(sorted(split.items(), key=lambda kv: -kv[1])),
            "host_ops_ms": top_host}


def operands(args):
    from repro_torch.core import dedup, engine, extract
    from repro_torch.data.synth import dblp_catalog

    t = time.perf_counter()
    g = extract(dblp_catalog(args.authors, args.pubs, 6.0, seed=args.seed),
                chip_smoke.QUERY).graph
    graph = engine.to_device_packed(g, correction=dedup.build_correction_streaming(g),
                                    device="cuda")
    ops, fused = graph.chains[0][0].fwd, graph.fused_fwd
    cases = {
        "bitmap_index": (False, [getattr(ops, k) for k in engine.PACKED_TABLES],
                         (ops.row_ptr, ops.col)),
        "bitmap_index_fused": (True, [getattr(fused, k) for k in engine.FUSED_TABLES]
                               + [fused.plane_weights],
                               (fused.row_ptr, fused.col, fused.weight)),
    }
    return cases, time.perf_counter() - t


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--authors", type=int, default=50_000)
    p.add_argument("--pubs", type=int, default=100_000)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--units", default="8,16,32")
    p.add_argument("--pairs", type=int, default=2)
    args = p.parse_args(argv)
    import torch

    from repro_torch.kernels import bitmap_index as BI

    if not torch.cuda.is_available():
        print("no CUDA device: the builders are timed on the card only", file=sys.stderr)
        return 1
    lib = build_serial()
    cases, build_s = operands(args)
    card = chip_smoke.card_line()
    for name, (fused, ops, uploaded) in cases.items():
        new = getattr(BI, name)
        plain = getattr(BI, f"{name}_plain")
        want = plain(*ops)
        if not all(torch.equal(a, b) for a, b in zip(want, uploaded)):
            raise AssertionError(f"{name}: the plain version differs from the uploaded index")
        builds = {"serial": lambda: serial_build(lib, fused, ops), "chunked": lambda: new(*ops)}
        for label, fn in builds.items():
            if not all(torch.equal(a, b) for a, b in zip(fn(), want)):
                raise AssertionError(f"{name}: the {label} build differs from the plain version")
        words = [t for t in ops if isinstance(t, torch.Tensor)]
        n_bytes = chip_smoke.nbytes(*words, *want)
        n_rt = int(ops[6 if fused else 2].shape[0])
        before = dict(BI.INDEX_BUILDS)
        turns = []
        for _ in range(args.pairs):
            for label in ("serial", "chunked", "chunked", "serial"):
                turns.append((label, chip_smoke.time_ms(builds[label], args.reps)))
        by_units = {}
        shipped_units = BI.CHUNK_UNITS
        for units in [int(u) for u in args.units.split(",")]:
            BI.CHUNK_UNITS = units
            try:
                got = new(*ops)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{name} at CHUNK_UNITS={units} differs from the plain "
                                         "version")
                grid, chunks = BI.LAST_GRID[name]
                ms = chip_smoke.time_ms(lambda: new(*ops), args.reps)
                by_units[units] = {"ms": ms, "chunks": chunks, "grid": grid,
                                   "gb_per_s": n_bytes / ms / 1e6,
                                   "profile": profile_split(lambda: new(*ops), args.reps)}
            finally:
                BI.CHUNK_UNITS = shipped_units
        split = profile_split(builds["serial"], args.reps)
        BI.INDEX_BUILDS.update(before)
        plain_ms = chip_smoke.time_ms(lambda: plain(*ops), 2, 1)
        mean = {label: sum(ms for lab, ms in turns if lab == label)
                / sum(1 for lab, _ in turns if lab == label) for label in builds}
        print(json.dumps({
            "name": name, "card": card, "graph_build_s": build_s, "turns": turns,
            "serial_ms": mean["serial"], "chunked_ms": mean["chunked"],
            "speedup": mean["serial"] / mean["chunked"], "plain_ms": plain_ms,
            "bound_ms": n_bytes / chip_smoke.HBM_BYTES_PER_S * 1e3, "bytes": n_bytes,
            "rows": int(want[0].shape[0]) - 1, "entries": int(want[1].shape[0]),
            "row_tiles": n_rt, "by_chunk_units": by_units, "serial_profile": split,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
