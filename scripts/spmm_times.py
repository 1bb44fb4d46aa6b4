#!/usr/bin/env python3
"""K1/K2 and K3 over the row index at the DBLP smoke graph's operands, on one GPU.

    python3 scripts/spmm_times.py --save FILE [--authors N] [--pubs N] [--seed S]
    python3 scripts/spmm_times.py --load FILE [--src DIR] [--items L,L,...] [--reps N]

``--save`` builds the graph as ``chip_smoke.py``'s main path does
(``dblp_catalog``, ``extract``, the streamed DEDUP-C correction, the packed
upload) and saves the two row indices whose rows ``chip_smoke.py`` times:
the author -> publication layer (K1/K2) and the forward fused stream (K3),
with their row statistics.  ``--load`` times them under the
``repro_torch`` of ``--src`` (default: this checkout's), so that two
versions of the kernels can be compared on one card back to back without
rebuilding the graph: each kernel's device ms per call (queued behind a
device-side spin, as ``chip_smoke.py`` times) and its split between the
range kernel and the carry pass (``torch.profiler``), at each range length
of ``--items`` (0: the wrappers' own).  Integer frontiers, so every range
length must give the same bits.  Prints one JSON line per range length.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (imports no kernel at import time)

FEAT = 32


def save(args) -> None:
    import torch

    from repro_torch.core import dedup, engine, extract
    from repro_torch.data.synth import dblp_catalog

    t = time.perf_counter()
    g = extract(dblp_catalog(args.authors, args.pubs, 6.0, seed=args.seed),
                chip_smoke.QUERY).graph
    graph = engine.to_device_packed(g, correction=dedup.build_correction_streaming(g),
                                    device="cuda")
    layer, fused = graph.chains[0][0], graph.fused_fwd
    out = {
        "k1": {"row_ptr": layer.fwd.row_ptr, "col": layer.fwd.col,
               "n_out": layer.n_dst, "n_src": layer.n_src},
        "k3": {"row_ptr": fused.row_ptr, "col": fused.col, "weight": fused.weight,
               "n_out": fused.n_out, "n_h": graph.chains[-1][-1].n_src, "n_x": graph.n_real},
    }
    stats = {}
    for name, op in out.items():
        lengths = (op["row_ptr"][1: op["n_out"] + 1] - op["row_ptr"][: op["n_out"]]).long()
        stats[name] = {"rows": op["n_out"], "entries": int(lengths.sum()),
                       "max_row": int(lengths.max()),
                       "rows_over_1000": int((lengths > 1000).sum()),
                       "entries_in_top_10_rows": int(lengths.topk(10).values.sum())}
    torch.save({k: {f: v.cpu() if torch.is_tensor(v) else v for f, v in op.items()}
                for k, op in out.items()}, args.save)
    print(json.dumps({"saved": args.save, "build_s": time.perf_counter() - t,
                      "stats": stats}))


def profile_split(fn, reps: int) -> dict:
    """Device seconds per call by kernel name prefix over ``reps`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or "bitmap_spmm::" not in e.key:
            continue
        kind = e.key.split("bitmap_spmm::")[1].split("<")[0]
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        split[kind] = split.get(kind, 0.0) + us / 1e3 / reps
    return split


def load(args) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels import bitmap_spmm as K

    ops = torch.load(args.load)
    k1 = {f: v.cuda() if torch.is_tensor(v) else v for f, v in ops["k1"].items()}
    k3 = {f: v.cuda() if torch.is_tensor(v) else v for f, v in ops["k3"].items()}
    rng = np.random.default_rng(7)

    def ints(n):
        return torch.from_numpy(rng.integers(0, 7, (n, FEAT)).astype(np.float32)).cuda()

    x, h, xr = ints(k1["n_src"]), ints(k3["n_h"]), ints(k3["n_x"])
    calls = {
        "k1_sum": lambda L: K.bitmap_spmm(k1["row_ptr"], k1["col"], x, k1["n_out"],
                                          range_items=L),
        "k2_min": lambda L: K.bitmap_spmm(k1["row_ptr"], k1["col"], x, k1["n_out"], "min",
                                          float("inf"), range_items=L),
        "k3": lambda L: K.bitmap_spmm_fused(k3["row_ptr"], k3["col"], k3["weight"], h, xr,
                                            k3["n_out"], range_items=L),
    }
    want = {name: fn(None) for name, fn in calls.items()}
    for items in [int(v) for v in args.items.split(",")]:
        L = items or None
        rec = {"src": os.path.relpath(os.path.abspath(args.src), ROOT),
               "card": chip_smoke.card_line(), "range_items": L}
        for name, fn in calls.items():
            if not torch.equal(fn(L), want[name]):
                raise AssertionError(f"{name} at range_items={L} gives other bits")
            rec[name] = {"ms": chip_smoke.time_ms(lambda: fn(L), args.reps),
                         "split_ms": profile_split(lambda: fn(L), args.reps)}
        print(json.dumps(rec), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--save")
    ap.add_argument("--load")
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--authors", type=int, default=50_000)
    ap.add_argument("--pubs", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--items", default="0")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    if not torch.cuda.is_available() or not (args.save or args.load):
        print("spmm_times: needs a CUDA device and --save or --load", file=sys.stderr)
        return 1
    if args.save:
        save(args)
    else:
        load(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
