#!/usr/bin/env python3
"""Host seconds of the port's dedup family on co-author graphs.

    python3 scripts/dedup_host_times.py                      # 1000/2000 and 3000/6000
    python3 scripts/dedup_host_times.py --sizes 300x600 --limit 60

For each ``authors x pubs`` size: ``dblp_catalog(mean_authors_per_pub=6.0,
seed=7)`` and the co-author query are extracted, then ``bitmap1``,
``bitmap2``, ``dedup1_greedy_virtual_first``, ``dedup2_greedy`` and
``build_wedge_correction`` each run in a child process of their own and
are cut after ``--limit`` seconds (reported as ``null`` with
``"cut": true``).  These are host NumPy / Python preprocessing steps;
no GPU is used.  Prints one JSON line per step and writes them all to
``chiprun_out/dedup_host_times.json``.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

QUERY = """
Nodes(ID, Name) :- Author(ID, Name).
Edges(ID1, ID2) :- AuthorPub(ID1, PubID), AuthorPub(ID2, PubID).
"""
STEPS = ("bitmap1", "bitmap2", "dedup1_greedy_virtual_first", "dedup2_greedy",
         "build_wedge_correction")


def _graph(authors: int, pubs: int):
    from repro_torch.core import extract
    from repro_torch.data.synth import dblp_catalog

    return extract(dblp_catalog(authors, pubs, 6.0, seed=7), QUERY).graph


def _size_of(step: str, out) -> dict:
    if step.startswith("bitmap"):
        return {"bitmaps": out.n_bitmaps, "bits": out.n_bits}
    if step.startswith("dedup1"):
        return {"total_edges": out.total_edges, "direct_edges": out.n_direct_edges}
    if step.startswith("dedup2"):
        return {"edges": out.n_edges, "vv_edges": len(out.vv_edges)}
    return {"triples": int(out[0].size)}


def _child(step: str, authors: int, pubs: int, queue) -> None:
    from repro_torch.core import dedup

    g = _graph(authors, pubs)
    t = time.perf_counter()
    out = getattr(dedup, step)(g)
    queue.put({"seconds": time.perf_counter() - t, **_size_of(step, out)})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", default="1000x2000,3000x6000")
    ap.add_argument("--limit", type=float, default=120.0)
    args = ap.parse_args()
    rows = []
    ctx = mp.get_context("spawn")
    for size in args.sizes.split(","):
        authors, pubs = (int(v) for v in size.split("x"))
        g = _graph(authors, pubs)
        base = {"authors": authors, "pubs": pubs, "edges_condensed": g.n_edges_condensed}
        for step in STEPS:
            queue = ctx.Queue()
            proc = ctx.Process(target=_child, args=(step, authors, pubs, queue))
            proc.start()
            proc.join(args.limit)
            if proc.is_alive():
                proc.terminate()
                proc.join()
                row = {**base, "step": step, "seconds": None, "cut": True,
                       "limit_s": args.limit}
            else:
                row = {**base, "step": step, **queue.get(timeout=10), "cut": False}
            rows.append(row)
            print(json.dumps(row), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "dedup_host_times.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
