#!/usr/bin/env python3
"""The four GNN training steps at their ``CONFIG``s under three segment
sums, on one GPU.

    python3 scripts/gnn_segsum_times.py [--steps N] [--seed S]

The graphs are ``chip_smoke.py`` phase 9's (meshgraphnet and graphcast
on ``full_graph_sm``, schnet and dimenet on ``molecule``).  Each step
runs with every sum of ``models/gnn.py`` done three ways, in turn on one
card:

* ``index_add``: ``index_add_`` into zeros (atomics on the card, no fixed
  order: the port before the fixed-order sums);
* ``plan``: the engine's ``core.semiring.segment_plan`` of each index,
  built once per graph;
* ``sort``: each index sorted once per graph, then
  ``torch.segment_reduce`` over the sorted values (the port's sum,
  ``models.gnn._seg_sum``).

Per kind and way: the median of ``--steps`` timed steps (after one
warm-up), host clock around a synchronised step, and whether step 0 run
twice from the same params gives the same bits.  Prints the card's name
and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402  (imports no kernel at import time)


def _index_add(vals, g, name, n):
    from repro_torch.models import gnn

    out = vals.new_zeros((n,) + tuple(vals.shape[1:]))
    return out.index_add(0, gnn._segment_ids(g, name).long(), vals)


def _planned(vals, g, name, n):
    from repro_torch.core.semiring import PLUS_TIMES, segment_plan, segment_reduce
    from repro_torch.models import gnn

    plans = g.__dict__.setdefault("_segment_plans", {})
    if (name, n) not in plans:
        plans[name, n] = segment_plan(gnn._segment_ids(g, name), n)
    return segment_reduce(PLUS_TIMES, vals, gnn._segment_ids(g, name), n, plan=plans[name, n])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("gnn_segsum_times: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.models import gnn
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import steps as steps_lib

    print(chip_smoke.card_line())
    ways = {"index_add": _index_add, "plan": _planned, "sort": gnn._seg_sum}
    out = {}
    for kind, shape_name in (("meshgraphnet", "full_graph_sm"), ("graphcast", "full_graph_sm"),
                             ("schnet", "molecule"), ("dimenet", "molecule")):
        cfg = registry.get_arch(kind).CONFIG
        shape = GNN_SHAPES[shape_name]
        g_cpu, target = chip_smoke.padded_graph(shape, kind, cfg.d_out, args.seed, "cpu")
        params = gnn.init_params(cfg, torch.Generator(device="cuda").manual_seed(args.seed),
                                 shape.d_feat, device="cuda")
        out[kind] = {}
        for way, fn in ways.items():
            gnn._seg_sum, saved = fn, gnn._seg_sum
            try:
                optimizer = opt_lib.adamw(1e-3)
                step_fn = steps_lib.build_gnn_train_step(cfg, optimizer)
                batch = {"graph": g_cpu.to("cuda"), "target": target.cuda()}
                firsts = []
                for _ in range(2):
                    state = steps_lib.init_train_state(opt_lib.tree_map(torch.clone, params),
                                                       optimizer)
                    state, m = step_fn(state, batch)
                    firsts.append((float(m["loss"]), float(m["grad_norm"]),
                                   [p.clone() for p in opt_lib.tree_leaves(state["params"])]))
                repeats = firsts[0][:2] == firsts[1][:2] and all(
                    torch.equal(a, b) for a, b in zip(firsts[0][2], firsts[1][2]))
                times = []
                for _ in range(args.steps):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    state, m = step_fn(state, batch)
                    float(m["loss"])
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t)
                out[kind][way] = {"median_step_s": statistics.median(times), "step_s": times,
                                  "loss0": firsts[0][0], "step0_repeats_bits": repeats}
                del state, step_fn, batch, firsts
            finally:
                gnn._seg_sum = saved
            torch.cuda.empty_cache()
        print(f"{kind}: " + ", ".join(f"{w} {r['median_step_s'] * 1e3:.2f} ms "
                                      f"(repeats {r['step0_repeats_bits']})"
                                      for w, r in out[kind].items()), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
