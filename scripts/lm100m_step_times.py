#!/usr/bin/env python3
"""lm-100m's training step on one GPU, through the example's launcher.

    python3 scripts/lm100m_step_times.py [--src DIR] [--steps 120]
    python3 scripts/lm100m_step_times.py --src NEW --against OLD --pairs 4 [--steps 120]

Runs ``repro_torch.launch.train_lm.train`` on ``lm-100m``
(``model_100m``: float32, K4's float32 kernels once a layer a step) at
the example's batch of 4 x 128 tokens for ``--steps`` steps, checkpoints
written every 50 steps under ``build/`` of this checkout and removed
after.  Prints one JSON line: the median seconds a step over the
launcher's log windows (every 10 steps, each ending on a loss read, so a
synchronise) that neither start nor follow a checkpoint write, as
``chip_smoke.py``'s phase 13 reads them, the median over every window,
and K4's launch counts.

``--src`` names the ``src`` directory whose ``repro_torch`` is run
(default: this checkout's).  With ``--against OLD`` and ``--pairs N``
the script runs N pairs of runs, each run in a process of its own, the
two trees in turns (old, new, then new, old, and so on), and prints one
JSON line with every run's medians, each pair's difference new - old in
the steady median, and the median, least and largest of those
differences: a difference that keeps its sign in every pair is resolved,
one that changes sign is within the spread of the calls.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (imports no kernel at import time)


def one_run(src: str, steps: int) -> dict:
    """The medians of one run of ``steps`` steps from ``src``, in a child
    process (each tree's ``repro_torch`` is imported by its own
    process)."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--src", src,
                           "--steps", str(steps)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"lm100m_step_times --src {src} exited {proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def pairs(new: str, old: str, n: int, steps: int) -> dict:
    runs, diffs = {"new": [], "old": []}, []
    for i in range(n):
        order = (("old", old), ("new", new)) if i % 2 == 0 else (("new", new), ("old", old))
        got = {}
        for tag, src in order:
            got[tag] = one_run(src, steps)
            runs[tag].append({k: got[tag][k] for k in ("steady_median_step_s",
                                                       "median_step_s", "run_s",
                                                       "k4_launches")})
        diffs.append(got["new"]["steady_median_step_s"] - got["old"]["steady_median_step_s"])
    return {"new": os.path.relpath(os.path.abspath(new), ROOT),
            "old": os.path.relpath(os.path.abspath(old), ROOT),
            "card": chip_smoke.card_line(), "steps": steps, "pairs": n, "runs": runs,
            "steady_diff_s": diffs, "median_diff_s": statistics.median(diffs),
            "min_diff_s": min(diffs), "max_diff_s": max(diffs),
            "new_steady_median_s": statistics.median(
                r["steady_median_step_s"] for r in runs["new"]),
            "old_steady_median_s": statistics.median(
                r["steady_median_step_s"] for r in runs["old"])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--against", default=None,
                    help="the other tree's src directory, run in turns with --src")
    ap.add_argument("--pairs", type=int, default=0,
                    help="pairs of runs (old, new / new, old in turns) with --against")
    args = ap.parse_args()
    if bool(args.against) != (args.pairs > 0):
        ap.error("--against and --pairs go together")

    import torch

    if not torch.cuda.is_available():
        print("lm100m_step_times: no CUDA device", file=sys.stderr)
        return 1
    if args.pairs:
        print(json.dumps(pairs(args.src, args.against, args.pairs, args.steps)))
        return 0
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.build import build_all
    from repro_torch.launch import train_lm

    build_all()
    ckpt = os.path.join(ROOT, "build", "ckpt_lm100m_times")
    shutil.rmtree(ckpt, ignore_errors=True)
    cfg = train_lm.model_100m(log=lambda line: None)
    FA.reset_launch_counts()
    t = time.perf_counter()
    run = train_lm.train(cfg, steps=args.steps, checkpoint_dir=ckpt, device="cuda",
                         log=lambda line: None)
    run_s = time.perf_counter() - t
    shutil.rmtree(ckpt, ignore_errors=True)
    windows, steady = chip_smoke._window_step_s(run["log_times"])
    print(json.dumps({"src": os.path.relpath(os.path.abspath(args.src), ROOT),
                      "card": chip_smoke.card_line(), "steps": args.steps,
                      "steady_median_step_s": statistics.median(steady),
                      "median_step_s": statistics.median(windows), "run_s": run_s,
                      "window_step_s": windows, "k4_launches": dict(FA.LAUNCHES)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
