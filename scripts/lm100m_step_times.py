#!/usr/bin/env python3
"""lm-100m's training step on one GPU, through the example's launcher.

    python3 scripts/lm100m_step_times.py [--src DIR] [--steps 120]

Runs ``repro_torch.launch.train_lm.train`` on ``lm-100m``
(``model_100m``: float32, K4's float32 kernel with lse once a layer a
step) at the example's batch of 4 x 128 tokens for ``--steps`` steps,
checkpoints written every 50 steps under ``build/`` of this checkout and
removed after.  Prints one JSON line: the median seconds a step over the
launcher's log windows (every 10 steps, each ending on a loss read, so a
synchronise) that neither start nor follow a checkpoint write, as
``chip_smoke.py``'s phase 13 reads them, the median over every window,
and K4's launch counts.

``--src`` names the ``src`` directory whose ``repro_torch`` is run
(default: this checkout's), as in ``scripts/k4_times.py``: run the
parent, the change, the change again and the parent, each in its own
process, to compare two versions on one card back to back.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (imports no kernel at import time)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--steps", type=int, default=120)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    if not torch.cuda.is_available():
        print("lm100m_step_times: no CUDA device", file=sys.stderr)
        return 1
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
