#!/usr/bin/env python3
"""K4's bf16 kernels at glm4-9b's main-path shapes on one GPU.

    python3 scripts/k4_times.py [--src DIR] [--reps N]

Runs ``chip_smoke.k4_rows`` alone, without the graph phases and the
served model: the 4096-token causal prefill (q ``(1, 4096, 32, 128)``
over a ``(1, 4128, 2, 128)`` cache) and the decode step (q ``(8, 1, 32,
128)`` over four distinct ``(8, 4128, 2, 128)`` caches in turn, cold in
L2), each held to the plain version by the element-wise bf16 bound and
timed in device milliseconds beside SDPA, as ``chip_smoke.py`` times
them.

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so that two versions of the kernels can be
compared on one card back to back: run the parent, the change, the
change again and the parent.  Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (imports no kernel at import time)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    if not torch.cuda.is_available():
        print("k4_times: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import glm4_9b
    from repro_torch.kernels import flash_attention as FA

    cfg = glm4_9b.CONFIG
    T, _, new_tokens = chip_smoke.LM_FULL
    rows = chip_smoke.k4_rows(T, T + new_tokens, cfg.n_heads, cfg.n_kv_heads,
                              cfg.resolved_head_dim, {key: 0 for key in FA.LAUNCHES},
                              args.reps, seed=7)
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    print(json.dumps({"src": os.path.relpath(os.path.abspath(args.src), ROOT),
                      "card": chip_smoke.card_line(),
                      **{r["name"]: {**{k: r[k] for k in keys},
                                     "warm_ms": r["shape"]["warm_ms"],
                                     "excess": r["shape"]["bf16_excess_over_rtol"]}
                         for r in rows}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
