#!/usr/bin/env python3
"""K4's training backward with dQ folded into the dK / dV walk, against the
shipped long route, on one GPU.

    python3 scripts/backward_fold_ab.py [--reps N] [--splits 8,16]

Builds ``scripts/ab/flash_backward_fold.cu`` (the folded design: five
products, 8 warps over 128-key tiles, dQ added in fp32 in a fixed key-tile
order by bulk adds behind per-row-tile counters) with ``nvcc`` for
``sm_90a`` into ``build/ab_fold/``.  Then, at glm4-9b's and granite's
training attention (q ``(1, 4096, 32, 128)`` over 2 kv heads and q ``(1,
4096, 24, 64)`` over 8, causal), it times in device milliseconds, in turns
shipped, fold, fold, shipped: the shipped long route
(``repro_torch.kernels.flash_attention._launch_backward``: row statistics,
dK / dV, dQ with recompute, reduce) and the fold at each row-block count
of ``--splits``.  Each fold result is held to the plain backward (relative
L2 within ``chip_smoke.BWD_L2_RTOL['plain']``) and to itself on a second
run, bit for bit.  Prints one JSON line with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402  (imports no kernel at import time)

SHAPES = {"glm4": (1, 4096, 32, 2, 128), "granite": (1, 4096, 24, 8, 64)}
ROWS = 64    # the fold's query rows a tile


def build_fold():
    from repro_torch.kernels import build

    out = os.path.join(ROOT, "build", "ab_fold")
    os.makedirs(out, exist_ok=True)
    lib_path = os.path.join(out, "libflash_backward_fold.so")
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", lib_path,
                        os.path.join(ROOT, "scripts", "ab", "flash_backward_fold.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}\n{r.stderr}")
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib = ctypes.CDLL(lib_path)
    for name, args in {"fold_rowstat_launch": [P] * 6 + [L] + [I] * 6 + [P],
                       "fold_long_launch": [P] * 12 + [I] * 8 + [F, I, P],
                       "fold_finish_launch": [P] * 6 + [I] * 8 + [F, I, P]}.items():
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = I
    return lib


def fold_backward(lib, q, k, v, out, lse, do, splits: int):
    """The fold's three launches on the current stream: ``(dq, dk, dv)``."""
    import torch

    B, Tq, H, D = q.shape
    _, Tk, KV, _ = k.shape
    r_pad = -(-Tq * (H // KV) // ROWS) * ROWS
    n_rows, n_kv = B * KV * r_pad, B * Tk * KV * D
    n_counters = B * KV * (r_pad // ROWS) + 1
    parts = 2 * splits * n_kv if splits > 1 else 0
    work = torch.empty(2 * n_rows + n_rows * D + parts + n_counters, dtype=torch.float32,
                       device=q.device)
    lse2, delta, acc = work[:n_rows], work[n_rows:2 * n_rows], work[2 * n_rows:]
    counters = work[work.numel() - n_counters:]
    n0 = 2 * n_rows + n_rows * D
    pk = work[n0:].data_ptr() if splits > 1 else None
    pv = work[n0 + splits * n_kv:].data_ptr() if splits > 1 else None
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dev = q.device.index or 0
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    scale = 1.0 / math.sqrt(D)
    for rc in (
        lib.fold_rowstat_launch(out.data_ptr(), do.data_ptr(), lse.data_ptr(), lse2.data_ptr(),
                                delta.data_ptr(), counters.data_ptr(), n_counters, B, Tq, H, KV,
                                D, dev, stream),
        lib.fold_long_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                             lse2.data_ptr(), delta.data_ptr(), acc.data_ptr(), dk.data_ptr(),
                             dv.data_ptr(), pk, pv, counters.data_ptr(), B, Tq, Tk, H, KV, D, 1,
                             splits, scale, dev, stream),
        lib.fold_finish_launch(acc.data_ptr(), dq.data_ptr(), pk, pv, dk.data_ptr(),
                               dv.data_ptr(), B, Tq, Tk, H, KV, D, 1, splits, scale, dev, stream),
    ):
        if rc != 0:
            raise RuntimeError(f"fold launch failed: CUDA error {rc}")
    return dq, dk, dv


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--splits", default="8,16", help="the fold's row-block counts")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("backward_fold_ab: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_attention as FA

    lib = build_fold()
    splits = [int(n) for n in args.splits.split(",") if n]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    result = {"card": chip_smoke.card_line()}
    for name, (B, T, H, KV, D) in SHAPES.items():
        q, do = (torch.randn((B, T, H, D), generator=gen, device="cuda").to(torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn((B, T, KV, D), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        out, lse = FA.flash_attention_op(q, k, v, None, True, 0, True, 512, 1024)
        plain = FA.flash_attention_backward_plain(q, k, v, out, lse, do, causal=True)
        row = {"shipped_ms": [], "fold_ms": {n: [] for n in splits}, "fold_l2": {},
               "fold_bits_repeat": {}}
        for n in splits:
            got = fold_backward(lib, q, k, v, out, lse, do, n)
            again = fold_backward(lib, q, k, v, out, lse, do, n)
            row["fold_bits_repeat"][n] = all(torch.equal(a, b) for a, b in zip(got, again))
            row["fold_l2"][n] = [float((a.float() - b.float()).norm() / b.float().norm())
                                 for a, b in zip(got, plain)]
            if not (row["fold_bits_repeat"][n]
                    and max(row["fold_l2"][n]) <= chip_smoke.BWD_L2_RTOL["plain"]):
                raise AssertionError(f"fold {name} splits {n}: {row}")
            del got, again
        for turn in ("shipped", "fold", "fold", "shipped"):
            if turn == "shipped":
                row["shipped_ms"].append(chip_smoke.time_ms(
                    lambda: FA._launch_backward(q, k, v, out, lse, do, True), args.reps))
            else:
                for n in splits:
                    row["fold_ms"][n].append(chip_smoke.time_ms(
                        lambda n=n: fold_backward(lib, q, k, v, out, lse, do, n), args.reps))
        result[name] = row
        del q, k, v, do, out, lse, plain
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
