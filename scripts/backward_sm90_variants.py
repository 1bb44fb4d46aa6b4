#!/usr/bin/env python3
"""K4's bf16 training backward (the long route) timed in turns on one GPU:
the shipped wgmma kernels against builds of other plans.

    python3 scripts/backward_sm90_variants.py [--variants ship,keys64,st2,...]
        [--shapes glm4,granite] [--rounds 2] [--reps 20] [--splits 1,2,4,8]
        [--kernels]

Each variant is a copy of ``csrc/flash_backward.cu`` whose plan
constants (``Config<DP>``'s ``KEYS``, ``STAGES``, ``DQ_KEYS``) are set
to the variant's values, written and built with ``nvcc`` into a library
of its own under ``build/backward_variants/`` (every build started at
once) with the shipped flags:

  ship        the source as shipped
  keys64 / keys128
              ``KEYS`` = 64 or 128 keys a dK / dV block (one or two
              consumer warpgroups)
  st2 / st3 / st4
              ``STAGES``: stages of the Q / dO ring (and of the dQ
              kernel's K / V ring, as many as fit)
  dq64 / dq128
              ``DQ_KEYS`` = 64 or 128 keys a K / V tile of the dQ kernel
  d64:KIND / d128:KIND
              KIND at head dim 64 (or 128) only (``d64:keys128``); the
              other head dim keeps the shipped value
  A+B         both (``keys64+st2``)
  NAME=PATH   a library built from another source file with the same C
              entry points, with the headers of this checkout's ``csrc/``

Shapes are ``chip_smoke``'s long-route backward rows: glm4-9b's training
attention, q ``(1, 4096, 32, 128)`` over 2 kv heads (``glm4``), and
granite's, q ``(1, 4096, 24, 64)`` over 8 (``granite``), causal, on K4's
own forward output and lse.  Every variant is first held to the plain
backward and to the tiled mirror of the shipped plan as ``chip_smoke.py``
holds the kernels (``chip_smoke.backward_errors``: a variant's other tiles
change only the order of fp32 sums), and to itself on a second run, bit
for bit; then each round times every variant at every shape through
``_launch_backward`` (device ms, CUDA events over ``--reps`` calls: row
statistics, dK / dV, dQ and, where the rows are split, the reduce), the
variants in one order and the next round in the reverse order.
``--splits`` also times each variant at each count of row runs a key tile
(the wrapper's ``backward_splits`` replaced; the default is the plan's).
``--kernels`` splits the first variant's call among its kernels (device
time by kernel name in one ``torch.profiler`` trace of the wrapper).  The
variant's library replaces the loaded ``flash_backward`` library under the
wrapper.  Prints the card, each variant's ptxas lines for the long
route's kernels, and one JSON line.  To time the parent's kernels in
turns, run ``scripts/k4_times.py --src <parent checkout>/src --rows
backward`` beside this checkout's.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (imports no kernel at import time)

OUT = os.path.join(ROOT, "build", "backward_variants")
# the plan constant a kind sets, and its value
KINDS = {
    "ship": None,
    "keys64": ("KEYS", 64), "keys128": ("KEYS", 128),
    "st2": ("STAGES", 2), "st3": ("STAGES", 3), "st4": ("STAGES", 4),
    "dq64": ("DQ_KEYS", 64), "dq128": ("DQ_KEYS", 128),
}
# (B, T, H, KV, D)
SHAPES = {"glm4": (1, 4096, 32, 2, 128), "granite": (1, 4096, 24, 8, 64)}
LONG_KERNELS = ("rowstat_kernel", "dkdv_sm90_kernel", "dq_sm90_kernel", "reduce_kernel")


def plan_source(spec: str) -> str:
    """``csrc/flash_backward.cu`` with ``Config<DP>``'s plan constants set
    as ``spec`` asks: each constant becomes ``DP == 64 ? a : b``, the head
    dims the spec leaves alone keeping the wrapper's mirrored values."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA

    plan = {"KEYS": dict(FA._BWD_SM90_KEYS),
            "STAGES": dict.fromkeys((64, 128), FA._BWD_SM90_STAGES),
            "DQ_KEYS": dict.fromkeys((64, 128), FA._BWD_SM90_DQ_KEYS)}
    for part in spec.split("+"):
        dims, kind = ((int(part[1:part.index(":")]),), part.split(":")[1]) if part.startswith(
            ("d64:", "d128:")) else ((64, 128), part)
        if KINDS[kind] is not None:
            name, value = KINDS[kind]
            plan[name].update(dict.fromkeys(dims, value))
    src = (build.CSRC / "flash_backward.cu").read_text()
    for name, by_dim in plan.items():
        src, n = re.subn(rf"static constexpr int {name} = [^;]+;",
                         f"static constexpr int {name} = DP == 64 ? {by_dim[64]} : {by_dim[128]};",
                         src)
        if n != 1:
            raise RuntimeError(f"Config<DP>'s {name} is not one constant of flash_backward.cu")
    return src


def build_variants(variants: list) -> dict:
    """Every variant's library, built at once; name -> (path, ptxas lines)."""
    from repro_torch.kernels import build

    os.makedirs(OUT, exist_ok=True)
    csrc = str(build.CSRC)
    procs = {}
    for name in variants:
        stem = re.sub(r"[^A-Za-z0-9]+", "_", name.split("=", 1)[0])
        if "=" in name:
            label, source = name.split("=", 1)
        elif name == "ship":
            label, source = name, os.path.join(csrc, "flash_backward.cu")
        else:
            label, source = name, os.path.join(OUT, f"flash_backward_{stem}.cu")
            with open(source, "w") as f:
                f.write(plan_source(name))
        lib = os.path.join(OUT, f"lib_{stem}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-I{csrc}", "-o", lib, source]
        procs[label] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    built = {}
    for label, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{text[-4000:]}")
        lines, keep = [], False
        for ln in text.splitlines():
            if "Compiling entry" in ln:
                keep = any(k in ln for k in LONG_KERNELS)
                name = next((k for k in LONG_KERNELS if k in ln), "")
                m = re.search(r"ILi(\d+)E", ln)
                if keep:
                    lines.append(f"{name}<{m.group(1)}>" if m else name)
            elif keep and any(w in ln for w in ("registers", "spill")):
                lines.append(ln.strip())
        built[label] = (lib, lines)
    return built


def use_library(path: str) -> None:
    """Make ``path`` the ``flash_backward`` library the wrapper launches."""
    from repro_torch.kernels import build

    lib = ctypes.CDLL(path)
    for fn, argtypes in build.LIBRARIES["flash_backward"][1].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    build._LOADED["flash_backward"] = lib


def inputs(shape: str, seed: int):
    import torch

    from repro_torch.kernels import flash_attention as FA

    B, T, H, KV, D = SHAPES[shape]
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v = randn(B, T, H, D), randn(B, T, KV, D), randn(B, T, KV, D)
    do = randn(B, T, H, D)
    out, lse = FA.flash_attention_op(q, k, v, None, True, 0, True, 512, 1024)
    return q, k, v, out, lse, do


def kernel_times(FA, data, reps: int) -> dict:
    """Device ms of each long-route kernel in one call of the wrapper:
    ``reps`` calls of ``_launch_backward`` in one ``torch.profiler`` trace,
    kernel time summed by name over the calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    FA._launch_backward(*data, True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            FA._launch_backward(*data, True)
        torch.cuda.synchronize()
    ms = {}
    for e in prof.key_averages():
        kernel = next((k for k in LONG_KERNELS if k in e.key), None)
        if e.device_type == DeviceType.CUDA and kernel and "flash_backward" in e.key:
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            ms[kernel] = ms.get(kernel, 0.0) + us / 1e3 / reps
    if not {"rowstat_kernel", "dkdv_sm90_kernel", "dq_sm90_kernel"} <= set(ms):
        raise RuntimeError(f"the trace holds no device time of the long route's kernels: {ms}")
    return ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default="ship")
    ap.add_argument("--shapes", default="glm4,granite")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--splits", default="",
                    help="comma-separated dK / dV row-run counts each variant is also timed at")
    ap.add_argument("--kernels", action="store_true",
                    help="also split the first variant's call among its kernels")
    args = ap.parse_args()
    variants = [v for v in args.variants.split(",") if v]
    shapes = [s for s in args.shapes.split(",") if s]
    splits = [int(n) for n in args.splits.split(",") if n]
    unknown = sorted(set(shapes) - set(SHAPES))
    if unknown:
        ap.error(f"unknown shapes {unknown}: pick from {', '.join(SHAPES)}")

    import torch

    if not torch.cuda.is_available():
        print("backward_sm90_variants: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_attention as FA

    print(chip_smoke.card_line(), flush=True)
    built = build_variants(variants)
    labels = list(built)
    for label, (_, lines) in built.items():
        for ln in lines:
            print(f"{label}: {ln[:160]}")
    data = {s: inputs(s, args.seed) for s in shapes}
    refs = {}
    for s in shapes:
        q, k, v, out, lse, do = data[s]
        refs[s] = (FA.flash_attention_backward_plain(q, k, v, out, lse, do, causal=True),
                   FA.flash_attention_backward_tiled_plain(q, k, v, out, lse, do, causal=True))
    checks, refused = {}, {}
    for label in labels:
        use_library(built[label][0])
        for s in shapes:
            try:
                got = FA._launch_backward(*data[s], True)[:3]
                again = FA._launch_backward(*data[s], True)[:3]
            except RuntimeError as e:  # a launch the card refuses (shared memory, ...)
                refused[f"{label}/{s}"] = str(e)
                print(f"{label} at {s}: {e}", flush=True)
                continue
            errors = chip_smoke.backward_errors(got, *refs[s])
            errors["bits_repeat"] = all(torch.equal(a, b) for a, b in zip(got, again))
            if not (errors["ok"] and errors["bits_repeat"]):
                raise AssertionError(f"{label} at {s}: {errors}")
            checks[f"{label}/{s}"] = errors
    chosen = FA.backward_splits
    counts = [None] + splits
    ms = {label: {f"{s}" + (f"/s{n}" if n else ""): [] for s in shapes for n in counts
                  if f"{label}/{s}" not in refused} for label in labels}
    try:
        for r in range(args.rounds):
            for label in (labels if r % 2 == 0 else labels[::-1]):
                use_library(built[label][0])
                for s in shapes:
                    if f"{label}/{s}" in refused:
                        continue
                    for n in counts:
                        FA.backward_splits = chosen if n is None else (
                            lambda *a, n=n, **kw: n)
                        ms[label][f"{s}" + (f"/s{n}" if n else "")].append(chip_smoke.time_ms(
                            lambda: FA._launch_backward(*data[s], True), args.reps))
            print(f"round {r}: " + json.dumps({lb: {k: t[-1] for k, t in ms[lb].items()}
                                               for lb in labels}), flush=True)
    finally:
        FA.backward_splits = chosen
    kernels = {}
    if args.kernels:
        use_library(built[labels[0]][0])
        kernels = {s: kernel_times(FA, data[s], args.reps) for s in shapes}
        print(f"kernels ({labels[0]}): {json.dumps(kernels)}", flush=True)
    print(json.dumps({"card": chip_smoke.card_line(), "ms": ms, "kernels": kernels,
                      "checks": checks, "refused": refused,
                      "ptxas": {lb: built[lb][1] for lb in labels}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
