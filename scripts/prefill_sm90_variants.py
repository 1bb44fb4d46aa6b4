#!/usr/bin/env python3
"""K4's bf16 prefill kernels timed in turns on one GPU: the shipped sm90
route against its variants and against the mma.sync kernel it replaced.

    python3 scripts/prefill_sm90_variants.py [--variants ship,mma,bkv176,st2,...]
        [--shapes main,granite,moonshot,main_lse,granite_lse] [--rounds 2] [--reps 20]

Each variant is ``csrc/flash_prefill.cu`` built with ``nvcc`` into a
library of its own under ``build/prefill_variants/`` (every build started
at once), with the shipped flags plus the variant's defines:

  ship        the source as shipped (no define)
  mma         ``-DFLASH_PREFILL_SM90=0``: the mma.sync kernel on every
              straight call (its 64-key tiles, cp.async double buffering)
  bkv64 / bkv80 / bkv96 / bkv128 / bkv176
              ``FLASH_SM90_BKV_64`` and ``_128`` = 64, 80, 96, 128 or 176 keys
              a K / V tile
  st2 / st3   ``FLASH_SM90_STAGES_64`` and ``_128`` = 2 or 3 stages
  pp / nopp   ``FLASH_SM90_PINGPONG_64`` and ``_128`` = 1 or 0: ping-pong
              between the consumer warpgroups or not
  persistent / onegrid
              ``FLASH_SM90_PERSISTENT_64`` and ``_128`` = 1 or 0: one block
              an SM walking the items, or one block an item
  c2 / c3     ``FLASH_SM90_CONSUMERS_64`` = 2 or 3 consumer warpgroups (128
              or 192 query rows a block) at head dim 64
  d64:KIND / d128:KIND
              the define of KIND at head dim 64 (or 128) only
              (``d64:bkv176``)
  A+B         both (``bkv176+st2``)
  NAME=PATH   a library built from another source file (an older
              ``flash_prefill.cu``, e.g. ``git show <commit>:src/repro_torch/
              kernels/csrc/flash_prefill.cu > build/old.cu``, or a copy cut
              to attribute time, named in ``--cuts`` so that it is timed
              although its outputs are wrong), with the headers of this
              checkout's ``csrc/``

Shapes are ``chip_smoke``'s K4 prefill rows: glm4-9b's 4096-token causal
prefill, q ``(1, 4096, 32, 128)`` over a ``(1, 4128, 2, 128)`` cache with
4096 valid keys (``main``), granite's ``(1, 4096, 24, 64)`` over 8 kv heads
(``granite``), moonshot's ``(1, 4096, 16, 128)`` over 16 (``moonshot``),
and the training forwards with lse at glm4-9b's and granite's heads
(``main_lse``, ``granite_lse``: Tk = Tq = 4096, no cache).  Every variant
is first held to the plain version as ``chip_smoke.py`` holds the kernel
(``|err| <= K4_BF16_ATOL + K4_BF16_RTOL |plain|``); then each round times
every variant at every shape (device ms, CUDA events over ``--reps``
launches), the variants in one order and the next round in the reverse
order.  The variant's library replaces the loaded ``flash_prefill``
library under the wrapper, so the calls go through ``flash_attention`` as
the main path's do.  Prints the card, each variant's ptxas lines for the
prefill kernels, and one JSON line.
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

OUT = os.path.join(ROOT, "build", "prefill_variants")
KINDS = {
    "ship": [],
    "mma": ["-DFLASH_PREFILL_SM90=0"],
    "bkv64": ["-DFLASH_SM90_BKV_64=64", "-DFLASH_SM90_BKV_128=64"],
    "bkv80": ["-DFLASH_SM90_BKV_64=80", "-DFLASH_SM90_BKV_128=80"],
    "bkv96": ["-DFLASH_SM90_BKV_64=96", "-DFLASH_SM90_BKV_128=96"],
    "bkv128": ["-DFLASH_SM90_BKV_64=128", "-DFLASH_SM90_BKV_128=128"],
    "bkv176": ["-DFLASH_SM90_BKV_64=176", "-DFLASH_SM90_BKV_128=176"],
    "st2": ["-DFLASH_SM90_STAGES_64=2", "-DFLASH_SM90_STAGES_128=2"],
    "st3": ["-DFLASH_SM90_STAGES_64=3", "-DFLASH_SM90_STAGES_128=3"],
    "pp": ["-DFLASH_SM90_PINGPONG_64=1", "-DFLASH_SM90_PINGPONG_128=1"],
    "nopp": ["-DFLASH_SM90_PINGPONG_64=0", "-DFLASH_SM90_PINGPONG_128=0"],
    "persistent": ["-DFLASH_SM90_PERSISTENT_64=1", "-DFLASH_SM90_PERSISTENT_128=1"],
    "onegrid": ["-DFLASH_SM90_PERSISTENT_64=0", "-DFLASH_SM90_PERSISTENT_128=0"],
    "c2": ["-DFLASH_SM90_CONSUMERS_64=2"],
    "c3": ["-DFLASH_SM90_CONSUMERS_64=3"],
}
# (q shape, kv heads, cache length or None, with lse)
SHAPES = {
    "main": ((1, 4096, 32, 128), 2, 4128, False),
    "granite": ((1, 4096, 24, 64), 8, 4128, False),
    "moonshot": ((1, 4096, 16, 128), 16, 4128, False),
    "main_lse": ((1, 4096, 32, 128), 2, None, True),
    "granite_lse": ((1, 4096, 24, 64), 8, None, True),
}


def defines(spec: str) -> list:
    flags = []
    for part in spec.split("+"):
        if part.startswith(("d64:", "d128:")):
            dim, kind = part.split(":")
            flags += [f for f in KINDS[kind] if f"_{dim[1:]}=" in f]
        else:
            flags += KINDS[part]
    return flags


def build_variants(variants: list) -> dict:
    """Every variant's library, built at once; name -> (path, ptxas lines)."""
    from repro_torch.kernels import build

    os.makedirs(OUT, exist_ok=True)
    csrc = str(build.CSRC)
    procs = {}
    for name in variants:
        if "=" in name:
            label, source = name.split("=", 1)
            flags = []
        else:
            label, source = name, os.path.join(csrc, "flash_prefill.cu")
            flags = defines(name)
        lib = os.path.join(OUT, f"lib_{re.sub(r'[^A-Za-z0-9]+', '_', label)}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, *flags, f"-I{csrc}", "-o", lib, source]
        procs[label] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    built = {}
    for label, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{text[-4000:]}")
        lines = [ln.strip() for ln in text.splitlines()
                 if any(w in ln for w in ("Compiling entry", "registers", "spill", "arning"))]
        built[label] = (lib, lines)
    return built


def use_library(path: str) -> None:
    """Make ``path`` the ``flash_prefill`` library the wrapper launches."""
    from repro_torch.kernels import build

    lib = ctypes.CDLL(path)
    for fn, argtypes in build.LIBRARIES["flash_prefill"][1].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    build._LOADED["flash_prefill"] = lib


def inputs(shape: str, seed: int):
    import torch

    (B, T, H, D), KV, cache, lse = SHAPES[shape]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    Tk = cache or T

    def randn(*s):
        return torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v = randn(B, T, H, D), randn(B, Tk, KV, D), randn(B, Tk, KV, D)
    lengths = torch.full((B,), T, dtype=torch.int32, device="cuda") if cache else None
    return q, k, v, lengths, lse


def call(FA, q, k, v, lengths, lse):
    return FA._launch(q, k, v, True, 0, lengths, with_lse=lse)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default="ship,mma")
    ap.add_argument("--shapes", default="main,granite,moonshot")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--cuts", default="",
                    help="comma-separated labels of cut copies (NAME=PATH variants that "
                         "drop work to attribute time): timed although their outputs "
                         "disagree with the plain version")
    args = ap.parse_args()
    cuts = {c for c in args.cuts.split(",") if c}
    variants = [v for v in args.variants.split(",") if v]
    shapes = [s for s in args.shapes.split(",") if s]
    unknown = sorted(set(shapes) - set(SHAPES))
    if unknown:
        ap.error(f"unknown shapes {unknown}: pick from {', '.join(SHAPES)}")

    import torch

    if not torch.cuda.is_available():
        print("prefill_sm90_variants: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_attention as FA

    print(chip_smoke.card_line(), flush=True)
    built = build_variants(variants)
    labels = list(built)
    for label, (_, lines) in built.items():
        for ln in lines:
            print(f"{label}: {ln[:160]}")
    data = {s: inputs(s, args.seed) for s in shapes}
    checks, refused = {}, {}
    for label in labels:
        use_library(built[label][0])
        for s in shapes:
            q, k, v, lengths, lse = data[s]
            try:
                out, _ = call(FA, q, k, v, lengths, lse)
            except RuntimeError as e:  # a launch the card refuses (shared memory, ...)
                refused[f"{label}/{s}"] = str(e)
                print(f"{label} at {s}: {e}", flush=True)
                continue
            want = FA.flash_attention_plain(q, k, v, causal=True, kv_length=lengths)
            excess = float(((out.float() - want.float()).abs()
                            - chip_smoke.K4_BF16_RTOL * want.float().abs()).max())
            if not excess <= chip_smoke.K4_BF16_ATOL and label not in cuts:
                raise AssertionError(f"{label} at {s}: |err| exceeds the bound by "
                                     f"{excess - chip_smoke.K4_BF16_ATOL}")
            checks[f"{label}/{s}"] = excess
    ms = {label: {s: [] for s in shapes if f"{label}/{s}" not in refused} for label in labels}
    for r in range(args.rounds):
        for label in (labels if r % 2 == 0 else labels[::-1]):
            use_library(built[label][0])
            for s in ms[label]:
                q, k, v, lengths, lse = data[s]
                ms[label][s].append(chip_smoke.time_ms(
                    lambda: call(FA, q, k, v, lengths, lse), args.reps))
        print(f"round {r}: " + json.dumps({lb: {s: t[-1] for s, t in ms[lb].items()}
                                           for lb in labels}), flush=True)
    print(json.dumps({"card": chip_smoke.card_line(), "ms": ms, "excess_over_rtol": checks,
                      "refused": refused,
                      "ptxas": {lb: built[lb][1] for lb in labels}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
