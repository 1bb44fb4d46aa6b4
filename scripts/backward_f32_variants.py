#!/usr/bin/env python3
"""Variants of K4's float32 training backward kernel, timed on one GPU.

    python3 scripts/backward_f32_variants.py [--variants 8:32,16:32,8:32:dkdv,...]
                                              [--shapes 4x128x8x4x64,...] [--reps 20]

Each variant is ``csrc/flash_backward_f32.cu`` with its dK / dV block's
key-tile width ``BK`` and chunk rows ``RC`` replaced, optionally built
with one kind of block only (``dkdv``: the dQ blocks return at once;
``dq``: the dK / dV blocks do) or without the kernel's two-blocks-an-SM
register cap (``lb1``).  ``8:32`` is the shipped kernel.  All are
compiled at once, one ``nvcc`` each, into ``build/backward_f32_variants/``, each in a
namespace of its own (a template's function-local statics are unique
across the process, so two libraries of one namespace would share the
kernel's set-once shared-memory attribute), loaded with ``ctypes`` and
launched through the shipped C interface on K4's own forward output and
lse at each shape ``BxTxHxKVxD`` (causal; ``nc`` at the end: not
causal).  A full variant's gradients are held to the plain backward
(relative L2, printed) and repeated bit for bit; a one-kind variant
writes only its own gradients, so only its time counts.  Times are
device ms per launch (``chip_smoke.time_ms``).  Prints one JSON line
and writes it to ``chiprun_out/backward_f32_variants.json``.
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
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (imports no kernel at import time)

CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(ROOT, "build", "backward_f32_variants")


def start_variant(spec: str):
    """Write variant ``BK:RC[:dkdv|dq|lb1]``'s source and start its
    ``nvcc``; returns ``(process, library path, kind)``."""
    from repro_torch.kernels import build

    bk, rc, *rest = spec.split(":")
    kind = rest[0] if rest else ""
    tag = re.sub(r"\W", "_", spec)
    src = open(os.path.join(CSRC, "flash_backward_f32.cu")).read()
    src = re.sub(r"constexpr int BK = \d+;", f"constexpr int BK = {int(bk)};", src)
    src = re.sub(r"constexpr int RC = \d+;", f"constexpr int RC = {int(rc)};", src)
    src = src.replace("flash_backward_f32::", f"fbv_{tag}::").replace(
        "namespace flash_backward_f32", f"namespace fbv_{tag}")
    if kind == "dkdv":
        src = src.replace("    dq_block<DP>(a, smem,", "    if (a.D < 0) dq_block<DP>(a, smem,")
    elif kind == "dq":
        src = src.replace("    dkdv_block<DP>(a, smem,", "    if (a.D < 0) dkdv_block<DP>(a, smem,")
    elif kind == "lb1":
        src = src.replace("__launch_bounds__(THREADS, 2)", "__launch_bounds__(THREADS, 1)")
    elif kind:
        raise ValueError(f"unknown variant kind {kind!r} in {spec!r}")
    d = os.path.join(OUT, tag)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "kernel.cu"), "w") as f:
        f.write(src)
    with open(os.path.join(CSRC, "flash_f32.cuh")) as f_in, \
            open(os.path.join(d, "flash_f32.cuh"), "w") as f_out:
        f_out.write(f_in.read())
    so = os.path.join(d, "kernel.so")
    proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", so,
                             os.path.join(d, "kernel.cu")], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, so, kind


def load_variant(spec: str, proc, so: str, kind: str):
    """Wait for the variant's build; returns ``(launch function,
    ptxas register / spill lines, kind)``."""
    from repro_torch.kernels import build

    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {spec}:\n{text}")
    regs = [line.strip() for line in text.splitlines() if "registers" in line or "spill" in line]
    fn = ctypes.CDLL(so).flash_backward_f32_launch
    fn.argtypes = build.LIBRARIES["flash_backward_f32"][1]["flash_backward_f32_launch"]
    fn.restype = ctypes.c_int
    return fn, regs, kind


def launch(fn, q, k, v, out, lse, do, causal: bool):
    import torch

    B, Tq, H, D = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Tq, Tk, H, KV, D,
            int(causal), 1.0 / D ** 0.5, torch.cuda.current_device(),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return dq, dk, dv


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default="8:32,8:32:dkdv,8:32:dq,16:32,8:64,16:64,8:32:lb1")
    ap.add_argument("--shapes", default="4x128x8x4x64,1x128x8x4x64,1x16x2x2x64")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))

    import torch

    if not torch.cuda.is_available():
        print("backward_f32_variants: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    started = {spec: start_variant(spec) for spec in args.variants.split(",") if spec}
    variants = {spec: load_variant(spec, *job) for spec, job in started.items()}
    result = {"card": chip_smoke.card_line(),
              "registers": {spec: regs for spec, (_, regs, _) in variants.items()}}
    for shape in args.shapes.split(","):
        causal = not shape.endswith("nc")
        B, T, H, KV, D = (int(x) for x in shape.removesuffix("nc").split("x"))
        gen = torch.Generator(device="cuda").manual_seed(T + D)
        q, do = (torch.randn((B, T, H, D), generator=gen, device="cuda") for _ in range(2))
        k, v = (torch.randn((B, T, KV, D), generator=gen, device="cuda") for _ in range(2))
        out, lse = FA.flash_attention_op(q, k, v, None, causal, 0, True, 512, 1024)
        plain = FA.flash_attention_backward_plain(q, k, v, out, lse, do, causal=causal)
        row = {}
        for spec, (fn, _, kind) in variants.items():
            got = launch(fn, q, k, v, out, lse, do, causal)
            entry = {"ms": chip_smoke.time_ms(lambda: launch(fn, q, k, v, out, lse, do, causal),
                                              args.reps)}
            if not kind or kind == "lb1":
                again = launch(fn, q, k, v, out, lse, do, causal)
                entry["l2_err"] = max(float((a - b).norm() / b.norm())
                                      for a, b in zip(got, plain))
                entry["bits_repeat"] = all(torch.equal(a, b) for a, b in zip(got, again))
            row[spec] = entry
        result[shape] = row
        chip_smoke.log(f"{shape}: {json.dumps(row)}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "backward_f32_variants.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
