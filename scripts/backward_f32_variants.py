#!/usr/bin/env python3
"""Variants of K4's float32 training backward kernel, timed on one GPU.

    python3 scripts/backward_f32_variants.py [--variants ship,ship:timer+phases,base/ship,...]
                                              [--shapes 4x128x8x4x64,...] [--reps 20]
                                              [--source FILE] [--baseline FILE]

Each variant is a copy of ``csrc/flash_backward_f32.cu`` (or of
``--source``; a spec that starts ``base/`` copies ``--baseline``, such as
an earlier version of the kernel, so that two versions are timed in turns
in one call).  ``BK:RC`` replaces the dK / dV block's key-tile width
``BK`` and chunk rows ``RC`` (``ship``: the source as it is).  Kinds,
joined by ``+`` after a second colon, change the copy:

* ``dkdv`` / ``dq``: one kind of block only (the other returns at once);
  ``empty``: both return at once (the launch alone);
* ``lb1``: no two-blocks-an-SM register cap;
* cuts of the dK / dV block's step of the 8-key design (one (row, key)
  pair a thread, no clusters; anchored on its text, so for a ``base/``
  copy of it; a cut whose anchor is missing fails the build): ``walk``
  keeps the chunk loads and barriers but no math; ``math`` keeps the
  math but stages chunk 0 once and reuses it at every step; ``score``
  keeps the score phase (s, dp, delta, p, ds) but not the sums;
  ``sums`` keeps the sums (dV += P^T dO, dK += dS^T Q) but not the
  score phase;
* changes and cuts of the clustered kernel: ``cl1`` / ``cl2`` clusters
  of 1 / 2 blocks; ``su2`` / ``mu2`` the score / sums loops unrolled 2
  deep; ``noload`` no row copies at all; ``noreduce`` no add of the
  cluster's shares; ``nosync`` (with ``noreduce``) no cluster barrier;
  ``noscore`` / ``nosums`` no score phase / no sums; ``nokv`` /
  ``noqo`` the score phase without its K / V or its Q / dO loads;
* ``timer``: every block records its start and end (``%globaltimer``),
  its cycles (``clock64``) and its SM; the script fits each kind of
  block's cycles against its steps (chunks of a dK / dV block, key tiles
  of a dQ block), and prints the cycles a step, the fixed cycles a block,
  the span from the first block's start to the last one's end, and the
  blocks that started after the first wave; ``phases`` (clustered
  kernel, with ``timer``) adds each kind's median cycles by steps a
  block: to the first step's barrier, the walk, the wait for the
  cluster's shares, their add, and the last barrier and exit.

All are compiled at once, one ``nvcc`` each, into
``build/backward_f32_variants/``, each in a namespace of its own (a
template's function-local statics are unique across the process, so two
libraries of one namespace would share the kernel's set-once
shared-memory attribute), loaded with ``ctypes`` and launched through the
shipped C interface on K4's own forward output and lse at each shape
``BxTxHxKVxD`` (causal; ``nc`` at the end: not causal).  A variant that
computes the whole function (no kind but ``lb1``, ``timer``,
``phases``, ``cl1`` / ``cl2`` or ``su2`` / ``mu2``) has its
gradients held to the plain backward (relative L2, printed) and repeated
bit for bit; the others write what their cut leaves, so only their time
counts.  Times are device ms per launch (``chip_smoke.time_ms``), taken
in ``--rounds`` rounds over the variants in turns (the order reversed
every other round).  Prints one JSON line and writes it to
``chiprun_out/backward_f32_variants.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (imports no kernel at import time)

CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(ROOT, "build", "backward_f32_variants")
MAX_TIMED = 16384  # blocks whose times a ``timer`` copy records

# the dK / dV step's score phase and sums, as the 8-key design writes
# them: each cut wraps one in a branch that never runs
_SCORE_OFF = [("    float s[SR], dp[SR], dl[SR];\n",
               "    if (a.D < 0) {\n    float s[SR], dp[SR], dl[SR];\n"),
              ("    __syncthreads();  // P and dS of the chunk are written\n",
               "    }\n    __syncthreads();  // P and dS of the chunk are written\n")]
_SUMS_OFF = [("#pragma unroll 2\n    for (int r = h; r < RC; r += RS) {\n",
              "    if (a.D < 0) {\n#pragma unroll 2\n    for (int r = h; r < RC; r += RS) {\n"),
             ("      dk[3] = fma4(ss.w, qq, dk[3]);\n    }\n",
              "      dk[3] = fma4(ss.w, qq, dk[3]);\n    }\n    }\n")]
_DQ_OFF = [("    dq_block<DP>(a, smem,", "    if (a.D < 0) dq_block<DP>(a, smem,")]
_DKDV_OFF = [("    dkdv_block<DP>(a, smem,", "    if (a.D < 0) dkdv_block<DP>(a, smem,")]
CUTS = {
    "dkdv": _DQ_OFF,
    "dq": _DKDV_OFF,
    "empty": _DQ_OFF + _DKDV_OFF,
    "lb1": [("__launch_bounds__(THREADS, 2)", "__launch_bounds__(THREADS, 1)")],
    "walk": _SCORE_OFF + _SUMS_OFF,
    "math": [("    if (ch + 1 < n_chunks) {\n      stage_chunk(ch + 1);",
              "    if (a.D < 0 && ch + 1 < n_chunks) {\n      stage_chunk(ch + 1);"),
             ("const float* Qc = St + (ch & 1) * 3 * RC * QS;", "const float* Qc = St;"),
             ("const float* Lc = Ls + (ch & 1) * RC;", "const float* Lc = Ls;")],
    "score": _SUMS_OFF,
    "sums": _SCORE_OFF,
    "cl1": [("constexpr int CL = 4;", "constexpr int CL = 1;")],
    "cl2": [("constexpr int CL = 4;", "constexpr int CL = 2;")],
    # cuts of the clustered kernel: no row copies at all (the
    # stages keep what they held), no add of the cluster's shares, no
    # cluster barrier (only with noreduce: no rank then reads another)
    "noload": [("  for (int c = part; c < per_row; c += 8) {",
                "  for (int c = part; c < per_row && D < 0; c += 8) {")],
    "noreduce": [("  if (u.live) cluster_reduce<", "  if (u.live && a.D < 0) cluster_reduce<")],
    "nosync": [("  if (u.split > 1) {\n    cluster.sync();",
                "  if (u.split > 1 && u.sub < 0) {\n    cluster.sync();")],
    # the score phase without its K / V loads, or without its Q / dO
    # loads (register values in their place)
    "nokv": [("      kk[i] = *reinterpret_cast<const float4*>(Kt + (k + 16 * i) * QS + 4 * d4);\n"
              "      vv[i] = *reinterpret_cast<const float4*>(Vt + (k + 16 * i) * QS + 4 * d4);",
              "      kk[i] = make_float4(__int_as_float(d4 + i), 1.f, 2.f, 3.f);\n"
              "      vv[i] = make_float4(3.f, __int_as_float(d4 - i), 1.f, 2.f);")],
    "noqo": [("      qq[i] = *reinterpret_cast<const float4*>(Qr + (r + 16 * i) * QS + 4 * d4);\n"
              "      gg[i] = *reinterpret_cast<const float4*>(dOr + (r + 16 * i) * QS + 4 * d4);",
              "      qq[i] = make_float4(__int_as_float(d4 + i), 1.f, 2.f, 3.f);\n"
              "      gg[i] = make_float4(3.f, __int_as_float(d4 - i), 1.f, 2.f);")],
    # no score phase (the sums read stale P and dS), or no sums
    "noscore": [("      score_step<DP, false>(", "      if (a.D < 0) score_step<DP, false>("),
                ("      score_step<DP, true>(", "      if (a.D < 0) score_step<DP, true>(")],
    "nosums": [("      for (int r = h; r < RC; r += RS) {",
                "      for (int r = h; r < (a.D < 0 ? RC : 0); r += RS) {"),
               ("      for (int j = h; j < BKQ; j += RSQ) {",
                "      for (int j = h; j < (a.D < 0 ? BKQ : 0); j += RSQ) {")],
    # the clustered kernel's score loop / sums loops unrolled 2 deep
    "su2": [("#pragma unroll 4\n  for (int d4 = 0; d4 < NCG; ++d4) {",
             "#pragma unroll 2\n  for (int d4 = 0; d4 < NCG; ++d4) {")],
    "mu2": [("#pragma unroll 4\n      for (int r = h; r < RC; r += RS) {",
             "#pragma unroll 2\n      for (int r = h; r < RC; r += RS) {"),
            ("#pragma unroll 4\n      for (int j = h; j < BKQ; j += RSQ) {",
             "#pragma unroll 2\n      for (int j = h; j < BKQ; j += RSQ) {")],
}
# phase marks in the clustered kernel: clock64 by thread 0 at
# the first step's barrier, after the walk, after the shares are written
# in every rank, and after this rank's reduce
_MARK = "if (threadIdx.x == 0 && blockIdx.x < {max}) fbv_marks[8 * blockIdx.x + {n}] = clock64();"
_PHASES = [
    ("      __syncthreads();  // chunk ch landed; every thread is done with chunk ch - 1\n",
     "      __syncthreads();  // chunk ch landed; every thread is done with chunk ch - 1\n"
     "      if (ch == lo) { MARK1 }\n"),
    ("      __syncthreads();  // tile `tile` landed; every thread is done with tile - 1 (and with O)\n",
     "      __syncthreads();  // tile `tile` landed; every thread is done with tile - 1 (and with O)\n"
     "      if (tile == lo) { MARK1 }\n"),
    ("  __syncthreads();  // every read of the stages is done\n",
     "  __syncthreads();  // every read of the stages is done\n  MARK2\n"),
    ("  cg::cluster_group cluster = cg::this_cluster();\n  const int tid = threadIdx.x;\n",
     "  MARK5\n  cg::cluster_group cluster = cg::this_cluster();\n  const int tid = threadIdx.x;\n"),
    ("  share_sync(cluster, u);  // every rank's shares are written\n",
     "  share_sync(cluster, u);  // every rank's shares are written\n  MARK3\n"),
    ("  share_sync(cluster, u);  // no rank leaves while another reads its shares\n",
     "  MARK4\n  share_sync(cluster, u);  // no rank leaves while another reads its shares\n"),
]
EXACT_KINDS = {"lb1", "timer", "phases", "cl1", "cl2", "su2", "mu2"}  # leave the function whole  # kinds that leave the function whole


def _replace(src: str, pairs, spec: str) -> str:
    for old, new in pairs:
        if old not in src:
            raise ValueError(f"{spec}: the cut's anchor {old.strip()[:60]!r} is not in the source")
        src = src.replace(old, new)
    return src


def _add_timer(src: str, ns: str, spec: str) -> str:
    """Record each block's start, end, cycles and SM into a device array,
    and add ``fbv_read_times`` to copy it out."""
    src = _replace(src, [(
        "using namespace flash_f32;\n",
        "using namespace flash_f32;\n"
        f"__device__ unsigned long long fbv_block_times[4 * {MAX_TIMED}];\n"
        f"__device__ long long fbv_marks[8 * {MAX_TIMED}];\n"
        "__device__ __forceinline__ unsigned long long fbv_now() {\n"
        "  unsigned long long t;\n"
        "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
        "  return t;\n"
        "}\n")], spec)
    kernel = re.search(r"(__global__ void __launch_bounds__\(THREADS, \d\) "
                       r"flash_backward_f32_kernel\(const Args a\) \{\n)", src)
    if kernel is None:
        raise ValueError(f"{spec}: the kernel's signature is not in the source")
    body_start = kernel.end()
    body_end = src.index("\n}\n", body_start)
    src = (src[:body_start]
           + "  const unsigned long long fbv_t0 = fbv_now();\n"
           + "  const long long fbv_c0 = clock64();\n"
           + f"  if (threadIdx.x == 0 && blockIdx.x < {MAX_TIMED}) fbv_marks[8 * blockIdx.x] = fbv_c0;\n"
           + src[body_start:body_end]
           + "\n  __syncthreads();\n"
           + f"  if (threadIdx.x == 0 && blockIdx.x < {MAX_TIMED}) {{\n"
           + "    const long long fbv_c1 = clock64();\n"
           + "    unsigned sm;\n"
           + "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
           + "    unsigned long long* t = fbv_block_times + 4 * blockIdx.x;\n"
           + "    t[0] = fbv_t0;\n    t[1] = fbv_now();\n"
           + "    t[2] = static_cast<unsigned long long>(fbv_c1 - fbv_c0);\n    t[3] = sm;\n"
           + "  }"
           + src[body_end:])
    return src + (
        "\nextern \"C\" int fbv_read_times(void* dst, int n) {\n"
        f"  return static_cast<int>(cudaMemcpyFromSymbol(dst, {ns}::fbv_block_times,\n"
        "                                                 sizeof(unsigned long long) * 4 * n));\n"
        "}\n"
        "\nextern \"C\" int fbv_read_marks(void* dst, int n) {\n"
        f"  return static_cast<int>(cudaMemcpyFromSymbol(dst, {ns}::fbv_marks,\n"
        "                                                 sizeof(long long) * 8 * n));\n"
        "}\n")


def parse(spec: str):
    """``([base/]BK:RC | [base/]ship)[:kind+kind...]`` as ``((BK, RC) or
    None, kinds)``."""
    parts = spec.removeprefix("base/").split(":")
    if parts[0] == "ship":
        tiles, rest = None, parts[1:]
    else:
        tiles, rest = (int(parts[0]), int(parts[1])), parts[2:]
    return tiles, [k for k in (rest[0].split("+") if rest else []) if k]


def variant_source(spec: str, source: str, baseline: str | None) -> str:
    body = spec
    if spec.startswith("base/"):
        if baseline is None:
            raise ValueError(f"{spec} needs --baseline")
        source, body = baseline, spec[len("base/"):]
    tiles, kinds = parse(spec)
    src = open(source).read()
    if tiles is not None:
        bk, rc = tiles
        src = re.sub(r"constexpr int BK = \d+;", f"constexpr int BK = {bk};", src)
        src = re.sub(r"constexpr int RC = \d+;", f"constexpr int RC = {rc};", src)
    ns = "fbv_" + re.sub(r"\W", "_", spec)
    src = src.replace("flash_backward_f32::", f"{ns}::").replace(
        "namespace flash_backward_f32", f"namespace {ns}")
    for kind in kinds:
        if kind in ("timer", "phases"):
            continue
        if kind not in CUTS:
            raise ValueError(f"unknown variant kind {kind!r} in {spec!r}")
        src = _replace(src, CUTS[kind], spec)
    if "phases" in kinds:
        if "timer" not in kinds:
            raise ValueError(f"{spec}: phases need the timer")
        for old, new in _PHASES:
            if old in src:
                for n in range(1, 6):
                    new = new.replace(f"MARK{n}", _MARK.format(max=MAX_TIMED, n=n))
                src = src.replace(old, new)
    if "timer" in kinds:
        src = _add_timer(src, ns, spec)
    return src


def start_variant(spec: str, source: str, baseline: str | None):
    """Write variant ``spec``'s source and start its ``nvcc``; returns
    ``(process, library path, kinds, grid constants)``."""
    from repro_torch.kernels import build

    src = variant_source(spec, source, baseline)
    d = os.path.join(OUT, re.sub(r"\W", "_", spec))
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "kernel.cu"), "w") as f:
        f.write(src)
    for name in os.listdir(CSRC):
        if name.endswith(".cuh"):
            with open(os.path.join(CSRC, name)) as f_in, \
                    open(os.path.join(d, name), "w") as f_out:
                f_out.write(f_in.read())
    so = os.path.join(d, "kernel.so")
    proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", so,
                             os.path.join(d, "kernel.cu")], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, so, set(parse(spec)[1]), grid_constants(src)


def load_variant(spec: str, proc, so: str, kinds, grid):
    """Wait for the variant's build; returns ``(library, ptxas register /
    spill lines, kinds, grid constants)``."""
    from repro_torch.kernels import build

    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {spec}:\n{text}")
    regs = [line.strip() for line in text.splitlines() if "registers" in line or "spill" in line]
    lib = ctypes.CDLL(so)
    lib.flash_backward_f32_launch.argtypes = \
        build.LIBRARIES["flash_backward_f32"][1]["flash_backward_f32_launch"]
    lib.flash_backward_f32_launch.restype = ctypes.c_int
    return lib, regs, kinds, grid


def launch(lib, q, k, v, out, lse, do, causal: bool):
    import torch

    B, Tq, H, D = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rc = lib.flash_backward_f32_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Tq, Tk, H, KV, D,
        int(causal), 1.0 / D ** 0.5, torch.cuda.current_device(),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return dq, dk, dv


def _fit(xs, ys) -> dict:
    """Least squares ``y = a + b x``; ``b`` per step, ``a`` fixed."""
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    b = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx if sxx else 0.0
    return {"per_step": b, "fixed": my - b * mx, "blocks": n, "steps": sum(xs),
            "max": max(ys)}


def grid_constants(src: str) -> dict:
    """The grid's tile constants as a source sets them (``CL`` 1 where it
    launches no clusters)."""
    got = {name: int(m.group(1)) for name in ("CL", "BK", "RC", "RQ", "BKQ")
           if (m := re.search(rf"constexpr int {name} = (\d+);", src))}
    got.setdefault("CL", 1)
    return got


def block_steps(B, Tq, Tk, H, KV, causal, CL, BK, RC, RQ, BKQ, n_sm=132):
    """The blocks of the grid in launch order, each as ``(kind, steps)``:
    a dK / dV block's chunks, a dQ block's key tiles.  Tiles in walk order
    (key tile 0 first, the last row tile first), each tile's walk of ``n``
    steps split over the fewest of ``CL``, ``CL / 2``, .., 1 ranks that
    keep a share within ``target`` steps (rank ``r`` of ``s``: steps ``[r
    n // s, (r + 1) n // s)``), the ranks of one tile over every head
    packed into clusters of ``CL``; ``target`` the fewest steps, from the
    longest walk over ``CL``, whose grid is at most 2.5 blocks an SM (as
    ``flash_attention.f32_backward_target``); the tiles by kind, split
    (widest first) and walk order, as the kernel lays its grid."""
    G = H // KV
    R = Tq * G
    n_kt, n_rt, heads = -(-Tk // BK), -(-R // RQ), B * KV
    kv = [-(-(R - (min(kt * BK * G, R) if causal else 0)) // RC) for kt in range(n_kt)]
    q = []
    for j in range(n_rt):
        last = min((n_rt - 1 - j) * RQ + RQ, R) - 1
        q.append(-(-(min(Tk, last // G + 1) if causal else Tk) // BKQ))
    def split_of(n, target):
        split = CL
        while split > 1 and n <= target * (split // 2):
            split //= 2
        return split

    def n_blocks(target):
        return sum(-(-heads * split_of(n, target) // CL) * CL for n in kv + q)

    lo, hi = max(1, -(-max(kv[0], q[0]) // CL)), max(1, kv[0], q[0])
    while lo < hi:
        mid = (lo + hi) // 2
        if n_blocks(mid) > 2 * n_sm + (2 * n_sm) // 4:
            lo = mid + 1
        else:
            hi = mid
    target = lo if CL > 1 else max(kv[0], q[0])
    units = []  # (kind, level, walk-order index, walk, split)
    for kind, walks in enumerate((kv, q)):
        for j, n in enumerate(walks):
            split = split_of(n, target)
            units.append((kind, CL // split, j, n, split))
    units.sort(key=lambda u: u[:3])  # kind, split (widest first), walk order
    blocks = []
    for kind, _, _, n, split in units:
        for g in range(-(-heads * split // CL) * CL):
            sub = g % split
            live = g // split < heads
            blocks.append(("dq" if kind else "dkdv",
                           (sub + 1) * n // split - sub * n // split if live else 0))
    return blocks


def read_timer(lib, n_blocks: int, steps, cluster: int = 1, phases: bool = False) -> dict:
    """The timer copy's record of its last launch, fitted per kind of
    block; with ``phases``, each kind's median cycles by steps a block:
    [to the first step's barrier, the walk, waiting for the cluster's
    shares, the reduce, the last cluster barrier and exit, to the block
    function's start (of the first), blocks]."""
    buf = (ctypes.c_ulonglong * (4 * n_blocks))()
    rc = lib.fbv_read_times(ctypes.cast(buf, ctypes.c_void_p), n_blocks)
    if rc != 0:
        raise RuntimeError(f"reading the block times failed: CUDA error {rc}")
    rec = [tuple(buf[4 * i:4 * i + 4]) for i in range(n_blocks)]
    marks = (ctypes.c_longlong * (8 * n_blocks))()
    if lib.fbv_read_marks(ctypes.cast(marks, ctypes.c_void_p), n_blocks) != 0:
        raise RuntimeError("reading the phase marks failed")
    t0 = min(r[0] for r in rec)
    first_end = min(r[1] for r in rec)
    starts = sorted((r[0] - t0) / 1e3 for r in rec)
    out = {"span_us": (max(r[1] for r in rec) - t0) / 1e3,
           "start_us_quartiles": [starts[int(f * (len(starts) - 1))] for f in (0.25, 0.5, 0.75, 1)],
           "late_blocks": sum(1 for r in rec if r[0] >= first_end),
           "sms": len({r[3] for r in rec}),
           "ns_per_cycle": statistics.median((r[1] - r[0]) / r[2] for r in rec if r[2] > 0)}
    if cluster > 1:  # how far apart the blocks of a cluster start, ns
        skew = [max(r[0] for r in rec[i:i + cluster]) - min(r[0] for r in rec[i:i + cluster])
                for i in range(0, n_blocks, cluster)]
        out["cluster_start_skew_ns"] = {"median": statistics.median(skew), "max": max(skew)}
    for kind in ("dkdv", "dq"):
        if phases:  # median cycles of each phase, by the block's steps
            by = {}
            for i, ((k, s), r) in enumerate(zip(steps, rec)):
                if k != kind:
                    continue
                m = list(marks[8 * i:8 * i + 6])
                walk0 = m[1] if m[1] else m[0]
                by.setdefault(s, []).append((walk0 - m[0], m[2] - walk0, m[3] - m[2],
                                             m[4] - m[3], r[2] - (m[4] - m[0]),
                                             m[5] - m[0] if m[5] else 0))
            out[kind + "_phases"] = {
                str(s): [statistics.median(x[j] for x in v) for j in range(6)] + [len(v)]
                for s, v in sorted(by.items())}
        pts = [(s, r[2]) for (k, s), r in zip(steps, rec) if k == kind]
        if pts:
            out[kind + "_cycles"] = _fit([p[0] for p in pts], [p[1] for p in pts])
            out[kind + "_last_end_us"] = max(r[1] - t0 for (k, _), r in zip(steps, rec)
                                             if k == kind) / 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default="ship,ship:timer+phases,ship:dkdv+timer,ship:dq+timer")
    ap.add_argument("--shapes", default="4x128x8x4x64,1x128x8x4x64,1x16x2x2x64")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--source", default=os.path.join(CSRC, "flash_backward_f32.cu"))
    ap.add_argument("--baseline", default=None,
                    help="another version of the kernel's source, for base/ variants")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))

    import torch

    if not torch.cuda.is_available():
        print("backward_f32_variants: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    specs = [spec for spec in args.variants.split(",") if spec]
    started = {spec: start_variant(spec, args.source, args.baseline) for spec in specs}
    variants = {spec: load_variant(spec, *job) for spec, job in started.items()}
    result = {"card": chip_smoke.card_line(),
              "registers": {spec: regs for spec, (_, regs, _, _) in variants.items()},
              "grid": {spec: grid for spec, (_, _, _, grid) in variants.items()}}
    for shape in args.shapes.split(","):
        causal = not shape.endswith("nc")
        B, T, H, KV, D = (int(x) for x in shape.removesuffix("nc").split("x"))
        gen = torch.Generator(device="cuda").manual_seed(T + D)
        q, do = (torch.randn((B, T, H, D), generator=gen, device="cuda") for _ in range(2))
        k, v = (torch.randn((B, T, KV, D), generator=gen, device="cuda") for _ in range(2))
        out, lse = FA.flash_attention_op(q, k, v, None, causal, 0, True, 512, 1024)
        plain = FA.flash_attention_backward_plain(q, k, v, out, lse, do, causal=causal)
        row = {spec: {"ms": []} for spec in specs}
        for spec, (lib, _, kinds, _) in variants.items():
            got = launch(lib, q, k, v, out, lse, do, causal)
            if kinds <= EXACT_KINDS:
                again = launch(lib, q, k, v, out, lse, do, causal)
                row[spec]["l2_err"] = max(float((a - b).norm() / b.norm())
                                          for a, b in zip(got, plain))
                row[spec]["bits_repeat"] = all(torch.equal(a, b) for a, b in zip(got, again))
            if "timer" in kinds:
                torch.cuda.synchronize()
                steps = block_steps(B, T, T, H, KV, causal, **variants[spec][3])
                if len(steps) <= MAX_TIMED:
                    row[spec]["timer"] = read_timer(lib, len(steps), steps,
                                                    variants[spec][3]["CL"], "phases" in kinds)
        for r in range(args.rounds):
            for spec in (specs if r % 2 == 0 else specs[::-1]):
                lib = variants[spec][0]
                row[spec]["ms"].append(chip_smoke.time_ms(
                    lambda: launch(lib, q, k, v, out, lse, do, causal), args.reps))
        result[shape] = row
        chip_smoke.log(f"{shape}: {json.dumps(row)}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "backward_f32_variants.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
