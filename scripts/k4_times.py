#!/usr/bin/env python3
"""K4's kernels at the main paths' shapes on one GPU.

    python3 scripts/k4_times.py [--src DIR] [--reps N] [--rows main,f32_lm100m,backward_f32,...]

Runs ``chip_smoke``'s K4 rows alone, without the graph phases, the
served models and the training runs, each held to the plain version as
``chip_smoke.py`` holds it and timed in device milliseconds beside its
library call.  ``--rows`` picks the rows (default: all):

  main        glm4-9b's 4096-token causal prefill (q ``(1, 4096, 32,
              128)`` over a ``(1, 4128, 2, 128)`` cache) and its decode
              step (q ``(8, 1, 32, 128)`` over four distinct caches in
              turn, cold in L2): ``chip_smoke.k4_rows``
  granite     the same two rows at granite-moe-3b-a800m's heads (24 over
              8, D = 64)
  moonshot    the same two rows at moonshot-v1-16b-a3b's (16 over 16,
              D = 128)
  lse         the bf16 prefill with lse (the training forward) at glm4-9b's
              training attention, q ``(1, 4096, 32, 128)`` over 2 kv heads,
              and granite's, q ``(1, 4096, 24, 64)`` over 8:
              ``chip_smoke.k4_lse_row``
  f32_lm100m  the float32 kernel with lse at lm-100m's training shape, q
              ``(4, 128, 8, 64)`` over 4 kv heads: ``chip_smoke.k4_lse_row``
  sasrec      the bf16 prefill with lse at SASRec's training shape, q
              ``(65536, 50, 1, 50)``, and without lse at ``serve_bulk``'s
              262,144 sequences
  backward    the training backward (``csrc/flash_backward.cu``) at
              glm4-9b's training shape, q ``(1, 4096, 32, 128)`` over 2 kv
              heads, and granite's, q ``(1, 4096, 24, 64)`` over 8 (the
              long route), and SASRec's, q ``(65536, 50, 1, 50)`` (the
              short route): ``chip_smoke.k4_backward_row``; with
              ``--splits 1,2,...`` also the long route's time at each
              count of row runs a key tile (1: no split, the items only
              claimed longest first); and the plain backward's time at
              lm-100m's float32 q ``(4, 128, 8, 64)`` over 4 kv heads and
              at SASRec's, the shapes that ran it before their kernels
              (``plain_backward_ms``)
  backward_long  the long route's two rows of ``backward`` alone (glm4-9b's and
              granite's), without SASRec's row and the plain times
  backward_f32  the float32 training backward
              (``csrc/flash_backward_f32.cu``) at lm-100m's training
              shape, q ``(4, 128, 8, 64)`` over 4 kv heads:
              ``chip_smoke.k4_backward_row``, timed beside the plain
              backward, ``aten._scaled_dot_product_efficient_attention_backward``
              and its bound at the float32 rate

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so that two versions of the kernels can be
compared on one card back to back: run the parent, the change, the
change again and the parent.  Launch counts are not the main path's
here: each row's ``launches`` is 0.  Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (imports no kernel at import time)

ROWS = ("main", "granite", "moonshot", "lse", "f32_lm100m", "sasrec", "backward",
        "backward_long", "backward_f32")
SASREC_BULK = 262_144   # serve_bulk's users (configs/shapes.py's REC_SHAPES)


def lm_rows(arch, FA, reps: int, seed: int, tag: str) -> list:
    from repro_torch.configs import registry

    cfg = registry.get_arch(arch).CONFIG
    T, _, new_tokens = chip_smoke.LM_FULL
    return chip_smoke.k4_rows(T, T + new_tokens, cfg.n_heads, cfg.n_kv_heads,
                              cfg.resolved_head_dim, {key: 0 for key in FA.LAUNCHES}, reps,
                              seed=seed, tag=tag)


def lse_rows(reps: int, seed: int) -> list:
    import torch

    from repro_torch.configs import registry

    rows = []
    for arch, name in (("glm4-9b", "flash_attention_prefill_lse"),
                       ("granite-moe-3b-a800m", "flash_attention_prefill_lse_granite")):
        cfg = registry.get_arch(arch).CONFIG
        gen = torch.Generator(device="cuda").manual_seed(seed)
        hd = cfg.resolved_head_dim
        q, k, v = (torch.randn((1, 4096, h, hd), generator=gen, device="cuda").to(torch.bfloat16)
                   for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
        rows.append(chip_smoke.k4_lse_row(name, q, k, v, 0, reps))
        del q, k, v
    return rows


def lm100m_qkv(seed: int):
    """float32 q, k, v at lm-100m's training attention (4 x 128 tokens)."""
    import torch

    from repro_torch.launch.train_lm import model_100m

    cfg = model_100m(log=lambda line: None)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    hd = cfg.resolved_head_dim
    return tuple(torch.randn((4, 128, h, hd), generator=gen, device="cuda")
                 for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))


def f32_rows(reps: int, seed: int) -> list:
    return [chip_smoke.k4_lse_row("flash_attention_f32_lse", *lm100m_qkv(seed), 0, reps)]


def backward_f32_rows(reps: int, seed: int) -> list:
    return [chip_smoke.k4_backward_row("flash_attention_backward_f32", *lm100m_qkv(seed), 0, 0,
                                       reps)]


def sasrec_rows(reps: int, seed: int) -> list:
    import torch

    from repro_torch.configs import sasrec as sasrec_cfg

    rc = sasrec_cfg.CONFIG
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    shape = (65_536, rc.seq_len, 1, rc.d)
    v = randn(*shape)
    atol = 2.0 ** -8 * float(v.float().abs().max())  # chip_smoke's training_phase bound
    rows = [chip_smoke.k4_lse_row("flash_attention_prefill_lse_sasrec", randn(*shape),
                                  randn(*shape), v, 0, reps, atol=atol)]
    del v
    B = SASREC_BULK
    v = randn(B, rc.seq_len, 1, rc.d)
    rows.append(chip_smoke.k4_row(
        "flash_attention_prefill_sasrec_bulk", "flash_prefill.cu", randn(B, rc.seq_len, 1, rc.d),
        [(randn(B, rc.seq_len, 1, rc.d), v)], dict(causal=True, q_offset=0, kv_length=None),
        B * rc.seq_len * (rc.seq_len + 1) // 2, 0, reps,
        atol=2.0 ** -8 * float(v.float().abs().max()), library_parts=chip_smoke.LIBRARY_PARTS))
    return rows


def adapt_older_wrapper(FA) -> None:
    """Let this checkout's ``chip_smoke`` rows drive the wrapper of an
    older tree (``--src``): one whose ``backward_splits`` takes no head dim
    (the split rule before the wgmma long route) is called without it, and
    one without ``sm90_backward_plan`` records no plan."""
    import inspect

    if "D" not in inspect.signature(FA.backward_splits).parameters:
        splits = FA.backward_splits
        FA.backward_splits = lambda B, Tq, Tk, H, KV, n_sm=132, D=None: splits(
            B, Tq, Tk, H, KV, n_sm)
    if not hasattr(FA, "sm90_backward_plan"):
        FA.sm90_backward_plan = lambda *args, **kwargs: None


def backward_rows(reps: int, seed: int, splits: list, short: bool = True) -> list:
    import torch

    from repro_torch.configs import registry
    from repro_torch.configs import sasrec as sasrec_cfg
    from repro_torch.kernels import flash_attention as FA

    rc = sasrec_cfg.CONFIG
    shapes = [(registry.get_arch(arch).CONFIG, 1, 4096, name) for arch, name in (
        ("glm4-9b", "flash_attention_backward"),
        ("granite-moe-3b-a800m", "flash_attention_backward_granite"))]
    rows = []
    sasrec = [(None, 65_536, rc.seq_len, "flash_attention_backward_sasrec")] if short else []
    for cfg, B, T, name in shapes + sasrec:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        heads = (cfg.n_heads, cfg.n_kv_heads) if cfg else (1, 1)
        hd = cfg.resolved_head_dim if cfg else rc.d
        q, k, v = (torch.randn((B, T, h, hd), generator=gen, device="cuda").to(torch.bfloat16)
                   for h in (heads[0], heads[1], heads[1]))
        row = chip_smoke.k4_backward_row(name, q, k, v, 0, 0, reps)
        if cfg is None:   # the short route has no runs
            rows.append(row)
            del q, k, v
            continue
        out, lse = FA.flash_attention_op(q, k, v, None, True, 0, True, 512, 1024)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        chosen = FA.backward_splits
        by_splits = {}
        try:
            for n in splits:
                FA.backward_splits = lambda *a, n=n, **kw: n
                by_splits[n] = chip_smoke.time_ms(
                    lambda: FA._launch_backward(q, k, v, out, lse, do, True), reps)
        finally:
            FA.backward_splits = chosen
        row["shape"]["ms_by_splits"] = by_splits
        rows.append(row)
        del q, k, v, out, lse, do
    return rows


def plain_backward_ms(reps: int, seed: int) -> dict:
    """The plain backward's device ms a call at lm-100m's and SASRec's
    training attention (the routes the kernels do not take), timed as
    ``chip_smoke`` times a plain version."""
    import torch

    from repro_torch.configs import sasrec as sasrec_cfg
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.train_lm import model_100m

    cfg = model_100m(log=lambda line: None)
    rc = sasrec_cfg.CONFIG
    shapes = {"lm100m": ((4, 128, cfg.n_heads, cfg.resolved_head_dim),
                         (4, 128, cfg.n_kv_heads, cfg.resolved_head_dim), torch.float32),
              "sasrec": ((65_536, rc.seq_len, 1, rc.d), (65_536, rc.seq_len, 1, rc.d),
                         torch.bfloat16)}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out_ms = {}
    for name, (qs, ks, dtype) in shapes.items():
        q, do = (torch.randn(qs, generator=gen, device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn(ks, generator=gen, device="cuda").to(dtype) for _ in range(2))
        out, lse = FA.flash_attention_op(q, k, v, None, True, 0, True, 512, 1024)
        out_ms[name] = chip_smoke.time_ms(
            lambda: FA.flash_attention_backward_plain(q, k, v, out, lse, do, causal=True),
            max(2, reps // 4), 1)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    return out_ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--rows", default=",".join(ROWS),
                    help=f"comma-separated, of {', '.join(ROWS)}")
    ap.add_argument("--splits", default="",
                    help="comma-separated dK / dV row-run counts the backward rows also time")
    args = ap.parse_args()
    picked = [r for r in args.rows.split(",") if r]
    unknown = sorted(set(picked) - set(ROWS))
    if unknown:
        ap.error(f"unknown rows {unknown}: pick from {', '.join(ROWS)}")
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    if not torch.cuda.is_available():
        print("k4_times: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_attention as FA

    adapt_older_wrapper(FA)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows, extra = [], {}
    for name in picked:
        if name in ("main", "granite", "moonshot"):
            arch = {"main": "glm4-9b", "granite": "granite-moe-3b-a800m",
                    "moonshot": "moonshot-v1-16b-a3b"}[name]
            rows += lm_rows(arch, FA, args.reps, args.seed,
                            "" if name == "main" else f"_{name}")
        elif name == "lse":
            rows += lse_rows(args.reps, args.seed)
        elif name == "f32_lm100m":
            rows += f32_rows(args.reps, args.seed)
        elif name == "backward_f32":
            rows += backward_f32_rows(args.reps, args.seed)
        elif name in ("backward", "backward_long"):
            rows += backward_rows(args.reps, args.seed,
                                  [int(n) for n in args.splits.split(",") if n],
                                  short=name == "backward")
            if name == "backward":
                extra["plain_backward_ms"] = plain_backward_ms(args.reps, args.seed)
        else:
            rows += sasrec_rows(args.reps, args.seed)
        torch.cuda.empty_cache()
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    shape_keys = ("warm_ms", "bf16_excess_over_rtol", "excess_over_rtol", "lse_max_abs_err",
                  "plan", "library_parts", "splits", "ms_by_splits", "errors", "planted",
                  "bits_repeat", "library_note", "route")
    print(json.dumps({"src": os.path.relpath(os.path.abspath(args.src), ROOT),
                      "card": chip_smoke.card_line(), **extra,
                      **{r["name"]: {**{k: r[k] for k in keys},
                                     **{k: r["shape"][k] for k in shape_keys
                                        if k in r["shape"]}}
                         for r in rows}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
