"""Dry-run: run every (arch x shape) cell once over fake tensors on a
production mesh of H100s and record its per-rank cost and roofline.

The port of the JAX package's ``launch/dryrun.py``.  Where the reference
lowers and compiles each cell for 512 forced host devices, the port runs
the cell's step once in this process, as rank 0 of a fake process group
of 256 (``--mesh single``, a ``(16, 16)`` mesh) or 512 ranks (``multi``,
``(2, 16, 16)``), over fake tensors that hold each rank's shard and no
memory, and counts what it dispatches
(:mod:`repro_torch.launch.op_cost`).  ``--mesh host`` is a one-rank mesh
over one device, on which the same cell can also run for real.  The
fake tensors lie on ``--device``: the card by default (the CLI refuses
without one), ``cpu`` when asked::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single \
        --cells sasrec:train_batch,graphgen-paper:pagerank:banded

Records land in ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``
(``__<variant>`` appended for a variant, ``__smoke`` for the ``SMOKE``
configs), in the reference's record
format plus ``nvlink_bytes`` / ``network_bytes``, and
:mod:`repro_torch.launch.report` renders them.  A cell whose Python loops
are long (an LM's layers and microbatches, a GNN's layers, PageRank's
iterations) is traced at a few small trip counts and fitted
(:func:`repro_torch.launch.op_cost.extrapolate`); the record says so
under ``trace``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch

from ..configs import registry
from ..distributed.sharding import use_mesh_rules
from . import cells as cells_lib
from . import roofline as rl
from .op_cost import OpCost, extrapolate, measure
from .report import RESULTS_DIR

__all__ = ["RESULTS_DIR", "make_mesh", "trace_points", "measure_cell", "run_cell", "save",
           "main"]

MESH_RANKS = {"single": 256, "multi": 512, "host": 1}
# an LM / GNN traced whole up to this many layers (PageRank: iterations)
FULL_TRACE_LAYERS = 3


def make_mesh(mesh_name: str, device_type: str):
    """The mesh of ``mesh_name`` over ``device_type``: ``single`` / ``multi``
    over a fake group of 256 / 512 ranks (initialised here, or
    re-initialised at that size), ``host`` over this process's one
    device."""
    from ..distributed.world import init_fake_group, initialized, rank_world
    from .mesh import make_production_mesh

    if mesh_name == "host":
        return _one_rank_mesh(device_type)
    world = MESH_RANKS[mesh_name]
    if initialized() and rank_world()[1] != world:
        import torch.distributed as dist

        dist.destroy_process_group()
    if not initialized():
        init_fake_group(world)
    return make_production_mesh(multi_pod=mesh_name == "multi", device_type=device_type)


def _one_rank_mesh(device_type: str):
    """A ``(1, 1)`` mesh of this process alone (no process group)."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, torch.zeros((1, 1), dtype=torch.int64),
                      mesh_dim_names=("data", "model"), _init_backend=False, _rank=0)


def trace_points(arch: str, shape: str, smoke: bool = False, depth: Optional[int] = None):
    """``(target, points)``: the (layers, microbatches) a cell runs, and
    the small ones to trace and fit, or ``None`` to trace it whole."""
    from ..configs import shapes as shp

    mod = registry.get_arch(arch)
    cfg = mod.SMOKE if smoke else mod.CONFIG
    fam = mod.SHAPE_FAMILY
    if fam == "recsys":
        return (None, None)
    layers = depth if depth is not None else (
        cfg.pagerank_iters if fam == "graphgen" else cfg.n_layers)
    mbs = 1
    if fam == "lm" and shp.LM_SHAPES[shape].kind == "train":
        mbs = cfg.microbatches
    target = (layers, mbs)
    if layers <= FULL_TRACE_LAYERS and mbs <= 2:
        return target, None
    ls = (1, 2, 3) if layers > FULL_TRACE_LAYERS else (layers,)
    ms = (2, 3) if mbs > 2 else (mbs,)
    return target, sorted((l, m) for l in ls for m in ms)


def measure_cell(cell: cells_lib.Cell, device_type: str) -> OpCost:
    """One trace of ``cell`` over fake tensors on its mesh."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        args = cells_lib.materialize(cell, device_type)
        with use_mesh_rules(cell.mesh, cell.rules), torch.no_grad() if cell.kind != "train" \
                else torch.enable_grad():
            cost, out = measure(cell.fn, args)
        del out
    return cost


def run_cell(arch: str, shape: str, mesh_name: str, device_type: str,
             verbose: bool = True, variant: Optional[str] = None, smoke: bool = False,
             depth: Optional[int] = None, batch: Optional[int] = None) -> Dict:
    """Trace one cell on ``mesh_name``'s mesh over ``device_type`` and
    return its record.  ``depth`` / ``batch`` cut a cell (layers, global
    batch) for a host mesh that one card holds."""
    mesh = make_mesh(mesh_name, device_type)
    n_chips = mesh.size()
    target, points = trace_points(arch, shape, smoke, depth)
    if mesh_name == "host":
        points = None         # one rank traces quickly, and the card checks it exactly
    t0 = time.time()

    def cost_at(d, m):
        cell = cells_lib.build_cell(arch, shape, mesh, smoke=smoke, variant=variant, depth=d,
                                    microbatches=m, batch=batch)
        return measure_cell(cell, device_type)

    if points is None:
        cost = cost_at(depth, None)
    else:
        costs = {p: cost_at(p[0], p[1] if target[1] > 1 else None) for p in points}
        cost = extrapolate(costs, target)
    t_trace = time.time() - t0
    report = rl.roofline_terms(arch, shape, mesh_name, n_chips, cost, rl.model_flops(arch, shape))
    rec = report.to_json()
    rec.update({
        "n_chips": n_chips,
        "lower_s": round(t_trace, 2),
        "compile_s": 0.0,
        "op_counts": dict(cost.op_counts),
        "trace": {"layers_microbatches": list(target) if target else None,
                  "fitted_from": [list(p) for p in points] if points else None,
                  "device_type": device_type, "depth": depth, "batch": batch,
                  "variant": variant, "smoke": smoke},
        "ok": True,
    })
    if verbose:
        print(f"[{arch} x {shape} x {mesh_name}] traced in {t_trace:.1f}s "
              f"({'fit of ' + str(points) if points else 'whole'})")
        print("  flops/device = %.3e, bytes/device = %.3e, peak = %.3e"
              % (cost.flops, cost.bytes, cost.peak_bytes))
        print(f"  roofline: compute {report.compute_s * 1e3:.3f}ms | memory "
              f"{report.memory_s * 1e3:.3f}ms | collective {report.collective_s * 1e3:.3f}ms "
              f"-> dominant: {report.dominant}; useful_flops_ratio "
              f"{report.useful_ratio:.3f}")
    return rec


def save(rec: Dict, arch: str, shape: str, mesh_name: str) -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = os.path.join(RESULTS_DIR, f"{arch}__{shape}__{mesh_name}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", help="architecture id (see configs.registry)")
    ap.add_argument("--shape", help="input-shape name for the arch family")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both", "host"])
    ap.add_argument("--all", action="store_true", help="all 40 assigned cells")
    ap.add_argument("--cells", default=None,
                    help="comma-separated arch:shape[:variant] cells to run")
    ap.add_argument("--include-paper", action="store_true",
                    help="also run the graphgen-paper analytics cell")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default=None,
                    help="optimization variant (e.g. a2a); result files get a suffix")
    ap.add_argument("--smoke", action="store_true", help="the SMOKE configs")
    ap.add_argument("--depth", type=int, default=None, help="cut the layers (host mesh)")
    ap.add_argument("--batch", type=int, default=None, help="cut the global batch (host mesh)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device the fake tensors lie on: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")

    if args.all:
        targets = [(a, s, args.variant) for a, s in cells_lib.all_cells()]
        if args.include_paper:
            targets.append(("graphgen-paper", "pagerank", args.variant))
    elif args.cells:
        targets = [tuple(c.split(":")) + (None,) * (3 - len(c.split(":")))
                   for c in args.cells.split(",")]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all or --cells")
        targets = [(args.arch, args.shape, args.variant)]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = []
    for mesh_name in meshes:
        for arch, shape, variant in targets:
            tag = "__".join([mesh_name] + [t for t in (variant, "smoke" if args.smoke else None)
                                           if t])
            out = os.path.join(RESULTS_DIR, f"{arch}__{shape}__{tag}.json")
            if args.skip_existing and os.path.exists(out):
                with open(out) as f:
                    if json.load(f).get("ok"):
                        print(f"[skip] {arch} x {shape} x {mesh_name}")
                        continue
            try:
                rec = run_cell(arch, shape, mesh_name, args.device, variant=variant,
                               smoke=args.smoke, depth=args.depth, batch=args.batch)
            except Exception as e:  # noqa: BLE001 - recorded, and the run fails
                traceback.print_exc()
                rec = {"ok": False, "error": f"{type(e).__name__}: {e}",
                       "arch": arch, "shape": shape, "mesh": mesh_name}
                failures.append((arch, shape, mesh_name))
            save(rec, arch, shape, tag)
    if failures:
        print("FAILURES:", failures)
        return 1
    print("all dry-run cells OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
