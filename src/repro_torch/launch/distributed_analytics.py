"""Distributed condensed-graph analytics with a scripted worker failure.

    PYTHONPATH=src python -m repro_torch.launch.distributed_analytics --device cpu --world 4
    PYTHONPATH=src python -m repro_torch.launch.distributed_analytics --smoke

The port of the JAX package's ``examples/graph_analytics_distributed.py``
over ``torch.distributed``, step by step:

1. build the paper's graph (``configs/graphgen_paper.py``: App. C.2's
   ``layered_condensed`` at ``SMOKE``'s counts, or ``CONFIG``'s — paper
   Table 1, DBLP-2017 — with ``--smoke``) and its DEDUP-C correction;
2. PageRank on the whole graph on each rank: the reference;
3. edge-sharded ("flat") PageRank: the edges cut into 8 slices (4
   workers × 2 devices), ``8 / world`` per rank, one all-reduce per hop
   (:func:`~repro_torch.distributed.sharding.shard_condensed`);
4. banded PageRank over ``world × --bands-per-rank`` bands
   (:mod:`repro_torch.core.banding`): all-gather, reduce-scatter;
5. a :class:`~repro_torch.launch.orchestrator.Supervisor` declares worker
   3 dead on a scripted heartbeat timeline;
6. ``remesh_plan(devices_per_worker=2)`` gives the survivors' mesh;
7. the graph is sharded again onto the survivors' slice count, over the
   ranks that still host a live worker;
8. the answers equal the reference (``atol=1e-6``, and within
   ``VEC_RTOL`` of the reference's largest value): ``results identical``.

Ranks are processes of one group: NCCL on the card (the default; one
card per rank, so ``--world`` is at most the card count, and a failed
NCCL init raises), ``gloo`` with ``--device cpu``.  The banded answer
equals the reference only when its band count divides ``n_real``, as in
the JAX package (the bands pad the node axis otherwise).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

N_WORKERS = 4           # the scripted supervisor's workers
DEVICES_PER_WORKER = 2  # the example's (4 data x 2 model) mesh: 8 slices
FLAT_ATOL = 1e-6        # the example's bound
BANDED_ATOL = 1e-7      # tests/test_sharded_paths.py's bound
# The bounds above were set for graphs of ~1e4 nodes; PageRank values
# scale as 1 / n_real, so at CONFIG's 1.6M nodes (values near 6e-7) they
# would pass an answer that lost, say, the dangling mass.  Every answer
# is also held to max |diff| <= VEC_RTOL * max |reference|, a bound that
# shrinks with the vector.
VEC_RTOL = 1e-5


def build_graph(n_real: int, n_virtual: int, n_in_edges: int, seed: int = 0):
    """The paper's author -> publication graph at the config's counts:
    ``n_in_edges`` author -> pub edges (each pub drawn at least once)."""
    from ..data.synth import layered_condensed

    return layered_condensed(n_real, [n_virtual], [n_in_edges - n_virtual] * 2,
                             seed=seed, symmetric=True)


def scripted_failure():
    """The example's timeline: 4 workers heartbeat, worker 3 goes silent
    and is declared dead after two missed deadlines.  Returns the
    supervisor and its re-mesh plan for the survivors."""
    from .orchestrator import Heartbeat, Supervisor

    sup = Supervisor(n_workers=N_WORKERS, heartbeat_deadline=0.5, miss_limit=2,
                     model_parallel=DEVICES_PER_WORKER)
    now = 1000.0
    for w in range(N_WORKERS):
        sup.heartbeat(Heartbeat(w, step=100, wall_time=now))
    for t_off in (1.0, 2.0):
        for w in range(N_WORKERS - 1):
            sup.heartbeat(Heartbeat(w, step=101, wall_time=now + t_off))
        sup.check_deadlines(now + t_off)
    if sup.workers[N_WORKERS - 1].alive:
        raise AssertionError("the supervisor did not declare the silent worker dead")
    return sup, sup.remesh_plan(devices_per_worker=DEVICES_PER_WORKER)


def survivor_ranks(alive_workers, world: int):
    """The ranks that still host a live worker (worker ``w`` runs on rank
    ``w · world / N_WORKERS``)."""
    return sorted({w * world // N_WORKERS for w in alive_workers})


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device, iters: int):
    """``fn()`` twice: the first call builds the segment plans; the second
    gives the time per iteration (ms)."""
    _sync(device)
    t = time.perf_counter()
    fn()
    _sync(device)
    first = time.perf_counter() - t
    t = time.perf_counter()
    out = fn()
    _sync(device)
    return out, {"first_s": first, "ms_per_iter": (time.perf_counter() - t) * 1e3 / iters}


def _check(what: str, got: torch.Tensor, ref: torch.Tensor, atol: float) -> dict:
    """``got`` against ``ref``: max |diff| within both ``atol`` and
    ``VEC_RTOL · max |ref|``; raises otherwise."""
    d = float((got - ref).abs().max())
    bound = min(atol, VEC_RTOL * float(ref.abs().max()))
    if not d <= bound:
        raise AssertionError(f"{what} differs by {d:.3e} (bound {bound:.3e})")
    return {"max_abs_diff": d, "bound": bound}


def _print(msg: str) -> None:
    print(msg, flush=True)


def analytics(rank: int, world: int, cfg, bands_per_rank: int, device: str,
              seed: int = 0, log=_print) -> dict:
    """Steps 1-8 on this rank of the current group (one process alone
    without a group) at the counts of ``cfg`` (a
    :class:`~repro_torch.configs.graphgen_paper.GraphGenConfig`); returns
    the timings, the differences and the re-mesh.  Raises when an answer
    leaves its bound."""
    import torch.distributed as dist

    from ..core import algorithms, dedup, engine
    from ..core.banding import band_partition, make_banded_pagerank
    from ..distributed.sharding import shard_condensed
    from ..distributed.world import initialized

    n_real, iters = cfg.n_real, cfg.pagerank_iters
    n_slices = N_WORKERS * DEVICES_PER_WORKER
    if n_slices % world or N_WORKERS % world:
        raise ValueError(f"--world must divide {N_WORKERS} (the workers) and "
                         f"{n_slices} (the slices); got {world}")
    say = log if rank == 0 else (lambda *a: None)
    rec = {"world": world, "n_real": n_real, "iters": iters}

    t = time.perf_counter()
    g = build_graph(n_real, cfg.n_virtual, cfg.n_in_edges, seed)
    rec["graph_s"] = time.perf_counter() - t
    t = time.perf_counter()
    corr = dedup.build_correction(g)
    rec["correction_s"] = time.perf_counter() - t
    t = time.perf_counter()
    dev = engine.to_device(g, correction=corr, device=device)
    _sync(device)
    rec["upload_s"] = time.perf_counter() - t
    rec["correction_triples"] = int(len(corr[0]))
    say(f"graph: {g.n_real} real, {g.n_virtual} virtual, {g.n_edges_condensed} condensed "
        f"edges, {len(corr[0])} correction triples ({rec['graph_s']:.2f} s + "
        f"{rec['correction_s']:.2f} s)")

    # 2. the reference: the whole graph on one rank
    ref, rec["engine"] = _timed(lambda: algorithms.pagerank(dev, num_iters=iters), device, iters)

    # 3. edge-sharded PageRank over every rank
    sharded = shard_condensed(dev, None, n_slices // world)
    pr, rec["flat"] = _timed(lambda: algorithms.pagerank(sharded, num_iters=iters), device, iters)
    rec["flat"].update(_check("flat PageRank", pr, ref, FLAT_ATOL), slices=n_slices)
    say(f"flat PageRank on {n_slices} slices over {world} ranks: "
        f"{rec['flat']['ms_per_iter']:.3f} ms/iter; max |diff| vs one rank "
        f"{rec['flat']['max_abs_diff']:.2e}")
    del sharded

    # 4. banded PageRank
    n_bands = bands_per_rank * world
    t = time.perf_counter()
    deg = algorithms.out_degrees(dev).cpu().numpy()
    rec["degrees_s"] = time.perf_counter() - t
    t = time.perf_counter()
    banded = band_partition(g, corr, n_bands, deg)
    rec["band_partition_s"] = time.perf_counter() - t
    t = time.perf_counter()
    local = banded.local(rank, bands_per_rank, device)
    _sync(device)
    rec["band_upload_s"] = time.perf_counter() - t
    fn = make_banded_pagerank(None, banded.n_real, banded.n_virtual, n_bands, iters=iters)
    got, rec["banded"] = _timed(lambda: fn(local), device, iters)
    rec["banded"].update(bands=n_bands, divides=n_real % n_bands == 0)
    if rec["banded"]["divides"]:
        rec["banded"].update(_check("banded PageRank", got[:n_real], ref, BANDED_ATOL))
    else:  # the bands pad the node axis: a different answer, as in the JAX package
        rec["banded"]["max_abs_diff"] = float((got[:n_real] - ref).abs().max())
    say(f"banded PageRank on {n_bands} bands: {rec['banded']['ms_per_iter']:.3f} ms/iter; "
        f"max |diff| {rec['banded']['max_abs_diff']:.2e}")
    del local, banded

    # 5-6. a worker fails; the supervisor re-meshes the survivors
    sup, (shape, axes) = scripted_failure()
    rec["events"] = [list(e) for e in sup.events]
    rec["remesh"] = {"shape": list(shape), "axes": list(axes)}
    say(f"supervisor: worker {N_WORKERS - 1} declared dead; events={sup.events}")
    say(f"re-mesh plan on survivors: shape={shape} axes={axes}")

    # 7-8. the graph sharded again onto the survivors' slices
    ranks = survivor_ranks(sup.alive_workers, world)
    n_after = int(np.prod(shape))
    if n_after % len(ranks):
        raise ValueError(f"{n_after} slices do not divide over survivor ranks {ranks}")
    group = dist.new_group(ranks) if initialized() else None
    rec["survivors"] = {"ranks": ranks, "slices": n_after}
    if rank in ranks:
        sharded = shard_condensed(dev, group, n_after // len(ranks))
        pr2, timing = _timed(lambda: algorithms.pagerank(sharded, num_iters=iters),
                             device, iters)
        rec["survivors"].update(timing, **_check("PageRank on the survivors", pr2, ref,
                                                 FLAT_ATOL))
        say(f"flat PageRank on the survivors' {n_after} slices over ranks {ranks}: "
            f"{timing['ms_per_iter']:.3f} ms/iter")
        say("analysis resumed on the shrunken mesh; results identical")
    if initialized():
        dist.barrier()
    return rec


def _rank_main(rank, world, cfg, bands_per_rank, device, seed):
    dev = f"cuda:{rank}" if device == "cuda" else "cpu"
    return analytics(rank, world, cfg, bands_per_rank, dev, seed)


def main(argv=None) -> int:
    from ..configs.graphgen_paper import CONFIG, SMOKE
    from ..distributed.world import spawn_world

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=1, help="ranks (1, 2 or 4)")
    ap.add_argument("--bands-per-rank", type=int, default=None,
                    help="bands each rank owns (default: 8 bands in all)")
    ap.add_argument("--smoke", action="store_true",
                    help="the chip smoke's size: CONFIG's counts (paper Table 1, "
                         "DBLP-2017); without it, SMOKE's")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds before every rank is killed")
    args = ap.parse_args(argv)
    cfg = CONFIG if args.smoke else SMOKE
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
        if args.world > torch.cuda.device_count():
            raise RuntimeError(f"--world {args.world} needs {args.world} cards, "
                               f"found {torch.cuda.device_count()}")
    k = args.bands_per_rank or max(8 // args.world, 1)
    print(f"{cfg.name}: {args.world} rank(s) over "
          f"{'nccl' if args.device == 'cuda' else 'gloo'}")
    spawn_world(_rank_main, args.world, (cfg, k, args.device, args.seed),
                backend="nccl" if args.device == "cuda" else "gloo",
                timeout_s=args.timeout, threads=max(torch.get_num_threads() // args.world, 1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
