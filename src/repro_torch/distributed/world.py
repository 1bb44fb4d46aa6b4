"""Process groups of the port's distributed paths.

The JAX package reads its place in a run from ``jax.process_index()`` /
``jax.process_count()`` and lets GSPMD insert the collectives; the port
reads them from ``torch.distributed`` and calls the collectives itself.
This module holds what every distributed path shares:

* :func:`rank_world` — a group's rank and size, ``(0, 1)`` when no group
  is initialised (a single process then runs every path alone);
* :func:`all_reduce`, :func:`all_gather_into`, :func:`reduce_scatter_into`
  — collectives that are no-ops without a group (the gather and the
  scatter call ``all_gather_into_tensor`` / ``reduce_scatter_tensor``,
  which every supported torch has);
* :func:`init_fake_group` — a fake group of any size in one process:
  every rank's collectives are shapes only (the dry-run's 256 / 512-rank
  worlds, which hold fake tensors);
* :func:`init_group` / :func:`spawn_world` — a group over a ``FileStore``
  (no network), and a local world of ``world`` processes that each run
  one function and hand back its result, joined under a timeout that
  kills every rank, so a hung rank fails its caller instead of stalling
  it.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "initialized",
    "rank_world",
    "all_reduce",
    "all_gather_into",
    "reduce_scatter_into",
    "init_fake_group",
    "init_group",
    "spawn_world",
    "WorldError",
]


class WorldError(RuntimeError):
    """A spawned world failed: a rank raised, died, or outlived its
    timeout (every rank is then killed)."""


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank_world(group=None) -> Tuple[int, int]:
    """``(rank, world size)`` of ``group`` (the default group for
    ``None``); ``(0, 1)`` when no process group is initialised."""
    if not initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """In-place all-reduce of ``t`` under a semiring add (``'sum'``,
    ``'min'`` or ``'max'``); ``t`` unchanged without a group.  Returns
    ``t``."""
    ops = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}
    if op not in ops:
        raise ValueError(f"no collective for semiring add {op!r}")
    if initialized():
        dist.all_reduce(t, op=ops[op], group=group)
    return t


def all_gather_into(out: torch.Tensor, inp: torch.Tensor, group=None) -> torch.Tensor:
    """Concatenate every rank's ``inp`` (equal sizes) into ``out`` in rank
    order; a copy without a group."""
    if initialized():
        dist.all_gather_into_tensor(out, inp, group=group)
    else:
        out.copy_(inp)
    return out


def reduce_scatter_into(out: torch.Tensor, inp: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``inp`` over the ranks and keep this rank's contiguous block of
    the sum in ``out``; a copy without a group."""
    if initialized():
        dist.reduce_scatter_tensor(out, inp, op=dist.ReduceOp.SUM, group=group)
    else:
        out.copy_(inp)
    return out


def init_group(backend: str, store_path: str, rank: int, world: int,
               timeout_s: float = 120.0) -> None:
    """Initialise the default process group over a ``FileStore`` at
    ``store_path`` (shared by every rank; no sockets are needed to meet).
    ``backend='nccl'`` binds this rank to ``cuda:rank`` first.  A failed
    init raises: there is no fallback to another backend."""
    import datetime

    if backend == "nccl":
        torch.cuda.set_device(rank)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def init_fake_group(world: int, rank: int = 0) -> None:
    """Initialise the default process group as ``torch.distributed``'s
    ``fake`` backend over a ``HashStore``: ``world`` ranks in this one
    process, seen from ``rank``.  Its collectives move no data (they give
    outputs of the right shapes), so a step over fake tensors runs as
    ``rank`` would run it in a real world of that size."""
    # the backend registers itself when its module is first imported
    import torch.testing._internal.distributed.fake_pg  # noqa: F401

    dist.init_process_group("fake", store=dist.HashStore(), rank=rank, world_size=world)


def _rank_main(fn, rank, world, backend, store_dir, args, threads):
    err = os.path.join(store_dir, f"error_{rank}.txt")
    try:
        torch.set_num_threads(threads)
        init_group(backend, os.path.join(store_dir, "store"), rank, world)
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(store_dir, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(err, "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_world(
    fn: Callable[..., Any],
    world: int,
    args: Sequence = (),
    backend: str = "gloo",
    timeout_s: float = 120.0,
    store_dir: Optional[str] = None,
    threads: int = 1,
) -> List[Any]:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes joined
    in one process group, and return the ranks' results in rank order.

    ``fn`` must be importable by name (a module-level function).  Each
    rank initialises the group over a ``FileStore`` in ``store_dir`` (a
    new temporary directory when ``None``), uses ``threads`` intra-op
    threads, and destroys its group when ``fn`` returns.  A rank that
    raises or dies fails the world at once: the others are killed (they
    would wait in a collective), and :class:`WorldError` carries the
    ranks' tracebacks.  So does a world still running after
    ``timeout_s``."""
    import multiprocessing as mp
    import shutil

    own_dir = store_dir is None
    store_dir = tempfile.mkdtemp(prefix="world-") if own_dir else store_dir
    os.makedirs(store_dir, exist_ok=True)
    for name in os.listdir(store_dir):
        if name == "store" or name.startswith(("result_", "error_")):
            os.remove(os.path.join(store_dir, name))
    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(target=_rank_main,
                    args=(fn, r, world, backend, store_dir, tuple(args), threads))
        for r in range(world)
    ]
    deadline = time.monotonic() + timeout_s
    timed_out = False
    try:
        for p in procs:
            p.start()
        # wait for every rank; stop at the first failure or the deadline
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.02)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
        errors = []
        for r, p in enumerate(procs):
            path = os.path.join(store_dir, f"error_{r}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if timed_out or errors:
            what = f"timed out after {timeout_s} s" if timed_out else "failed"
            raise WorldError(f"{world}-rank {backend} world {what}\n" + "\n".join(errors))
        results = []
        for r in range(world):
            with open(os.path.join(store_dir, f"result_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        if own_dir:
            shutil.rmtree(store_dir, ignore_errors=True)
