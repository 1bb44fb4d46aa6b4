"""Training launcher: ``--arch <id>`` end-to-end training on one device,
or an LM over the ranks of a process group.

The port of the JAX package's ``launch/train.py``, with its flags and its
three families (the LMs, dense and MoE; SASRec; the GNNs) at their
``SMOKE`` configs.  One process trains on one device (``--device``, the
card by default; ``--device cpu`` runs the plain attention), under
``use_mesh_rules(make_host_mesh(), cfg.sharding_rules)`` as the
reference trains: the host mesh is ``(n, 1)`` over an initialised
process group's ranks, one rank without one.
The port's :class:`~repro_torch.launch.orchestrator.Supervisor` decides
when to checkpoint and :class:`~repro_torch.train.checkpoint.CheckpointManager`
writes the reference's checkpoint layout, so ``--resume`` also takes a
checkpoint the JAX package wrote.  ``--smoke`` is kept as the reference
has it (``store_true`` with ``default=True``: the full config is not
reachable from the command line).  Example::

    PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b --steps 20 \\
        --device cpu --checkpoint-dir /tmp/ckpt

Under a process group (one that is initialised already, or the one that
``torch.distributed.run``'s environment describes, which :func:`main`
initialises: NCCL with one card per rank, gloo with ``--device cpu``)::

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \\
        -m repro_torch.launch.train --arch glm4-9b --device cpu

an LM's state is distributed by ``cfg.sharding_rules`` over
:func:`~repro_torch.launch.mesh.make_host_mesh` (each param a DTensor,
the optimizer state placed as its param), each rank feeds its rows of
every batch (every rank draws the same global batch from the seeded
pipeline), a checkpoint is gathered and written by rank 0, and
``--resume`` restores it with ``shardings=``.  SASRec and the GNNs train
on one rank only: their sharded steps come with the dry-run cells
(ROADMAP.md Queue 1 item 2).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..configs import registry
from ..data.pipeline import TokenPipeline, sasrec_batches
from ..distributed import sharding
from ..distributed.sharding import use_mesh_rules
from ..distributed.world import initialized, rank_world
from ..launch.mesh import make_host_mesh
from ..launch.orchestrator import Supervisor
from ..models import gnn, sasrec, transformer
from ..train import optimizer as opt_lib
from ..train import steps as steps_lib
from ..train.checkpoint import CheckpointManager

__all__ = ["build_lm_training", "build_sasrec_training", "build_gnn_training", "main"]


def _generator(device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


def build_lm_training(cfg, smoke_batch=4, smoke_seq=32, device="cuda"):
    """``(state, step_fn, batches)`` for an LM: float32 params drawn
    from seed 0, AdamW on the reference's cosine schedule, Zipf token
    batches of ``smoke_batch x smoke_seq``."""
    optimizer = opt_lib.adamw(opt_lib.cosine_schedule(3e-4, 20, 1000))
    params = transformer.init_params(cfg, _generator(device), device,
                                     dtype=transformer.torch_dtype(cfg.param_dtype))
    state = steps_lib.init_train_state(params, optimizer)
    step_fn = steps_lib.build_lm_train_step(cfg, optimizer)
    pipe = iter(TokenPipeline(cfg.vocab_size, smoke_seq, smoke_batch).device_iter(device))
    return state, step_fn, pipe


def build_sasrec_training(cfg, batch=8, device="cuda"):
    """``(state, step_fn, batches)`` for SASRec: AdamW at 1e-3, uniform
    sequences of ``batch`` users."""
    optimizer = opt_lib.adamw(1e-3)
    state = steps_lib.init_train_state(sasrec.init_params(cfg, _generator(device), device),
                                       optimizer)
    step_fn = steps_lib.build_sasrec_train_step(cfg, optimizer)
    it = sasrec_batches(cfg.n_items, cfg.seq_len, batch)
    pipe = ({k: torch.from_numpy(v).to(device) for k, v in b.items()} for b in it)
    return state, step_fn, pipe


def build_gnn_training(cfg, device="cuda"):
    """``(state, step_fn, batch)`` for a GNN on the reference's smoke graph:
    4 molecules of 8 atoms for SchNet / DimeNet, else a 64-node random
    graph with positions; 6 input features, zero targets."""
    from ..data.graphs import batch_molecules, graph_batch_from_numpy, random_graph

    optimizer = opt_lib.adamw(1e-3)
    if cfg.kind in ("schnet", "dimenet"):
        g = batch_molecules(4, 8, 20, d_feat=6, seed=1, device=device)
        target = np.zeros((4, cfg.d_out), np.float32)
    else:
        src, dst, feats, pos = random_graph(64, 200, 6, seed=1, with_positions=True)
        g = graph_batch_from_numpy(src, dst, feats, positions=pos, device=device)
        target = np.zeros((64, cfg.d_out), np.float32)
    params = gnn.init_params(cfg, _generator(device), d_in=6, device=device)
    state = steps_lib.init_train_state(params, optimizer)
    step_fn = steps_lib.build_gnn_train_step(cfg, optimizer)
    return state, step_fn, {"graph": g, "target": torch.from_numpy(target).to(device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the device to train on: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train on the CPU")

    own_group = _init_launched_group(args.device)
    try:
        return _train(args)
    finally:
        if own_group:
            import torch.distributed as dist

            dist.destroy_process_group()


def _init_launched_group(device: str) -> bool:
    """Initialise the process group that ``torch.distributed.run``'s
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) describes, when there is one and no group is
    initialised yet: NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU.
    Returns whether it did."""
    import torch.distributed as dist

    if initialized() or "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl", init_method="env://")
    else:
        dist.init_process_group("gloo", init_method="env://")
    return True


def _train(args) -> int:
    mod = registry.get_arch(args.arch)
    cfg = mod.SMOKE if args.smoke else mod.CONFIG
    supervisor = Supervisor(n_workers=1, checkpoint_interval=args.checkpoint_every)
    mgr = CheckpointManager(args.checkpoint_dir, keep_last=2) if args.checkpoint_dir else None
    mesh = make_host_mesh(torch.device(args.device).type)
    rules = dict(cfg.sharding_rules)
    distributed = initialized()
    if distributed and mod.SHAPE_FAMILY != "lm" and rank_world()[1] > 1:
        raise ValueError(
            f"{args.arch} trains on one rank: the SASRec and GNN sharded steps come with the "
            "dry-run cells (ROADMAP.md Queue 1 item 2)"
        )
    shardings = None

    if mod.SHAPE_FAMILY == "lm":
        state, step_fn, pipe = build_lm_training(cfg, device=args.device)
        batch_of = lambda: next(pipe)  # noqa: E731
        if distributed:
            # the state laid out by the rules; each rank feeds its rows
            shardings = sharding.state_placements(state, transformer.logical_axes(cfg), rules,
                                                  mesh)
            state = sharding.place_tree(state, shardings, mesh)
            rows = sharding.batch_placements(rules, mesh)
            batch_of = lambda: sharding.place_tree(  # noqa: E731
                next(pipe), {"tokens": rows, "labels": rows}, mesh, src_data_rank=None)
    elif mod.SHAPE_FAMILY == "recsys":
        state, step_fn, pipe = build_sasrec_training(cfg, device=args.device)
        batch_of = lambda: next(pipe)  # noqa: E731
    else:
        state, step_fn, batch = build_gnn_training(cfg, device=args.device)
        batch_of = lambda: batch  # noqa: E731

    start = 0
    if args.resume and mgr is not None and mgr.latest_step() is not None:
        if shardings is not None:
            state, start = mgr.restore_latest(device=args.device, shardings=shardings,
                                              mesh=mesh)
        else:
            state, start = mgr.restore_latest(device=args.device)
        print(f"resumed from step {start}")

    with use_mesh_rules(mesh, rules):
        for i in range(start, args.steps):
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch_of())
            dt = time.perf_counter() - t0
            if i % 5 == 0 or i == args.steps - 1:
                print(f"step {i:5d} loss {float(metrics['loss']):.4f} ({dt * 1e3:.0f} ms)")
            if mgr is not None and supervisor.should_checkpoint(i + 1):
                mgr.save(i + 1, state)
        if mgr is not None:
            mgr.save(args.steps, state)
            mgr.wait()
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
