"""Elastic orchestrator: heartbeats, stragglers, failure recovery
(host-only; the JAX package's ``launch/orchestrator.py``).

Each worker process runs this supervisor around its loop.  The control
plane is real (state machine, deadlines, re-mesh decisions, checkpoint
discipline) and is exercised in tests and in
:mod:`repro_torch.launch.distributed_analytics` with scripted failures.

Recovery contract:

* every worker heartbeats ``(step, wall_time)`` after each step;
* a worker missing ``miss_limit`` deadlines is declared dead, the
  surviving devices re-mesh via :func:`~.mesh.largest_feasible_mesh`,
  and work resumes from the last committed checkpoint (step-atomic, so
  at most one step of lost work per failure);
* stragglers (step time > ``straggler_factor`` × the running p50) raise
  a flag; a policy hook decides (ignore / shrink / evict);
* the checkpoint interval halves while a worker is flagged.

For the same heartbeat timeline the ``events`` tuples and the straggler
flags equal the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .mesh import largest_feasible_mesh

__all__ = ["WorkerState", "Heartbeat", "Supervisor", "run_with_recovery"]


@dataclasses.dataclass
class Heartbeat:
    worker: int
    step: int
    wall_time: float


@dataclasses.dataclass
class WorkerState:
    worker: int
    last_step: int = -1
    last_seen: float = 0.0
    missed: int = 0
    alive: bool = True
    straggler: bool = False
    step_times: List[float] = dataclasses.field(default_factory=list)


class Supervisor:
    """Tracks worker health and drives elastic decisions."""

    def __init__(
        self,
        n_workers: int,
        heartbeat_deadline: float = 30.0,
        miss_limit: int = 3,
        straggler_factor: float = 2.0,
        model_parallel: int = 16,
        checkpoint_interval: int = 100,
    ):
        self.workers: Dict[int, WorkerState] = {
            i: WorkerState(i) for i in range(n_workers)
        }
        self.deadline = heartbeat_deadline
        self.miss_limit = miss_limit
        self.straggler_factor = straggler_factor
        self.model_parallel = model_parallel
        self.base_checkpoint_interval = checkpoint_interval
        self.checkpoint_interval = checkpoint_interval
        self.events: List[Tuple[str, int]] = []

    # -- ingestion -------------------------------------------------------------
    def heartbeat(self, hb: Heartbeat) -> None:
        w = self.workers[hb.worker]
        if not w.alive:
            return
        if w.last_seen:
            w.step_times.append(hb.wall_time - w.last_seen)
            w.step_times = w.step_times[-50:]
        w.last_seen = hb.wall_time
        w.last_step = hb.step
        w.missed = 0
        self._update_straggler(w)

    def check_deadlines(self, now: float) -> None:
        for w in self.workers.values():
            if not w.alive or not w.last_seen:
                continue
            if now - w.last_seen > self.deadline:
                w.missed += 1
                w.last_seen = now
                if w.missed >= self.miss_limit:
                    w.alive = False
                    self.events.append(("dead", w.worker))

    def _update_straggler(self, w: WorkerState) -> None:
        times = [
            t for ws in self.workers.values() if ws.alive for t in ws.step_times
        ]
        if len(times) < 8 or not w.step_times:
            return
        p50 = float(np.percentile(times, 50))
        was = w.straggler
        w.straggler = w.step_times[-1] > self.straggler_factor * p50
        if w.straggler and not was:
            self.events.append(("straggler", w.worker))
            # adaptive checkpoint cadence while unstable
            self.checkpoint_interval = max(
                self.base_checkpoint_interval // 2, 1
            )
        elif not any(ws.straggler for ws in self.workers.values()):
            self.checkpoint_interval = self.base_checkpoint_interval

    # -- decisions ---------------------------------------------------------------
    @property
    def alive_workers(self) -> List[int]:
        return [w.worker for w in self.workers.values() if w.alive]

    def needs_remesh(self) -> bool:
        return len(self.alive_workers) < len(self.workers)

    def remesh_plan(self, devices_per_worker: int) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
        """Largest feasible (data, model) mesh on surviving devices."""
        n = len(self.alive_workers) * devices_per_worker
        return largest_feasible_mesh(n, self.model_parallel)

    def should_checkpoint(self, step: int) -> bool:
        return step > 0 and step % self.checkpoint_interval == 0


def run_with_recovery(
    train_once: Callable[[int, Optional[int]], int],
    supervisor: Supervisor,
    max_restarts: int = 3,
) -> int:
    """Driver: call ``train_once(restart_idx, resume_step)``; on failure
    (``RuntimeError``), record a restart and call again, resuming from the
    last committed step.

    ``train_once`` returns the final step reached; it raises to simulate
    or propagate a node failure.
    """
    resume: Optional[int] = None
    for attempt in range(max_restarts + 1):
        try:
            return train_once(attempt, resume)
        except RuntimeError:  # node failure class
            supervisor.events.append(("restart", attempt))
            resume = None  # train_once rediscovers from CheckpointManager
            if attempt == max_restarts:
                raise
    raise AssertionError("unreachable")
