"""Recovery of the port against the JAX package: the elastic re-mesh, the
supervisor, the restart driver, checkpoints, and the distributed
analytics launcher.

``largest_feasible_mesh`` and the ``Supervisor``'s events and straggler
flags equal the JAX package's on the same scripted heartbeat timelines;
``run_with_recovery`` restarts as the JAX package's does; a checkpoint
written by either package restores in the other (float32, int32,
bfloat16), a corrupt buffer raises ``IOError`` while the previous step
still restores, and retention and async saves behave as the JAX
package's.  ``python -m repro_torch.launch.distributed_analytics
--device cpu --world 4`` prints ``results identical``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import largest_feasible_mesh
from repro_torch.launch.orchestrator import Heartbeat, Supervisor, run_with_recovery
from repro_torch.train.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

REPO = os.path.join(os.path.dirname(__file__), "..")


@pytest.mark.parametrize("model_parallel", [1, 2, 4, 16])
def test_largest_feasible_mesh_equals_reference(model_parallel):
    from repro.launch.mesh import largest_feasible_mesh as ref_mesh

    for n in range(1, 65):
        assert largest_feasible_mesh(n, model_parallel) == ref_mesh(n, model_parallel)
    with pytest.raises(ValueError):
        largest_feasible_mesh(0, model_parallel)


def _timeline(sup_cls, hb_cls):
    """Six workers over 30 steps: worker 4 slows down from step 12 (a
    straggler, then recovers at step 20), worker 5 goes silent at step 8
    (declared dead after two missed deadlines)."""
    sup = sup_cls(n_workers=6, heartbeat_deadline=1.5, miss_limit=2,
                  straggler_factor=2.0, model_parallel=4, checkpoint_interval=10)
    trace = []
    clock = {w: 0.0 for w in range(6)}
    for step in range(30):
        for w in range(6):
            if w == 5 and step >= 8:
                continue
            dt = 1.0 + 0.01 * w
            if w == 4 and 12 <= step < 20:
                dt = 3.5
            clock[w] += dt
            sup.heartbeat(hb_cls(w, step, clock[w]))
        sup.check_deadlines(max(clock.values()))
        trace.append((
            [ws.straggler for ws in sup.workers.values()],
            [ws.alive for ws in sup.workers.values()],
            sup.checkpoint_interval, sup.should_checkpoint(step), sup.needs_remesh(),
        ))
    return sup, trace


def test_supervisor_events_equal_reference_on_a_scripted_timeline():
    from repro.launch import orchestrator as ref

    sup, trace = _timeline(Supervisor, Heartbeat)
    rsup, rtrace = _timeline(ref.Supervisor, ref.Heartbeat)
    assert sup.events == rsup.events
    assert ("dead", 5) in sup.events and ("straggler", 4) in sup.events
    assert trace == rtrace
    assert sup.alive_workers == rsup.alive_workers == [0, 1, 2, 3, 4]
    for dpw in (1, 2, 4):
        assert sup.remesh_plan(dpw) == rsup.remesh_plan(dpw)
    for w in sup.workers:
        assert sup.workers[w].step_times == rsup.workers[w].step_times


@pytest.mark.parametrize("failures,max_restarts", [(0, 3), (2, 3), (3, 3), (5, 2)])
def test_run_with_recovery_equals_reference(failures, max_restarts):
    from repro.launch import orchestrator as ref

    def drive(run, sup_cls):
        sup = sup_cls(n_workers=2)
        calls = []

        def train_once(attempt, resume):
            calls.append((attempt, resume))
            if attempt < failures:
                raise RuntimeError(f"node lost at attempt {attempt}")
            return 100 + attempt

        try:
            out = run(train_once, sup, max_restarts=max_restarts)
        except RuntimeError as e:
            out = f"raised: {e}"
        return out, calls, sup.events

    got = drive(run_with_recovery, Supervisor)
    assert got == drive(ref.run_with_recovery, ref.Supervisor)
    if failures <= max_restarts:
        assert got[0] == 100 + failures and len(got[2]) == failures
    else:
        assert got[0].startswith("raised") and len(got[2]) == max_restarts + 1


# -- checkpoints ------------------------------------------------------------------

def _state(seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((5, 3)).astype(np.float32)
    return {
        "params": {"w": w, "b": rng.standard_normal(3).astype(np.float32)},
        "step": np.array(seed, np.int32),
        "opt": {"count": rng.integers(-9, 9, (4,)).astype(np.int32),
                "mu": w.astype(np.float32) * 0.5},
        "bf": w[:2],   # stored as bfloat16
    }


def _port_tree(state):
    t = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
             else torch.from_numpy(np.asarray(v))) for k, v in state.items()}
    t["bf"] = t["bf"].to(torch.bfloat16)
    return t


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _bits(x):
    """A leaf's dtype name, shape and bytes (bfloat16 through its int16 bits)."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).replace("torch.", "")
        data = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return name, tuple(x.shape), data.numpy().tobytes()
    x = np.asarray(x)
    return x.dtype.name, x.shape, x.tobytes()


def test_port_checkpoint_restores_in_reference(tmp_path):
    from repro.train.checkpoint import restore_checkpoint as ref_restore

    state = _port_tree(_state(1))
    save_checkpoint(str(tmp_path), 7, state)
    tree, step = ref_restore(str(tmp_path))
    assert step == 7
    want, got = _leaves(state), _leaves(tree)
    assert sorted(want) == sorted(got)
    for k in want:
        assert _bits(want[k]) == _bits(got[k]), k
    assert got["bf"].dtype.name == "bfloat16"


def test_reference_checkpoint_restores_in_port(tmp_path):
    import jax.numpy as jnp
    from repro.train.checkpoint import save_checkpoint as ref_save

    state = _state(2)
    ref_state = dict(state, bf=jnp.asarray(state["bf"], jnp.bfloat16))
    ref_save(str(tmp_path), 3, ref_state)
    tree, step = restore_checkpoint(str(tmp_path))
    assert step == 3
    want, got = _leaves(_port_tree(state)), _leaves(tree)
    assert sorted(want) == sorted(got)
    for k in want:
        assert _bits(want[k]) == _bits(got[k]), k
    assert got["bf"].dtype == torch.bfloat16


def test_corrupt_buffer_raises_and_previous_step_restores(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _port_tree(_state(1)))
    save_checkpoint(d, 2, _port_tree(_state(2)))
    victim = os.path.join(d, "step_0000000002", "0000.bin")
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) - 2)
    with pytest.raises(IOError, match="corrupt checkpoint"):
        restore_checkpoint(d)
    tree, step = restore_checkpoint(d, step=1)
    assert step == 1
    assert _bits(tree["params"]["w"]) == _bits(torch.from_numpy(_state(1)["params"]["w"]))


def test_latest_is_rediscovered_and_uncommitted_dirs_ignored(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 4, {"x": torch.arange(3)})
    save_checkpoint(d, 9, {"x": torch.arange(4)})
    os.makedirs(os.path.join(d, "step_0000000011.tmp"))
    os.remove(os.path.join(d, "LATEST"))
    assert latest_step(d) == 9
    tree, step = restore_checkpoint(d, device="cpu")
    assert step == 9 and torch.equal(tree["x"], torch.arange(4))
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "empty"))


@pytest.mark.parametrize("async_save", [False, True])
def test_manager_keeps_last_k_and_saves_a_snapshot(tmp_path, async_save):
    from repro.train.checkpoint import CheckpointManager as RefManager

    mgr = CheckpointManager(str(tmp_path / "port"), keep_last=2, async_save=async_save)
    ref = RefManager(str(tmp_path / "ref"), keep_last=2, async_save=async_save)
    x = torch.zeros(6)
    for step in (10, 20, 30, 40):
        x += 1
        mgr.save(step, {"x": x, "n": torch.tensor(step)})
        ref.save(step, {"x": x.numpy().copy(), "n": np.asarray(step)})
        x += 100  # mutated after the save: the snapshot keeps the value
    mgr.wait()
    ref.wait()
    kept = sorted(os.listdir(tmp_path / "port"))
    assert kept == sorted(os.listdir(tmp_path / "ref")) == [
        "LATEST", "step_0000000030", "step_0000000040"]
    tree, step = mgr.restore_latest()
    assert step == mgr.latest_step() == 40
    assert torch.equal(tree["x"], torch.full((6,), 304.0))
    rtree, _ = ref.restore_latest()
    assert np.array_equal(rtree["x"], tree["x"].numpy())


def test_manager_surfaces_a_failed_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, {"bad": torch.zeros(2, dtype=torch.complex64)})
    with pytest.raises(TypeError, match="no checkpoint dtype"):
        mgr.wait()


# -- the launcher ---------------------------------------------------------------------

def test_distributed_analytics_launcher_on_four_cpu_ranks():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.distributed_analytics",
         "--device", "cpu", "--world", "4", "--timeout", "120"],
        capture_output=True, text=True, timeout=240, cwd=REPO, env=env,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    out = proc.stdout
    assert "worker 3 declared dead" in out and "shape=(3, 2)" in out
    assert "over ranks [0, 1, 2]" in out
    assert "results identical" in out
