"""``repro_torch.launch.train_lm`` against the JAX package's
``examples/train_lm.py``, on the CPU.

* ``model_100m()`` equals the example's config field for field (the
  example is loaded from its file, which stays as it is).
* :func:`~repro_torch.launch.train_lm.train` on a cut of ``lm-100m`` (2
  layers, ``d_model`` 64, 4 heads over 2 kv heads, ``d_ff`` 128, vocab
  512, float32) against the example's path rebuilt from the JAX package
  with the same params (carried across with
  ``transformer_params_from_arrays``), schedule and ``TokenPipeline``:
  8 steps' losses and gradient norms ``rtol=1e-4``.  As in
  ``test_torch_launch_train.py``, AdamW's update of an element whose
  gradient is near ``eps`` moves with the gradient's last bits, so the
  two packages' float32 weights drift apart step by step.
* ``--resume``: 6 steps then 9, ``keep_last=2``; and a checkpoint that
  the JAX package's ``CheckpointManager`` wrote, resumed by the port,
  gives the reference's next loss ``rtol=1e-5`` (the same weights: only
  the forward's round-off differs).
* Without a card ``main`` refuses unless given ``--device cpu``; its
  checkpoints go under the temporary directory ``TMPDIR`` names, and
  ``train`` takes no default directory.
"""
import dataclasses
import importlib.util
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models import transformer as jtransformer
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.launch import train_lm
from repro_torch.models.interop import transformer_params_from_arrays

REPO = os.path.join(os.path.dirname(__file__), "..")
CUT = dict(name="lm-100m-cut", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
           vocab_size=512)
BATCH, SEQ = 2, 32


def _example():
    """``examples/train_lm.py`` as a module (its ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location(
        "train_lm_example", os.path.join(REPO, "examples", "train_lm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flatten(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(k.key for k in path): np.asarray(a) for path, a in leaves}


def _reference_run(jcfg, steps, ckpt, resume=False):
    """The example's ``main``, step for step, at ``jcfg``: returns every
    step's ``(loss, grad_norm)`` (the example prints every tenth) and the
    params it started from."""
    optimizer = jopt.adamw(jopt.cosine_schedule(3e-4, 50, steps))
    params = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    state = jsteps.init_train_state(params, optimizer)
    step_fn = jax.jit(jsteps.build_lm_train_step(jcfg, optimizer))
    mgr = JCheckpointManager(ckpt, keep_last=2)
    start = 0
    if resume and mgr.latest_step() is not None:
        state, start = mgr.restore_latest()
        state = jax.tree_util.tree_map(jnp.asarray, state)
    pipe = iter(JTokenPipeline(jcfg.vocab_size, SEQ, BATCH).device_iter())
    out = []
    for i in range(start, steps):
        state, metrics = step_fn(state, next(pipe))
        out.append((float(metrics["loss"]), float(metrics["grad_norm"])))
        if (i + 1) % 50 == 0:
            mgr.save(i + 1, state)
    mgr.save(steps, state)
    mgr.wait()
    return out, params


@pytest.fixture(scope="module")
def cut_configs():
    example = _example()
    return (dataclasses.replace(example.model_100m(), **CUT),
            dataclasses.replace(train_lm.model_100m(log=lambda _: None), **CUT))


@pytest.fixture(scope="module")
def reference(cut_configs, tmp_path_factory):
    """The example's path at the cut for 8 steps (its checkpoint at step 8
    copied aside), then resumed from it to 9."""
    jcfg, _ = cut_configs
    ckpt = str(tmp_path_factory.mktemp("jax_ckpt"))
    run, jparams = _reference_run(jcfg, 8, ckpt)
    written = str(tmp_path_factory.mktemp("jax_ckpt_copy") / "ckpt")
    shutil.copytree(ckpt, written)
    resumed, _ = _reference_run(jcfg, 9, ckpt, resume=True)
    return {"run": run, "params": _flatten(jparams), "written": written, "resumed": resumed}


def test_model_100m_equals_the_example(capsys):
    want = _example().model_100m()
    want_line = capsys.readouterr().out
    got = train_lm.model_100m()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.n_params() == want.n_params() == 98_661_888
    assert capsys.readouterr().out == want_line == "model: 98.7M parameters\n"


def test_train_matches_the_reference_example(cut_configs, reference, tmp_path):
    _, cfg = cut_configs
    params = transformer_params_from_arrays(reference["params"], cfg, "cpu", torch.float32)
    lines = []
    got = train_lm.train(cfg, steps=8, batch=BATCH, seq=SEQ, checkpoint_dir=str(tmp_path),
                         device="cpu", params=params, log=lines.append)
    want = reference["run"]
    np.testing.assert_allclose(got["losses"], [m[0] for m in want], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norms"], [m[1] for m in want], rtol=1e-4)
    # the example's log lines: steps 0 and 7 (the last), then "done"
    assert [ln.split()[:2] for ln in lines[:2]] == [["step", "0"], ["step", "7"]]
    assert float(lines[1].split()[3]) == pytest.approx(got["losses"][7], abs=1e-4)
    assert lines[-1] == f"done; checkpoints in {tmp_path}"
    assert got["start"] == 0 and int(got["state"]["step"]) == 8


def test_resume_keeps_the_last_two_checkpoints(cut_configs, tmp_path):
    _, cfg = cut_configs
    kw = dict(batch=BATCH, seq=SEQ, checkpoint_dir=str(tmp_path), device="cpu")
    first = train_lm.train(cfg, steps=6, log=lambda _: None, **kw)
    lines = []
    again = train_lm.train(cfg, steps=9, resume=True, log=lines.append, **kw)
    assert lines[0] == "resumed from step 6"
    assert again["start"] == 6 and len(again["losses"]) == 3
    assert np.all(np.isfinite(again["losses"])) and int(again["state"]["step"]) == 9
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_0000000006", "step_0000000009"]
    assert len(first["losses"]) == 6


def test_resumes_a_checkpoint_the_reference_wrote(cut_configs, reference):
    _, cfg = cut_configs
    lines = []
    got = train_lm.train(cfg, steps=9, batch=BATCH, seq=SEQ,
                         checkpoint_dir=reference["written"], resume=True, device="cpu",
                         log=lines.append)
    assert lines[0] == "resumed from step 8" and got["start"] == 8
    assert got["losses"][0] == pytest.approx(reference["resumed"][0][0], rel=1e-5)


def test_main_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device: pass --device cpu"):
        train_lm.main(["--steps", "1"])


def test_checkpoints_default_under_tmpdir(tmp_path):
    with pytest.raises(TypeError, match="checkpoint_dir"):
        train_lm.train(train_lm.model_100m(log=lambda _: None), steps=1, device="cpu")
    env = dict(os.environ, TMPDIR=str(tmp_path),
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-c", "from repro_torch.launch import train_lm; "
         "print(train_lm.DEFAULT_CHECKPOINT_DIR)"],
        env=env, capture_output=True, text=True, check=True).stdout.strip()
    assert out == os.path.join(str(tmp_path), "repro_lm_ckpt")
