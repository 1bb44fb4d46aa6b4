"""LM training end to end: a ~100 M-parameter decoder on a synthetic
corpus, AdamW on a cosine schedule, checkpoint / resume, loss logging.

    PYTHONPATH=src python -m repro_torch.launch.train_lm --steps 300   # on the card
    PYTHONPATH=src python -m repro_torch.launch.train_lm --steps 20 --device cpu

The port of the JAX package's ``examples/train_lm.py``, with its flags
and defaults (``--steps 300 --batch 4 --seq 128 --checkpoint-dir
/tmp/repro_lm_ckpt --resume``; the directory is ``repro_lm_ckpt`` under
the temporary directory that ``TMPDIR`` names) and its log lines.  ``lm-100m``
(:func:`model_100m`) is float32 end to end, so on the card every
attention call runs K4's float32 kernel with its log-sum-exp output
(``csrc/flash_attention.cu``, once per layer a step: the config keeps no
remat) and its backward K4's float32 backward kernel
(``csrc/flash_backward_f32.cu``, once per layer a step).  Matrix
products stay full float32: nothing here turns TF32 on.

:func:`train` is the example's ``main`` given the config, its flags and
optionally starting params, and returns every step's loss and gradient
norm and the final state, so the tests can hold it against the
reference's path and the smoke run can count its kernel launches.
:func:`main` adds ``--device`` (the card by default; without one it
refuses unless given ``--device cpu``).  As in the reference, the cosine
schedule's total is ``--steps``, a resumed run draws its batches from
the start of the seeded pipeline, and the last step is saved even where
the every-50-steps save already wrote it.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, Optional

import torch

from ..configs.base import TransformerConfig
from ..data.pipeline import TokenPipeline
from ..models import transformer
from ..train import optimizer as opt_lib
from ..train import steps as steps_lib
from ..train.checkpoint import CheckpointManager

__all__ = ["model_100m", "train", "main"]

LOG_EVERY = 10
SAVE_EVERY = 50
DEFAULT_CHECKPOINT_DIR = os.path.join(tempfile.gettempdir(), "repro_lm_ckpt")


def model_100m(log=print) -> TransformerConfig:
    """The example's ``lm-100m``: 12 layers, ``d_model`` 512, 8 heads over
    4 kv heads, ``d_ff`` 2048, the GPT-2 vocabulary, float32 (98.7 M
    parameters)."""
    cfg = TransformerConfig(
        name="lm-100m",
        n_layers=12,
        d_model=512,
        n_heads=8,
        n_kv_heads=4,
        d_ff=2048,
        vocab_size=50_257,
        remat_policy="none",
        microbatches=1,
        dtype="float32",
    )
    log(f"model: {cfg.n_params()/1e6:.1f}M parameters")
    return cfg


def train(cfg: TransformerConfig, *, checkpoint_dir: str, steps: int = 300, batch: int = 4,
          seq: int = 128, resume: bool = False, device="cuda",
          params: Optional[Dict] = None, log=print) -> Dict:
    """The example's training run on ``device``: params drawn from seed 0
    (or ``params``), ``adamw(cosine_schedule(3e-4, 50, steps))``, batches
    of ``batch x seq`` tokens from ``TokenPipeline``, a log line every 10
    steps and at the last, a checkpoint in ``checkpoint_dir`` every 50
    steps and at the end (``keep_last=2``), restored from the latest
    under ``resume``.

    Returns ``losses`` and ``grad_norms`` (every step run), ``start`` (the
    step resumed from, else 0), ``log_times`` (``(step, perf_counter)`` at
    each log line, after the loss is read: on the card a synchronise) and
    the final ``state``."""
    optimizer = opt_lib.adamw(opt_lib.cosine_schedule(3e-4, 50, steps))
    if params is None:
        params = transformer.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                                         device, dtype=transformer.torch_dtype(cfg.param_dtype))
    state = steps_lib.init_train_state(params, optimizer)
    step_fn = steps_lib.build_lm_train_step(cfg, optimizer)
    mgr = CheckpointManager(checkpoint_dir, keep_last=2)

    start = 0
    if resume and mgr.latest_step() is not None:
        state, start = mgr.restore_latest(device=device)
        log(f"resumed from step {start}")

    pipe = iter(TokenPipeline(cfg.vocab_size, seq, batch).device_iter(device))
    losses, norms, log_times = [], [], []
    t_start = time.time()
    for i in range(start, steps):
        state, metrics = step_fn(state, next(pipe))
        losses.append(metrics["loss"])
        norms.append(metrics["grad_norm"])
        if i % LOG_EVERY == 0 or i == steps - 1:
            loss = float(metrics["loss"])
            log_times.append((i, time.perf_counter()))
            tok_s = (i - start + 1) * batch * seq / (time.time() - t_start)
            log(f"step {i:4d}  loss {loss:7.4f}  grad_norm "
                f"{float(metrics['grad_norm']):6.2f}  ({tok_s:,.0f} tok/s)")
        if (i + 1) % SAVE_EVERY == 0:
            mgr.save(i + 1, state)
    mgr.save(steps, state)
    mgr.wait()
    log(f"done; checkpoints in {checkpoint_dir}")
    return {"losses": torch.stack(losses).tolist() if losses else [],
            "grad_norms": torch.stack(norms).tolist() if norms else [],
            "start": start, "log_times": log_times, "state": state}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--checkpoint-dir", default=DEFAULT_CHECKPOINT_DIR)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the device to train on: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train on the CPU")
    train(model_100m(), **vars(args))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
