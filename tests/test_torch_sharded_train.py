"""The port's LM train step over more than one rank (DTensor state laid out
by each config's ``sharding_rules``) against the JAX package's sharded
step and the port's own one-rank step, on the CPU.

* Worlds: ``gloo`` worlds of 2 ranks (meshes (2, 1) and (1, 2)) and 4
  ranks ((2, 2)), named ``("data", "model")``; one world per mesh, each
  rank running every config.
* Configs: the SMOKE configs, under each arch's ``CONFIG`` rules, of
  glm4-9b (FSDP + TP + SP + vocab),
  granite-moe-3b-a800m (``expert_ff`` / ``expert_capacity``, sort
  dispatch), moonshot-v1-16b-a3b (experts over ``"model"``: EP) with
  AdamW, and llama3-405b with adafactor (factored moments), all with
  ``dtype="float32"``: partial sums rounded in bf16 before their reduce
  would move the loss by ~4e-4.  glm4-9b recomputes its layers under the
  ``minimal`` remat policy, granite under ``full``.
* Steps: two, the first whole, the second in 2 microbatches (each the
  reference's global rows, spread over the data ranks); the batch's
  masked labels make the masked mean depend on how rows are grouped.
* The JAX package's sharded step: ``build_lm_train_step`` jitted with
  ``specs_for_tree`` / ``_opt_shardings`` ``in_shardings`` over 2 and 4
  of 8 forced host devices, one subprocess per config.
* Tolerances: loss and gradient norm ``rtol=1e-5``.  Params after two
  steps ``rtol=1e-5, atol=PARAM_ATOL``: AdamW divides each gradient entry
  by its own root mean square, so an entry whose sum cancels to the size
  of float32 rounding (it adds in another order on another mesh) can
  take a step of up to a fraction of ``lr = 3e-4`` in one run and not in
  the other; ``PARAM_ATOL = 3e-5`` is a tenth of that step (measured:
  at most 3.0e-6 on these meshes).  Optimizer moments ``atol=1e-7``.
* Int8 gradient compression (glm4-9b at (2, 2)) against the one-rank
  compressed step, params to ``COMPRESSED_PARAM_ATOL``.
* A checkpoint written at (2, 2) after two steps restores at (1, 2) by
  ``restore_checkpoint(shardings=, mesh=)``, bit for bit, and its next
  step equals the uninterrupted (2, 2) one.
* ``launch/train.main`` on 2 ranks: ``tests/test_torch_sharded_launch.py``.

Spawned ranks run functions of this module, so it imports the JAX
package only inside tests and subprocesses.
"""
import concurrent.futures
import contextlib
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.distributed import sharding
from repro_torch.distributed.world import spawn_world
from repro_torch.models import transformer
from repro_torch.train import checkpoint
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import steps

REPO = os.path.join(os.path.dirname(__file__), "..")
WORLD_TIMEOUT_S = 240
ARCHS = ["glm4-9b", "granite-moe-3b-a800m", "moonshot-v1-16b-a3b", "llama3-405b"]
MESHES = [(2, 1), (1, 2), (2, 2)]
CKPT_ARCH = "granite-moe-3b-a800m"
COMPRESS_ARCH = "glm4-9b"
# int8 compression: an entry on a rounding boundary of the int8 grid
# moves one quantum between meshes, which AdamW's normalised update turns
# into up to a fraction of lr = 3e-4 (measured: 2.7e-5 at (2, 2))
COMPRESSED_PARAM_ATOL = 1e-4
B, T = 4, 16
PARAM_ATOL = 3e-5
LOSS_RTOL = 1e-5
# remat around DTensor ops: the two policies on two of the configs
REMAT = {"glm4-9b": "minimal", "granite-moe-3b-a800m": "full"}


def _cfg(arch):
    """SMOKE's widths under the arch's own rules (``CONFIG.sharding_rules``:
    the SMOKE configs keep the default rules)."""
    mod = registry.get_arch(arch)
    return dataclasses.replace(mod.SMOKE, dtype="float32", remat_policy=REMAT.get(arch, "none"),
                               sharding_rules=dict(mod.CONFIG.sharding_rules))


def _optimizer(arch):
    return opt_lib.adafactor(1e-2) if arch == "llama3-405b" else opt_lib.adamw(3e-4)


def _inputs(arch):
    """Params (seed 0) and one batch (seed 1) of ``arch``, as numpy."""
    cfg = _cfg(arch)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                     dtype=torch.float32)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -3:] = -1
    labels[0, :5] = -1
    return _flat(params), {"tokens": tokens, "labels": labels}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            if hasattr(v, "full_tensor"):
                v = v.full_tensor()
            out[prefix + k] = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _run_steps(arch, state, batch, mesh=None):
    """Step 0 whole, step 1 in 2 microbatches: ``(state, [(loss, norm)])``."""
    cfg, opt = _cfg(arch), _optimizer(arch)
    out = []
    ctx = (sharding.use_mesh_rules(mesh, dict(cfg.sharding_rules)) if mesh is not None
           else contextlib.nullcontext())
    with ctx:
        for mb in (1, 2):
            step = steps.build_lm_train_step(dataclasses.replace(cfg, microbatches=mb), opt)
            state, m = step(state, batch)
            out.append((float(m["loss"]), float(m["grad_norm"])))
    return state, out


def _plain_state(arch, params):
    p = _nest({k: torch.from_numpy(v.copy()) for k, v in params.items()})
    return steps.init_train_state(p, _optimizer(arch))


def _torch_batch(batch):
    return {k: torch.from_numpy(v).to(torch.int64) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------

def _mesh(shape):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(shape[0] * shape[1]).reshape(shape),
                      mesh_dim_names=("data", "model"))


def _sharded(arch, state, batch, mesh):
    cfg = _cfg(arch)
    rules = dict(cfg.sharding_rules)
    state = sharding.distribute_state(state, transformer.logical_axes(cfg), rules, mesh)
    rows = sharding.batch_placements(rules, mesh)
    return state, sharding.place_tree(_torch_batch(batch), {"tokens": rows, "labels": rows},
                                      mesh, src_data_rank=None)


def _rank(rank, world, shape, inputs, ckpt_dir):
    mesh = _mesh(shape)
    out = {}
    for arch, (params, batch) in inputs.items():
        state, dbatch = _sharded(arch, _plain_state(arch, params), batch, mesh)
        placements = {"/".join(k): tuple(v.placements)
                      for k, v in _flat_leaves(state["params"]).items()}
        cfg = _cfg(arch)
        tree = sharding.distribute_tree(_plain_state(arch, params)["params"],
                                        transformer.logical_axes(cfg),
                                        dict(cfg.sharding_rules), mesh)
        assert {"/".join(k): tuple(v.placements)
                for k, v in _flat_leaves(tree).items()} == placements
        state, metrics = _run_steps(arch, state, dbatch, mesh)
        out[arch] = {"metrics": metrics, "params": _flat(state["params"]),
                     "opt": _flat(state["opt"]), "placements": placements}
        if arch == COMPRESS_ARCH and shape == (2, 2):
            state, dbatch = _sharded(arch, _plain_state(arch, params), batch, mesh)
            with sharding.use_mesh_rules(mesh, dict(_cfg(arch).sharding_rules)):
                out["compressed"] = _compressed_steps(arch, state, dbatch)
        if arch == CKPT_ARCH and shape == (2, 2):
            checkpoint.save_checkpoint(ckpt_dir, 2, state)
            state, third = _third_step(arch, state, dbatch, mesh)
            out["ckpt"] = {"metrics": third, "params": _flat(state["params"])}
        if arch == CKPT_ARCH and shape == (1, 2):
            cfg = _cfg(arch)
            shardings = sharding.state_placements(state, transformer.logical_axes(cfg),
                                                  dict(cfg.sharding_rules), mesh)
            restored, at = checkpoint.restore_checkpoint(ckpt_dir, shardings=shardings,
                                                         mesh=mesh)
            saved = _flat(restored["params"])
            kinds = {type(v).__name__ for v in _flat_leaves(restored["params"]).values()}
            restored, third = _third_step(arch, restored, dbatch, mesh)
            out["restored"] = {"step": at, "saved": saved, "kinds": kinds, "metrics": third,
                               "params": _flat(restored["params"])}
    return out


def _compressed_steps(arch, state, batch):
    """Two steps with int8 error-feedback gradient compression: ``(loss,
    norm)`` pairs and the params after."""
    step = steps.build_lm_train_step(_cfg(arch), _optimizer(arch), compress_grads=True)
    metrics = []
    for _ in range(2):
        state, m = step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {"metrics": metrics, "params": _flat(state["params"]),
            "grad_err_kinds": {type(v).__name__ for v in _flat_leaves(state["grad_err"]).values()}}


def _flat_leaves(tree):
    return dict(opt_lib.tree_paths(tree))


def _third_step(arch, state, batch, mesh):
    cfg = _cfg(arch)
    with sharding.use_mesh_rules(mesh, dict(cfg.sharding_rules)):
        state, m = steps.build_lm_train_step(cfg, _optimizer(arch))(state, batch)
    return state, (float(m["loss"]), float(m["grad_norm"]))


# ---------------------------------------------------------------------------
# the JAX package's sharded step
# ---------------------------------------------------------------------------

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding
from repro.configs import registry
from repro.distributed.sharding import _dedup_axes, logical_spec, specs_for_tree, use_mesh_rules
from repro.launch.cells import _opt_shardings
from repro.models import transformer
from repro.train import optimizer as opt_lib, steps

arch, src, dst = sys.argv[1:4]
data = dict(np.load(src))
params = {}
for path, v in data.items():
    if path.startswith("params/"):
        node = params
        *head, last = path[len("params/"):].split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = jnp.asarray(v)
batch = {k: jnp.asarray(data[k]) for k in ("tokens", "labels")}
mod = registry.get_arch(arch)
remat = {"glm4-9b": "minimal", "granite-moe-3b-a800m": "full"}.get(arch, "none")
cfg = dataclasses.replace(mod.SMOKE, dtype="float32", remat_policy=remat,
                          sharding_rules=dict(mod.CONFIG.sharding_rules))
opt = opt_lib.adafactor(1e-2) if arch == "llama3-405b" else opt_lib.adamw(3e-4)
rules = dict(cfg.sharding_rules)
out = {}
for shape in ((2, 1), (1, 2), (2, 2)):
    mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape), ("data", "model"))
    pspecs = specs_for_tree(transformer.logical_axes(cfg), rules, mesh)
    state = steps.init_train_state(params, opt)
    state_sh = {"params": pspecs, "opt": _opt_shardings(state["opt"], pspecs, mesh),
                "step": NamedSharding(mesh, jax.sharding.PartitionSpec())}
    rows = NamedSharding(mesh, _dedup_axes(logical_spec(("batch", None), rules, mesh)))
    batch_sh = {"tokens": rows, "labels": rows}
    with use_mesh_rules(mesh, rules):
        state = jax.device_put(state, state_sh)
        b = jax.device_put(batch, batch_sh)
        for i, mb in enumerate((1, 2)):
            step = jax.jit(steps.build_lm_train_step(dataclasses.replace(cfg, microbatches=mb), opt),
                           in_shardings=(state_sh, batch_sh))
            state, m = step(state, b)
            out[f"{shape}/{i}"] = np.array([float(m["loss"]), float(m["grad_norm"])])
    for path, leaf in jax.tree_util.tree_leaves_with_path(state["params"]):
        out[f"{shape}/params/" + "/".join(k.key for k in path)] = np.asarray(leaf)
np.savez(dst, **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_train")
    inputs = {arch: _inputs(arch) for arch in ARCHS}
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    procs = {}
    for arch, (params, batch) in inputs.items():       # the JAX side runs meanwhile
        np.savez(tmp / f"{arch}.npz", **{f"params/{k}": v for k, v in params.items()}, **batch)
        procs[arch] = subprocess.Popen(
            [sys.executable, "-c", JAX_SCRIPT, arch, str(tmp / f"{arch}.npz"),
             str(tmp / f"{arch}.want.npz")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO, env=env)
    try:
        one = {}
        for arch, (params, batch) in inputs.items():
            state, metrics = _run_steps(arch, _plain_state(arch, params), _torch_batch(batch))
            one[arch] = {"metrics": metrics, "params": _flat(state["params"]),
                         "opt": _flat(state["opt"])}
        one["compressed"] = _compressed_steps(COMPRESS_ARCH, _plain_state(
            COMPRESS_ARCH, inputs[COMPRESS_ARCH][0]), _torch_batch(inputs[COMPRESS_ARCH][1]))
        ckpt = str(tmp / "ckpt")

        def world(shape):
            return spawn_world(_rank, shape[0] * shape[1], (shape, inputs, ckpt),
                               timeout_s=WORLD_TIMEOUT_S,
                               store_dir=str(tmp / f"store{shape[0]}{shape[1]}"))

        # (2, 1) beside the (2, 2) world, which writes the checkpoint (1, 2) reads
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            beside = pool.submit(world, (2, 1))
            got = {(2, 2): world((2, 2)), (1, 2): world((1, 2)), (2, 1): beside.result()}
        want = {}
        for arch, proc in procs.items():
            text, _ = proc.communicate(timeout=600)
            assert proc.returncode == 0, text
            want[arch] = dict(np.load(tmp / f"{arch}.want.npz"))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    return inputs, one, got, want


CASES = [(arch, shape) for arch in ARCHS for shape in MESHES]


@pytest.mark.parametrize("arch,shape", CASES)
def test_sharded_step_equals_the_jax_sharded_step(runs, arch, shape):
    _, _, got, want = runs
    w = want[arch]
    for r in got[shape]:
        for i, (loss, norm) in enumerate(r[arch]["metrics"]):
            np.testing.assert_allclose([loss, norm], w[f"{shape}/{i}"], rtol=LOSS_RTOL)
    params = got[shape][0][arch]["params"]
    for path, v in params.items():
        np.testing.assert_allclose(v, w[f"{shape}/params/{path}"], rtol=1e-5, atol=PARAM_ATOL,
                                   err_msg=path)


@pytest.mark.parametrize("arch,shape", CASES)
def test_sharded_step_equals_the_one_rank_step(runs, arch, shape):
    _, one, got, _ = runs
    ref = one[arch]
    for r in got[shape]:
        for (loss, norm), (l1, n1) in zip(r[arch]["metrics"], ref["metrics"]):
            np.testing.assert_allclose([loss, norm], [l1, n1], rtol=LOSS_RTOL)
    for path, v in got[shape][0][arch]["params"].items():
        np.testing.assert_allclose(v, ref["params"][path], rtol=1e-5, atol=PARAM_ATOL,
                                   err_msg=path)
    for path, v in got[shape][0][arch]["opt"].items():
        np.testing.assert_allclose(v, ref["opt"][path], rtol=1e-5, atol=1e-7, err_msg=path)


def test_int8_compression_runs_on_the_reduced_sharded_gradients(runs):
    """Compression quantizes each reduced gradient (its scale the leaf's
    global max |g|) before the clip, as the reference does: two steps at
    (2, 2) equal the one-rank compressed steps; the residuals are DTensors
    placed as their params."""
    _, one, got, _ = runs
    want = one["compressed"]
    for r in got[(2, 2)]:
        np.testing.assert_allclose(r["compressed"]["metrics"], want["metrics"], rtol=LOSS_RTOL)
        assert r["compressed"]["grad_err_kinds"] == {"DTensor"}
    for path, v in got[(2, 2)][0]["compressed"]["params"].items():
        np.testing.assert_allclose(v, want["params"][path], rtol=1e-5,
                                   atol=COMPRESSED_PARAM_ATOL, err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_are_laid_out_by_the_rules(runs, arch):
    """At (2, 2) every param is a DTensor placed by its logical axes: the
    reference's ``specs_for_tree`` for the config's rules."""
    from torch.distributed.tensor import Replicate, Shard

    _, _, got, _ = runs
    cfg = _cfg(arch)
    want = {"/".join(p): tuple(v) for p, v in opt_lib.tree_paths(sharding.specs_for_tree(
        transformer.logical_axes(cfg), dict(cfg.sharding_rules), _mesh_names((2, 2))))}
    got_pl = got[(2, 2)][0][arch]["placements"]
    assert set(got_pl) == set(want)
    for path, spec in want.items():
        dims = {}
        for i, entry in enumerate(spec):
            for name in (entry if isinstance(entry, tuple) else (entry,)):
                if name is not None:
                    dims.setdefault(name, i)
        expect = tuple(Shard(dims[n]) if n in dims else Replicate() for n in ("data", "model"))
        assert got_pl[path] == expect, path
    assert any(Shard(0) in pl or Shard(1) in pl or Shard(2) in pl for pl in got_pl.values())


def _mesh_names(shape):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(shape[0] * shape[1]).reshape(shape),
                      mesh_dim_names=("data", "model"), _init_backend=False, _rank=0)


def test_checkpoint_written_at_2x2_restores_at_1x2_and_gives_the_next_step(runs):
    _, _, got, _ = runs
    written = got[(2, 2)][0]
    for r in got[(1, 2)]:
        restored = r["restored"]
        assert restored["step"] == 2 and restored["kinds"] == {"DTensor"}
        for path, v in restored["saved"].items():      # the (2, 2) state, bit for bit
            np.testing.assert_array_equal(v, written[CKPT_ARCH]["params"][path], err_msg=path)
        np.testing.assert_allclose(restored["metrics"], written["ckpt"]["metrics"],
                                   rtol=LOSS_RTOL)
        for path, v in restored["params"].items():
            np.testing.assert_allclose(v, written["ckpt"]["params"][path], rtol=1e-5,
                                       atol=PARAM_ATOL, err_msg=path)
