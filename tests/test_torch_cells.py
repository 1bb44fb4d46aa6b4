"""The port's dry-run cells (``launch/cells.py``) against the JAX package's,
on the production meshes, on the CPU.

* The JAX side: one subprocess over 512 forced host devices builds every
  cell and variant on ``(16, 16)`` and ``(2, 16, 16)`` meshes and dumps
  each argument leaf's shape, dtype and ``PartitionSpec`` as JSON, with
  ``model_flops`` of the 41 cells.
* The port's side: the same cells on ``DeviceMesh``es of the same shapes
  and names (no process group is needed to build a cell).
* Leaves are matched by path (``0/params/embed``, ``1/graph/edge_src``);
  the one difference by design is a decode cache's ``length``, an int32
  scalar in the reference and a Python int in the port (asserted).
* Variants: ``a2a`` on the MoE archs, ``zero3`` on the LM archs, and
  ``banded`` on graphgen-paper.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import registry, shapes
from repro_torch.launch import cells as cells_lib
from repro_torch.launch.roofline import model_flops

REPO = os.path.join(os.path.dirname(__file__), "..")
MESHES = {"single": (16, 16), "multi": (2, 16, 16)}
MOE = ["granite-moe-3b-a800m", "moonshot-v1-16b-a3b"]
LMS = ["glm4-9b", "yi-9b", "llama3-405b"] + MOE
BASE = cells_lib.all_cells() + [("graphgen-paper", "pagerank")]
TARGETS = (
    [(a, s, None) for a, s in BASE]
    + [(a, s, "a2a") for a in MOE for s in shapes.LM_SHAPES]
    + [(a, s, "zero3") for a in LMS for s in shapes.LM_SHAPES]
    + [("graphgen-paper", "pagerank", "banded")]
)

JAX_SCRIPT = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from jax.sharding import NamedSharding
from repro.configs import registry
from repro.launch import cells
from repro.launch.mesh import make_production_mesh
from repro.launch.roofline import model_flops

targets = json.loads(open(sys.argv[1]).read())

def key(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)

def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in s]

out = {"all_cells": cells.all_cells(), "assigned": registry.list_archs(assigned_only=True),
       "model_flops": {f"{a}/{s}": model_flops(a, s)
                       for a, s in cells.all_cells() + [("graphgen-paper", "pagerank")]},
       "cells": {}}
for mesh_name, multi in (("single", False), ("multi", True)):
    mesh = make_production_mesh(multi_pod=multi)
    for arch, shape, variant in targets:
        cell = cells.build_cell(arch, shape, mesh, variant=variant)
        leaves = {}
        for i, (a, sh) in enumerate(zip(cell.args, cell.in_shardings)):
            args = jax.tree_util.tree_flatten_with_path(a)[0]
            shs = jax.tree_util.tree_leaves(sh, is_leaf=lambda x: isinstance(x, NamedSharding))
            assert len(args) == len(shs), (arch, shape)
            for (path, leaf), s in zip(args, shs):
                name = "/".join([str(i)] + [key(k) for k in path])
                leaves[name] = [list(leaf.shape), str(leaf.dtype), spec(s.spec)]
        out["cells"][f"{mesh_name}/{arch}/{shape}/{variant}"] = {
            "kind": cell.kind, "donate": list(cell.donate), "leaves": leaves}
json.dump(out, open(sys.argv[2], "w"))
"""


def _mesh(shape):
    from torch.distributed.device_mesh import DeviceMesh

    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh("cpu", torch.arange(n).reshape(shape), mesh_dim_names=names,
                      _init_backend=False, _rank=0)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cells")
    (tmp / "targets.json").write_text(json.dumps(TARGETS))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(tmp / "targets.json"),
                           str(tmp / "ref.json")], capture_output=True, text=True, timeout=600,
                          cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads((tmp / "ref.json").read_text())


@pytest.fixture(scope="module")
def meshes():
    return {name: _mesh(shape) for name, shape in MESHES.items()}


def _spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in s]


def test_all_cells_and_assigned_archs_are_the_references(reference):
    assert [list(c) for c in cells_lib.all_cells()] == reference["all_cells"]
    assert len(cells_lib.all_cells()) == 40
    assert registry.list_archs(assigned_only=True) == reference["assigned"]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape,variant", TARGETS)
def test_cell_equals_the_reference_cell(reference, meshes, mesh_name, arch, shape, variant):
    """Shapes, dtypes and per-leaf specs of every argument, leaf for leaf."""
    want = reference["cells"][f"{mesh_name}/{arch}/{shape}/{variant}"]
    cell = cells_lib.build_cell(arch, shape, meshes[mesh_name], variant=variant)
    assert cell.kind == want["kind"] and list(cell.donate) == want["donate"]
    got = {path: [list(a.shape), str(a.dtype).replace("torch.", ""), _spec(sh)]
           for path, (a, sh) in cells_lib.cell_leaves(cell).items()}
    ref = dict(want["leaves"])
    if cell.kind == "decode":                  # the port's cache length is a Python int
        assert ref.pop("1/length") == [[], "int32", []]
        assert cell.args[1].length == shapes.LM_SHAPES[shape].seq_len - 1
    assert sorted(got) == sorted(ref)
    for path in ref:
        assert got[path] == ref[path], path


@pytest.mark.parametrize("arch,shape", BASE)
def test_model_flops_equal_the_reference(reference, arch, shape):
    assert model_flops(arch, shape) == reference["model_flops"][f"{arch}/{shape}"]


def test_materialize_gives_each_ranks_shard_as_a_dtensor(meshes):
    """Under a fake mode the arguments are DTensors of the global shapes,
    each holding rank 0's shard (a ``(16, 16)`` mesh needs no group to
    build them)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard

    cell = cells_lib.build_cell("sasrec", "train_batch", meshes["single"])
    with FakeTensorMode():
        state, batch = cells_lib.materialize(cell, "cpu")
    table = state["params"]["item_embed"]
    assert tuple(table.shape) == (1_000_000, 50)
    assert tuple(table.placements) == (Replicate(), Shard(0))
    assert tuple(table.to_local().shape) == (62_500, 50)
    assert tuple(batch["seqs"].to_local().shape) == (65_536 // 16, 50)
