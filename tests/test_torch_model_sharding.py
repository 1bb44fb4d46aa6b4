"""The model half of the port's ``distributed/sharding.py`` and the MoE
all-to-all dispatch across ranks, against the JAX package.

* ``logical_spec`` / ``_dedup_axes`` / ``specs_for_tree`` equal the JAX
  package's ``PartitionSpec``s for ``transformer.logical_axes`` of every
  LM arch under its ``sharding_rules`` (on a (1, 1) mesh both sides; the
  JAX one on the one CPU device, the port's a ``DeviceMesh`` that needs no
  process group);
* ``_moe_a2a`` on ``gloo`` worlds of 2 and 4 ranks (meshes (1, 2) and
  (2, 2) named ``("data", "model")``, experts over ``"model"``) equals
  the JAX package's ``_moe_a2a`` under ``shard_map`` over 2 and 4 of 8
  forced host devices in a subprocess, at a capacity that drops
  (float32, ``rtol=1e-5, atol=1e-6``; the metrics too), and the port's
  sort path at one that does not; at world 2 its gradients (router,
  experts, tokens) equal the sort path's.

Spawned ranks run functions of this module, so it imports the JAX
package only inside tests: a rank imports the port alone.
"""
import math
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import MoEConfig
from repro_torch.distributed import sharding
from repro_torch.distributed.world import spawn_world
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe, transformer

REPO = os.path.join(os.path.dirname(__file__), "..")
WORLD_TIMEOUT_S = 180
LM_ARCHS = ["glm4-9b", "yi-9b", "granite-moe-3b-a800m", "moonshot-v1-16b-a3b", "llama3-405b"]
RULES = {"experts": "model", "expert_ff": None, "expert_capacity": None,
         "embed": None, "batch": ("data", "model")}
MESHES = {2: (1, 2), 4: (2, 2)}
T, D = 64, 16
MOE = dict(n_experts=8, top_k=2, d_expert=32)
# capacity factors: 0.5 drops slots at both worlds, 8.0 drops none
CAPACITY = {"binding": 0.5, "ample": 8.0}


def _host_mesh_11():
    return make_host_mesh("cpu")


def _jax_mesh_11():
    import jax

    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


# ---------------------------------------------------------------------------
# logical-axis rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_specs_equal_the_reference_for_every_lm_arch(arch):
    from repro.configs import registry as jregistry
    from repro.distributed import sharding as jsh
    from repro.models import transformer as jtransformer

    cfg, jcfg = registry.get_arch(arch).CONFIG, jregistry.get_arch(arch).CONFIG
    rules, mesh, jmesh = dict(cfg.sharding_rules), _host_mesh_11(), _jax_mesh_11()
    axes = transformer.logical_axes(cfg)
    assert _flat(axes) == _flat(jtransformer.logical_axes(jcfg))
    got = _flat(sharding.specs_for_tree(axes, rules, mesh))
    want = {k: v.spec for k, v in _flat(jsh.specs_for_tree(axes, rules, jmesh)).items()}
    assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}
    assert all(isinstance(v, sharding.Spec) for v in got.values())
    # the activations' annotations, deduplicated where two names share a dim
    for names in [("batch", "act_seq", "embed"), ("batch", "seq", "vocab"),
                  ("batch", "act_seq", "vocab"), ("experts", "expert_capacity", "expert_ff"),
                  ("batch", "seq", "heads", None), ("cache_batch", "cache_seq", "kv_heads")]:
        spec = sharding.logical_spec(names, rules, mesh)
        jspec = jsh.logical_spec(names, rules, jmesh)
        assert tuple(spec) == tuple(jspec), names
        assert tuple(sharding._dedup_axes(spec)) == tuple(jsh._dedup_axes(jspec)), names


def test_mesh_rules_context_is_thread_local_and_reentrant():
    mesh = _host_mesh_11()
    assert sharding.current_mesh() is None
    assert sharding.logical_spec(("batch", "embed")) == sharding.Spec()
    assert sharding.named_sharding(("batch",)) is None
    seen = []
    with sharding.use_mesh_rules(mesh, RULES):
        assert sharding.current_mesh() is mesh
        inner = make_host_mesh("cpu")
        with sharding.use_mesh_rules(inner, {"batch": "model"}):
            assert sharding.current_mesh() is inner
            assert sharding.logical_spec(("batch", None)) == sharding.Spec("model", None)
        assert sharding.current_mesh() is mesh
        worker = threading.Thread(target=lambda: seen.append(sharding.current_mesh()))
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
        assert sharding.logical_spec(("batch", "embed", "experts")) == sharding.Spec(
            ("data", "model"), None, "model")
    assert seen == [None] and sharding.current_mesh() is None


def test_named_sharding_placements_and_shard_is_a_no_op_on_one_device():
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard

    mesh = _host_mesh_11()
    got = sharding.named_sharding(("embed", "experts", "batch"), RULES, mesh)
    assert got == (Shard(2), Shard(1))
    assert sharding.named_sharding((None, "embed"), RULES, mesh) == (Replicate(), Replicate())
    x = torch.ones(3, 4)
    assert sharding.shard(x, "batch") is x                    # no context
    with sharding.use_mesh_rules(mesh, RULES):
        assert sharding.shard(x, "batch") is x                # one device, any rank
    two = DeviceMesh("cpu", torch.arange(2).reshape(2, 1), mesh_dim_names=("data", "model"),
                     _init_backend=False, _rank=0)
    with sharding.use_mesh_rules(two, RULES):
        assert sharding.shard(x, "batch", "embed") is x       # plain tensors stay as laid out
        with pytest.raises(ValueError, match="rank 2 tensor got 1"):
            sharding.shard(x, "batch")


def test_make_update_fn_places_grads_under_a_one_device_mesh():
    """``param_axes`` reaches every gradient leaf (an unknown leaf would
    raise) and changes nothing on one device."""
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import steps

    cfg = registry.get_arch("granite-moe-3b-a800m").SMOKE
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                     dtype=torch.float32)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    grad_fn = steps.make_grad_fn(lambda p, b: steps.lm_loss(p, b, cfg))
    placed = steps.make_grad_fn(lambda p, b: steps.lm_loss(p, b, cfg),
                                param_axes=transformer.logical_axes(cfg))
    loss, _, grads = grad_fn(params, batch)
    with sharding.use_mesh_rules(_host_mesh_11(), dict(cfg.sharding_rules)):
        loss2, _, grads2 = placed(params, batch)
    assert float(loss) == float(loss2)
    for path, g in opt_lib.tree_paths(grads):
        assert torch.equal(g, opt_lib.tree_get(grads2, path)), path
    assert float(opt_lib.tree_get(grads, ("layers", "moe", "router")).abs().sum()) > 0
    state = steps.init_train_state(params, opt_lib.adamw(1e-3))
    state, m = steps.build_lm_train_step(cfg, opt_lib.adamw(1e-3))(state, batch)
    assert np.isfinite(float(m["loss"])) and float(m["aux"]) > 0


# ---------------------------------------------------------------------------
# the all-to-all dispatch across ranks
# ---------------------------------------------------------------------------

JAX_A2A_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.base import MoEConfig
from repro.distributed.sharding import use_mesh_rules
from repro.models import moe as moe_lib

data = dict(np.load(sys.argv[1]))
x = jnp.asarray(data.pop("x"))
params = {k: jnp.asarray(v) for k, v in data.items()}
rules = {"experts": "model", "expert_ff": None, "expert_capacity": None,
         "embed": None, "batch": ("data", "model")}
out = {}
for world, shape in ((2, (1, 2)), (4, (2, 2))):
    mesh = Mesh(np.array(jax.devices()[:world]).reshape(shape), ("data", "model"))
    for tag, cf in (("binding", 0.5), ("ample", 8.0)):
        cfg = MoEConfig(n_experts=8, top_k=2, d_expert=32, capacity_factor=cf,
                        dispatch="a2a")
        with use_mesh_rules(mesh, rules):
            xs = jax.device_put(x, NamedSharding(mesh, P(("data", "model"), None)))
            ps = jax.device_put(params, NamedSharding(mesh, P()))
            y, m = jax.jit(lambda p, x: moe_lib.moe_apply(p, x, cfg))(ps, xs)
        out[f"{world}/{tag}/y"] = np.asarray(y)
        for k, v in m.items():
            out[f"{world}/{tag}/{k}"] = np.asarray(v)
np.savez(sys.argv[2], **out)
"""


def _weights():
    rng = np.random.default_rng(11)
    E, F = MOE["n_experts"], MOE["d_expert"]
    w = {
        "router": rng.standard_normal((D, E)) / math.sqrt(D),
        "w_gate": rng.standard_normal((E, D, F)) / math.sqrt(D),
        "w_up": rng.standard_normal((E, D, F)) / math.sqrt(D),
        "w_down": rng.standard_normal((E, F, D)) / math.sqrt(F),
    }
    return {k: v.astype(np.float32) for k, v in w.items()}


def _inputs():
    rng = np.random.default_rng(12)
    return (rng.standard_normal((T, D)).astype(np.float32),
            rng.standard_normal((T, D)).astype(np.float32))


def _a2a_rank(rank, world, shape, weights, x, w_out):
    """One rank: the a2a dispatch at each capacity, the gradients of
    ``sum(y * w_out)`` at ample capacity, the host mesh, and ``shard`` of a
    DTensor."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                      mesh_dim_names=("data", "model"))
    host = make_host_mesh("cpu")
    out = {"host_mesh": (tuple(host.shape), host.mesh_dim_names)}
    x_loc = torch.from_numpy(x).chunk(world)[rank]
    params = {k: torch.from_numpy(v) for k, v in weights.items()}
    with sharding.use_mesh_rules(mesh, RULES):
        for tag, cf in CAPACITY.items():
            cfg = MoEConfig(**MOE, capacity_factor=cf, dispatch="a2a")
            y, m = moe.moe_apply(params, x_loc, cfg)
            out[tag] = (y.numpy(), {k: float(v) for k, v in m.items()})
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        xl = x_loc.clone().requires_grad_()
        y, _ = moe.moe_apply(leaves, xl, MoEConfig(**MOE, capacity_factor=CAPACITY["ample"],
                                                    dispatch="a2a"))
        loss = (y * torch.from_numpy(w_out).chunk(world)[rank]).sum()
        grads = torch.autograd.grad(loss, [xl] + list(leaves.values()))
        out["grads"] = dict(zip(["x"] + list(leaves), (g.numpy() for g in grads)))
        full = distribute_tensor(torch.arange(16.0).reshape(8, 2), mesh,
                                 [Replicate(), Replicate()])
        placed = sharding.shard(full, "batch", None)
        out["dtensor"] = (tuple(placed.placements), placed.to_local().numpy())
    assert out["dtensor"][0] == (Shard(0), Shard(0))
    return out


@pytest.fixture(scope="module")
def a2a_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("a2a")
    weights = _weights()
    x, w_out = _inputs()
    np.savez(tmp / "in.npz", x=x, **weights)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_A2A_SCRIPT, str(tmp / "in.npz"), str(tmp / "want.npz")],
        capture_output=True, text=True, timeout=600, cwd=REPO, env=env,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    want = dict(np.load(tmp / "want.npz"))
    got = {world: spawn_world(_a2a_rank, world, (shape, weights, x, w_out),
                              timeout_s=WORLD_TIMEOUT_S, store_dir=str(tmp / f"store{world}"))
           for world, shape in MESHES.items()}
    return weights, x, w_out, want, got


@pytest.mark.parametrize("world", sorted(MESHES))
def test_a2a_on_gloo_equals_jax_shard_map_where_capacity_drops(a2a_runs, world):
    _, _, _, want, got = a2a_runs
    y = np.concatenate([r["binding"][0] for r in got[world]])
    np.testing.assert_allclose(y, want[f"{world}/binding/y"], rtol=1e-5, atol=1e-6)
    drop = float(want[f"{world}/binding/moe_drop_fraction"])
    assert drop > 0
    for r in got[world]:      # the metrics are means over every rank: equal on all
        m = r["binding"][1]
        assert m["moe_drop_fraction"] == pytest.approx(drop, abs=1e-7)
        for k in ("moe_aux_loss", "moe_z_loss"):
            np.testing.assert_allclose(m[k], float(want[f"{world}/binding/{k}"]), rtol=1e-5)
        assert r["host_mesh"] == ((world, 1), ("data", "model"))
        assert r["dtensor"][1].shape == (8 // world, 2)
    np.testing.assert_array_equal(np.concatenate([r["dtensor"][1] for r in got[world]]),
                                  np.arange(16.0).reshape(8, 2))


@pytest.mark.parametrize("world", sorted(MESHES))
def test_a2a_on_gloo_equals_the_sort_path_where_nothing_drops(a2a_runs, world):
    weights, x, _, want, got = a2a_runs
    cfg = MoEConfig(**MOE, capacity_factor=CAPACITY["ample"])
    sort, _ = moe.moe_apply({k: torch.from_numpy(v) for k, v in weights.items()},
                            torch.from_numpy(x), cfg)
    y = np.concatenate([r["ample"][0] for r in got[world]])
    np.testing.assert_allclose(y, sort.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y, want[f"{world}/ample/y"], rtol=1e-5, atol=1e-6)
    assert all(r["ample"][1]["moe_drop_fraction"] == 0.0 for r in got[world])


def test_a2a_gradients_at_world_2_equal_the_sort_path(a2a_runs):
    """Each rank differentiates its tokens' share of the loss; the reverse
    all-to-all hands each expert's gradient to its owner, so the sum over
    ranks of every weight gradient (zero outside a rank's experts) and the
    ranks' token gradients in order equal the sort path's."""
    weights, x, w_out, _, got = a2a_runs
    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in weights.items()}
    xs = torch.from_numpy(x).requires_grad_()
    y, _ = moe.moe_apply(leaves, xs, MoEConfig(**MOE, capacity_factor=CAPACITY["ample"]))
    want = torch.autograd.grad((y * torch.from_numpy(w_out)).sum(), [xs] + list(leaves.values()))
    want = dict(zip(["x"] + list(leaves), (g.numpy() for g in want)))
    ranks = [r["grads"] for r in got[2]]
    np.testing.assert_allclose(np.concatenate([g["x"] for g in ranks]), want["x"],
                               rtol=1e-5, atol=1e-6)
    E_loc = MOE["n_experts"] // 2
    for k in weights:
        np.testing.assert_allclose(sum(g[k] for g in ranks), want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
        if k != "router":   # a rank's gradient lives on its own experts only
            for r, g in enumerate(ranks):
                others = np.delete(g[k], np.s_[r * E_loc:(r + 1) * E_loc], axis=0)
                assert not others.any(), k
    assert all(np.abs(g["router"]).sum() > 0 for g in ranks)
