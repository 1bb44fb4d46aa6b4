"""The port's SASRec, GNN and cached-LM steps over more than one rank
against the JAX package's sharded steps, on the CPU.

* Worlds: ``gloo`` worlds of 2 ranks (meshes (2, 1) and (1, 2)) and 4
  ranks ((2, 2)), named ``("data", "model")``; one world per mesh, each
  rank running every case.
* SASRec (SMOKE widths, float32, ``CONFIG``'s rules: the item table's
  rows on ``"model"``) and the four GNNs (SMOKE widths, float32, their
  ``CONFIG`` rules: nodes and edges over every mesh dim, params
  replicated): two train steps, loss and gradient norm within
  ``LOSS_RTOL`` (the sharded LM step's tolerance) of the JAX package's step jitted with
  the reference cells' shardings over 2 and 4 of 8 forced host devices.
* SASRec's ``score_all`` and ``score_candidates`` over the split table
  against the unsharded port's.
* glm4-9b SMOKE (float32) under the decode cells' rules (``cache_seq`` on
  ``"model"``): a prefill of 8 tokens into a 16-position cache, then 2
  decode steps; each step's last-position logits against the unsharded
  port's and the JAX package's.  At (1, 2) and (2, 2) the cache's
  positions are split, so the prefill's cache write falls on one rank's
  range and each decode step combines two ranks' key ranges.

Spawned ranks run functions of this module, so it imports the JAX
package only inside the subprocess that runs it.
"""
import concurrent.futures
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
from repro_torch.models import gnn, sasrec, transformer
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import steps

REPO = os.path.join(os.path.dirname(__file__), "..")
WORLD_TIMEOUT_S = 240
MESHES = [(2, 1), (1, 2), (2, 2)]
GNNS = ["meshgraphnet", "graphcast", "schnet", "dimenet"]
LOSS_RTOL = 1e-5
LOGIT_ATOL = 1e-5
B_REC = 8
PREFILL, MAX_LEN, DECODE = 8, 16, 2


def _cfg(arch):
    mod = registry.get_arch(arch)
    return dataclasses.replace(mod.SMOKE, dtype="float32",
                               sharding_rules=dict(mod.CONFIG.sharding_rules))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.numpy()
    return out


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = torch.from_numpy(np.array(v))
    return out


def _pad(a, n, fill=0):
    pad = (-a.shape[0]) % n
    return np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)]) if pad else a


def _inputs():
    """Every case's params and batch, as numpy (the same on both sides)."""
    from repro_torch.data.graphs import batch_molecules, random_graph

    out = {}
    cfg = _cfg("sasrec")
    rng = np.random.default_rng(3)
    seqs = rng.integers(0, cfg.n_items, (B_REC, cfg.seq_len)).astype(np.int32)
    seqs[0, :5] = 0
    out["sasrec"] = (_flat(sasrec.init_params(cfg, torch.Generator().manual_seed(0), "cpu")),
                     {"seqs": seqs, "pos": np.roll(seqs, -1, axis=1),
                      "neg": rng.integers(1, cfg.n_items, seqs.shape).astype(np.int32)})
    for arch in GNNS:
        cfg = _cfg(arch)
        if cfg.kind in ("schnet", "dimenet"):
            g = batch_molecules(4, 8, 20, d_feat=6, seed=1, device="cpu")
            graph = {f.name: getattr(g, f.name).numpy() for f in dataclasses.fields(g)
                     if isinstance(getattr(g, f.name), torch.Tensor)}
            target = rng.standard_normal((4, cfg.d_out)).astype(np.float32)
        else:
            src, dst, feats, pos = random_graph(64, 200, 6, seed=1, with_positions=True)
            graph = {"nodes": feats, "edge_src": src.astype(np.int32),
                     "edge_dst": dst.astype(np.int32), "positions": pos,
                     "node_mask": np.ones(64, bool), "edge_mask": np.ones(200, bool)}
            target = rng.standard_normal((64, cfg.d_out)).astype(np.float32)
        for name in ("edge_src", "edge_dst", "edge_mask", "triplets", "triplet_mask"):
            if name in graph:                    # rows divisible by 4 ranks, padding masked
                graph[name] = _pad(graph[name], 4)
        if "triplets" in graph and "triplet_mask" not in graph:
            graph["triplet_mask"] = _pad(np.ones(len(graph["triplets"]), bool), 4)
        params = gnn.init_params(cfg, torch.Generator().manual_seed(0), d_in=6, device="cpu")
        out[arch] = (_flat(params), {"graph": graph, "target": target})
    cfg = _cfg("glm4-9b")
    out["glm4-9b"] = (_flat(transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                                    "cpu", dtype=torch.float32)),
                      {"tokens": rng.integers(0, cfg.vocab_size,
                                              (2, PREFILL + DECODE)).astype(np.int32)})
    return out


def _graph(arrays, n_graphs):
    fields = {f.name for f in dataclasses.fields(gnn.GraphBatch)}
    return gnn.GraphBatch(n_graphs=n_graphs, **{
        k: torch.from_numpy(np.array(v)) for k, v in arrays.items() if k in fields})


def _optimizer(arch):
    return opt_lib.adamw(1e-3 if arch == "sasrec" else 3e-4)


def _train(arch, params, batch, mesh=None):
    """Two steps: ``[(loss, grad norm)] * 2``, sharded over ``mesh`` when
    given."""
    cfg = _cfg(arch)
    rules = dict(cfg.sharding_rules)
    state = steps.init_train_state(_nest(params), _optimizer(arch))
    if arch == "sasrec":
        step = steps.build_sasrec_train_step(cfg, _optimizer(arch))
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
    else:
        step = steps.build_gnn_train_step(cfg, _optimizer(arch))
        n_graphs = batch["target"].shape[0] if cfg.kind in ("schnet", "dimenet") else 1
        b = {"graph": _graph(batch["graph"], n_graphs),
             "target": torch.from_numpy(batch["target"])}
    if mesh is not None:
        if arch == "sasrec":
            state = sharding.distribute_state(state, sasrec.logical_axes(cfg), rules, mesh)
            rows = sharding.batch_placements(rules, mesh)
            b = sharding.place_tree(b, {k: rows for k in b}, mesh)
        else:
            state = sharding.place_tree(state, sharding.state_placements(
                state, _replicated(state["params"]), rules, mesh), mesh)
            level = "batch" if b["target"].shape[0] != b["graph"].n_nodes else "nodes"
            b = {"graph": gnn.distribute_graph(b["graph"], rules, mesh),
                 "target": sharding.place_tree(b["target"], sharding.placements_for(
                     (level, None), rules, mesh), mesh)}
    out = []
    with sharding.use_mesh_rules(mesh, rules) if mesh is not None else _null():
        for _ in range(2):
            state, m = step(state, b)
            out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def _replicated(params):
    return {k: _replicated(v) if isinstance(v, dict) else (None,) * v.ndim
            for k, v in params.items()}


def _null():
    import contextlib

    return contextlib.nullcontext()


def _scores(params, batch, mesh=None):
    """SASRec's ``score_all`` (top-5 scores) and ``score_candidates`` on the
    first 4 users, as numpy."""
    cfg = _cfg("sasrec")
    p = _nest(params)
    seqs = torch.from_numpy(batch["seqs"][:4])
    cand = torch.from_numpy(batch["neg"][:4, :16].copy())
    if mesh is not None:
        rules = dict(cfg.sharding_rules)
        p = sharding.distribute_tree(p, sasrec.logical_axes(cfg), rules, mesh)
        seqs = sharding.place_tree(seqs, sharding.batch_placements(rules, mesh), mesh)
        cand = sharding.place_tree(cand, sharding.placements_for((None, "items"), rules, mesh),
                                   mesh)
    with sharding.use_mesh_rules(mesh, dict(cfg.sharding_rules)) if mesh is not None \
            else _null(), torch.no_grad():
        s, i = sasrec.score_all(p, seqs, cfg, top_k=5)
        c = sasrec.score_candidates(p, seqs, cand, cfg)
    full = lambda t: (t.full_tensor() if sharding.is_dtensor(t) else t).numpy()  # noqa: E731
    return full(s), full(i), full(c)


def _lm(params, tokens, mesh=None):
    """Prefill, then decode steps: each step's last-position logits."""
    cfg = _cfg("glm4-9b")
    rules = {**cfg.sharding_rules, "cache_seq": "model"}
    p = _nest(params)
    tok = torch.from_numpy(tokens)
    if mesh is not None:
        p = sharding.distribute_tree(p, transformer.logical_axes(cfg), rules, mesh)

    def place(t):
        if mesh is None:
            return t
        return sharding.place_tree(t, sharding.placements_for(("cache_batch", None), rules,
                                                              mesh), mesh)

    prefill = steps.build_lm_prefill_step(cfg, MAX_LEN)
    decode = steps.build_lm_decode_step(cfg)
    out = []
    with sharding.use_mesh_rules(mesh, rules) if mesh is not None else _null(), \
            torch.no_grad():
        logits, cache = prefill(p, place(tok[:, :PREFILL]))
        out.append(logits)
        for i in range(DECODE):
            logits, cache = decode(p, cache, place(tok[:, PREFILL + i:PREFILL + i + 1]))
            out.append(logits)
        kinds = {type(cache.k).__name__}
    return [(t.full_tensor() if sharding.is_dtensor(t) else t).numpy() for t in out], kinds


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------

def _mesh(shape):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(shape[0] * shape[1]).reshape(shape),
                      mesh_dim_names=("data", "model"))


def _rank(rank, world, shape, inputs):
    mesh = _mesh(shape)
    out = {}
    for arch in ["sasrec"] + GNNS:
        params, batch = inputs[arch]
        out[arch] = _train(arch, params, batch, mesh)
    out["scores"] = _scores(*inputs["sasrec"], mesh)
    out["lm"] = _lm(inputs["glm4-9b"][0], inputs["glm4-9b"][1]["tokens"], mesh)
    return out


# ---------------------------------------------------------------------------
# the JAX package's sharded steps
# ---------------------------------------------------------------------------

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec
from repro.configs import registry
from repro.distributed.sharding import specs_for_tree, use_mesh_rules
from repro.launch.cells import _ns, _opt_shardings, _replicated_tree
from repro.models import gnn, sasrec, transformer
from repro.train import optimizer as opt_lib, steps

inputs = pickle.load(open(sys.argv[1], "rb"))

def nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = jnp.asarray(v)
    return out

def cfg_of(arch):
    mod = registry.get_arch(arch)
    return dataclasses.replace(mod.SMOKE, dtype="float32",
                               sharding_rules=dict(mod.CONFIG.sharding_rules))

out = {}
for shape in ((2, 1), (1, 2), (2, 2)):
    mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape), ("data", "model"))
    for arch in ["sasrec", "meshgraphnet", "graphcast", "schnet", "dimenet"]:
        cfg = cfg_of(arch)
        rules = dict(cfg.sharding_rules)
        params, batch = inputs[arch]
        opt = opt_lib.adamw(1e-3 if arch == "sasrec" else 3e-4)
        state = steps.init_train_state(nest(params), opt)
        rep = NamedSharding(mesh, PartitionSpec())
        if arch == "sasrec":
            step = steps.build_sasrec_train_step(cfg, opt)
            ps = specs_for_tree(sasrec.logical_axes(cfg), rules, mesh)
            state_sh = {"params": ps, "opt": _opt_shardings(state["opt"], ps, mesh), "step": rep}
            b = {k: jnp.asarray(v) for k, v in batch.items()}
            b_sh = {k: _ns(mesh, rules, ("batch", None)) for k in b}
        else:
            step = steps.build_gnn_train_step(cfg, opt)
            state_sh = {"params": _replicated_tree(state["params"], mesh),
                        "opt": _replicated_tree(state["opt"], mesh), "step": rep}
            g = batch["graph"]
            graph_level = cfg.kind in ("schnet", "dimenet")
            n_graphs = batch["target"].shape[0] if graph_level else 1
            fields = {f.name for f in dataclasses.fields(gnn.GraphBatch)}
            gb = gnn.GraphBatch(n_graphs=n_graphs, **{k: jnp.asarray(v) for k, v in g.items()
                                                      if k in fields})
            def sh(name, v):
                if v is None or name == "n_graphs":
                    return v
                ax = "nodes" if name in ("nodes", "node_mask", "positions", "graph_ids") else "edges"
                return _ns(mesh, rules, (ax,) + (None,) * (v.ndim - 1))
            g_sh = dataclasses.replace(gb, **{f.name: sh(f.name, getattr(gb, f.name))
                                              for f in dataclasses.fields(gb)})
            b = {"graph": gb, "target": jnp.asarray(batch["target"])}
            b_sh = {"graph": g_sh,
                    "target": _ns(mesh, rules, ("batch" if graph_level else "nodes", None))}
        with use_mesh_rules(mesh, rules):
            s = jax.device_put(state, state_sh)
            bb = jax.device_put(b, b_sh)
            f = jax.jit(step, in_shardings=(state_sh, b_sh))
            res = []
            for _ in range(2):
                s, m = f(s, bb)
                res.append((float(m["loss"]), float(m["grad_norm"])))
        out[(shape, arch)] = res
# the cached LM, unsharded
cfg = cfg_of("glm4-9b")
params, batch = inputs["glm4-9b"]
p = nest(params)
tok = jnp.asarray(batch["tokens"])
logits, cache = jax.jit(steps.build_lm_prefill_step(cfg, max_len=16))(p, tok[:, :8])
lm = [np.asarray(logits)]
decode = jax.jit(steps.build_lm_decode_step(cfg))
for i in range(2):
    logits, cache = decode(p, cache, tok[:, 8 + i:9 + i])
    lm.append(np.asarray(logits))
out["lm"] = lm
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import pickle

    tmp = tmp_path_factory.mktemp("sharded_models")
    inputs = _inputs()
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(tmp / "inputs.pkl"),
                             str(tmp / "want.pkl")], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=REPO, env=env)
    try:
        one = {arch: _train(arch, *inputs[arch]) for arch in ["sasrec"] + GNNS}
        one["scores"] = _scores(*inputs["sasrec"])
        one["lm"] = _lm(inputs["glm4-9b"][0], inputs["glm4-9b"][1]["tokens"])

        def world(shape):
            return spawn_world(_rank, shape[0] * shape[1], (shape, inputs),
                               timeout_s=WORLD_TIMEOUT_S,
                               store_dir=str(tmp / f"store{shape[0]}{shape[1]}"))

        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            beside = pool.submit(world, (2, 1))
            got = {(2, 2): world((2, 2)), (1, 2): world((1, 2)), (2, 1): beside.result()}
        text, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, text
        with open(tmp / "want.pkl", "rb") as f:
            want = pickle.load(f)
    finally:
        if proc.poll() is None:
            proc.kill()
    return one, got, want


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ["sasrec"] + GNNS)
def test_sharded_train_step_equals_the_jax_sharded_step(runs, arch, shape):
    one, got, want = runs
    for r in got[shape]:
        np.testing.assert_allclose(r[arch], want[(shape, arch)], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r[arch], one[arch], rtol=LOSS_RTOL)


@pytest.mark.parametrize("shape", MESHES)
def test_sasrec_scores_over_the_split_table(runs, shape):
    one, got, _ = runs
    s1, i1, c1 = one["scores"]
    for r in got[shape]:
        s, i, c = r["scores"]
        np.testing.assert_allclose(s, s1, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(np.sort(i, axis=1), np.sort(i1, axis=1))
        np.testing.assert_allclose(c, c1, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape", MESHES)
def test_cached_prefill_and_decode_over_a_sharded_cache(runs, shape):
    one, got, want = runs
    ref, kinds = one["lm"]
    assert kinds == {"Tensor"}
    for r in got[shape]:
        logits, kinds = r["lm"]
        assert kinds == {"DTensor"}
        for step, (l, l1, lj) in enumerate(zip(logits, ref, want["lm"])):
            np.testing.assert_allclose(l, l1, rtol=1e-5, atol=LOGIT_ATOL, err_msg=str(step))
            np.testing.assert_allclose(l, lj, rtol=1e-5, atol=LOGIT_ATOL, err_msg=str(step))
