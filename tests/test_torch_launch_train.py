"""The port's training launchers on the CPU: ``launch/train.py`` for the
three families and an MoE LM (3 steps, a checkpoint, then ``--resume``), and
``launch/recsys_serve.py`` against the JAX package's
``examples/recsys_serve.py`` path with the same SASRec weights.

The recsys comparison runs the example's path in float32 (the example's
config with ``dtype="float32"``).  Over 30 AdamW steps float32 round-off
compounds: where a gradient element is near AdamW's ``eps``, its update
(about ``lr * g / (|g| + eps)``) moves with the last bits of ``g``, and
after 30 steps the two packages' losses differ by ~1e-4 relative (step
29: 1.0008e-4 with PyTorch on 2 CPU threads, 9.9e-5 on 8), at the edge of
any tolerance that order of sums can promise.  So training is held
step by step: each of the port's 30 steps starts from the reference's
state before that step (weights and AdamW moments) on the same batch, and
its loss is held to ``rtol=1e-5`` (measured ≤ 6e-7), its moments to 1e-5
of each leaf's largest element (measured ≤ 2.1e-6) and its weights to a
tenth of the learning rate (measured ≤ 1.9e-5, the elements near
``eps``).  The launcher's own 30 losses equal, within ``rtol=1e-6``,
those of the port's step chained from the same initial weights on the
same batches (measured: bit for bit), and the launcher's trained model's
top-5 scores stay within 5% of the largest of the reference's (measured
drift ~2%).  The serving calls are held strictly on the same
weights: the reference's trained weights carried into the port give its
scores ``rtol=1e-5`` and its ids wherever the scores are separated.  The
graph half (extraction, the streaming correction, PageRank, the served
answers) runs on NumPy-identical inputs: counts exactly, scores
``rtol=1e-5, atol=1e-6``.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro_torch.configs import registry
from repro_torch.launch import recsys_serve
from repro_torch.launch import train as launch_train
from repro_torch.train.checkpoint import latest_step, restore_checkpoint

NEW_ARCHS = ["meshgraphnet", "graphcast", "schnet", "dimenet", "sasrec"]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_carry_the_reference_numbers(arch):
    for name in ("CONFIG", "SMOKE", "SHAPE_FAMILY"):
        ref, got = getattr(jregistry.get_arch(arch), name), getattr(registry.get_arch(arch), name)
        assert (got if isinstance(got, str) else dataclasses.asdict(got)) == (
            ref if isinstance(ref, str) else dataclasses.asdict(ref))
    assert registry.shapes_for(arch) == jregistry.shapes_for(arch)


@pytest.mark.parametrize("arch", ["glm4-9b", "sasrec", "schnet", "granite-moe-3b-a800m"])
def test_train_launcher_checkpoints_and_resumes(arch, tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    args = ["--arch", arch, "--device", "cpu", "--checkpoint-dir", ckpt]
    assert launch_train.main(args + ["--steps", "3", "--checkpoint-every", "2"]) == 0
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines() if line.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses)) and out.rstrip().endswith("done")
    assert latest_step(ckpt) == 3
    state, step = restore_checkpoint(ckpt)
    assert step == 3 and int(state["step"]) == 3 and set(state) == {"params", "opt", "step"}
    assert launch_train.main(args + ["--steps", "5", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "step     4 loss" in out
    assert latest_step(ckpt) == 5
    resumed, _ = restore_checkpoint(ckpt)
    assert int(resumed["step"]) == 5
    assert sorted(os.listdir(ckpt)) == ["LATEST", "step_0000000003", "step_0000000005"]


def test_train_launcher_refuses_unported_arch():
    """Kept under its old name: graphgen-paper is in the registry now, and
    the launcher refuses it because it has no train step."""
    with pytest.raises(ValueError, match="distributed_analytics"):
        launch_train.main(["--arch", "graphgen-paper", "--device", "cpu"])


def _flatten(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(k.key for k in path): np.asarray(a) for path, a in leaves}


def _port_arrays(tree: dict, prefix: str = "") -> dict:
    """The port's nested dict of tensors as path-keyed numpy arrays, keyed
    as :func:`_flatten` keys the reference's."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_port_arrays(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v.detach().cpu().numpy()
    return out


def _reference_example(cfg, jparams):
    """``examples/recsys_serve.py``'s ``main``, step for step, with its
    prints replaced by the values they show."""
    from repro.core import algorithms, extract
    from repro.core.relational import Catalog, Table
    from repro.data.pipeline import sasrec_batches
    from repro.models import sasrec
    from repro.serve import GraphQuery, GraphQueryServer
    from repro.train import optimizer as opt_lib
    from repro.train import steps as steps_lib

    out = {}
    optimizer = opt_lib.adamw(1e-3)
    state = steps_lib.init_train_state(jparams, optimizer)
    step = jax.jit(steps_lib.build_sasrec_train_step(cfg, optimizer))
    batches = sasrec_batches(cfg.n_items, cfg.seq_len, batch=64, seed=0)
    out["losses"], out["states"] = [], []
    for _ in range(30):
        batch = next(batches)
        out["states"].append((batch, _flatten(state["params"]), _flatten(state["opt"]["m"]),
                              _flatten(state["opt"]["v"])))
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        out["losses"].append(float(m["loss"]))
    out["params"] = state["params"]
    seqs = jnp.asarray(next(batches)["seqs"][:8])
    out["seqs"] = np.asarray(seqs)
    scores, ids = sasrec.score_all(state["params"], seqs, cfg, top_k=5)
    out["top_scores"], out["top_ids"] = np.asarray(scores), np.asarray(ids)
    cands = jnp.asarray(np.random.default_rng(0).integers(1, cfg.n_items, size=(1, 2_000)))
    out["candidate_scores"] = np.asarray(sasrec.score_candidates(state["params"], seqs[:1],
                                                                 cands, cfg))
    rng = np.random.default_rng(1)
    n_users, n_interactions = 500, 4_000
    users = rng.integers(0, n_users, n_interactions)
    items = rng.zipf(1.5, n_interactions) % 300
    catalog = Catalog([
        Table("User", {"uid": np.arange(n_users)}),
        Table("Interaction", {"uid": users, "iid": items}),
    ])
    g = extract(catalog, recsys_serve.GRAPH_QUERY).graph
    out["edges"] = (g.n_edges_condensed, g.n_edges_expanded())
    server = GraphQueryServer.from_condensed(g, budget_bytes=2 << 20, max_batch=32)
    acct = server.correction_accounting
    out["correction"] = (acct.peak_resident_triples, acct.n_chunks, acct.n_paths)
    pr = algorithms.pagerank(server.graph, num_iters=10)
    out["pagerank"], out["central_user"] = np.asarray(pr), int(jnp.argmax(pr))
    queries = [GraphQuery(qid=i, kind="common_neighbors", node=int(u))
               for i, u in enumerate(rng.integers(0, n_users, size=24))]
    queries += [GraphQuery(qid=100 + i, kind="ppr", node=int(u))
                for i, u in enumerate(rng.integers(0, n_users, size=8))]
    answers = server.run(queries)
    out["answers"] = {qid: np.asarray(a) for qid, a in answers.items()}
    out["served"] = (server.n_queries, server.n_propagation_batches)
    scores0 = np.array(out["answers"][0])
    scores0[queries[0].node] = -np.inf
    out["partners"] = np.argsort(scores0)[::-1][:3].tolist()
    return out


def test_recsys_launcher_answers_equal_the_reference_example(capsys):
    from repro.models import sasrec as jsasrec
    from repro_torch.models.interop import sasrec_params_from_arrays

    cfg = dataclasses.replace(recsys_serve.DEMO, dtype="float32")
    jparams = jsasrec.init_params(jax.random.PRNGKey(0), cfg)
    want = _reference_example(cfg, jparams)
    got = recsys_serve.run(cfg, sasrec_params_from_arrays(_flatten(jparams), cfg, "cpu"),
                           device="cpu")
    assert "served 32 queries" in capsys.readouterr().out

    # training, step by step from the reference's state before each step
    from repro_torch.models.interop import tree_from_arrays
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import steps as steps_lib

    optimizer = opt_lib.adamw(1e-3)
    step = steps_lib.build_sasrec_train_step(cfg, optimizer)
    after = want["states"][1:] + [(None, _flatten(want["params"]), None, None)]
    for t, ((batch, p, m, v), (_, p1, m1, v1)) in enumerate(zip(want["states"], after)):
        state = {"params": sasrec_params_from_arrays(p, cfg, "cpu"),
                 "opt": {"m": tree_from_arrays(m, "cpu"), "v": tree_from_arrays(v, "cpu")},
                 "step": torch.tensor(t, dtype=torch.int32)}
        state, metrics = step(state, {k: torch.from_numpy(x) for k, x in batch.items()})
        np.testing.assert_allclose(float(metrics["loss"]), want["losses"][t], rtol=1e-5,
                                   err_msg=f"step {t}")
        for key, ref, bound in (("params", p1, 1e-4), ("m", m1, None), ("v", v1, None)):
            if ref is None:
                continue
            tree = state[key] if key == "params" else state["opt"][key]
            for path, leaf in _port_arrays(tree).items():
                atol = bound if bound is not None else 1e-5 * np.abs(ref[path]).max()
                np.testing.assert_allclose(leaf, ref[path], rtol=0, atol=atol,
                                           err_msg=f"step {t} {key} {path}")
    # the launcher's own 30 steps: that step chained from the same initial
    # state with the same optimizer on the same batches, in the same order
    state = steps_lib.init_train_state(
        sasrec_params_from_arrays(_flatten(jparams), cfg, "cpu"), optimizer)
    chained = []
    for batch, *_ in want["states"]:
        state, metrics = step(state, {k: torch.from_numpy(x) for k, x in batch.items()})
        chained.append(float(metrics["loss"]))
    np.testing.assert_allclose(got["losses"], chained, rtol=1e-6)
    top = np.abs(want["top_scores"]).max()
    np.testing.assert_allclose(got["top_scores"], want["top_scores"], atol=0.05 * top)

    # serving, on the same (the reference's trained) weights
    from repro_torch.models import sasrec

    trained = sasrec_params_from_arrays(_flatten(want["params"]), cfg, "cpu")
    seqs = torch.from_numpy(want["seqs"].copy())
    s, i = sasrec.score_all(trained, seqs, cfg, top_k=5)
    ws, wi = jsasrec.score_all(want["params"], jnp.asarray(want["seqs"]), cfg, top_k=5)
    ws, wi = np.asarray(ws), np.asarray(wi)
    np.testing.assert_allclose(s.numpy(), ws, rtol=1e-5, atol=1e-6)
    gap = np.minimum(np.abs(np.diff(ws, axis=1, prepend=np.inf)),
                     np.abs(np.diff(ws, axis=1, append=-np.inf)))
    sep = gap > 1e-5 * np.abs(ws).max()
    assert sep.mean() > 0.9
    np.testing.assert_array_equal(i.numpy()[sep], wi[sep])
    cands = np.random.default_rng(0).integers(1, cfg.n_items, size=(1, 2_000))
    np.testing.assert_allclose(
        sasrec.score_candidates(trained, seqs[:1], torch.from_numpy(cands), cfg).numpy(),
        want["candidate_scores"], rtol=1e-5, atol=1e-6)

    for key in ("edges", "correction", "central_user", "served", "partners"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["pagerank"], want["pagerank"], rtol=1e-5, atol=1e-6)
    assert set(got["answers"]) == set(want["answers"])
    for qid, a in want["answers"].items():
        np.testing.assert_allclose(got["answers"][qid], a, rtol=1e-5, atol=1e-6,
                                   err_msg=str(qid))


def test_recsys_launcher_runs_on_cpu(capsys):
    assert recsys_serve.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "training SASRec" in out and "served 32 queries" in out
