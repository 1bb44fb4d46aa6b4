"""SASRec end to end: train briefly, then serve, then the graph tie-in.

    PYTHONPATH=src python -m repro_torch.launch.recsys_serve --device cpu

The port of the JAX package's ``examples/recsys_serve.py``, step by step:

1. SASRec (``embed_dim`` 50, 2 blocks, 1 head, ``seq_len`` 50, 5,000
   items) trains 30 AdamW steps on batches of 64 (K4's training route on
   the card);
2. ``score_all``: top-5 over the whole catalog for 8 users;
3. ``score_candidates``: one user against 2,000 candidates;
4. the co-interaction graph of 500 users and 4,000 interactions (users
   who interacted with the same item), extracted with the paper's DSL,
   condensed;
5. ``GraphQueryServer.from_condensed`` builds the DEDUP-C correction under
   a 2 MB streaming budget and uploads both graphs packed (``'auto'``
   dispatch: K1 and K3 on the card, the segment path on the CPU);
   ``pagerank`` names the most central user and ``run`` answers 24
   common-neighbour and 8 personalized-PageRank queries in micro-batches.

:func:`run` returns every answer, so the tests can hold them against the
reference's with the same SASRec weights (:func:`main` draws its own from
seed 0).  Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..configs.base import RecsysConfig

__all__ = ["DEMO", "GRAPH_QUERY", "co_interaction_catalog", "example_queries", "run", "main"]

DEMO = RecsysConfig(name="sasrec-demo", embed_dim=50, n_blocks=2, n_heads=1,
                    seq_len=50, n_items=5_000)

GRAPH_QUERY = """
    Nodes(ID) :- User(ID).
    Edges(ID1, ID2) :- Interaction(ID1, item), Interaction(ID2, item).
"""


def co_interaction_catalog(n_users: int = 500, n_interactions: int = 4_000, seed: int = 1):
    """The example's catalog; also returns its generator, which draws the
    queries next."""
    from ..core.relational import Catalog, Table

    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, n_interactions)
    items = rng.zipf(1.5, n_interactions) % 300
    catalog = Catalog([
        Table("User", {"uid": np.arange(n_users)}),
        Table("Interaction", {"uid": users, "iid": items}),
    ])
    return catalog, rng


def example_queries(rng, n_users: int = 500):
    """The example's 24 common-neighbour and 8 PPR queries, drawn from the
    catalog's generator."""
    from ..serve.server import GraphQuery

    queries = [GraphQuery(qid=i, kind="common_neighbors", node=int(u))
               for i, u in enumerate(rng.integers(0, n_users, size=24))]
    queries += [GraphQuery(qid=100 + i, kind="ppr", node=int(u))
                for i, u in enumerate(rng.integers(0, n_users, size=8))]
    return queries


def run(cfg: RecsysConfig, params: Dict, device="cuda", steps: int = 30,
        log=print) -> Dict:
    """The example's path with the SASRec weights ``params`` (on
    ``device``); returns its answers."""
    from ..core import algorithms, extract
    from ..data.pipeline import sasrec_batches
    from ..models import sasrec
    from ..serve.server import GraphQueryServer
    from ..train import optimizer as opt_lib
    from ..train import steps as steps_lib

    out: Dict = {}
    optimizer = opt_lib.adamw(1e-3)
    state = steps_lib.init_train_state(params, optimizer)
    step = steps_lib.build_sasrec_train_step(cfg, optimizer)

    def to_device(b):
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    batches = sasrec_batches(cfg.n_items, cfg.seq_len, batch=64, seed=0)
    log("training SASRec...")
    out["losses"] = []
    for i in range(steps):
        state, m = step(state, to_device(next(batches)))
        out["losses"].append(float(m["loss"]))
        if i % 10 == 0:
            log(f"  step {i}: bce={out['losses'][-1]:.4f}")

    # serving: full-catalog top-k
    seqs = torch.from_numpy(next(batches)["seqs"][:8]).to(device)
    with torch.no_grad():
        t0 = time.time()
        scores, ids = sasrec.score_all(state["params"], seqs, cfg, top_k=5)
        ids = ids.cpu().numpy()
        log(f"top-5 for 8 users in {(time.time() - t0) * 1e3:.0f} ms:")
        log(str(ids[:3]))
        # retrieval: one user against a candidate set (batched dot)
        cands = np.random.default_rng(0).integers(1, cfg.n_items, size=(1, 2_000))
        cs = sasrec.score_candidates(state["params"], seqs[:1],
                                     torch.from_numpy(cands).to(device), cfg)
    best = int(cands[0, int(torch.argmax(cs[0]))])
    log(f"candidate scoring: {tuple(cs.shape)} scores, best={best}")
    out.update(top_scores=scores.cpu().numpy(), top_ids=ids,
               candidate_scores=cs.cpu().numpy(), candidate_best=best)

    # the GraphGen tie-in: users who interacted with the same item
    catalog, rng = co_interaction_catalog()
    g = extract(catalog, GRAPH_QUERY).graph
    out["edges"] = (g.n_edges_condensed, g.n_edges_expanded())
    log(f"co-interaction graph: {g.n_edges_condensed} condensed edges "
        f"vs {g.n_edges_expanded()} expanded "
        f"({g.n_edges_expanded() / max(g.n_edges_condensed, 1):.0f}x)")
    server = GraphQueryServer.from_condensed(g, budget_bytes=2 << 20, max_batch=32,
                                             packed=True, device=device)
    acct = server.correction_accounting
    out["correction"] = (acct.peak_resident_triples, acct.n_chunks, acct.n_paths)
    log(f"correction built streaming: peak {acct.peak_resident_triples} "
        f"resident triples over {acct.n_chunks} chunks ({acct.n_paths} raw paths)")
    pr = algorithms.pagerank(server.graph, num_iters=10)
    out["pagerank"] = pr.cpu().numpy()
    out["central_user"] = int(torch.argmax(pr))
    log(f"most central user (candidate-generation seed): {out['central_user']}")
    queries = example_queries(rng)
    t0 = time.time()
    answers = server.run(queries)
    out["answers"] = {qid: np.asarray(a) for qid, a in answers.items()}
    out["served"] = (server.n_queries, server.n_propagation_batches)
    log(f"served {server.n_queries} queries in {server.n_propagation_batches} "
        f"propagation batches ({(time.time() - t0) * 1e3:.0f} ms)")
    q0 = queries[0]
    scores0 = np.array(out["answers"][q0.qid], dtype=np.float64)
    scores0[q0.node] = -np.inf  # self-score is the user's own degree
    out["partners"] = np.argsort(scores0)[::-1][:3].tolist()
    log(f"  user {q0.node}: strongest co-interaction partners {out['partners']}")
    return out


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="the device to run on: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    from ..models import sasrec

    gen = torch.Generator(device=args.device).manual_seed(0)
    run(DEMO, sasrec.init_params(DEMO, gen, args.device), args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
