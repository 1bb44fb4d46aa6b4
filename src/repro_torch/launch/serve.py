"""Serving launcher of the port: batched LM generation, or the
multi-tenant graph tier.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b --requests 6
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --graphs 3 --requests 64

The LM path serves the arch's ``SMOKE`` config with random weights drawn
from ``--seed``, as the JAX package's launcher does.  ``--graphs N``
serves N random membership graphs from one
:class:`~repro_torch.serve.tier.GraphServingTier` under a device-byte
budget that fits about two of them, prints the replica placement plan
(:func:`~repro_torch.launch.cells.place_serving_replicas`) for the local
card count, runs a mixed workload over every request kind, and reports
batch occupancy plus cache hit rates.  Both run on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import registry
from ..models import transformer
from ..serve.server import BatchedServer, Request


def _serve_lm(args) -> int:
    cfg = registry.get_arch(args.arch).SMOKE
    device = torch.device(args.device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    params = transformer.init_params(cfg, generator, device)
    server = BatchedServer(params, cfg, batch_slots=args.slots, max_len=64)
    rng = np.random.default_rng(args.seed)
    reqs = [
        Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size, size=rng.integers(4, 12)),
            max_new_tokens=args.new_tokens,
        )
        for i in range(args.requests)
    ]
    out = server.run(reqs)
    for rid in sorted(out):
        print(f"request {rid}: {out[rid]}")
    if len(out) != args.requests:
        raise RuntimeError(f"served {len(out)} of {args.requests} requests")
    print("served", len(out), "requests")
    return 0


def _serve_graphs(args) -> int:
    from ..core.dedup import graph_from_membership
    from ..core.engine import ResidencyBudget, device_graph_bytes, to_device
    from ..serve.tier import KINDS, GraphServingTier, ServeRequest
    from .cells import place_serving_replicas

    rng = np.random.default_rng(args.seed)
    tenants = {}
    for g in range(args.graphs):
        n_real, n_virt = 60 + 10 * g, 18 + 2 * g
        sets = [
            rng.choice(n_real, size=rng.integers(2, 6), replace=False)
            for _ in range(n_virt)
        ]
        tenants[f"graph{g}"] = graph_from_membership(n_real, sets)

    # budget: fit roughly two of the tenants at a time, in this package's
    # own device bytes
    per_tenant = [
        2 * device_graph_bytes(to_device(g, device=args.device))
        for g in tenants.values()
    ]
    budget = ResidencyBudget(
        max_device_bytes=int(sum(sorted(per_tenant)[-2:]) * 1.25)
    )
    tier = GraphServingTier(max_batch=args.slots, budget=budget, device=args.device)
    for name, g in tenants.items():
        tier.add_tenant(name, g)

    n_devices = max(torch.cuda.device_count(), 1)
    placements = place_serving_replicas(
        sorted(tenants), n_devices=n_devices,
        replicas=min(args.replicas, n_devices),
    )
    for p in placements:
        print(f"placement: {p.tenant} replica {p.replica} -> devices {p.devices}")

    names = sorted(tenants)
    reqs = [
        ServeRequest(
            qid=i,
            tenant=names[int(rng.integers(len(names)))],
            kind=KINDS[int(rng.integers(len(KINDS)))],
            node=int(rng.integers(40)),
        )
        for i in range(args.requests)
    ]
    out = tier.serve(reqs)
    if len(out) != args.requests:
        raise RuntimeError(f"served {len(out)} of {args.requests} requests")
    print(
        f"served {len(out)} requests over {len(tenants)} tenants: "
        f"occupancy={tier.stats.occupancy:.2f} "
        f"result_cache_hit_rate={tier.result_stats.hit_rate:.2f} "
        f"exec_cache_hit_rate={tier.exec_stats.hit_rate:.2f} "
        f"resident={budget.resident_bytes}B/"
        f"{budget.max_device_bytes}B evictions={budget.n_evictions}"
    )
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--graphs", type=int, default=0,
                    help="serve N graph tenants from one tier instead of the LM")
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.graphs > 0:
        return _serve_graphs(args)
    return _serve_lm(args)


if __name__ == "__main__":
    raise SystemExit(main())
