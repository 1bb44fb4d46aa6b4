"""Serving launcher of the port: batched LM generation.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b --requests 6
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --device cpu

Serves the arch's ``SMOKE`` config with random weights drawn from
``--seed``, as the JAX package's launcher does, on the card unless
``--device cpu`` is given.  ``--graphs N`` (the multi-tenant graph tier)
is not ported yet.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--graphs", type=int, default=0,
                    help="serve N graph tenants from one tier (not ported yet)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.graphs > 0:
        raise NotImplementedError(
            "--graphs: the multi-tenant graph serving tier is not ported yet "
            "(ROADMAP.md, Queue 1 item 3)"
        )
    return _serve_lm(args)


if __name__ == "__main__":
    raise SystemExit(main())
