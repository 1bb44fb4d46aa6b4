"""GraphGen on PyTorch and CUDA: the port of the JAX package ``repro``.

The main path of the paper's system, end to end on one NVIDIA H100:
declare a graph over relational tables, extract it condensed, build the
DEDUP-C correction, upload bit-packed operands, and answer node-seeded
analytics queries in batches::

    from repro_torch.data.synth import dblp_catalog
    from repro_torch.core.extract import extract
    from repro_torch.serve.server import GraphQuery, GraphQueryServer

    g = extract(dblp_catalog(mean_authors_per_pub=6.0), QUERY).graph
    server = GraphQueryServer.from_condensed(g, packed=True)  # device="cuda"
    answers = server.run([GraphQuery(0, "bfs", 3), GraphQuery(1, "ppr", 3)])

Batched steps run on hand-written CUDA kernels
(:mod:`repro_torch.kernels.bitmap_spmm`, sources in ``kernels/csrc``).
The package imports neither JAX nor ``repro``.
"""
