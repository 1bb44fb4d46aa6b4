#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # the full run: DBLP 50K authors / 100K pubs
    python3 chip_smoke.py --quick    # a first check of changed kernels (~1.5 min)

Phases, each of which fails the run (non-zero exit, no result line):

1. Setup: build every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once) and print the card's name and
   power limit.
2. Small input: a small DBLP graph served through the kernels agrees with
   NumPy dense-expansion oracles (BFS and common neighbors exactly,
   personalized PageRank to float32 round-off).
3. Main path: ``dblp_catalog(mean_authors_per_pub=6.0)`` -> ``extract`` ->
   ``GraphQueryServer.from_condensed(packed=True)`` with ``'auto'``
   dispatch (the upload builds every row index on the card: its builds
   are counted, and all of them are run and timed once more against the
   uploaded bytes, ``stages.index_build_s``), ``run`` of 32 ``bfs`` + 32
   ``ppr`` + 32 ``common_neighbors`` queries and one ``reachable_multi``
   batch of 32.  Launch counts are zeroed just before and read just
   after; every kernel must have launched (at the full size exactly
   ``FULL_LAUNCHES``), no ``'vmem_or_backend'`` stand-down may occur, and the
   answers must equal those of the same graphs served by the segment
   path on the card (PPR to ``rtol=1e-5, atol=1e-6``: the two paths add
   float32 values in different orders).
   One more run of the same batches under ``torch.profiler`` gives the
   device time by kernel and the card's idle share; its wrappers must
   make the counted run's launches and its answers the counted run's, and
   its trace one range kernel and one carry pass per wrapper call.  Only a
   trace that holds fewer kernel records than its run's wrapper calls is
   taken again (up to ``PROFILE_TRIES`` times, the records it lacked and
   the profiler's dropped-record warnings kept).
4. Kernels: at the main path's operands, K1-K3 against their plain
   PyTorch versions over the bitmaps (integer frontiers, byte-equal),
   twice on a float frontier (the same bits) and against the plain mirror
   of their arithmetic over the index; the index builder against its plain
   version (byte-equal).  Each with its time, the plain version's time, a
   bound (the larger of the bytes these inputs need at 3.35 TB/s and the
   float32 operations at 67 TFLOP/s; ``layout_bound_ms`` counts every
   bitmap byte instead, the earlier design's reads) and, for K1 and K3,
   one ``torch.sparse.mm`` call on a CSR of the same function.
   Then larger-than-memory extraction on phase 3's catalog:
   ``extract_sharded`` in 8 shards spilled under ``build/spill`` and
   tree-merged two at a time, unbounded and again with
   ``max_resident_rows`` / ``max_assembly_bytes`` at the peaks it
   observed, each graph identical to phase 3's and each spill store
   validated; one row below the peak must raise
   ``ExtractionBudgetError``.  ``sharded_extract_to_device(packed=True,
   pack_shard_edges=)`` (and the counts graph packed slice by slice) must
   upload phase 3's operands byte for byte, compared on the card, and
   serve phase 3's batches with its answers bit for bit and its launches.
5. Analytics (``analytics_phase``), each analytic with the launch counts
   zeroed just before and read just after, ``backend='auto'``, each
   equal to the same call on the segment backend on the card (exactly,
   PPR to ``rtol=1e-5, atol=1e-6``), each launching the kernels
   named and no ``'vmem_or_backend'`` stand-down (HITS, 1-D on the segment
   path both ways, is compared bit for bit in default mode: the segment
   sums add in a fixed order): on the served DEDUP-C
   graph, ``shortest_paths_multi`` over 32 sources with an integer cost
   in 1-8 per publication (K2 min), ``widest_paths_multi`` with
   capacities drawn the same way (K2 max), ``triangle_counts`` over every
   author in blocks of 128 in ``per_step`` mode (K1 + K3 at F = 128) and
   in ``wedge`` mode (raw hops on K1), the two equal on every node whose
   wedge terms stay exact in float32 (``WEDGE_EXACT_BELOW``; the rest are
   counted and their difference recorded), the per_step counts summing to
   a multiple of 3 and the ten largest equal to an int64 count by scipy,
   ``clustering_coefficients``
   and ``hits(30)``, and one profiled triangle block; on App. C.2's
   ``layered_1`` (30,000 real nodes, two virtual layers of 12,000, packed),
   ``scc_labels(batch=128)`` equal to scipy's strong components of the
   expanded graph, ``condensation`` equal to the DAG built from them,
   and weighted ``shortest_paths_multi`` forward and reversed (K2 min);
   on a DEDUP-1 rewriting of a 1,000-author co-author graph, batched PPR
   (K1, never K3) equal to DEDUP-C's and BFS equal exactly.  Then K1 and
   K3 at F = 128, K2 max at F = 128 on the layered middle layer (the
   width of ``scc_labels``' pivot batches) and K2 min on it at F = 32,
   held and timed as in phase 4; and the F = 128 route against the
   32-feature one (``slice_checks``): on float frontiers at a fixed range
   length, one F = 128 launch of K1 sum / min / max, K3 and the layered K2
   max equal to four F = 32 launches on its column slices, bit for bit.
   ``--quick``: layered_1's smoke size (600, [240, 240]) and DEDUP-1 at
   300 / 600.
   Then the measured crossover: every ``range_items`` candidate of K1 at
   the served operands equal to its plain versions; ``measure_crossover``
   (ops sum / min / max, B in 8 / 32 / 128) on every packed direction of
   the served exact graph, and ``to_device_packed(measure=True)`` of
   layered_1 and of the DEDUP-1 graph, each table through its JSON round
   trip, its B = 128 decisions logged on a line of their own; DEDUP-1 PPR and BFS, condensation and layered_1's shortest paths
   both ways rerun on the measured graphs, every step's dispatch the
   table's decision and one launch per ``'cuda'`` decision, each equal to
   the segment path.  Last, ``collapse_to_single_layer``: layered_1 keeps
   its SCC labels and expanded edge count; TPC-H's symmetric three-layer
   query (1,000 customers; ``--quick`` 300) collapses to one layer that
   DEDUP-1 rewrites, batched PPR on it (K1, never K3) equal to DEDUP-C's
   on the uncollapsed graph and BFS exact.
6. Live graph, tier, planner (``live_tier_phase``) on phase 3's catalog:
   ``LiveGraph`` with a write-ahead ``DeltaLog`` (``build/wal``, removed
   after) takes 4 deltas, each inserting new publications that make
   ``DELTA_SHARE`` of ``AuthorPub`` and deleting about as many rows by
   publication (the third also deletes ``TOMBSTONE_AUTHORS`` authors):
   every graph identical to a fresh ``extract`` of the mutated catalog,
   and ``LiveGraph.replay`` lands on the same graph and version.  One
   ``GraphServingTier(device="cuda")`` serves four tenants (the live DBLP
   graph, packed and pinned, through its version listener; layered_1
   with per-layer costs and capacities; the DEDUP-1 graph; the TPC-H
   collapse), sized by one upload each, then under a ``ResidencyBudget``
   of the DBLP tenant plus the next largest, with one byte less than the
   smallest to spare (derived again from the DBLP tenant's new bytes when
   the fifth delta bumps its version).  ``TIER_REQUESTS``
   requests of every kind, half to DBLP, run through ``run_load`` in two
   halves, with a fifth delta between them while 4 DBLP requests are in
   flight (answered at the old version by the quiesce handoff).  The first
   half arrives at once and gives the tier's service rate under a
   backlog; the second is offered one request per ``TIER_SPACING_BATCHES``
   of the first half's mean batch times, so its latencies are those of a
   bounded queue.  Launch
   counts are zeroed before the stream and read after: K1, K2 min, K2 max
   and K3 must each launch, with no ``'vmem_or_backend'`` stand-down.
   Every answer equals the segment path on the tenant's own upload (PPR
   to ``rtol=1e-5, atol=1e-6``), the new version's bfs / ppr / common
   neighbours a fresh ``GraphQueryServer`` on the new graph; every
   evicted tenant's re-upload is byte-equal to its first.  Then ``plan``
   with this machine's ``measure_pack_throughput`` and the measured
   crossover table, its report through ``save_plan_report`` /
   ``load_plan_report``, ``extract(plan=)`` identical to phase 3's graph,
   ``sharded_extract_to_device(plan=)`` byte-equal to phase 3's upload,
   and ``recommend(graph, crossover=table)``.
7. Distributed paths (``distributed_phase``) under an NCCL process group
   of one rank over a ``FileStore`` in ``build/dist`` (one card: no
   number here is a multi-GPU number; the group is destroyed at the end,
   so later phases see none, and a failed NCCL init fails the run):
   ``repro_torch.launch.distributed_analytics.analytics`` at
   ``configs/graphgen_paper.CONFIG``'s counts (``--quick``: ``SMOKE``'s)
   times graph generation, the correction, the upload, the out-degrees,
   ``band_partition`` and the band upload; banded PageRank on 8 bands
   within 1e-7 of the engine's segment-path PageRank on the same upload;
   flat (edge-sharded) PageRank on 8 slices, then on the 6 slices that
   the scripted ``Supervisor``'s ``remesh_plan`` leaves after worker 3
   dies, each within ``atol=1e-6`` of the engine's; each of the three
   also within 1e-5 of the engine's largest value (the bound that scales
   with 1 / n_real: the two absolute ones exceed a typical value at
   this size); each with its time per iteration.  ``allreduce_int8`` on 64 MB equals quantize-dequantize.
   ``MultihostSpillExtraction`` on phase 3's catalog, 4 simulated
   processes × 8 shards and ``run()`` with the default barrier, each
   byte-identical to phase 3's graph (spill under ``build/``, removed
   after).  K1-K3 launch counts are zeroed before and must read 0 after;
   peak device bytes are recorded under ``distributed``.
8. LM serving: K4 against its plain version on small and cache-path
   shapes (the main path's prefill and decode among them) in float32 to
   2e-5 and bf16 to 0.05; glm4-9b at full width in bf16 with random
   weights serves 16 requests (8 x 4096 + 8 x 1024 prompt tokens, 32 new
   each) on 8 slots, with K4 launched at every attention call and the
   plain attention never: the tensor-core prefill kernel n_layers x
   prefills times, every launch on the sm90 route (TMA and wgmma:
   ``PREFILL_ROUTES``), the split-KV decode kernel and its combine n_layers x
   decode steps times each, the float32 kernel never; the last-position
   logits of one prefill through K4 and through the plain attention
   agree; a profiled prefill and decode step; K4's rows at the prefill
   and decode shapes, held to the plain version element by element in
   bf16, the decode row timed over four distinct caches in turn (cold
   L2) with its warm time logged beside; the count of tensor-core
   instructions (``HMMA``, ``HGMMA``) and TMA loads (``UTMALDG``) in the
   bf16 kernels' SASS where ``cuobjdump`` exists, the prefill library's
   or the backward library's without ``HGMMA`` or ``UTMALDG`` failing the
   run.  The small check
   holds the sweep's head dims (8, 16, 32) on the mma.sync kernel
   and the cache path's prefills on the sm90 kernel.
9. Training (``training_phase``), after the LM phase's weights are freed:
   glm4-9b at ``CONFIG``'s widths and ``LM_TRAIN_LAYERS`` of its layers,
   float32 params, AdamW on ``launch/train.py``'s schedule,
   ``TRAIN_STEPS`` steps of ``LM_TRAIN_BATCH`` x 4096 tokens in
   ``CONFIG``'s 4 microbatches with full remat: step 0's loss and
   gradient norm equal those through the plain attention (plain forward
   and backward) within ``TRAIN_RTOL``; K4's prefill kernel with lse
   launches exactly layers x microbatches x 2 (the remat recompute) a
   step, K4's backward kernels (``csrc/flash_backward.cu``'s long route:
   row statistics, the wgmma dK / dV and dQ kernels and, where the dK / dV
   rows are split, the reduce) exactly layers x microbatches each, no other K4 kernel, no
   plain forward and no plain backward; the params are
   unchanged by step 0 (the schedule's lr is 0 there) and move at step
   1; one more step is profiled and its device time split by the port's
   profiler ranges (the plain attention backward, the optimizer), K4,
   GEMMs and the rest.  SASRec at ``CONFIG`` (1,000,000 items):
   ``train_batch`` (65,536) for ``TRAIN_STEPS`` steps (one lse launch and
   one backward through the short route's kernel per block a step, the
   plain backward never), ``serve_p99`` and ``serve_bulk`` (262,144 users,
   ``batch_chunk`` 4096; one prefill launch per block), every prefill
   on the re-laid route (D = 50, ``PREFILL_ROUTES['relay']``), their first and
   last 64 users scored alone within ``REC_RTOL``, and ``retrieval_cand``
   (every item a candidate: its best score is ``score_all``'s top 1).
   The four GNNs at their ``CONFIG``s (meshgraphnet and graphcast on
   ``full_graph_sm``, schnet and dimenet on ``molecule`` with
   ``triplet_count(shape, 8)`` triplets), ``TRAIN_STEPS`` steps each, the
   first loss on the card within ``TRAIN_RTOL`` of the port's float32
   loss on the CPU.  ``launch/recsys_serve.run`` at the example's sizes,
   its answers equal to the segment path's (its interaction layers repeat
   edges, so sums there take the segment path, as the reference's take
   XLA).  Last, K4's lse rows at glm4-9b's and SASRec's training shapes
   against the plain version (output at the bf16 bound, lse within
   ``LSE_ATOL``) and ``aten._scaled_dot_product_flash_attention`` (at
   SASRec's 65,536 rows, which that op refuses in one call, the sum of
   the fewest equal batch parts it takes, timed back to back), and K4's
   row at ``serve_bulk``'s attention (262,144 sequences, no lse) against
   SDPA in the fewest equal batch parts it takes.  Then K4's backward rows
   at glm4-9b's training shape (the long route) and SASRec's (the short
   route) (``k4_backward_row``): the kernels'
   ``dq``, ``dk``, ``dv`` against the plain backward and the tiled
   mirror of their arithmetic within ``BWD_L2_RTOL`` / ``BWD_MAX_RTOL``,
   two runs bit for bit, the same check refusing the gradients under
   each fault of ``BACKWARD_PLANTS`` planted at the launch, timed
   against the plain backward and
   ``aten._scaled_dot_product_flash_attention_backward``; a long-route
   row records its route and ``sm90_backward_plan`` (``shape.plan``).
   ``--quick`` runs the ``SMOKE`` configs, SASRec's batches / 64.
10. The MoE LMs (``moe_phase``), after phase 9 frees its weights.
   granite-moe-3b-a800m at ``CONFIG`` (full width, all 32 layers, bf16
   random weights) serves ``MOE_EACH`` x 4096 + ``MOE_EACH`` x 1024
   prompt tokens, 32 new each, on 8 slots (``serve_counted``: K4's
   prefill kernel n_layers x prefills times, decode and combine n_layers
   x steps, the plain attention never, every prefill on the sm90 route),
   each prefill's drop fraction
   printed; the same requests again give the same tokens bit for bit;
   one prefill's last-position logits through K4 and the plain attention
   agree within ``LOGITS_RTOL``; a profiled prefill and decode step split
   by the MoE layer's profiler ranges (expert products against routing,
   sorts, gathers and writes).  K4's rows at granite's shapes (D = 64,
   24 heads over 8).  Then granite trained as phase 9 trains glm4-9b:
   ``CONFIG``'s widths at ``LM_TRAIN_LAYERS`` layers, 8 x 4096 tokens in
   its 8 microbatches, ``aux`` in the loss, step 0 within ``TRAIN_RTOL``
   of the plain attention, the router's gradient non-zero and the router
   moved by step 1, K4's backward kernels launched as in phase 9, and
   K4's training-forward (lse) and backward rows at granite's training
   shape.  moonshot-v1-16b-a3b at full width and
   ``MOONSHOT_LAYERS`` of its 48 layers serves the same batch; one of its
   layers runs ``_moe_a2a`` on 4096 tokens under a (1, 1) ``DeviceMesh``
   over an NCCL group of one rank (no collective runs at one rank), equal
   to ``_moe_sort`` within ``A2A_RTOL`` with nothing dropped; K4's rows at
   its shapes (D = 128, 16 heads over 16).  llama3-405b at full width and
   ``LLAMA_LAYERS`` of its 126 layers serves the same batch.  Every
   served prefill of the three on the sm90 route.
   ``--quick`` runs the three ``SMOKE`` configs.
11. The sharded train step (``sharded_phase``), after phase 10 frees its
   weights: an NCCL group of one rank over a ``FileStore`` under
   ``build/dist`` and a (1, 1) ``DeviceMesh``; granite-moe-3b-a800m at
   ``CONFIG``'s widths and ``LM_TRAIN_LAYERS`` layers, its float32
   params and AdamW state DTensors placed by its ``sharding_rules``, 8 x
   4096 tokens in its 8 microbatches, the batch a DTensor.  Step 0's
   loss and gradient norm equal phase 10's plain-tensor step (same seed
   and batch) bit for bit, or within ``TRAIN_RTOL`` (recorded); K4's lse
   prefill kernel launches layers x microbatches x 2 a step, its backward
   kernels layers x microbatches each, the plain forward and backward
   never; the state saved after step 1 and restored with
   ``restore_checkpoint(shardings=)`` gives step 2 bit for bit; step
   seconds and peak bytes beside phase 10's.  Then ``python -m
   torch.distributed.run --nproc-per-node 1 -m repro_torch.launch.train
   --arch granite-moe-3b-a800m --steps 3`` runs as a subprocess and must
   exit 0.  One card: no number from it is a multi-GPU number.
   ``--quick`` runs granite's ``SMOKE`` config.
12. The dry-run (``dryrun_phase``): each of ``DRYRUN_HOST_CELLS`` (glm4-9b
   ``prefill_32k`` at batch 1, ``decode_32k`` at batch 8, ``train_4k`` at
   phase 9's cut, granite ``train_4k`` at phase 10's, SASRec
   ``train_batch``; widths never cut) is traced by
   ``repro_torch.launch.dryrun`` on a one-rank host mesh over fake CUDA
   tensors, then the same ``Cell.fn`` runs for real on the card under the
   same count: the FLOPs counted there must equal the prediction, K4's
   forward and backward launches the op counts traced, and the predicted
   peak be within
   ``PEAK_RTOL`` of ``max_memory_allocated`` (from just before the
   arguments are made); the roofline's time beside a second, uncounted
   step's time is printed, not gated.  Then ``python -m
   repro_torch.launch.dryrun --mesh single --cells DRYRUN_MESH_CELLS`` as
   a subprocess (a fake group of 256 ranks): rc 0 and every record
   ``ok``.  ``--quick`` runs the ``SMOKE`` configs; ``--only-dryrun``
   builds the kernels and runs this phase alone (no result line).
13. ``examples/train_lm.py``'s ``lm-100m`` (``train_lm_phase``): the
   port's ``repro_torch.launch.train_lm`` at the example's full width
   and depth (12 layers, ``d_model`` 512, 98.7 M parameters, float32, no
   TF32) and its defaults: 4 x 128 tokens a step, 300 steps, a
   checkpoint every 50 (under ``build/``, removed after).  Step 0's loss
   and gradient norm on the card against the port's float32 step 0 on
   the CPU (same params and batch) within ``LM100M_LOSS_RTOL`` /
   ``LM100M_NORM_RTOL``, and the same gate refusing step 0 on the card
   under each fault of ``LM100M_PLANTS`` planted in K4's forward kernel
   (no causal mask; query heads reading the wrong kv heads) and each of
   ``BACKWARD_PLANTS`` planted in its float32 backward kernel's launch.
   K4's float32 kernel with lse and its float32 backward kernel
   (``csrc/flash_backward_f32.cu``) each launched exactly 12 times a step
   in the run (and in the resumed steps), no other K4 kernel, no plain
   forward and no plain backward; every loss
   finite and the last below step 0's.  The checkpoint at step 300 read
   back equal to the run's final state bit for bit, then ``--resume
   --steps 350`` (prints ``resumed from step 300``, finite losses).  One
   profiled step split as phase 9's (its kernels, busy time and idle
   share printed beside the run's step times); K4's float32 lse row at
   the step's shape (q (4, 128, 8, 64), kv 4 heads, causal) against the
   plain version and ``aten._scaled_dot_product_efficient_attention``,
   and its float32 backward row there (``k4_backward_row``: within
   ``BWD_F32_L2_RTOL`` / ``BWD_F32_MAX_RTOL`` of the plain backward and
   the kernel's mirror, bit for bit twice, every planted fault refused)
   against the plain backward and
   ``aten._scaled_dot_product_efficient_attention_backward``.
   ``--quick`` runs 30 steps and resumes to 35, at full width.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  A copy of the measurements goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

QUERY = """
Nodes(ID, Name) :- Author(ID, Name).
Edges(ID1, ID2) :- AuthorPub(ID1, PubID), AuthorPub(ID2, PubID).
"""

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
TPU_KERNEL = "src/repro/kernels/bitmap_spmm.py"
# (authors, pubs, batch) of the full run, and the graph kernels' launches in
# its served run: K1 at PPR's first layer and common neighbours, K2 min at
# BFS, K2 max at reachable_multi, K3 at PPR's last layer
FULL_GRAPH = (50_000, 100_000, 32)
INDEX_FIELDS = ("row_ptr", "col", "weight")
FULL_LAUNCHES = {"bitmap_spmm_sum": 22, "bitmap_spmm_min": 10, "bitmap_spmm_max": 10,
                 "bitmap_spmm_fused": 20}
CSRC = "src/repro_torch/kernels/csrc"
# traces of the served batches taken before their kernel records must match
# the counted run's launches; only a trace that came back short of the
# wrapper calls its own run made is taken again
PROFILE_TRIES = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


# device-side spin (clock cycles, ~0.1 s on an H100) that holds the stream
# while the host enqueues a timed run
HOLD_CYCLES = 200_000_000


def time_device_and_host(fn, reps: int, warmup: int = 2):
    """``(device ms, host ms)`` per call of ``fn``.  The ``reps`` calls are
    queued behind a device-side spin (``torch.cuda._sleep``), so the CUDA
    events around them time the card's work and not the host's launch
    rate: a call whose host cost exceeds its device time (K4's decode) is
    otherwise timed at the host's pace.  The host ms is the enqueue time;
    if it outlasts the spin, the queue ran dry and the device time includes
    host gaps, which is logged."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    held, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    held.record()
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t) * 1e3
    end.record()
    torch.cuda.synchronize()
    if host_ms > held.elapsed_time(start):
        log(f"  (timing: the host took {host_ms:.1f} ms to enqueue {reps} calls, longer "
            f"than the {held.elapsed_time(start):.1f} ms hold: device time includes host gaps)")
    return start.elapsed_time(end) / reps, host_ms / reps


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    return time_device_and_host(fn, reps, warmup)[0]


# ---------------------------------------------------------------------------
# Phase 2: small input against NumPy dense oracles
# ---------------------------------------------------------------------------

def small_input_check(seed: int) -> None:
    import numpy as np

    from repro_torch.core import extract
    from repro_torch.data.synth import dblp_catalog
    from repro_torch.serve.server import GraphQuery, GraphQueryServer

    g = extract(dblp_catalog(400, 700, 6.0, seed=seed), QUERY).graph
    n = g.n_real
    s, d, m = g.multiplicities()
    mult = np.zeros((n, n), dtype=np.float64)
    np.add.at(mult, (s, d), m)
    adj = (mult > 0).astype(np.float64)
    np.fill_diagonal(adj, 0.0)
    server = GraphQueryServer.from_condensed(g, packed=True, device="cuda")
    nodes = [int(v) for v in np.random.default_rng(seed).integers(0, n, 8)]
    kinds = ("bfs", "ppr", "common_neighbors")
    queries = [GraphQuery(i * 3 + k, kind, v)
               for i, v in enumerate(nodes) for k, kind in enumerate(kinds)]
    got = server.run(queries)
    deg = adj.sum(axis=1)
    for i, v in enumerate(nodes):
        dist = np.full(n, np.inf)
        dist[v] = 0.0
        frontier = np.zeros(n, dtype=bool)
        frontier[v] = True
        hop = 0
        while frontier.any():
            hop += 1
            nxt = (adj[frontier].sum(axis=0) > 0) & np.isinf(dist)
            dist[nxt] = hop
            frontier = nxt
        seeds = np.zeros(n)
        seeds[v] = 1.0
        x = seeds.copy()
        for _ in range(server.ppr_iters):
            contrib = np.where(deg > 0, x / np.maximum(deg, 1.0), 0.0)
            y = adj.T @ contrib + np.where(deg > 0, 0.0, x).sum() * seeds
            x = (1 - server.damping) * seeds + server.damping * y
        if not np.array_equal(got[i * 3], dist):
            raise AssertionError(f"small input: bfs from {v} disagrees with the oracle")
        if not np.allclose(got[i * 3 + 1], x, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"small input: ppr from {v} disagrees with the oracle")
        if not np.array_equal(got[i * 3 + 2], mult[v]):
            raise AssertionError(
                f"small input: common_neighbors of {v} disagrees with the oracle"
            )
    log(f"small input: {len(queries)} answers equal the dense oracles (n={n})")


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

def serve_queries(server, nodes, reach_nodes):
    from repro_torch.core import algorithms
    from repro_torch.serve.server import GraphQuery

    queries = []
    for kind in ("bfs", "ppr", "common_neighbors"):
        for v in nodes:
            queries.append(GraphQuery(len(queries), kind, int(v)))
    answers, stats = server.run(queries, with_stats=True)
    reach = algorithms.reachable_multi(server.graph, reach_nodes).cpu().numpy()
    return queries, answers, reach, stats


def compare_answers(queries, got, ref, reach, reach_ref,
                    what: str = "kernel path != segment path") -> None:
    import numpy as np

    for q in queries:
        a, b = got[q.qid], ref[q.qid]
        if q.kind == "ppr":
            ok = np.allclose(a, b, rtol=1e-5, atol=1e-6) and np.isfinite(a).all()
        else:
            ok = np.array_equal(a, b)
        if not ok:
            raise AssertionError(f"{q.kind} query {q.qid}: {what}")
    if not np.array_equal(reach, reach_ref):
        raise AssertionError(f"reachable_multi: {what}")


def profile_call(fn) -> tuple:
    """Device time by kernel over one call of ``fn`` under
    ``torch.profiler``: the wall time, the summed kernel time and the share
    of the wall time the card sat idle.  Launches made here are restored:
    they do not count as a path's.  The record keeps them as
    ``wrapper_launches`` (each wrapper's count over the call) beside the
    kernel records the trace holds, and the profiler's native warnings of
    dropped records.  Returns the record and ``fn``'s result."""
    import tempfile

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import bitmap_spmm as K

    before = dict(K.LAUNCHES)
    torch.cuda.synchronize()
    # the profiler's native warnings go to file descriptor 2: copy them
    # through a file, then pass them on
    sys.stderr.flush()
    saved = os.dup(2)
    with tempfile.TemporaryFile() as err:
        os.dup2(err.fileno(), 2)
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t
            events = prof.key_averages()
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
        err.seek(0)
        native = err.read().decode(errors="replace")
    sys.stderr.write(native)
    wrapper = {k: v - before.get(k, 0) for k, v in K.LAUNCHES.items()}
    K.LAUNCHES.update(before)
    by_kernel, calls = {}, {}
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 1e6
        calls[e.key] = calls.get(e.key, 0) + e.count
    busy_s = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    # device launches of the graph kernels, by kind (the names' prefixes)
    graph = {kind: sum(n for key, n in calls.items() if key.startswith(f"void bitmap_spmm::{kind}<"))
             for kind in ("spmm_kernel", "carry_kernel", "fused_kernel", "fused_carry_kernel")}
    return {
        "wall_s": wall_s,
        "device_busy_s": busy_s if by_kernel else None,
        "idle_share": 1.0 - busy_s / wall_s if by_kernel else None,
        "top_kernels_s": dict(top),
        "graph_kernel_launches": graph,
        "wrapper_launches": wrapper,
        "dropped_record_warnings": [ln for ln in native.splitlines() if "drop" in ln.lower()],
        "bitmap_kernels_s": sum(t for key, t in by_kernel.items() if "bitmap_spmm::" in key),
        "memcpy_dtoh_s": sum(t for key, t in by_kernel.items() if "DtoH" in key),
    }, out


def profile_serve(server, nodes, reach_nodes):
    """:func:`profile_call` over one more run of the served batches;
    returns the record and the run's ``(queries, answers, reach, stats)``."""
    return profile_call(lambda: serve_queries(server, nodes, reach_nodes))


# ---------------------------------------------------------------------------
# Phase 4: kernels against their plain versions
# ---------------------------------------------------------------------------

def set_bits(words) -> int:
    import torch

    flat = words.reshape(-1)
    vals = flat[flat != 0].to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, device=words.device, dtype=torch.int64)
    return int(((vals[:, None] >> shifts) & 1).sum().item())


def popcounts(words):
    """Set bits of each 32-bit word (an int32 tensor), as int64."""
    import torch

    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def plane_skew(fused):
    """How K3's correction bits are spread: the most set bits in one 2 KiB
    plane, and the plane bits of the heaviest output row tile against all
    of them (per-unit counts in chunks, so no large temporaries)."""
    import torch

    n_corr, n_planes = int(fused.planes.shape[0]), int(fused.planes.shape[1])
    units = fused.planes.reshape(n_corr * n_planes, -1)
    bits = torch.cat([popcounts(units[i:i + 65536]).sum(dim=1)
                      for i in range(0, units.shape[0], 65536)])
    corr = fused.kind == 1
    tile_of = torch.empty(n_corr, dtype=torch.int64, device=bits.device)
    tile_of[fused.corr_idx[corr].to(torch.int64)] = fused.slot_row[corr].to(torch.int64)
    n_rt = int(fused.row_start.shape[0])
    per_tile = torch.zeros(n_rt, dtype=torch.int64, device=bits.device).index_add_(
        0, tile_of.repeat_interleave(n_planes), bits)
    return {"max_bits_per_plane": int(bits.max().item()),
            "top_row_tile_plane_bits": int(per_tile.max().item()),
            "row_tiles": n_rt}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def leaf_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict (a param tree)."""
    return sum(leaf_bytes(v) if isinstance(v, dict) else nbytes(v) for v in tree.values())


def index_bytes(graph) -> int:
    """Device bytes of a packed graph's row indices."""
    return sum(nbytes(*(getattr(ops, k) for k in INDEX_FIELDS if hasattr(ops, k)))
               for ops in all_operands(graph))


def all_operands(graph):
    """Every PackedOperands and FusedOperands of a packed graph."""
    layers = [layer for chain in graph.chains for layer in chain]
    if graph.direct is not None:
        layers.append(graph.direct)
    out = [ops for layer in layers for ops in (layer.fwd, layer.rev) if ops is not None]
    return out + [f for f in (graph.fused_fwd, graph.fused_rev) if f is not None]


def rebuild_indices(graphs) -> float:
    """Seconds to build every row index of ``graphs`` again on the card (the
    upload-time work), each rebuild held to the uploaded bytes."""
    import torch

    from repro_torch.core import engine
    from repro_torch.kernels import bitmap_index as BI

    before = dict(BI.INDEX_BUILDS)
    torch.cuda.synchronize()
    t = time.perf_counter()
    rebuilt = []
    for graph in graphs:
        for ops in all_operands(graph):
            if isinstance(ops, engine.FusedOperands):
                tables = [getattr(ops, k) for k in engine.FUSED_TABLES]
                rebuilt.append((ops, BI.bitmap_index_fused(*tables, ops.plane_weights)))
            else:
                tables = [getattr(ops, k) for k in engine.PACKED_TABLES]
                rebuilt.append((ops, BI.bitmap_index(*tables)))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    BI.INDEX_BUILDS.update(before)
    for ops, index in rebuilt:
        if not all(torch.equal(getattr(ops, k), v) for k, v in zip(INDEX_FIELDS, index)):
            raise AssertionError("a rebuilt row index differs from the uploaded one")
    return seconds


def bound(n_bytes: int, n_ops: int):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_repeats(name, fn) -> None:
    """Two launches on a float frontier give the same bits."""
    import torch

    first = fn()
    if not torch.equal(first, fn()):
        raise AssertionError(f"{name}: two launches on a float frontier differ")


def spmm_row(name, source, line, launches, y, y_plain, ms, plain_ms, need, layout,
             library_ms, mirror_err, shape) -> dict:
    b_ms, b_by = bound(*need)
    return {
        "name": name, "route": "cuda", "source": f"{CSRC}/{source}",
        "replaces": f"{TPU_KERNEL}:{line}", "launches": launches,
        "max_abs_err": float((y - y_plain).abs().nan_to_num(0.0).max().item()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "layout_bound_ms": bound(*layout)[0], "library_ms": library_ms,
        "shape": {**shape, "float_repeat_bit_identical": True,
                  "float_vs_mirror_max_abs_err": mirror_err},
    }


ZERO = {"sum": 0.0, "min": float("inf"), "max": 0.0}


def k12_row(name, layer, op, feat, launches, reps, rng, library=True) -> dict:
    """K1 (``op='sum'``) or K2 over ``layer``'s forward operands at ``feat``
    features against its plain version over the bitmaps: exactly on an
    integer frontier (``inf`` half the entries for min, 0/1 for max), twice
    on a float frontier (the same bits) and against the plain mirror of its
    arithmetic.  ``bound_ms`` counts the bytes these inputs need (the index,
    each source and output row once); ``layout_bound_ms`` every bitmap byte
    the earlier design read.  ``library``: time one ``torch.sparse.mm`` of
    the incidence's CSR (the sum only)."""
    import numpy as np
    import torch

    from repro_torch.kernels import bitmap_spmm as K

    ops, n_src, n_out = layer.fwd, layer.n_src, layer.n_dst
    zero = ZERO[op]
    x = torch.from_numpy(rng.integers(0, 7, (n_src, feat)).astype(np.float32)).cuda()
    if op == "min":
        x[torch.from_numpy(rng.random((n_src, feat)) < 0.5).cuda()] = float("inf")
    elif op == "max":
        x = (x > 3).to(torch.float32)
    floats = torch.from_numpy(rng.random((n_src, feat)).astype(np.float32)).cuda()
    nnz = int(ops.row_ptr[n_out].item())
    index = (ops.row_ptr[: n_out + 1], ops.col)
    idx_args = (ops.row_ptr, ops.col)
    plain_args = (ops.slot_src, ops.slot_row, ops.row_start, ops.row_count, ops.bitmaps)
    before = dict(K.LAUNCHES)
    y = K.bitmap_spmm(*idx_args, x, n_out, op=op, zero=zero)
    y_plain = K.bitmap_spmm_plain(*plain_args, x, n_out, op=op, zero=zero)
    torch.cuda.synchronize()
    if not torch.equal(y, y_plain):
        raise AssertionError(f"{name}: kernel != plain version")
    check_repeats(name, lambda: K.bitmap_spmm(*idx_args, floats, n_out, op=op, zero=zero))
    mirror_err = float((K.bitmap_spmm(*idx_args, floats, n_out, op=op, zero=zero)
                        - K.bitmap_spmm_index_plain(*idx_args, floats, n_out, op=op,
                                                    zero=zero)).abs().max().item())
    ms = time_ms(lambda: K.bitmap_spmm(*idx_args, x, n_out, op=op, zero=zero), reps)
    plain_ms = time_ms(lambda: K.bitmap_spmm_plain(*plain_args, x, n_out, op=op, zero=zero),
                       3, 1)
    K.LAUNCHES.update(before)  # comparison launches are not the path's launches
    library_ms = None
    if library and op == "sum":
        csr = torch.sparse_coo_tensor(
            torch.stack([layer.dst, layer.src]),
            torch.ones(layer.src.shape[0], device=x.device),
            (n_out, n_src),
        ).coalesce().to_sparse_csr()
        library_ms = time_ms(lambda: torch.sparse.mm(csr, x), reps)
    return spmm_row(
        name, "bitmap_spmm.cu", 77, launches, y, y_plain, ms, plain_ms,
        (nbytes(*index, x, y), nnz * feat), (nbytes(*plain_args, x, y), nnz * feat),
        library_ms, mirror_err,
        {"n_src": n_src, "n_out": n_out, "features": feat,
         "slots": int(ops.slot_src.shape[0]), "entries": nnz, "repeats": layer.repeats})


def k3_row(name, graph, feat, launches, reps, rng) -> dict:
    """K3 over the forward fused stream at ``feat`` features, held as
    :func:`k12_row` holds K1/K2; the library call is one ``torch.sparse.mm``
    of the CSR ``[B | -D]`` (the last layer's incidence beside the weighted
    correction) against the stacked ``[h; x]``."""
    import numpy as np
    import torch

    from repro_torch.kernels import bitmap_spmm as K

    fused = graph.fused_fwd
    n_h = graph.chains[-1][-1].n_src
    h = torch.from_numpy(rng.integers(0, 7, (n_h, feat)).astype(np.float32)).cuda()
    xr = torch.from_numpy(rng.integers(0, 7, (graph.n_real, feat)).astype(np.float32)).cuda()
    hf = torch.from_numpy(rng.random((n_h, feat)).astype(np.float32)).cuda()
    xf = torch.from_numpy(rng.random((graph.n_real, feat)).astype(np.float32)).cuda()
    f_idx = (fused.row_ptr, fused.col, fused.weight)
    f_plain = (fused.kind, fused.main_src, fused.corr_src, fused.main_idx, fused.corr_idx,
               fused.slot_row, fused.row_start, fused.row_count, fused.bitmaps, fused.planes)
    before = dict(K.LAUNCHES)
    y = K.bitmap_spmm_fused(*f_idx, h, xr, fused.n_out)
    y_plain = K.bitmap_spmm_fused_plain(*f_plain, h, xr, fused.n_out, fused.plane_weights)
    torch.cuda.synchronize()
    if not torch.equal(y, y_plain):
        raise AssertionError(f"{name}: kernel != plain version")
    check_repeats(name, lambda: K.bitmap_spmm_fused(*f_idx, hf, xf, fused.n_out))
    mirror_err = float((K.bitmap_spmm_fused(*f_idx, hf, xf, fused.n_out)
                        - K.bitmap_spmm_fused_index_plain(*f_idx, hf, xf, fused.n_out))
                       .abs().max().item())
    ms = time_ms(lambda: K.bitmap_spmm_fused(*f_idx, h, xr, fused.n_out), reps)
    plain_ms = time_ms(lambda: K.bitmap_spmm_fused_plain(*f_plain, h, xr, fused.n_out,
                                                         fused.plane_weights), 3, 1)
    K.LAUNCHES.update(before)
    last = graph.chains[-1][-1]
    cs, cd, cm = graph.correction
    k3_csr = torch.sparse_coo_tensor(
        torch.stack([torch.cat([last.dst, cd]), torch.cat([last.src, n_h + cs])]),
        torch.cat([torch.ones(last.src.shape[0], device=xr.device), -cm]),
        (fused.n_out, n_h + graph.n_real),
    ).coalesce().to_sparse_csr()
    stacked = torch.cat([h, xr])
    y_lib = torch.sparse.mm(k3_csr, stacked)
    torch.cuda.synchronize()
    if not torch.equal(y_lib, y_plain):
        raise AssertionError("K3's library call computes another function")
    library_ms = time_ms(lambda: torch.sparse.mm(k3_csr, stacked), reps)
    del k3_csr, stacked, y_lib
    n_planes = int(fused.planes.shape[1])
    n_corr = int(fused.planes.shape[0])
    f_nnz = int(fused.row_ptr[fused.n_out].item())
    corr_entries = int((fused.weight != 0).sum().item())
    main_bits, corr_bits = f_nnz - corr_entries, set_bits(fused.planes)
    # one add per main entry, a multiply and an add per correction entry,
    # one subtract per output
    f_ops = feat * (main_bits + 2 * corr_entries + fused.n_out)
    need = nbytes(fused.row_ptr[: fused.n_out + 1], *f_idx[1:], h, xr, y)
    layout = nbytes(*f_plain[:5], f_plain[6], f_plain[7], fused.bitmaps, fused.planes, h, xr, y)
    return spmm_row(
        name, "bitmap_spmm_fused.cu", 190, launches, y, y_plain, ms, plain_ms,
        (need, f_ops), (layout, f_ops), library_ms, mirror_err,
        {"n_h": n_h, "n_out": fused.n_out, "features": feat,
         "slots": int(fused.kind.shape[0]), "correction_slots": n_corr,
         "planes": n_planes, "main_entries": main_bits, "correction_entries": corr_entries,
         "plane_bits": corr_bits, **plane_skew(fused)})


def kernel_rows(graph, launches, reps: int, seed: int):
    """K1, K2 and K3 at the main path's operands (F = 32, the author ->
    publication layer: ppr's and bfs's first) against their plain
    versions (:func:`k12_row`, :func:`k3_row`)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    layer = graph.chains[0][0]
    rows = [k12_row(f"bitmap_spmm_{op}", layer, op, 32, launches[f"bitmap_spmm_{op}"],
                    reps, rng) for op in ("sum", "min", "max")]
    rows.append(k3_row("bitmap_spmm_fused", graph, 32, launches["bitmap_spmm_fused"],
                       reps, rng))
    return rows


def index_rows(graph, builds: dict, reps: int) -> list:
    """The upload-time index builder at the main path's operands (the
    author -> publication layer and the forward fused stream) against its
    plain version, byte for byte.  ``launches``: the builds the served
    graphs' upload made."""
    import torch

    from repro_torch.kernels import bitmap_index as BI

    ops, fused = graph.chains[0][0].fwd, graph.fused_fwd
    cases = [
        ("bitmap_index", 77, BI.bitmap_index, BI.bitmap_index_plain,
         (ops.slot_src, ops.slot_row, ops.row_start, ops.row_count, ops.bitmaps),
         (ops.row_ptr, ops.col)),
        ("bitmap_index_fused", 190, BI.bitmap_index_fused, BI.bitmap_index_fused_plain,
         (fused.kind, fused.main_src, fused.corr_src, fused.main_idx, fused.corr_idx,
          fused.slot_row, fused.row_start, fused.row_count, fused.bitmaps, fused.planes,
          fused.plane_weights),
         (fused.row_ptr, fused.col, fused.weight)),
    ]
    rows = []
    for name, line, fn, plain, args, uploaded in cases:
        before = dict(BI.INDEX_BUILDS)
        got, want = fn(*args), plain(*args)
        grid, chunks = BI.LAST_GRID[name]
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: kernel != plain version")
        if not all(torch.equal(a, b) for a, b in zip(got, uploaded)):
            raise AssertionError(f"{name}: a rebuild differs from the uploaded index")
        err = max(float((a.double() - b.double()).abs().max().item()) if a.numel() else 0.0
                  for a, b in zip(got, want))
        ms = time_ms(lambda: fn(*args), reps)
        plain_ms = time_ms(lambda: plain(*args), 2, 1)
        BI.INDEX_BUILDS.update(before)
        words = [t for t in args if isinstance(t, torch.Tensor)]
        n_bytes = nbytes(*words, *got)
        b_ms, b_by = bound(n_bytes, 0)
        rows.append({
            "name": name, "route": "cuda", "source": f"{CSRC}/bitmap_index.cu",
            "replaces": f"{TPU_KERNEL}:{line}", "launches": builds[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "layout_bound_ms": b_ms, "library_ms": None,
            "chunks": chunks, "gb_per_s": n_bytes / ms / 1e6,
            "shape": {"entries": int(got[1].shape[0]), "rows": int(got[0].shape[0]) - 1,
                      "index_bytes": nbytes(*got), "bound_bytes": n_bytes,
                      "chunk_units": BI.CHUNK_UNITS, "grid_chunks": grid},
        })
    return rows


# ---------------------------------------------------------------------------
# Phase 5: the analytics library on the card
# ---------------------------------------------------------------------------

# App. C.2's layered_1 (benchmarks/bench_large.py): a directed chain with two
# virtual layers; (n_real, layer sizes, edges per level), full and --quick
LAYERED = {False: (30_000, [12_000, 12_000], [60_000, 40_000, 60_000]),
           True: (600, [240, 240], [1_200, 800, 1_200])}
# (authors, pubs) of the DEDUP-1 graph: the greedy rewriting runs in host
# Python, so it is cut far below the main graph; full and --quick
DEDUP1_GRAPH = {False: (1_000, 2_000), True: (300, 600)}
# wedge-mode triangle counts sum raw M^2 terms in float32: a node's count is
# exact when the largest entry of its M^2 column stays below 2^23, so that
# every partial sum of the raw hops and corrections is below 2^24
WEDGE_EXACT_BELOW = 2.0 ** 23
# columns of one analytic's (n, B) frontiers; the tolerance of HITS and PPR
# (float32 sums added in other orders by the two paths)
ANALYTIC_BATCH = 32
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)


class Analytics:
    """Runs each analytic with the launch counts zeroed just before and
    read just after, under its wall time (ending in a synchronize), its
    ``propagate`` calls (supersteps of a fixpoint; for ``scc_labels`` also
    its pivot rounds), its launches and stand-downs; and the same call on
    the segment backend, which must launch nothing."""

    def __init__(self):
        self.records = {}

    def run(self, name, fn, need):
        import unittest.mock

        import torch

        from repro_torch.core import algorithms, engine
        from repro_torch.kernels import bitmap_spmm as K

        K.reset_launch_counts()
        engine.reset_kernel_dispatch_count()
        with unittest.mock.patch.object(algorithms, "propagate",
                                        wraps=algorithms.propagate) as prop, \
                unittest.mock.patch.object(algorithms, "reachable_multi",
                                           wraps=algorithms.reachable_multi) as reach:
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        launches = dict(K.LAUNCHES)
        standdowns = dict(engine.KERNEL_STANDDOWN_COUNT)
        rec = {"wall_s": wall, "propagate_calls": prop.call_count,
               "launches": launches, "standdowns": standdowns}
        if reach.call_count:
            rec["reachable_multi_calls"] = reach.call_count
        log(f"{name}: {wall:.4f} s, {prop.call_count} propagate calls, launches "
            f"{json.dumps({k: v for k, v in launches.items() if v})}, stand-downs "
            f"{json.dumps(standdowns)}")
        missing = [k for k in need if launches[k] == 0]
        if missing:
            raise AssertionError(f"{name}: kernels never launched: {missing}")
        if standdowns.get("vmem_or_backend"):
            raise AssertionError(f"{name}: the fused kernel stood down for 'vmem_or_backend'")
        self.records[name] = rec
        return out

    def segment(self, name, fn):
        import torch

        from repro_torch.kernels import bitmap_spmm as K

        before = dict(K.LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        self.records[name]["segment_wall_s"] = time.perf_counter() - t
        if K.LAUNCHES != before:
            raise AssertionError(f"{name}: the segment backend launched a kernel")
        return out


def _equal(name, got, want) -> None:
    import numpy as np
    import torch

    if isinstance(got, torch.Tensor):
        ok = torch.equal(got, want)
    else:
        ok = np.array_equal(got, want)
    if not ok:
        raise AssertionError(f"{name}: kernel path != segment path")


def m2_column_max(graph, block: int):
    """Largest entry of each column of ``M^2`` (M = the raw C-DUP
    multiplicities): two raw hops of identity blocks on the kernel path.
    Launches made here do not count as a path's."""
    import numpy as np
    import torch

    from repro_torch.core import engine
    from repro_torch.kernels import bitmap_spmm as K

    before = dict(K.LAUNCHES)
    raw = dataclasses.replace(graph, correction=None, diag_mult=None)
    n = graph.n_real
    out = np.zeros(n, dtype=np.float64)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        X = torch.zeros((n, block), dtype=torch.float32, device="cuda")
        X[torch.arange(lo, hi, device="cuda"), torch.arange(hi - lo, device="cuda")] = 1.0
        mx = engine.propagate(raw, X, allow_duplicates=True)
        mmx = engine.propagate(raw, mx, allow_duplicates=True)
        out[lo:hi] = mmx.max(dim=0).values[: hi - lo].cpu().numpy()
    K.LAUNCHES.update(before)
    return out


def hub_triangles(g, t, n_hubs: int = 10) -> dict:
    """The ``n_hubs`` largest per_step counts against an int64 count on the
    host: scipy's sparse product of the neighbours' incidence rows, whose
    off-diagonal nonzeros are the edges among a hub's neighbours (twice)."""
    import numpy as np
    import scipy.sparse as sp

    e = g.chains[0].edges[0]  # author -> publication
    inc = sp.csr_matrix((np.ones(e.n_edges, np.float32), (e.src, e.dst)),
                        shape=(e.n_src, e.n_dst))
    inc_t = inc.T.tocsr()
    hubs = np.argsort(-t, kind="stable")[:n_hubs]
    want = []
    t0 = time.perf_counter()
    for v in hubs:
        nbrs = np.unique(inc_t[inc[v].indices].indices)
        nbrs = nbrs[nbrs != v]
        rows = inc[nbrs]
        prod = (rows @ rows.T).tocsr()
        want.append((int(prod.nnz) - int((prod.diagonal() != 0).sum())) // 2)
    got = t[hubs]
    if not np.array_equal(got, np.asarray(want, dtype=np.float64)):
        raise AssertionError(f"triangle_counts: hub counts {got.tolist()} != scipy's {want}")
    return {"hubs": hubs.tolist(), "counts": want, "host_s": time.perf_counter() - t0}


def dblp_analytics(an, exact, g, rng) -> dict:
    """The DEDUP-C graph the main path served: weighted shortest and
    widest paths (K2 min / max), triangle counts in both modes (K1 + K3 at
    F = 128; K1 on the raw hops), clustering coefficients, HITS."""
    import numpy as np
    import torch

    from repro_torch.core import algorithms as A

    seg = dataclasses.replace(exact, backend="segment")
    n, n_pub = exact.n_real, exact.chains[0][0].n_dst
    sources = rng.integers(0, n, ANALYTIC_BATCH)
    cost = torch.from_numpy(rng.integers(1, 9, n_pub).astype(np.float32)).cuda()
    cap = torch.from_numpy(rng.integers(1, 9, n_pub).astype(np.float32)).cuda()
    rec = {}

    d = an.run("shortest_paths_multi", lambda: A.shortest_paths_multi(
        exact, sources, layer_weights=((cost,),)), ["bitmap_spmm_min"])
    _equal("shortest_paths_multi", d, an.segment("shortest_paths_multi", lambda: A.shortest_paths_multi(
        seg, sources, layer_weights=((cost,),))))
    if d.shape != (n, ANALYTIC_BATCH) or bool((d[sources, torch.arange(ANALYTIC_BATCH)] != 0).any()):
        raise AssertionError("shortest_paths_multi: malformed distances")
    rec["shortest_reached_share"] = float(torch.isfinite(d).float().mean().item())

    w = an.run("widest_paths_multi", lambda: A.widest_paths_multi(
        exact, sources, layer_capacities=((cap,),)), ["bitmap_spmm_max"])
    _equal("widest_paths_multi", w, an.segment("widest_paths_multi", lambda: A.widest_paths_multi(
        seg, sources, layer_capacities=((cap,),))))
    if bool((w[sources, torch.arange(ANALYTIC_BATCH)] != float("inf")).any()) or bool(
            (w < 0).any()):
        raise AssertionError("widest_paths_multi: malformed widths")

    t = an.run("triangle_counts_per_step", lambda: A.triangle_counts(exact, block=128),
               ["bitmap_spmm_sum", "bitmap_spmm_fused"])
    _equal("triangle_counts_per_step", t, an.segment(
        "triangle_counts_per_step", lambda: A.triangle_counts(seg, block=128)))
    tw = an.run("triangle_counts_wedge", lambda: A.triangle_counts(exact, block=128, mode="wedge"),
                ["bitmap_spmm_sum"])
    tw_seg = an.segment("triangle_counts_wedge",
                        lambda: A.triangle_counts(seg, block=128, mode="wedge"))
    m2 = m2_column_max(exact, 128)
    exact_nodes = m2 < WEDGE_EXACT_BELOW
    for name, got in (("wedge (kernel path)", tw), ("wedge (segment path)", tw_seg)):
        if not np.array_equal(got[exact_nodes], t[exact_nodes]):
            raise AssertionError(f"triangle_counts: {name} != per_step on nodes whose "
                                 "wedge terms are exact in float32")
    hub = ~exact_nodes
    rel = np.abs(tw[hub] - t[hub]) / np.maximum(t[hub], 1.0)
    rec["triangles"] = {
        "total": float(t.sum() / 3.0), "max": float(t.max()),
        "wedge_exact_nodes": int(exact_nodes.sum()), "wedge_rounded_nodes": int(hub.sum()),
        "m2_column_max": float(m2.max()),
        "wedge_rounded_max_rel_diff": float(rel.max()) if hub.any() else 0.0,
        "wedge_rounded_max_abs_diff": float(np.abs(tw[hub] - t[hub]).max()) if hub.any() else 0.0,
        "wedge_kernel_vs_segment_equal": bool(np.array_equal(tw, tw_seg)),
    }
    log(f"triangles: {json.dumps(rec['triangles'])}")
    if t.shape != (n,) or not (np.isfinite(t).all() and (t >= 0).all()
                               and np.array_equal(t, np.floor(t))):
        raise AssertionError("triangle_counts: malformed counts")
    # per_step reduces each block in float64: the counts are exact
    if int(t.sum()) % 3 or float(int(t.sum())) != t.sum():
        raise AssertionError(f"triangle_counts: the counts sum to {t.sum()}, not 3 x triangles")
    rec["triangles"]["hub_check"] = hub_triangles(g, t)
    log(f"triangle hubs against scipy: {json.dumps(rec['triangles']['hub_check'])}")

    cc = an.run("clustering_coefficients", lambda: A.clustering_coefficients(exact, block=128),
                ["bitmap_spmm_sum", "bitmap_spmm_fused"])
    _equal("clustering_coefficients", cc, an.segment(
        "clustering_coefficients", lambda: A.clustering_coefficients(seg, block=128)))
    if not (np.isfinite(cc).all() and (cc >= 0).all() and (cc <= 1.0 + 1e-9).all()):
        raise AssertionError("clustering_coefficients: outside [0, 1]")

    # HITS steps 1-D frontiers on the segment path both ways, whose sums
    # run in a fixed order: the 'auto' and 'segment' calls are two runs of
    # the same sums and must give the same bits, in default mode
    h, a = an.run("hits", lambda: A.hits(exact, num_iters=30), [])
    hs, as_ = an.segment("hits", lambda: A.hits(seg, num_iters=30))
    if torch.are_deterministic_algorithms_enabled():
        raise AssertionError("hits: deterministic mode is on")
    for got, want in ((h, hs), (a, as_)):
        if not torch.equal(got, want):
            raise AssertionError("hits: two runs of the segment path differ")
    for v in (h, a):
        if not (bool(torch.isfinite(v).all())
                and abs(float(torch.linalg.vector_norm(v).item()) - 1.0) < 1e-4):
            raise AssertionError("hits: scores are not a finite unit vector")

    prof, _ = profile_call(lambda: A._triangle_block(
        exact, torch.eye(n, 128, device="cuda"), None, "per_step"))
    rec["triangle_block_profile"] = prof
    log(f"profiled per_step triangle block: {json.dumps(prof)}")
    return rec


def layered_analytics(an, args, rng) -> dict:
    """App. C.2's layered_1, uploaded packed: SCC labels (K2 max) held to
    scipy's strong components, the condensation DAG held to one built from
    them, weighted shortest paths over both virtual layers forward and
    reversed (K2 min)."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from scipy.sparse.csgraph import connected_components

    from repro_torch.core import algorithms as A
    from repro_torch.core import engine
    from repro_torch.data.synth import layered_condensed

    n_real, sizes, edges = LAYERED[args.quick]
    t = time.perf_counter()
    lg = layered_condensed(n_real, sizes, edges, seed=0, symmetric=False)
    lay = engine.to_device_packed(lg, backend="auto", device="cuda")
    torch.cuda.synchronize()
    rec = {"graph": {"n_real": n_real, "layer_sizes": sizes, "edges_per_level": edges,
                     "layers_with_repeats": sum(layer.repeats for layer in lay.chains[0])},
           "upload_s": time.perf_counter() - t}
    seg = dataclasses.replace(lay, backend="segment")

    # the expanded graph and its strong components, by scipy
    mats = [sp.csr_matrix((np.ones(e.n_edges, np.float32), (e.src, e.dst)),
                          shape=(e.n_src, e.n_dst)) for e in lg.chains[0].edges]
    adj = (mats[0] @ mats[1] @ mats[2]).tocsr()
    adj.setdiag(0)
    adj.eliminate_zeros()
    n_comp, comp = connected_components(adj, directed=True, connection="strong")
    first = np.full(n_comp, n_real, dtype=np.int64)
    np.minimum.at(first, comp, np.arange(n_real))
    want_labels = first[comp]
    rec["graph"].update(expanded_edges=int(adj.nnz), sccs=int(n_comp),
                        largest_scc=int(np.bincount(comp).max()))

    labels = an.run("scc_labels", lambda: A.scc_labels(lay, batch=128), ["bitmap_spmm_max"])
    _equal("scc_labels", labels, an.segment("scc_labels", lambda: A.scc_labels(seg, batch=128)))
    if not np.array_equal(labels, want_labels):
        raise AssertionError("scc_labels != scipy's strong components")
    cond = an.run("condensation", lambda: A.condensation(lay, labels=labels), ["bitmap_spmm_max"])
    cond_seg = an.segment("condensation", lambda: A.condensation(seg, labels=labels))
    for field in cond._fields:
        _equal(f"condensation.{field}", getattr(cond, field), getattr(cond_seg, field))
    u, v = adj.nonzero()
    c = cond.component
    keep = c[u] != c[v]
    pairs = np.unique(c[u][keep] * cond.n_components + c[v][keep])
    if not (np.array_equal(cond.dag_src, pairs // cond.n_components)
            and np.array_equal(cond.dag_dst, pairs % cond.n_components)):
        raise AssertionError("condensation DAG != the one built from scipy's components")
    if not (cond.layers[cond.dag_src] > cond.layers[cond.dag_dst]).all():
        raise AssertionError("condensation layering is not topological")
    rec["condensation"] = {"components": cond.n_components, "dag_edges": int(cond.dag_src.size),
                           "layers": int(cond.layers.max()) + 1}

    lw = ((torch.from_numpy(rng.integers(1, 9, sizes[0]).astype(np.float32)).cuda(),
           torch.from_numpy(rng.integers(1, 9, sizes[1]).astype(np.float32)).cuda()),)
    sources = rng.integers(0, n_real, ANALYTIC_BATCH)
    for reverse in (False, True):
        name = "shortest_paths_multi_layered" + ("_reverse" if reverse else "")
        d = an.run(name, lambda: A.shortest_paths_multi(lay, sources, layer_weights=lw,
                                                       reverse=reverse), ["bitmap_spmm_min"])
        _equal(name, d, an.segment(name, lambda: A.shortest_paths_multi(
            seg, sources, layer_weights=lw, reverse=reverse)))
        rec[name + "_reached_share"] = float(torch.isfinite(d).float().mean().item())
    log(f"layered: {json.dumps(rec)}")
    ctx = {"layered_host": lg, "layered_labels": labels, "layered_weights": lw,
           "layered_sources": sources}
    return rec, lay, ctx


def dedup1_analytics(an, args, rng) -> dict:
    """DEDUP-1 on a small co-author graph (host Python greedy), uploaded
    packed with ``deduplicated=True``: batched PPR runs K1 and never K3 and
    equals DEDUP-C's on the same graph; BFS agrees exactly."""
    import torch

    from repro_torch.core import algorithms as A
    from repro_torch.core import dedup, engine, extract
    from repro_torch.data.synth import dblp_catalog

    na, npb = DEDUP1_GRAPH[args.quick]
    g = extract(dblp_catalog(na, npb, 6.0, seed=args.seed), QUERY).graph
    t = time.perf_counter()
    d1 = dedup.dedup1_greedy_virtual_first(g)
    rec = {"graph": {"authors": na, "pubs": npb, "edges_condensed": g.n_edges_condensed,
                     "dedup1_total_edges": d1.total_edges,
                     "dedup1_direct_edges": d1.n_direct_edges},
           "dedup1_host_s": time.perf_counter() - t}
    dev1 = engine.to_device_packed(d1.graph, deduplicated=True, backend="auto", device="cuda")
    devc = engine.to_device_packed(g, correction=dedup.build_correction(g), backend="auto",
                                   device="cuda")
    sources = rng.integers(0, g.n_real, ANALYTIC_BATCH)
    seeds = A.one_hot_frontier(g.n_real, sources, device="cuda")
    p1 = an.run("ppr_dedup1", lambda: A.personalized_pagerank(dev1, seeds), ["bitmap_spmm_sum"])
    if an.records["ppr_dedup1"]["launches"]["bitmap_spmm_fused"]:
        raise AssertionError("DEDUP-1 PPR launched K3")
    p1_seg = an.segment("ppr_dedup1", lambda: A.personalized_pagerank(
        dataclasses.replace(dev1, backend="segment"), seeds))
    if not torch.allclose(p1, p1_seg, **FLOAT_TOL):
        raise AssertionError("ppr_dedup1: kernel path != segment path")
    pc = an.run("ppr_dedupc", lambda: A.personalized_pagerank(devc, seeds),
                ["bitmap_spmm_sum", "bitmap_spmm_fused"])
    if not torch.allclose(p1, pc, rtol=1e-5, atol=1e-6) or not bool(torch.isfinite(p1).all()):
        raise AssertionError("PPR on DEDUP-1 != PPR on DEDUP-C")
    b1 = an.run("bfs_dedup1", lambda: A.bfs_multi(dev1, sources), ["bitmap_spmm_min"])
    _equal("bfs_dedup1", b1, an.segment("bfs_dedup1", lambda: A.bfs_multi(
        dataclasses.replace(dev1, backend="segment"), sources)))
    if not torch.equal(b1, A.bfs_multi(devc, sources)):
        raise AssertionError("BFS on DEDUP-1 != BFS on DEDUP-C")
    rec["ppr_max_abs_diff_vs_dedupc"] = float((p1 - pc).abs().max().item())
    log(f"DEDUP-1: {json.dumps(rec)}")
    return rec, {"dedup1_host": d1.graph, "dedup1_seeds": seeds, "dedup1_sources": sources}


def slice_checks(exact, lay, rng) -> dict:
    """One F = 128 launch against four F = 32 launches on its column
    slices, on float frontiers at the range length the wrappers choose at
    F = 128: K1 sum / min / max over the author -> publication layer, K3
    over the forward fused stream, K2 max over the layered middle layer.
    A feature's fold order depends only on the index and the range length,
    so the wide route (one group owns 128 features) must give the 32-feature
    route's bits.  Launches made here do not count as a path's."""
    import numpy as np
    import torch

    from repro_torch.kernels import bitmap_spmm as K

    def floats(n):
        return torch.from_numpy(rng.random((n, 128)).astype(np.float32)).cuda()

    def k12(layer, op):
        ops = layer.fwd
        return (lambda fr, L: K.bitmap_spmm(ops.row_ptr, ops.col, *fr, layer.n_dst, op,
                                            ZERO[op], range_items=L),
                (floats(layer.n_src),), layer.n_dst + int(ops.col.shape[0]))

    fused = exact.fused_fwd
    cases = {f"bitmap_spmm_{op}": k12(exact.chains[0][0], op) for op in ("sum", "min", "max")}
    cases["bitmap_spmm_fused"] = (
        lambda fr, L: K.bitmap_spmm_fused(fused.row_ptr, fused.col, fused.weight, *fr,
                                          fused.n_out, range_items=L),
        (floats(exact.chains[-1][-1].n_src), floats(exact.n_real)),
        fused.n_out + int(fused.col.shape[0]))
    cases["bitmap_spmm_max_layered"] = k12(lay.chains[0][1], "max")
    before = dict(K.LAUNCHES)
    rec = {}
    for name, (fn, fr, total) in cases.items():
        items = K.default_range_items(total, 128)
        whole = fn(fr, items)
        parts = torch.cat([fn(tuple(t[:, c:c + 32].contiguous() for t in fr), items)
                           for c in range(0, 128, 32)], 1)
        torch.cuda.synchronize()
        if not torch.equal(whole, parts):
            raise AssertionError(f"{name}: one F = 128 launch != four F = 32 launches on its "
                                 f"column slices at range_items={items}")
        rec[name] = {"range_items": items, "bit_identical": True}
    K.LAUNCHES.update(before)
    return rec


def analytics_phase(args, exact, g, record):
    """Phase 5: every analytic on the card with ``backend='auto'``, each
    against the same call on the segment backend; then the kernels' rows
    at the analytics' shapes (K1 and K3 at the triangle block's F = 128, K2
    max on the layered graph's middle layer at ``scc_labels``' F = 128, K2
    min on it at the batch's F = 32) and :func:`slice_checks`."""
    import numpy as np

    an = Analytics()
    rng = np.random.default_rng(args.seed + 1)
    t = time.perf_counter()
    rec = {"dblp": dblp_analytics(an, exact, g, rng)}
    rec["layered"], lay, ctx = layered_analytics(an, args, rng)
    rec["dedup1"], d1ctx = dedup1_analytics(an, args, rng)
    ctx.update(d1ctx)
    rec["phase_s"] = time.perf_counter() - t
    rec["runs"] = an.records

    def launched(kernel, names):
        return sum(an.records[n]["launches"][kernel] for n in names)

    f128 = ("triangle_counts_per_step", "triangle_counts_wedge", "clustering_coefficients")
    layered_min = ("shortest_paths_multi_layered", "shortest_paths_multi_layered_reverse")
    rows = [
        k12_row("bitmap_spmm_sum_f128", exact.chains[0][0], "sum", 128,
                launched("bitmap_spmm_sum", f128), args.reps, rng),
        k3_row("bitmap_spmm_fused_f128", exact, 128, launched("bitmap_spmm_fused", f128),
               args.reps, rng),
        k12_row("bitmap_spmm_max_f128_layered", lay.chains[0][1], "max", 128,
                launched("bitmap_spmm_max", ("scc_labels",)), args.reps, rng),
        k12_row("bitmap_spmm_min_layered", lay.chains[0][1], "min", ANALYTIC_BATCH,
                launched("bitmap_spmm_min", layered_min), args.reps, rng, library=False),
    ]
    for r in rows:
        log(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']}, library {r['library_ms']}), "
            f"{r['launches']} launches in the analytics phase")
    rec["f128_slices"] = slice_checks(exact, lay, rng)
    log(f"F = 128 launches equal four F = 32 slice launches: {json.dumps(rec['f128_slices'])}")
    log(f"analytics phase: {rec['phase_s']:.1f} s")
    record["analytics"] = rec
    return rows, ctx


# ---------------------------------------------------------------------------
# Phase 6: LM serving (glm4-9b at full width) with K4
# ---------------------------------------------------------------------------

# (B, T, H, KV, D, causal): tests/test_kernels.py's FLASH_SWEEP
FLASH_SWEEP = [
    (1, 64, 2, 1, 8, True),
    (2, 128, 4, 2, 16, True),
    (1, 96, 4, 4, 8, False),
    (2, 100, 2, 1, 8, True),
    (1, 256, 8, 2, 32, True),
]
# (B, Tq, Tk, H, KV, D, causal, q_offset, kv_length): the cache path
FLASH_CACHE = [
    (1, 300, 4128, 32, 2, 128, True, 0, [300]),        # prefill into a longer cache
    (2, 64, 600, 32, 2, 128, True, 200, [264, 264]),   # prefill after a prefix
    (8, 1, 4128, 32, 2, 128, False, 0, [4097, 4100, 1, 0, 33, 4128, 2049, 77]),
    (1, 4096, 4128, 32, 2, 128, True, 0, [4096]),      # the main path's prefill
]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 0.05}   # tests/test_kernels.py:138
BF16_OPS_PER_S = 989e12                           # H100 SXM dense bf16
F32_OPS_PER_S = 67e12                             # H100 SXM float32, CUDA cores
FLASH_TPU_KERNEL = "src/repro/kernels/flash_attention.py:34"
# last-position logits of a 4096-token prefill, K4 against the plain
# attention, both bf16 end to end: the max abs difference may be this
# share of the largest |logit| (40 layers of bf16 round-off apart)
LOGITS_RTOL = 0.05
# K4 in bf16 at the main path's shapes, element by element against the
# plain version: |got - want| <= K4_BF16_ATOL + K4_BF16_RTOL * |want|.
# RTOL is one bf16 unit in the last place of the output (both round it
# once); ATOL covers p rounded to bf16 against a different running max.
# A late row of a 4096-token prefill averages thousands of keys, so its
# outputs are a few hundredths: a dropped key tile hides under the 0.05 of
# FLASH_TOL, not under this bound.
K4_BF16_RTOL = 2.0 ** -7
K4_BF16_ATOL = 2e-3
# (long prompt, short prompt, new tokens) of the served LM run; --quick
# takes the second for a first check of a changed kernel (weights stay
# full width).  The cache holds the long prompt and its new tokens.
LM_FULL = (4096, 1024, 32)
# distinct decode-shape caches K4's decode row is timed over in turn: 4 x
# 33.8 MB at the full run's shape, well past the 50 MB L2
DECODE_CACHES = 4
LM_QUICK = (256, 64, 4)


def flash_small_check() -> dict:
    """K4 against its plain version on the sweep and the cache-path shapes,
    float32 (full-precision matmuls) and bf16.  Launch counts made here
    are restored: they are comparisons, not the main path's."""
    import torch

    from repro_torch.kernels import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")
    before = dict(FA.LAUNCHES), dict(FA.PLAIN_CUDA_CALLS), dict(FA.PREFILL_ROUTES)
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    cases = [(B, T, T, H, KV, D, c, 0, None) for B, T, H, KV, D, c in FLASH_SWEEP]
    for dname, tol in FLASH_TOL.items():
        dtype = getattr(torch, dname)
        for B, Tq, Tk, H, KV, D, causal, q_off, kv_len in cases + FLASH_CACHE:
            q = torch.randn((B, Tq, H, D), generator=gen, device="cuda").to(dtype)
            k = torch.randn((B, Tk, KV, D), generator=gen, device="cuda").to(dtype)
            v = torch.randn((B, Tk, KV, D), generator=gen, device="cuda").to(dtype)
            lengths = (None if kv_len is None
                       else torch.tensor(kv_len, dtype=torch.int32, device="cuda"))
            kw = dict(causal=causal, q_offset=q_off, kv_length=lengths)
            got = FA.flash_attention(q, k, v, **kw)
            want = FA.flash_attention_plain(q, k, v, **kw)
            err = float((got.float() - want.float()).abs().max().item())
            shape = (B, Tq, Tk, H, KV, D, causal, q_off)
            if not err < tol:
                raise AssertionError(f"K4 {dname} {shape}: max abs err {err} >= {tol}")
            worst[dname] = max(worst.get(dname, 0.0), err)
    # the sweep's head dims (8, 16, 32) keep the mma.sync kernel; the
    # cache path's bf16 prefills (D = 128) run the sm90 kernel
    routes = {key: n - before[2][key] for key, n in FA.PREFILL_ROUTES.items()}
    FA.LAUNCHES.update(before[0])
    FA.PLAIN_CUDA_CALLS.update(before[1])
    FA.PREFILL_ROUTES.update(before[2])
    log(f"K4 small check: {2 * len(cases + FLASH_CACHE)} cases within tolerance; "
        f"worst {json.dumps(worst)} (tolerances {json.dumps(FLASH_TOL)}); bf16 prefill "
        f"routes {json.dumps(routes)}")
    if routes != {"sm90": 3, "mma": len(FLASH_SWEEP), "relay": 0}:
        raise AssertionError(f"K4 small check's bf16 prefill routes {routes}")
    return worst


def lm_requests(cfg, seed: int, long_len: int, short_len: int, n_each: int, new_tokens: int):
    import numpy as np

    from repro_torch.serve.server import Request

    rng = np.random.default_rng(seed)
    lengths = [long_len] * n_each + [short_len] * n_each
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=n),
                    max_new_tokens=new_tokens) for i, n in enumerate(lengths)]


def device_time_by_kind(prof) -> dict:
    """Seconds of device time in K4, in matrix products (cuBLAS / CUTLASS
    kernels) and in everything else."""
    from torch.autograd import DeviceType

    out = {"k4_s": 0.0, "gemm_s": 0.0, "other_s": 0.0, "k4_by_kernel_s": {}}
    for e in prof.key_averages():
        # the port's profiler ranges also show as device spans over their
        # kernels: counting them would count those kernels twice
        if e.device_type != DeviceType.CUDA or e.key in RANGES:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = e.key.lower()
        if "flash_" in name:  # flash_prefill / flash_decode / flash_combine kernels
            kind = "k4_s"
        elif any(w in name for w in ("gemm", "nvjet", "cutlass", "xmma", "sm90_")):
            kind = "gemm_s"
        else:
            kind = "other_s"
        out[kind] += us / 1e6
        if kind == "k4_s":
            by = out["k4_by_kernel_s"]
            by[e.key] = by.get(e.key, 0.0) + us / 1e6
    return out


def profile_lm(server, requests) -> dict:
    """One profiled prefill (the first request) and, once every slot is
    full, one profiled decode step: wall time, device time by kind and the
    idle share.  Launches made here do not count as the main path's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as FA

    before = dict(FA.LAUNCHES)
    out = {}
    slots = len(server.slots)
    for phase in ("prefill", "decode"):
        if phase == "decode":
            for r in requests[1:slots]:
                server.admit(r)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            if phase == "prefill":
                server.admit(requests[0])
            else:
                server.step()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t
        kinds = device_time_by_kind(prof)
        busy = kinds["k4_s"] + kinds["gemm_s"] + kinds["other_s"]
        out[phase] = {"wall_s": wall_s, **kinds, "device_busy_s": busy,
                      "idle_share": 1.0 - busy / wall_s, "by_range": trace_split(prof)}
    FA.LAUNCHES.update(before)
    return out


def trace_split(prof) -> dict:
    """:func:`split_device_time` of a finished profile, through its
    exported trace (written under ``build/`` and removed)."""
    trace_path = os.path.join(ROOT, "build", "profile_trace.json")
    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    prof.export_chrome_trace(trace_path)
    try:
        with open(trace_path) as f:
            return split_device_time(json.load(f))
    finally:
        os.remove(trace_path)


def k4_row(name, source, q, caches, kw, pairs, launches, reps, atol=K4_BF16_ATOL,
           library_parts=(1,)) -> dict:
    """K4 at one main-path shape: time, plain time, SDPA time, bound.
    ``caches`` holds distinct ``(k, v)`` pairs of one shape: K4 and SDPA
    are timed over them in turn, so that with more bytes than the 50 MB L2
    every call finds its keys and values cold, as the served run's
    attention does after reading a layer's weights; the warm time on the
    first pair alone is logged beside it.  ``pairs`` counts the (batch
    row, query, key) triples whose score the masks keep: the causal half
    for prefill, every valid key for decode.  The output is held to the
    plain version within ``atol + K4_BF16_RTOL |plain|``.  SDPA runs over
    the batch in one call, or, where the row names more ``library_parts``,
    in the fewest equal batch parts of them that it takes (timed back to
    back: the sum of the parts' times); a row whose SDPA refuses every
    part count it names records no library time only if it named more
    than one, and fails otherwise."""
    import itertools

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA

    k, v = caches[0]
    before = dict(FA.LAUNCHES), dict(FA.PLAIN_CUDA_CALLS)
    got = FA.flash_attention(q, k, v, **kw)
    want = FA.flash_attention_plain(q, k, v, **kw)
    diff = (got.float() - want.float()).abs()
    err = float(diff.max().item())
    excess = float((diff - K4_BF16_RTOL * want.float().abs()).max().item())
    log(f"{name}: K4 against plain, max abs err {err}, largest |err| - "
        f"{K4_BF16_RTOL} |plain| {excess} (tolerance {atol})")
    if not excess <= atol:
        raise AssertionError(f"K4 {name}: |err| exceeds {atol} + "
                             f"{K4_BF16_RTOL} |plain| by up to {excess - atol}")

    def rotated(fn, pairs_):
        turn = itertools.count()
        return lambda: fn(*pairs_[next(turn) % len(pairs_)])

    attend = lambda k_, v_: FA.flash_attention(q, k_, v_, **kw)  # noqa: E731
    ms, host_ms = time_device_and_host(rotated(attend, caches), reps)
    warm_ms = time_ms(lambda: attend(k, v), reps)
    plain_ms = time_ms(lambda: FA.flash_attention_plain(q, k, v, **kw), 3, 1)
    FA.LAUNCHES.update(before[0])
    FA.PLAIN_CUDA_CALLS.update(before[1])
    B, Tq, H, D = q.shape
    n_valid = k.shape[1] if kw["kv_length"] is None else int(kw["kv_length"].max().item())
    # SDPA over the valid keys (every row of these shapes holds n_valid)
    qs = q.transpose(1, 2).contiguous()
    sdpa_caches = [(k_[:, :n_valid].transpose(1, 2).contiguous(),
                    v_[:, :n_valid].transpose(1, 2).contiguous()) for k_, v_ in caches]
    def sdpa_in(bounds):
        return lambda k_, v_: [F.scaled_dot_product_attention(
            qs[lo:hi], k_[lo:hi], v_[lo:hi], is_causal=kw["causal"], enable_gqa=True)
            for lo, hi in bounds]

    library_ms = library_warm_ms = library_note = parts_used = None
    for parts in library_parts:
        size = -(-B // parts)
        sdpa = sdpa_in([(lo, min(B, lo + size)) for lo in range(0, B, size)])
        try:
            sdpa(*sdpa_caches[0])
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError) as e:  # the library's own limits
            if len(library_parts) == 1:
                raise
            library_note = str(e).splitlines()[0][:200]
            log(f"{name}: SDPA refuses {size} batch rows: {library_note}")
            continue
        library_ms = time_ms(rotated(sdpa, sdpa_caches), reps)
        library_warm_ms = time_ms(lambda: sdpa(*sdpa_caches[0]), reps)
        parts_used = parts
        break
    if library_ms is None:
        log(f"{name}: no library time: SDPA refuses each of {list(library_parts)} batch parts")
    del sdpa_caches
    kv_bytes = 2 * B * n_valid * k.shape[2] * D * k.element_size()
    n_bytes = 2 * nbytes(q) + kv_bytes
    n_ops = 4 * H * D * pairs
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / BF16_OPS_PER_S * 1e3
    b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    rotation = sum(nbytes(k_, v_) for k_, v_ in caches)
    log(f"{name}: K4 {ms:.4f} ms over {len(caches)} caches in turn ({rotation / 1e6:.1f} MB), "
        f"warm on one {warm_ms:.4f} ms, host {host_ms:.4f} ms a call; SDPA "
        f"{library_ms} ms in turn, warm {library_warm_ms} ms, in {parts_used} call(s)")
    return {
        "name": name, "route": "cuda", "source": f"{CSRC}/{source}",
        "replaces": FLASH_TPU_KERNEL, "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": library_ms,
        "shape": {"q": list(q.shape), "kv": list(k.shape), "kv_valid": n_valid,
                  "causal": kw["causal"], "q_offset": kw["q_offset"],
                  "dtype": str(q.dtype), "pairs": pairs, "bytes": n_bytes,
                  "flops": n_ops, "bf16_excess_over_rtol": excess,
                  "caches_in_turn": len(caches), "bytes_in_turn": rotation,
                  "warm_ms": warm_ms, "library_warm_ms": library_warm_ms,
                  "library_parts": parts_used, "library_note": library_note,
                  "host_ms": host_ms, "plan": k4_plan(q, k, kw["q_offset"])},
    }


def k4_plan(q, k, q_offset) -> dict:
    """The launch plan the wrapper chooses for this call: the float32
    kernel's rows a block and blocks, or the bf16 prefill's sequences a
    block."""
    import torch

    from repro_torch.kernels import flash_attention as FA

    B, Tq, H, _ = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16 and Tq == 1:
        return {}  # the decode kernel: its split is recorded beside its row
    if not hasattr(FA, "prefill_pack"):
        return {}  # a tree from before the plans (the parent of an A/B in k4_times.py)
    if q.dtype == torch.float32:
        rows, blocks = FA.f32_block_rows(B, Tq, H, KV,
                                         torch.cuda.get_device_properties(0).multi_processor_count)
        return {"rows": rows, "blocks": blocks}
    pack = FA.prefill_pack(Tq, Tk, H // KV, q_offset)
    if not hasattr(FA, "prefill_route"):
        return {"pack": pack}  # a tree from before the sm90 route
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k))
    route = FA.prefill_route(q.dtype, q.shape, k.shape, pack, aligned)
    plan = {"pack": pack, "route": route}
    if route == "sm90":
        plan.update(FA.sm90_prefill_plan(B, Tq, H, KV, q.shape[3]))
    return plan


def k4_rows(T, max_len, H, KV, hd, launches, reps, seed, tag="") -> list:
    """K4's two rows at the served run's shapes: a causal prefill of ``T``
    tokens into a ``max_len`` cache, and a decode step of 8 slots over
    ``T + 4`` cached positions, timed over ``DECODE_CACHES`` distinct
    caches in turn.  ``launches``: the served run's per-kernel counts;
    ``tag`` suffixes the rows' names."""
    import torch

    from repro_torch.kernels import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    rows = [k4_row(
        "flash_attention_prefill" + tag, "flash_prefill.cu", randn(1, T, H, hd),
        [(randn(1, max_len, KV, hd), randn(1, max_len, KV, hd))],
        dict(causal=True, q_offset=0,
             kv_length=torch.full((1,), T, dtype=torch.int32, device="cuda")),
        T * (T + 1) // 2, launches["flash_attention_prefill"], reps)]
    kv = T + 4
    rows.append(k4_row(
        "flash_attention_decode" + tag, "flash_decode.cu", randn(8, 1, H, hd),
        [(randn(8, max_len, KV, hd), randn(8, max_len, KV, hd))
         for _ in range(DECODE_CACHES)],
        dict(causal=False, q_offset=kv - 1,
             kv_length=torch.full((8,), kv, dtype=torch.int32, device="cuda")),
        8 * kv, launches["flash_attention_decode"], reps))
    n_split, split_keys = FA.decode_split(
        max_len, 8 * KV * -(-(H // KV) // 16),
        torch.cuda.get_device_properties(0).multi_processor_count)
    rows[-1]["shape"].update(combine_launches=launches["flash_attention_combine"],
                             n_split=n_split, split_keys=split_keys,
                             decode_blocks=n_split * KV * 8)
    return rows


def graph_atomic_counts() -> dict:
    """Atomic and reduction instructions in the SASS of the graph SpMM
    libraries, where the toolkit has ``cuobjdump``: global ones (``ATOMG``,
    ``RED``) must be absent; the carry pass's one shared-memory integer
    ``ATOMS`` is counted beside them."""
    import re

    from repro_torch.kernels import build

    tool = cuobjdump()
    if tool is None:
        return {}
    counts = {}
    for name in ("bitmap_spmm", "bitmap_spmm_fused"):
        sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                              capture_output=True, text=True, check=True).stdout
        counts[name] = {op: len(re.findall(rf"\b{op}\.", sass))
                        for op in ("ATOMG", "RED", "REDG", "ATOM", "ATOMS")}
        if any(counts[name][op] for op in ("ATOMG", "RED", "REDG", "ATOM")):
            raise AssertionError(f"{name}: global atomics in the SASS: {counts[name]}")
    log(f"SASS atomics of the graph SpMMs: {json.dumps(counts)}")
    return counts


def cuobjdump():
    import shutil

    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = shutil.which("cuobjdump") or os.path.join(home, "bin", "cuobjdump")
    if not os.path.exists(tool):
        log("cuobjdump not found: no SASS instruction counts")
        return None
    return tool


def mma_instruction_counts() -> dict:
    """Tensor-core instructions (``HMMA``: mma.sync; ``HGMMA``: wgmma) and
    TMA tensor loads (``UTMALDG``) in the SASS of K4's bf16 libraries, where
    the toolkit has ``cuobjdump``; empty where it has none.  The prefill
    library must hold ``HGMMA`` and ``UTMALDG`` (its sm90 kernel), and so
    must the backward library (its long route's kernels)."""
    import re

    from repro_torch.kernels import build

    tool = cuobjdump()
    if tool is None:
        return {}
    counts = {}
    for name in ("flash_prefill", "flash_decode", "flash_backward"):
        sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                              capture_output=True, text=True, check=True).stdout
        counts[name] = {op: len(re.findall(rf"\b{op}\b", sass))
                        for op in ("HMMA", "HGMMA", "UTMALDG")}
    log(f"SASS tensor-core and TMA instructions: {json.dumps(counts)}")
    for name in ("flash_prefill", "flash_backward"):
        if not (counts[name]["HGMMA"] and counts[name]["UTMALDG"]):
            raise AssertionError(f"{name}'s SASS holds no wgmma or no TMA load: {counts[name]}")
    return counts


def serve_counted(cfg, server, requests) -> tuple:
    """``server.run(requests)`` with K4's launch counts zeroed just before
    and read just after: every prefill and decode step timed, the served
    tokens checked, K4 launched at every attention call (the prefill
    kernel n_layers x prefills times, the decode kernel and its combine
    n_layers x decode steps times each, nothing else) and the plain
    attention never.  ``requests``: n long then n short prompts (n at most
    the slots), so the batch drains once.  Returns the record and K4's
    per-kernel launches."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as FA

    lengths = sorted({int(r.prompt.size) for r in requests}, reverse=True)
    long_len, short_len = lengths[0], lengths[-1]
    new_tokens = requests[0].max_new_tokens
    n_each = len(requests) // 2
    prefill_s = {long_len: [], short_len: []}
    step_s, step_len = [], []
    split = {"prefill": 0, "decode": 0}
    admit, step = server.admit, server.step

    def timed_admit(req):
        torch.cuda.synchronize()
        n0, t0 = FA.LAUNCHES["flash_attention"], time.perf_counter()
        ok = admit(req)
        torch.cuda.synchronize()
        prefill_s[int(req.prompt.size)].append(time.perf_counter() - t0)
        split["prefill"] += FA.LAUNCHES["flash_attention"] - n0
        return ok

    def timed_step():
        length = server._active_length()
        torch.cuda.synchronize()
        n0, t0 = FA.LAUNCHES["flash_attention"], time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        step_len.append(length)
        split["decode"] += FA.LAUNCHES["flash_attention"] - n0

    server.admit, server.step = timed_admit, timed_step

    # -- the run whose launches count ---------------------------------------
    FA.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    try:
        out = server.run(requests)
        torch.cuda.synchronize()
    finally:
        server.admit, server.step = admit, step
    run_s = time.perf_counter() - t
    launches = FA.LAUNCHES["flash_attention"]
    plain_calls = FA.PLAIN_CUDA_CALLS["flash_attention"]
    peak = torch.cuda.max_memory_allocated()

    n_prefill = sum(len(v) for v in prefill_s.values())
    n_steps = len(step_s)
    log(f"{cfg.name}: served {len(out)} requests ({n_each} x {long_len} + {n_each} x "
        f"{short_len} prompt tokens, {new_tokens} new each) in {run_s:.2f} s: "
        f"{n_prefill} prefills, {n_steps} decode steps, {launches} K4 launches, "
        f"{plain_calls} plain attention calls on the card")
    if sorted(out) != sorted(r.rid for r in requests):
        raise AssertionError(f"served {sorted(out)}")
    for rid, toks in out.items():
        if len(toks) != new_tokens or not all(0 <= t_ < cfg.vocab_size for t_ in toks):
            raise AssertionError(f"request {rid}: {len(toks)} tokens {toks[:4]}...")
    if n_prefill != 2 * n_each or n_steps != 2 * (new_tokens - 1):
        raise AssertionError(f"{n_prefill} prefills / {n_steps} steps: deferral broke")
    if launches != cfg.n_layers * (n_prefill + n_steps):
        raise AssertionError(
            f"K4 launched {launches} times, not n_layers x (prefills + steps) = "
            f"{cfg.n_layers * (n_prefill + n_steps)}")
    if plain_calls:
        raise AssertionError(f"the plain attention ran {plain_calls} times on the card")
    kernel_launches = {key: n for key, n in FA.LAUNCHES.items() if key != "flash_attention"}
    # every prefill on the route the launcher names for this model's heads
    # (a prompt into a longer cache: one sequence a block, aligned)
    hd = cfg.resolved_head_dim
    route = FA.prefill_route(torch.bfloat16, (1, 2, cfg.n_heads, hd), (1, 4, cfg.n_kv_heads, hd),
                             1, True)
    routes = dict(FA.PREFILL_ROUTES)
    log(f"K4 prefill launches by route: {json.dumps(routes)} (expected all '{route}')")
    if routes != {**dict.fromkeys(routes, 0), route: cfg.n_layers * n_prefill}:
        raise AssertionError(f"prefill routes {routes}: every prefill should be '{route}'")
    expected = dict.fromkeys(kernel_launches, 0)
    expected.update(flash_attention_prefill=cfg.n_layers * n_prefill,
                    flash_attention_decode=cfg.n_layers * n_steps,
                    flash_attention_combine=cfg.n_layers * n_steps)
    log(f"K4 kernel launches: {json.dumps(kernel_launches)}")
    if kernel_launches != expected:
        raise AssertionError(f"K4 kernel launches {kernel_launches}, expected {expected}")

    long_steps = [s_ for s_, n in zip(step_s, step_len) if n >= long_len]
    short_steps = [s_ for s_, n in zip(step_s, step_len) if n < long_len]
    rec = {
        "requests": len(out), "slots": len(server.slots), "max_len": server.max_len,
        "prompt_tokens": [long_len, short_len], "new_tokens": new_tokens,
        "run_s": run_s, "generated_tokens_per_s": len(out) * new_tokens / run_s,
        "prefill_s_mean": {str(n): float(np.mean(v)) for n, v in prefill_s.items()},
        "prefill_s_first": {str(n): v[0] for n, v in prefill_s.items()},
        "decode_ms_per_step_mean": {
            f"kv~{long_len}": 1e3 * float(np.mean(long_steps)),
            f"kv~{short_len}": 1e3 * float(np.mean(short_steps))},
        "prefills": n_prefill, "decode_steps": n_steps, "k4_launches": launches,
        "k4_launches_split": dict(split), "k4_kernel_launches": kernel_launches,
        "prefill_route": route, "prefill_routes": routes,
        "plain_attention_cuda_calls": plain_calls,
        "peak_memory_bytes": peak,
    }
    log(f"prefill s/request: {json.dumps(rec['prefill_s_mean'])}; decode ms/step at "
        f"{len(server.slots)} slots: {json.dumps(rec['decode_ms_per_step_mean'])}; "
        f"{rec['generated_tokens_per_s']:.1f} generated tokens/s; peak memory "
        f"{peak / 1e9:.2f} GB")
    return rec, kernel_launches, out


def logits_check(cfg, params, prompt, max_len) -> dict:
    """One prefill's last-position logits through K4 and through the plain
    attention, both bf16 end to end: the largest difference must stay
    within ``LOGITS_RTOL`` of the largest |logit|."""
    import unittest.mock

    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer

    prompt = torch.as_tensor(prompt, device="cuda")[None, :]
    logits = {}
    with torch.inference_mode():
        for which in ("k4", "plain"):
            cache = transformer.init_cache(cfg, 1, max_len, "cuda")
            attention = FA.flash_attention if which == "k4" else FA.flash_attention_plain
            with unittest.mock.patch.object(transformer, "flash_attention", attention):
                full, _, _ = transformer.forward(params, prompt, cfg, cache)
            logits[which] = full[0, -1].clone()
            del full, cache
    FA.reset_launch_counts()
    err = float((logits["k4"] - logits["plain"]).abs().max().item())
    scale = float(logits["plain"].abs().max().item())
    same_argmax = int(logits["k4"].argmax()) == int(logits["plain"].argmax())
    log(f"{cfg.name}: last-position logits, K4 vs plain attention on the card: max abs err "
        f"{err:.5f} (largest |logit| {scale:.4f}, tolerance {LOGITS_RTOL} x that); argmax "
        f"agrees: {same_argmax}")
    if not (np.isfinite(err) and err <= LOGITS_RTOL * scale):
        raise AssertionError(f"{cfg.name}: K4 logits differ from the plain attention's by {err}")
    return {"max_abs_err": err, "max_abs_logit": scale, "rtol": LOGITS_RTOL,
            "argmax_agrees": same_argmax}


def lm_phase(args) -> dict:
    """glm4-9b (CONFIG: 40 layers, d_model 4096, vocab 151552) in bf16
    with random weights: 16 requests through ``BatchedServer.run`` on 8
    slots, counted K4 launches, the K4-vs-plain logits check, a profile
    and K4's rows."""
    import torch

    from repro_torch.configs import glm4_9b
    from repro_torch.models import transformer
    from repro_torch.serve.server import BatchedServer

    cfg = glm4_9b.CONFIG
    rec = {"config": {"name": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                      "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                      "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size, "dtype": cfg.dtype,
                      "n_params": cfg.n_params()}}
    rec["k4_small_worst_err"] = flash_small_check()

    t = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = transformer.init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t

    rec["weight_bytes"] = leaf_bytes(params)
    log(f"glm4-9b: {cfg.n_params():,} parameters, {rec['weight_bytes'] / 1e9:.2f} GB of "
        f"bf16 weights, drawn in {rec['init_s']:.1f} s")

    long_len, short_len, new_tokens = LM_QUICK if args.quick else LM_FULL
    max_len, n_each = long_len + new_tokens, 8
    server = BatchedServer(params, cfg, batch_slots=8, max_len=max_len)
    requests = lm_requests(cfg, args.seed, long_len, short_len,
                           n_each, new_tokens)
    served, kernel_launches, _ = serve_counted(cfg, server, requests)
    rec.update(served)
    if served["prefill_route"] != "sm90":  # glm4-9b's heads: D = 128, G = 16
        raise AssertionError(f"glm4-9b's prefills went '{served['prefill_route']}', not 'sm90'")
    rec["logits_check"] = logits_check(cfg, params, requests[0].prompt, max_len)

    rec["profile"] = profile_lm(server, lm_requests(
        cfg, args.seed + 1, long_len, short_len, n_each, new_tokens))
    log(f"profiled prefill / decode step: {json.dumps(rec['profile'])}")

    # -- K4 rows at the main path's shapes --------------------------------------
    rows = k4_rows(long_len, max_len, cfg.n_heads, cfg.n_kv_heads,
                   cfg.resolved_head_dim, kernel_launches, args.reps, args.seed)
    rec["sass"] = mma_instruction_counts()
    for r in rows:
        log(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']}, SDPA {r['library_ms']:.4f}), "
            f"{r['launches']} launches in the served run")
    rec["kernels"] = rows
    return rec


# ---------------------------------------------------------------------------
# Phase 3b: larger-than-memory extraction, and the measured crossover
# ---------------------------------------------------------------------------

# shards of the sharded runs, and the spill directory (gitignored build/)
SCALE_SHARDS = 8
SPILL_ROOT = os.path.join(ROOT, "build", "spill")
# the frontier widths and ops of every measured crossover cell
CROSSOVER_BATCHES = (8, 32, 128)
CROSSOVER_OPS = ("sum", "min", "max")
# TPC-H's "customers who bought the same item" (paper Fig. 5a): three
# virtual layers, symmetric, so its collapse can be rewritten by DEDUP-1;
# (customers, orders, parts), full and --quick
TPCH_GRAPH = {False: (1_000, 4_000, 300), True: (300, 900, 100)}
TPCH_QUERY = """
Nodes(ID, Name) :- Customer(ID, Name).
Edges(ID1, ID2) :- Orders(ok1, ID1), LineItem(ok1, pk),
                   Orders(ok2, ID2), LineItem(ok2, pk).
"""
BUDGET_FIELDS = ("peak_resident_rows", "peak_assembly_bytes", "spilled_bytes",
                 "n_spilled_records", "n_merge_rounds", "merge_peak_resident_bytes",
                 "n_shards_processed", "n_segments_executed")


def device_tensors(obj, prefix=""):
    """Every tensor reachable from a device container, by path."""
    import torch

    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(device_tensors(getattr(obj, f.name), f"{prefix}.{f.name}"))
        return out
    if isinstance(obj, (tuple, list)):
        out = {}
        for i, v in enumerate(obj):
            out.update(device_tensors(v, f"{prefix}[{i}]"))
        return out
    return {}


def same_upload(name, got, want) -> int:
    """Every uploaded tensor of ``got`` equals ``want``'s, compared on the
    card; returns the bytes compared."""
    import torch

    a, b = device_tensors(got), device_tensors(want)
    if a.keys() != b.keys():
        raise AssertionError(f"{name}: the uploads hold different operands")
    for k in b:
        if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k]):
            raise AssertionError(f"{name}: operand {k} differs from the one-shot upload")
    return sum(t.numel() * t.element_size() for t in b.values())


def sharded_extraction(args, catalog, g, extract_s) -> dict:
    """C.1: ``extract_sharded`` in ``SCALE_SHARDS`` shards, spilled and
    tree-merged two at a time, unbounded and then under budgets set to the
    peaks it observed, each graph identical to the one-shot build; one row
    below the peak must raise ``ExtractionBudgetError``."""
    import shutil

    from repro_torch.core import (ExtractionBudgetError, ShardSpillStore, extract_sharded,
                                  graphs_identical)

    shutil.rmtree(SPILL_ROOT, ignore_errors=True)
    rec = {"one_shot_extract_s": extract_s}

    def run(name, **kw):
        spill = os.path.join(SPILL_ROOT, name)
        t = time.perf_counter()
        res = extract_sharded(catalog, QUERY, n_shards=SCALE_SHARDS, spill_dir=spill,
                              merge_arity=2, **kw)
        seconds = time.perf_counter() - t
        if not graphs_identical(g, res.graph):
            raise AssertionError(f"sharded extraction ({name}) != the one-shot graph")
        report = ShardSpillStore.open(spill).validate()
        b = res.budget
        rec[name] = {"seconds": seconds, **{f: getattr(b, f) for f in BUDGET_FIELDS},
                     "validated_records": len(report.get("records", report))}
        log(f"sharded extraction ({name}): {json.dumps(rec[name])}")
        return b

    b = run("unbounded")
    run("at_peak", max_resident_rows=b.peak_resident_rows,
        max_assembly_bytes=b.peak_assembly_bytes)
    try:
        extract_sharded(catalog, QUERY, n_shards=SCALE_SHARDS,
                        spill_dir=os.path.join(SPILL_ROOT, "below"), merge_arity=2,
                        max_resident_rows=b.peak_resident_rows - 1)
    except ExtractionBudgetError as e:
        rec["below_peak_error"] = str(e)
    else:
        raise AssertionError("a budget one row below the observed peak did not raise")
    shutil.rmtree(SPILL_ROOT, ignore_errors=True)
    return rec


def sharded_upload(args, catalog, g, exact, counts, served) -> dict:
    """C.2: ``sharded_extract_to_device(packed=True, pack_shard_edges=)``
    uploads phase 3's exact graph byte for byte; the served batch from it
    (beside a counts graph uploaded from the sharded build, also held to
    phase 3's) gives phase 3's answers bit for bit with phase 3's
    launches.  The copies are freed before the next phase."""
    import numpy as np
    import torch

    from repro_torch.core import engine
    from repro_torch.data.pipeline import sharded_extract_to_device
    from repro_torch.kernels import bitmap_spmm as K
    from repro_torch.serve.server import GraphQueryServer

    nodes, reach_nodes, got, reach, launches = served
    shard_edges = max(max(e.n_edges for e in g.chains[0].edges) // SCALE_SHARDS, 1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    res, dev = sharded_extract_to_device(
        catalog, QUERY, n_shards=SCALE_SHARDS, packed=True, pack_shard_edges=shard_edges,
        spill_dir=os.path.join(SPILL_ROOT, "upload"), device="cuda")
    torch.cuda.synchronize()
    rec = {"pack_shard_edges": shard_edges, "pipeline_s": time.perf_counter() - t}
    t = time.perf_counter()
    dev_counts = engine.to_device_packed(res.graph, drop_self_loops=False, device="cuda")
    torch.cuda.synchronize()
    rec["counts_upload_s"] = time.perf_counter() - t
    rec["bytes_compared"] = (same_upload("exact", dev, exact)
                             + same_upload("counts", dev_counts, counts))
    server = GraphQueryServer(dev, counts_graph=dev_counts)
    K.reset_launch_counts()
    engine.reset_kernel_dispatch_count()
    t = time.perf_counter()
    queries, got2, reach2, _ = serve_queries(server, nodes, reach_nodes)
    torch.cuda.synchronize()
    rec["serve_s"] = time.perf_counter() - t
    rec["launches"] = dict(K.LAUNCHES)
    if rec["launches"] != launches:
        raise AssertionError(f"served from the sharded build: launches {rec['launches']}, "
                             f"phase 3 made {launches}")
    for q in queries:
        if not np.array_equal(got2[q.qid], got[q.qid]):
            raise AssertionError(f"{q.kind} query {q.qid}: the sharded build's answer "
                                 "differs from phase 3's")
    if not np.array_equal(reach2, reach):
        raise AssertionError("reachable_multi: the sharded build's answer differs")
    log(f"sharded upload: {json.dumps(rec)}")
    del server, dev, dev_counts
    torch.cuda.empty_cache()
    return rec


def direction_views(graph):
    """(name, ops.PackedLayer) of every packed direction of a packed graph,
    each a forward layer of its own (``measure_crossover`` measures that)."""
    from repro_torch.kernels.ops import PackedLayer

    layers = [(f"chain{c}.layer{i}", layer) for c, chain in enumerate(graph.chains)
              for i, layer in enumerate(chain)]
    if graph.direct is not None:
        layers.append(("direct", graph.direct))
    for name, layer in layers:
        yield f"{name}.fwd", PackedLayer(None, None, layer.fwd, None, layer.src, layer.dst,
                                         layer.n_src, layer.n_dst, plans=layer.plans)
        yield f"{name}.rev", PackedLayer(None, None, layer.rev, None, layer.dst, layer.src,
                                         layer.n_dst, layer.n_src)


def table_cells(table):
    return [{"op": op, "src_bucket": sb, "batch_bucket": bb, "cuda_us": e.cuda_us,
             "segment_us": e.segment_us, "range_items": e.range_items, "backend": e.backend}
            for (op, sb, bb), e in table.entries]


def round_trip(name, table) -> None:
    from repro_torch.core import serialize

    path = os.path.join(ROOT, "build", "crossover", f"{name}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    back = serialize.load_crossover_table(serialize.save_crossover_table(table, path))
    if back != table or back.to_json() != table.to_json():
        raise AssertionError(f"{name}: the crossover table changed in its JSON round trip")


def candidate_checks(exact, rng) -> dict:
    """Every ``range_items`` candidate of K1 at the served operands (the
    author -> publication layer, F = 32): equal to the plain version over
    the bitmaps on an integer frontier, to the plain mirror of its own
    ranges on a float frontier, and twice the same bits.  Comparison
    launches, not the path's."""
    import numpy as np
    import torch

    from repro_torch.kernels import autotune
    from repro_torch.kernels import bitmap_spmm as K

    layer = exact.chains[0][0]
    ops, n_out = layer.fwd, layer.n_dst
    x = torch.from_numpy(rng.integers(0, 7, (layer.n_src, 32)).astype(np.float32)).cuda()
    floats = torch.from_numpy(rng.random((layer.n_src, 32)).astype(np.float32)).cuda()
    plain = K.bitmap_spmm_plain(ops.slot_src, ops.slot_row, ops.row_start, ops.row_count,
                                ops.bitmaps, x, n_out)
    before = dict(K.LAUNCHES)
    out = {}
    for cfg in autotune.CANDIDATES:
        items = cfg.range_items
        if not torch.equal(K.bitmap_spmm(ops.row_ptr, ops.col, x, n_out, range_items=items),
                           plain):
            raise AssertionError(f"K1 at range_items={items} != its plain version")
        a = K.bitmap_spmm(ops.row_ptr, ops.col, floats, n_out, range_items=items)
        if not torch.equal(a, K.bitmap_spmm(ops.row_ptr, ops.col, floats, n_out,
                                            range_items=items)):
            raise AssertionError(f"K1 at range_items={items}: two launches differ")
        mirror = K.bitmap_spmm_index_plain(ops.row_ptr, ops.col, floats, n_out,
                                           range_items=items)
        out[items] = float((a - mirror).abs().max().item())
        if out[items] != 0.0:
            raise AssertionError(f"K1 at range_items={items} != the plain mirror's bits")
    K.LAUNCHES.update(before)
    return {"vs_mirror_max_abs_err": out}


class Followed:
    """Counts the dispatch decisions of ``'auto'`` steps over measured
    operands: each must be the table's own (``decide`` on the cell), and
    the kernels must launch exactly once per ``'cuda'`` decision."""

    def __init__(self):
        self.decisions = []

    def __enter__(self):
        import unittest.mock

        from repro_torch.core import engine
        from repro_torch.core.semiring import kernelizable

        orig = engine._kernel_applicable

        def wrapped(graph, layer, x, semiring, reverse):
            ok = orig(graph, layer, x, semiring, reverse)
            ops = layer.rev if reverse else layer.fwd
            if (graph.backend == "auto" and x.ndim == 2 and kernelizable(semiring)
                    and ops is not None and not (layer.repeats and not semiring.idempotent)):
                if ops.crossover is None:
                    raise AssertionError("an 'auto' step consulted unmeasured operands")
                want = ops.crossover.decide(semiring.add_kind,
                                            layer.n_dst if reverse else layer.n_src,
                                            x.shape[1])
                if (want == "cuda") != ok:
                    raise AssertionError(f"dispatch {ok} against the table's {want!r}")
                self.decisions.append(want)
            return ok

        self._patch = unittest.mock.patch.object(engine, "_kernel_applicable", wrapped)
        self._patch.__enter__()
        return self

    def __exit__(self, *exc):
        return self._patch.__exit__(*exc)


def measured_run(name, fn, seg_fn, exact) -> dict:
    """One analytic over measured operands: its time, its launches, which
    must follow the table, and its answer against the segment path's."""
    import numpy as np
    import torch

    from repro_torch.kernels import bitmap_spmm as K

    K.reset_launch_counts()
    with Followed() as f:
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launches = dict(K.LAUNCHES)
    n_cuda = f.decisions.count("cuda")
    if sum(launches.values()) != n_cuda:
        raise AssertionError(f"{name}: {launches} launches for {n_cuda} 'cuda' decisions")
    before = dict(K.LAUNCHES)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = seg_fn()
    torch.cuda.synchronize()
    seg_wall = time.perf_counter() - t
    if K.LAUNCHES != before:
        raise AssertionError(f"{name}: the segment backend launched a kernel")
    outs, wants = (out, want) if isinstance(out, tuple) else ((out,), (want,))
    for a, b in zip(outs, wants):
        if isinstance(a, torch.Tensor):
            ok = torch.allclose(a, b, **FLOAT_TOL) if exact is False else torch.equal(a, b)
        else:
            ok = np.array_equal(a, b)
        if not ok:
            raise AssertionError(f"{name} (measured): != the segment path")
    rec = {"wall_s": wall, "segment_wall_s": seg_wall, "launches": launches,
           "decisions": {"cuda": n_cuda, "segment": f.decisions.count("segment")}}
    log(f"measured {name}: {json.dumps(rec)}")
    return rec


def crossover_phase(args, exact, ctx, record) -> dict:
    """C.3: the measured crossover on every packed direction of the served
    exact graph, of layered_1 and of the DEDUP-1 graph; each table through
    its JSON round trip; layered_1 and DEDUP-1 rebuilt with
    ``to_device_packed(measure=True)`` and their analytics rerun, launches
    following the tables, answers equal to the segment path's.
    C.4: ``collapse_to_single_layer`` on layered_1 (SCC labels and expanded
    edge count kept) and on TPC-H's symmetric three-layer query, whose
    collapse DEDUP-1 rewrites (PPR on K1 only equal to DEDUP-C's, BFS
    exact)."""
    import numpy as np
    import torch

    from repro_torch.core import algorithms as A
    from repro_torch.core import condensed, dedup, engine, extract
    from repro_torch.data.synth import tpch_catalog
    from repro_torch.kernels import autotune
    from repro_torch.kernels import bitmap_spmm as K

    rng = np.random.default_rng(args.seed + 2)
    t_phase = time.perf_counter()
    rec = {"candidates": candidate_checks(exact, rng)}
    mk = dict(ops=CROSSOVER_OPS, batch_sizes=CROSSOVER_BATCHES)
    before = dict(K.LAUNCHES)

    # -- the served exact graph: measure_crossover on every direction ------
    t = time.perf_counter()
    tables = {}
    for name, view in direction_views(exact):
        tables[f"exact.{name}"] = autotune.measure_crossover(view, **mk)
    rec["exact_measure_s"] = time.perf_counter() - t

    # -- layered_1 and DEDUP-1, packed with measure=True -------------------
    t = time.perf_counter()
    lay_host = ctx["layered_host"]
    lay = engine.to_device_packed(lay_host, backend="auto", measure=True, measure_kwargs=mk,
                                  device="cuda")
    torch.cuda.synchronize()
    rec["layered_measured_upload_s"] = time.perf_counter() - t
    t = time.perf_counter()
    dev1 = engine.to_device_packed(ctx["dedup1_host"], deduplicated=True, backend="auto",
                                   measure=True, measure_kwargs=mk, device="cuda")
    torch.cuda.synchronize()
    rec["dedup1_measured_upload_s"] = time.perf_counter() - t
    for gname, graph in (("layered", lay), ("dedup1", dev1)):
        for name, view in direction_views(graph):
            tables[f"{gname}.{name}"] = view.fwd.crossover
    K.LAUNCHES.update(before)  # measurement launches are not the path's
    for name, table in tables.items():
        round_trip(name, table)
    rec["tables"] = {name: table_cells(table) for name, table in tables.items()}
    for name, table in tables.items():  # op, B: winner @ range_items, cuda / segment us
        log(f"crossover {name} (n_src 2^{table.entries[0][0][1]}): " + " ".join(
            f"{op}{1 << bb}:{e.backend[:3]}@{e.range_items}={e.cuda_us:.0f}/{e.segment_us:.0f}"
            for (op, sb, bb), e in table.entries))
    # the B = 128 cells: the width of the triangle and clustering blocks
    # and of scc_labels' pivot batches, the kernels' wide route
    b128 = autotune.batch_bucket(128)
    rec["b128_decisions"] = {
        name: {op: {"backend": e.backend, "range_items": e.range_items,
                    "cuda_us": e.cuda_us, "segment_us": e.segment_us}
               for (op, sb, bb), e in table.entries if bb == b128}
        for name, table in tables.items()}
    log("crossover B = 128 decisions: " + json.dumps(
        {name: {op: f"{d['backend']}@{d['range_items']}" for op, d in cells.items()}
         for name, cells in rec["b128_decisions"].items()}))

    # -- analytics over the measured graphs --------------------------------
    runs = {}
    seeds, sources = ctx["dedup1_seeds"], ctx["dedup1_sources"]
    seg1 = dataclasses.replace(dev1, backend="segment")
    runs["ppr_dedup1"] = measured_run(
        "ppr_dedup1", lambda: A.personalized_pagerank(dev1, seeds),
        lambda: A.personalized_pagerank(seg1, seeds), exact=False)
    runs["bfs_dedup1"] = measured_run(
        "bfs_dedup1", lambda: A.bfs_multi(dev1, sources),
        lambda: A.bfs_multi(seg1, sources), exact=True)
    seg_lay = dataclasses.replace(lay, backend="segment")
    labels = ctx["layered_labels"]
    runs["condensation"] = measured_run(
        "condensation", lambda: A.condensation(lay, labels=labels),
        lambda: A.condensation(seg_lay, labels=labels), exact=True)
    lw, lsources = ctx["layered_weights"], ctx["layered_sources"]
    for reverse in (False, True):
        name = "shortest_paths_multi_layered" + ("_reverse" if reverse else "")
        runs[name] = measured_run(
            name, lambda: A.shortest_paths_multi(lay, lsources, layer_weights=lw,
                                                 reverse=reverse),
            lambda: A.shortest_paths_multi(seg_lay, lsources, layer_weights=lw,
                                           reverse=reverse), exact=True)
    rec["runs"] = runs
    del lay, dev1, seg1, seg_lay

    # -- collapse ------------------------------------------------------------
    t = time.perf_counter()
    flat = condensed.collapse_to_single_layer(lay_host, max_growth=10.0)
    col = {"collapse_s": time.perf_counter() - t, "max_growth": 10.0,
           "edges_condensed": lay_host.n_edges_condensed,
           "edges_collapsed": flat.n_edges_condensed}
    t = time.perf_counter()
    col["edges_expanded"] = lay_host.n_edges_expanded()
    if flat.n_edges_expanded() != col["edges_expanded"]:
        raise AssertionError("collapse changed the expanded edge count")
    col["expanded_count_s"] = time.perf_counter() - t
    flat_dev = engine.to_device_packed(flat, backend="auto", device="cuda")
    K.reset_launch_counts()
    t = time.perf_counter()
    flat_labels = A.scc_labels(flat_dev, batch=128)
    torch.cuda.synchronize()
    col["scc_s"] = time.perf_counter() - t
    col["scc_launches"] = dict(K.LAUNCHES)
    if not np.array_equal(flat_labels, labels):
        raise AssertionError("SCC labels of the collapsed layered_1 != the uncollapsed ones")
    col["sccs"] = int(np.unique(labels).size)
    del flat_dev

    nc, no, npt = TPCH_GRAPH[args.quick]
    tg = extract(tpch_catalog(n_customers=nc, n_orders=no, n_parts=npt, seed=args.seed),
                 TPCH_QUERY, mode="condensed").graph
    t = time.perf_counter()
    tflat = condensed.collapse_to_single_layer(tg, max_growth=10.0)
    d1 = dedup.dedup1_greedy_virtual_first(tflat)
    col["tpch"] = {"customers": nc, "orders": no, "parts": npt,
                   "layers": tg.chains[0].n_layers, "edges_condensed": tg.n_edges_condensed,
                   "edges_collapsed": tflat.n_edges_condensed,
                   "dedup1_total_edges": d1.total_edges,
                   "collapse_dedup1_host_s": time.perf_counter() - t}
    tdev1 = engine.to_device_packed(d1.graph, deduplicated=True, backend="auto", device="cuda")
    tdevc = engine.to_device_packed(tg, correction=dedup.build_correction(tg), backend="auto",
                                    device="cuda")
    tsrc = rng.integers(0, tg.n_real, ANALYTIC_BATCH)
    tseeds = A.one_hot_frontier(tg.n_real, tsrc, device="cuda")
    K.reset_launch_counts()
    p1 = A.personalized_pagerank(tdev1, tseeds)
    col["tpch"]["ppr_launches"] = dict(K.LAUNCHES)
    if K.LAUNCHES["bitmap_spmm_sum"] == 0 or K.LAUNCHES["bitmap_spmm_fused"]:
        raise AssertionError("PPR on the collapsed DEDUP-1 graph must run K1 and never K3")
    pc = A.personalized_pagerank(tdevc, tseeds)
    if not torch.allclose(p1, pc, **FLOAT_TOL) or not bool(torch.isfinite(p1).all()):
        raise AssertionError("PPR on the collapsed DEDUP-1 graph != PPR on DEDUP-C")
    if not torch.equal(A.bfs_multi(tdev1, tsrc), A.bfs_multi(tdevc, tsrc)):
        raise AssertionError("BFS on the collapsed DEDUP-1 graph != BFS on DEDUP-C")
    col["tpch"]["ppr_max_abs_diff_vs_dedupc"] = float((p1 - pc).abs().max().item())
    rec["collapse"] = col
    ctx["tpch_collapse"] = tflat
    ctx["crossover_table"] = tables["exact.chain0.layer0.fwd"]
    log(f"collapse: {json.dumps(col)}")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"crossover and collapse: {rec['phase_s']:.1f} s")
    record["crossover"] = rec
    return rec


# ---------------------------------------------------------------------------
# Phase 6: live graph under writes, the serving tier, the planner and advisor
# ---------------------------------------------------------------------------

WAL_DIR = os.path.join(ROOT, "build", "wal")
PLAN_PATH = os.path.join(ROOT, "build", "plan", "plan.json")
LIVE_DELTAS = 4
DELTA_SHARE = 0.005           # of AuthorPub's rows, inserted and deleted per delta
TOMBSTONE_AUTHORS = 50        # Author rows the third delta deletes
AUTHORS_PER_NEW_PUB = 6
TIER_REQUESTS = {False: 192, True: 96}
# requests that repeat an earlier (tenant, kind, node), so that the result
# cache is exercised: a property of this check, not a model of users' traffic
TIER_REPEAT_SHARE = 0.2
# the second half of the stream is offered one request per this many of the
# first half's measured mean batch times: a lone request's batch costs
# about a mean batch, so the tier is busy about half the time and its queue
# stays bounded
TIER_SPACING_BATCHES = 2
# request kinds per tenant: triangles need a symmetric simple graph (not
# layered_1) and stay off the DBLP tenant, whose per-node counts the
# analytics phase already holds to the segment path (one sweep is 1.1 s there,
# 6.2 s on the segment path)
TIER_KINDS = {
    "dblp": ("bfs", "ppr", "common_neighbors", "shortest", "widest", "scc"),
    "layered": ("bfs", "ppr", "common_neighbors", "shortest", "widest", "scc"),
    "dedup1": ("bfs", "ppr", "common_neighbors", "shortest", "widest", "scc", "triangles"),
    "tpch": ("bfs", "ppr", "common_neighbors", "shortest", "widest", "scc", "triangles"),
}
TIER_WEIGHTS = {"dblp": 0.5, "layered": 1 / 6, "dedup1": 1 / 6, "tpch": 1 / 6}


def delta_batch(rng, catalog, index: int, tombstone: bool, share: float = DELTA_SHARE):
    """One write batch on the DBLP catalog: new publications whose author
    rows make ``share`` of AuthorPub (distinct authors each, fresh pids),
    the deletion of whole existing publications making about the same
    share, and with ``tombstone`` the deletion of ``TOMBSTONE_AUTHORS``
    Author rows."""
    import numpy as np

    ap = catalog.table("AuthorPub")
    aids = catalog.table("Author").column("aid")
    n_rows = max(int(len(ap) * share), AUTHORS_PER_NEW_PUB)
    n_pubs = n_rows // AUTHORS_PER_NEW_PUB
    new_aid = np.concatenate([rng.choice(aids, AUTHORS_PER_NEW_PUB, replace=False)
                              for _ in range(n_pubs)]).astype(ap.column("aid").dtype)
    new_pid = np.repeat(3_000_000 + index * 1_000_000 + np.arange(n_pubs),
                        AUTHORS_PER_NEW_PUB).astype(ap.column("pid").dtype)
    pids = np.unique(ap.column("pid"))
    dels = {"AuthorPub": ("pid", rng.choice(pids, n_pubs, replace=False))}
    if tombstone:
        dels["Author"] = ("aid", rng.choice(aids, TOMBSTONE_AUTHORS, replace=False))
    return {"AuthorPub": {"aid": new_aid, "pid": new_pid}}, dels


def live_graph_part(catalog, g, rng) -> tuple:
    """``LiveGraph`` on phase 3's catalog with a write-ahead ``DeltaLog``:
    every delta's graph identical to a fresh ``extract`` of the mutated
    catalog, and ``LiveGraph.replay`` from the log landing on the same graph
    and version."""
    import shutil

    from repro_torch.core import (DeltaLog, LiveGraph, extract, graphs_identical,
                                  mutate_catalog)

    shutil.rmtree(WAL_DIR, ignore_errors=True)
    t = time.perf_counter()
    live = LiveGraph(catalog, QUERY, log=DeltaLog(WAL_DIR))
    rec = {"base_build_s": time.perf_counter() - t, "deltas": []}
    if not graphs_identical(live.graph, g):
        raise AssertionError("the live graph's base build != phase 3's graph")
    mutated = catalog
    for i in range(LIVE_DELTAS):
        ins, dels = delta_batch(rng, mutated, i, tombstone=(i == 2))
        t = time.perf_counter()
        graph, version = live.apply_delta(inserts=ins, deletes=dels)
        apply_s = time.perf_counter() - t
        mutated = mutate_catalog(mutated, inserts=ins, deletes=dels)
        t = time.perf_counter()
        fresh = extract(mutated, QUERY).graph
        fresh_s = time.perf_counter() - t
        if not graphs_identical(graph, fresh) or int(version) != i + 1:
            raise AssertionError(f"delta {i}: the live graph != a fresh extract")
        d = {"version": int(version), "apply_s": apply_s, "fresh_extract_s": fresh_s,
             "inserted_rows": int(ins["AuthorPub"]["aid"].size),
             "deleted_pubs": int(dels["AuthorPub"][1].size),
             "deleted_authors": int(dels["Author"][1].size) if "Author" in dels else 0,
             "n_real": graph.n_real, "edges_condensed": graph.n_edges_condensed}
        rec["deltas"].append(d)
        log(f"delta {i}: {json.dumps(d)}")
    t = time.perf_counter()
    replayed = LiveGraph.replay(catalog, QUERY, DeltaLog.open(WAL_DIR))
    rec["replay_s"] = time.perf_counter() - t
    if replayed.version != live.version or not graphs_identical(replayed.graph, live.graph):
        raise AssertionError("LiveGraph.replay from the log != the live graph")
    return live, rec


def tier_reference(tenant, kind, nodes, exact, counts):
    """The answers of ``kind`` for ``nodes`` on the segment path: the
    tenant's own uploads with ``backend='segment'``, one batched call."""
    import numpy as np

    from repro_torch.core import algorithms as A

    exact = dataclasses.replace(exact, backend="segment")
    if kind == "bfs":
        out = A.bfs_multi(exact, nodes)
    elif kind == "ppr":
        out = A.personalized_pagerank(exact, A.one_hot_frontier(exact.n_real, nodes,
                                                                device="cuda"))
    elif kind == "common_neighbors":
        out = A.common_neighbors_multi(dataclasses.replace(counts, backend="segment"), nodes)
    elif kind == "shortest":
        out = A.shortest_paths_multi(exact, nodes, layer_weights=tenant.layer_weights)
    elif kind == "widest":
        out = A.widest_paths_multi(exact, nodes, layer_capacities=tenant.layer_capacities)
    elif kind == "scc":
        labels = A.scc_labels(exact)
        return (labels[:, None] == labels[np.asarray(nodes)][None, :]).astype(np.float32)
    else:
        t = A.triangle_counts(exact).astype(np.float32)
        return np.tile(t[:, None], (1, len(nodes)))
    return out.cpu().numpy()


def check_answers(results, refs) -> int:
    """Every result equals its reference column (PPR to ``FLOAT_TOL``)."""
    import numpy as np

    n = 0
    for r in results:
        want = refs[(r.tenant, r.graph_version, r.kind)][r.node]
        if r.value.dtype != want.dtype or r.value.shape != want.shape:
            raise AssertionError(f"qid {r.qid}: answer of shape {r.value.shape} "
                                 f"{r.value.dtype}, expected {want.shape} {want.dtype}")
        if r.kind == "ppr":
            ok = np.allclose(r.value, want, **FLOAT_TOL) and np.isfinite(r.value).all()
        else:
            ok = np.array_equal(r.value, want)
        if not ok:
            raise AssertionError(f"qid {r.qid} ({r.tenant} {r.kind} {r.node} "
                                 f"v{r.graph_version}) != the segment path")
        n += 1
    return n


def add_refs(refs, tier, name, version, requests, exact, counts) -> None:
    by_kind = {}
    for q in requests:
        if q.tenant == name:
            by_kind.setdefault(q.kind, set()).add(q.node)
    for kind, nodes in by_kind.items():
        nodes = sorted(nodes)
        cols = tier_reference(tier.tenants[name], kind, nodes, exact, counts)
        refs[(name, version, kind)] = {node: cols[:, i] for i, node in enumerate(nodes)}


def tier_stream(rng, tier, n: int, qid0: int, t0: float, spacing_s: float):
    from repro_torch.serve import ServeRequest

    names = list(TIER_WEIGHTS)
    p = [TIER_WEIGHTS[k] for k in names]
    reqs, seen = [], []
    for i in range(n):
        if seen and rng.random() < TIER_REPEAT_SHARE:
            name, kind, node = seen[int(rng.integers(len(seen)))]
        else:
            name = names[int(rng.choice(len(names), p=p))]
            kinds = TIER_KINDS[name]
            kind = kinds[int(rng.integers(len(kinds)))]
            node = int(rng.integers(tier.tenants[name].n_nodes))
            seen.append((name, kind, node))
        reqs.append(ServeRequest(qid0 + i, name, kind, node,
                                 arrival_time=t0 + i * spacing_s))
    return reqs


def tier_part(args, live, ctx, rng) -> dict:
    """One ``GraphServingTier`` on the card serves four tenants (the live
    DBLP graph, packed and pinned, through its version listener; layered_1
    with per-layer costs and capacities; the DEDUP-1 graph; the TPC-H
    collapse) under a ``ResidencyBudget`` that holds the DBLP tenant plus
    the next largest.  A stream of every request kind, half of it to the
    DBLP tenant, runs through ``run_load`` in two halves with a fifth delta
    between them, applied while four DBLP requests are in flight (the
    quiesce handoff answers them at the old version).  The first half
    arrives at once and measures the tier's service rate under a backlog;
    the second is offered at a spacing derived from that rate, and its
    latencies are the ones of a tier whose queue stays bounded."""
    import numpy as np
    import torch

    from repro_torch.core import engine
    from repro_torch.core.engine import ResidencyBudget
    from repro_torch.kernels import bitmap_spmm as K
    from repro_torch.serve import GraphQuery, GraphQueryServer, GraphServingTier, ServeRequest
    from repro_torch.serve.server import ServerStats
    from repro_torch.serve.tier import ResultCacheStats

    rec = {}
    lay_host = ctx["layered_host"]
    sizes = [e.n_dst for e in lay_host.chains[0].edges[:-1]]
    costs = [rng.integers(1, 9, s).astype(np.float32) for s in sizes]
    caps = [rng.integers(1, 9, s).astype(np.float32) for s in sizes]
    tier = GraphServingTier(max_batch=32, device="cuda", budget=ResidencyBudget())
    t = time.perf_counter()
    tier.add_tenant("dblp", live, packed=True, pin=True)
    rec["dblp_correction_s"] = time.perf_counter() - t
    t = time.perf_counter()
    tier.add_tenant("layered", lay_host, packed=True, layer_weights=[costs],
                    layer_capacities=[caps])
    tier.add_tenant("dedup1", ctx["dedup1_host"], packed=True)
    tier.add_tenant("tpch", ctx["tpch_collapse"], packed=True)
    rec["small_corrections_s"] = time.perf_counter() - t

    # sizing: every tenant uploaded once, then the budget set to hold the
    # DBLP tenant plus the next largest and the small tenants evicted
    t = time.perf_counter()
    for i, name in enumerate(TIER_WEIGHTS):
        tier.serve([ServeRequest(-1 - i, name, "bfs", 0)])
    torch.cuda.synchronize()
    rec["sizing_uploads_s"] = time.perf_counter() - t
    sizes = {n: tier.tenants[n].resident_bytes for n in TIER_WEIGHTS}
    first = {n: (tier.tenants[n].device, tier.tenants[n].counts_device)
             for n in TIER_WEIGHTS if n != "dblp"}
    others = [v for k, v in sizes.items() if k != "dblp"]

    def holds_dblp_and_next(dblp_bytes: int) -> int:
        # the DBLP tenant plus the largest other, with one byte less than
        # the smallest other to spare: no room for a third tenant, so a
        # switch to a tenant that is not resident evicts
        return dblp_bytes + max(others) + min(others) - 1

    tier.budget.max_device_bytes = holds_dblp_and_next(sizes["dblp"])
    for n in first:
        tier.evict_tenant(n)
    tier.budget.peak_resident_bytes = tier.budget.resident_bytes
    tier.invalidate_results()
    tier.result_stats, tier.stats = ResultCacheStats(), ServerStats()
    rec["tenant_bytes"] = sizes
    rec["max_device_bytes"] = tier.budget.max_device_bytes
    log(f"tier tenants (bytes): {json.dumps(sizes)}; budget {tier.budget.max_device_bytes}")

    # -- the stream: launches zeroed just before, read just after ---------
    n_req = TIER_REQUESTS[args.quick]
    t0 = tier.now
    part1 = tier_stream(rng, tier, n_req // 2, 0, t0, 0.0)
    inflight = [ServeRequest(10_000 + i, "dblp", "bfs", int(rng.integers(live.graph.n_real)))
                for i in range(4)]
    counts_before = (tier.budget.n_uploads, tier.budget.n_evictions)
    K.reset_launch_counts()
    engine.reset_kernel_dispatch_count()
    t = time.perf_counter()
    res1 = tier.run_load(part1)
    torch.cuda.synchronize()
    rec["part1_s"] = time.perf_counter() - t
    busy = tier.now - t0           # the virtual clock advanced only by batches
    lat1 = np.array([r.latency for r in res1 if not r.cached])
    rec["saturated"] = {
        "requests": len(part1), "batches": tier.stats.n_batches, "busy_s": busy,
        "requests_per_s": len(part1) / busy, "batches_per_s": tier.stats.n_batches / busy,
        "mean_batch_s": busy / tier.stats.n_batches,
        "latency_p50_s": float(np.percentile(lat1, 50)),
        "latency_p99_s": float(np.percentile(lat1, 99))}
    for q in inflight:
        q.arrival_time = tier.now
        if tier.submit(q) is not None:
            raise AssertionError("an in-flight request was answered from the cache")
    launches_1 = dict(K.LAUNCHES)
    standdowns_1 = dict(engine.KERNEL_STANDDOWN_COUNT)
    # references for the DBLP tenant at version 4 while it is resident
    # (segment path: no launches), before the delta replaces its upload
    refs = {}
    d = tier.tenants["dblp"]
    v_old = d.version
    add_refs(refs, tier, "dblp", v_old, part1 + inflight, d.device, d.counts_device)
    if dict(K.LAUNCHES) != launches_1:
        raise AssertionError("the segment path launched a kernel")
    standdowns_refs = {k: v - standdowns_1.get(k, 0)
                       for k, v in engine.KERNEL_STANDDOWN_COUNT.items()}
    ins, dels = delta_batch(rng, live.catalog, LIVE_DELTAS, tombstone=False)
    t_delta = time.perf_counter()
    live.apply_delta(inserts=ins, deletes=dels)
    rec["delta5_refresh_s"] = time.perf_counter() - t_delta
    handoff = tier.take_handoff()
    # the new version's first request re-uploads the DBLP tenant, whose
    # bytes moved with the delta (by 12.5 MB at full size, more than the
    # smallest tenant): the budget follows it, still DBLP + the next largest
    bump = ServeRequest(20_000, "dblp", "bfs", int(rng.integers(live.graph.n_real)),
                        arrival_time=tier.now)
    t2 = time.perf_counter()
    tier.submit(bump)
    res_bump = tier.drain()
    rec["version_bump_latency_s"] = res_bump[0].latency   # the DBLP re-upload
    rec["dblp_bytes_new"] = tier.tenants["dblp"].resident_bytes
    tier.budget.max_device_bytes = holds_dblp_and_next(rec["dblp_bytes_new"])
    rec["max_device_bytes_new"] = tier.budget.max_device_bytes
    spacing = TIER_SPACING_BATCHES * rec["saturated"]["mean_batch_s"]
    t3, w = tier.now, time.perf_counter()
    part2 = tier_stream(rng, tier, n_req - n_req // 2, 1_000, t3, spacing)
    res2_load = tier.run_load(part2)
    torch.cuda.synchronize()
    rec["part2_s"] = time.perf_counter() - t2     # the DBLP re-upload included
    rec["stream_s"] = rec["part1_s"] + rec["delta5_refresh_s"] + rec["part2_s"]
    lat2 = np.array([r.latency for r in res2_load if not r.cached])
    span = tier.now - t3
    wall = time.perf_counter() - w
    rec["offered"] = {
        "requests": len(part2), "spacing_s": spacing, "span_s": span, "wall_s": wall,
        "wall_share_of_span": wall / span,
        "latency_p50_s": float(np.percentile(lat2, 50)),
        "latency_p99_s": float(np.percentile(lat2, 99))}
    res2 = res_bump + res2_load
    launches = dict(K.LAUNCHES)
    # the tier's stand-downs: the segment-path references' taken out
    standdowns = {k: v - standdowns_refs.get(k, 0)
                  for k, v in engine.KERNEL_STANDDOWN_COUNT.items()
                  if v - standdowns_refs.get(k, 0)}
    log(f"tier stream: {len(res1) + len(res2)} answers + {len(handoff)} handed off in "
        f"{rec['stream_s']:.2f} s; launches {json.dumps(launches)}; stand-downs "
        f"{json.dumps(standdowns)}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the tier: {missing}")
    if standdowns.get("vmem_or_backend"):
        raise AssertionError("the fused kernel stood down for 'vmem_or_backend' in the tier")
    if sorted(r.qid for r in handoff) != [q.qid for q in inflight] or any(
            r.graph_version != v_old for r in handoff):
        raise AssertionError("the in-flight requests were not answered at the old version")
    v_new = tier.tenants["dblp"].version
    if v_new != live.version or any(r.graph_version != v_new for r in res2
                                    if r.tenant == "dblp"):
        raise AssertionError("answers after the delta do not carry the new version")
    if len(res1) != len(part1) or len(res2) != len(part2) + 1:
        raise AssertionError("the tier did not answer every request")

    # -- answers: the segment path on the card, and a fresh server --------
    t = time.perf_counter()
    d = tier.tenants["dblp"]
    add_refs(refs, tier, "dblp", v_new, part2 + [bump], d.device, d.counts_device)
    for name, (exact, counts) in first.items():
        add_refs(refs, tier, name, 0, part1 + part2, exact, counts)
    n_checked = check_answers(res1 + handoff + res2, refs)
    fresh = GraphQueryServer.from_condensed(live.graph, packed=False, device="cuda",
                                            graph_version=v_new)
    fresh_q = [q for q in part2 + [bump] if q.tenant == "dblp"
               and q.kind in ("bfs", "ppr", "common_neighbors")]
    fresh_ans = fresh.run([GraphQuery(q.qid, q.kind, q.node) for q in fresh_q])
    by_qid = {r.qid: r for r in res2}
    for q in fresh_q:
        got, want = by_qid[q.qid].value, fresh_ans[q.qid]
        ok = (np.allclose(got, want, **FLOAT_TOL) if q.kind == "ppr"
              else np.array_equal(got, want))
        if not ok:
            raise AssertionError(f"qid {q.qid}: != a fresh GraphQueryServer on the new graph")
    del fresh
    rec["check_s"] = time.perf_counter() - t

    # -- re-uploads after eviction are byte-equal to the first uploads -----
    reupload = {}
    for i, name in enumerate(first):
        tier.result_cache_enabled = False
        tier.serve([ServeRequest(-100 - i, name, "bfs", 0)])
        tn = tier.tenants[name]
        reupload[name] = {"uploads": tn.n_uploads,
                          "bytes_compared": same_upload(f"tier {name}", (tn.device,
                                                        tn.counts_device), first[name])}
        if tn.n_uploads < 2:
            raise AssertionError(f"tenant {name} was never evicted and re-uploaded")
    tier.result_cache_enabled = True
    # drop the tier's listener, so the live graph no longer holds the tier
    # and its uploads are freed with it
    live.remove_version_listener(tier.tenants["dblp"]._listener)
    all_res = res1 + res2
    rec.update({
        "requests": len(part1) + len(part2) + len(inflight) + 1, "answers_checked": n_checked,
        "fresh_server_checked": len(fresh_q), "launches": launches,
        "standdowns": standdowns, "launches_part1": launches_1,
        "occupancy": tier.stats.occupancy, "batches": tier.stats.n_batches,
        "padding_waste": tier.stats.padding_waste,
        "result_cache": {"hits": tier.result_stats.hits, "misses": tier.result_stats.misses,
                         "invalidated": tier.result_stats.invalidated,
                         "hit_rate": tier.result_stats.hit_rate},
        "exec_cache": {"hits": tier.exec_stats.hits, "misses": tier.exec_stats.misses,
                       "evictions": tier.exec_stats.evictions,
                       "hit_rate": tier.exec_stats.hit_rate},
        "stream_uploads": tier.budget.n_uploads - counts_before[0],
        "stream_evictions": tier.budget.n_evictions - counts_before[1],
        "uploads": tier.budget.n_uploads, "evictions": tier.budget.n_evictions,
        "peak_resident_bytes": tier.budget.peak_resident_bytes,
        "resident_bytes": tier.budget.resident_bytes,
        "tenant_uploads": {n: t.n_uploads for n, t in tier.tenants.items()},
        "latency_p50_s": rec["offered"]["latency_p50_s"],
        "latency_p99_s": rec["offered"]["latency_p99_s"],
        "cached_answers": sum(r.cached for r in all_res),
        "reupload": reupload, "dblp_versions": [v_old, v_new],
    })
    if rec["stream_evictions"] == 0:
        raise AssertionError("the budget never evicted a tenant during the stream")
    if tier.budget.peak_resident_bytes > max(rec["max_device_bytes"],
                                             rec["max_device_bytes_new"]):
        raise AssertionError("the tier held more bytes than its budget")
    log(f"tier: {json.dumps({k: v for k, v in rec.items() if k not in ('reupload',)})}")
    return rec


def planner_part(catalog, g, exact, table) -> dict:
    """``plan`` on phase 3's catalog with this machine's measured pack
    rates and the measured crossover table, its report through
    ``save_plan_report`` / ``load_plan_report``; ``extract(plan=)``
    identical to phase 3's graph and ``sharded_extract_to_device(plan=)``
    uploading phase 3's operands byte for byte; ``recommend`` with the
    table and ``device_representation_costs``."""
    import shutil

    import torch

    from repro_torch.core import (Throughputs, extract, graphs_identical, plan,
                                  recommend)
    from repro_torch.core.cost import device_representation_costs
    from repro_torch.core.serialize import load_plan_report, save_plan_report
    from repro_torch.data.pipeline import sharded_extract_to_device
    from repro_torch.kernels.pack import measure_pack_throughput

    rec = {}
    t = time.perf_counter()
    rates = measure_pack_throughput(g.chains[0].edges[0])
    rec["pack_rates_edges_per_s"] = rates
    rec["pack_edges"] = g.chains[0].edges[0].n_edges
    rec["measure_pack_s"] = time.perf_counter() - t
    t = time.perf_counter()
    report = plan(catalog, QUERY, throughputs=Throughputs.with_measured_pack(rates),
                  crossover=table)
    rec["plan_s"] = time.perf_counter() - t
    os.makedirs(os.path.dirname(PLAN_PATH), exist_ok=True)
    back = load_plan_report(save_plan_report(report, PLAN_PATH))
    if back != report or back.to_json() != report.to_json():
        raise AssertionError("the plan report changed in its save / load round trip")
    shutil.rmtree(os.path.dirname(PLAN_PATH), ignore_errors=True)
    cfg = report.chosen.config
    rec.update(chosen=cfg.to_json_dict(), predicted_wall_s=report.chosen.cost.wall_s,
               n_enumerated=report.n_enumerated, n_feasible=len(report.ranked),
               n_pruned=len(report.pruned))
    log(report.render())
    t = time.perf_counter()
    res = extract(catalog, QUERY, plan=report.chosen)
    rec["planned_extract_s"] = time.perf_counter() - t
    if not graphs_identical(res.graph, g):
        raise AssertionError("extract(plan=) != phase 3's graph")
    t = time.perf_counter()
    res, dev = sharded_extract_to_device(catalog, QUERY, n_shards=1, packed=True,
                                         plan=report.chosen, device="cuda")
    torch.cuda.synchronize()
    rec["planned_upload_s"] = time.perf_counter() - t
    rec["planned_upload_bytes_compared"] = same_upload("sharded_extract_to_device(plan=)",
                                                       dev, exact)
    del dev
    t = time.perf_counter()
    rec_ = recommend(g, workload="multi_pass", crossover=table)
    rec["recommend_s"] = time.perf_counter() - t
    rec["recommendation"] = {
        "host": rec_.host_representation, "device": rec_.device_representation,
        "reason": rec_.reason, "expansion_ratio": rec_.expansion_ratio,
        "duplication_ratio": rec_.duplication_ratio, "device_costs_us": rec_.device_costs,
        "representation_costs_us": device_representation_costs(
            rec_.expansion_ratio, rec_.duplication_ratio, table, g.n_real),
    }
    log(f"planner and advisor: {json.dumps(rec)}")
    return rec


def live_tier_phase(args, catalog, g, exact, ctx, record) -> dict:
    """Phase 6: the live graph under writes, the multi-tenant tier through
    K1-K3, and the planner and advisor, on phase 3's catalog."""
    import shutil

    import numpy as np

    rng = np.random.default_rng(args.seed + 3)
    t = time.perf_counter()
    rec = {}
    live, rec["live"] = live_graph_part(catalog, g, rng)
    rec["live"]["phase_s"] = time.perf_counter() - t
    t1 = time.perf_counter()
    rec["tier"] = tier_part(args, live, ctx, rng)
    rec["tier"]["phase_s"] = time.perf_counter() - t1
    shutil.rmtree(WAL_DIR, ignore_errors=True)
    del live
    t1 = time.perf_counter()
    rec["planner"] = planner_part(catalog, g, exact, ctx["crossover_table"])
    rec["planner"]["phase_s"] = time.perf_counter() - t1
    rec["phase_s"] = time.perf_counter() - t
    log(f"live graph, tier, planner: {rec['phase_s']:.1f} s")
    record["live_tier"] = rec
    return rec


DIST_DIR = os.path.join(ROOT, "build", "dist")
DIST_SPILL = os.path.join(ROOT, "build", "spill_multihost")
DIST_BANDS = 8                  # banded PageRank's bands on the one rank
DIST_SHARDS, DIST_PROCS = 8, 4  # multi-process extraction: shards, simulated processes
INT8_ELEMS = 16 << 20           # allreduce_int8 on 64 MB of float32


def multihost_part(catalog, g) -> dict:
    """``MultihostSpillExtraction`` on phase 3's catalog: ``DIST_PROCS``
    simulated processes driven phase by phase over one spill directory,
    then ``run()`` on the NCCL group with its default barrier; every
    graph byte-identical to phase 3's."""
    import shutil

    from repro_torch.core import graphs_identical
    from repro_torch.distributed.sharding import MultihostSpillExtraction

    rec = {}
    sim_dir, run_dir = os.path.join(DIST_SPILL, "simulated"), os.path.join(DIST_SPILL, "run")
    shutil.rmtree(DIST_SPILL, ignore_errors=True)
    try:
        t = time.perf_counter()
        procs = [MultihostSpillExtraction(catalog, QUERY, DIST_SHARDS, sim_dir,
                                          process_index=p, process_count=DIST_PROCS,
                                          barrier=lambda name: None)
                 for p in range(DIST_PROCS)]
        for m in procs:
            m.phase_nodes()
        for m in procs:
            m.phase_shards()
        for r in range(len(procs[0].schedule)):
            for m in procs:
                m.phase_merge_round(r)
        results = [m.phase_finish() for m in procs]
        rec["simulated_s"] = time.perf_counter() - t
        if not all(graphs_identical(g, res.graph) for res in results):
            raise AssertionError("a simulated process's graph != phase 3's graph")
        rec["merge_rounds"] = len(procs[0].schedule)
        rec["spilled_bytes"] = [res.budget.spilled_bytes for res in results]
        t = time.perf_counter()
        res = MultihostSpillExtraction(catalog, QUERY, DIST_SHARDS, run_dir).run()
        rec["run_s"] = time.perf_counter() - t
        if not graphs_identical(g, res.graph):
            raise AssertionError("MultihostSpillExtraction.run() != phase 3's graph")
    finally:
        shutil.rmtree(DIST_SPILL, ignore_errors=True)
    log(f"multi-process extraction: {DIST_PROCS} simulated processes x {DIST_SHARDS} "
        f"shards {rec['simulated_s']:.2f} s, run() {rec['run_s']:.2f} s; identical")
    return rec


def int8_part(seed: int) -> dict:
    """``allreduce_int8`` on a 64 MB tensor over the group: equal to
    quantize-dequantize (one rank), timed beside it."""
    import torch

    from repro_torch.distributed import compression as C

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(INT8_ELEMS, generator=gen, device="cuda")
    got = C.allreduce_int8(x)
    q, s = C.quantize_int8(x)
    want = C.dequantize_int8(q, s)
    if not torch.equal(got, want):
        raise AssertionError(f"allreduce_int8 != quantize-dequantize by "
                             f"{float((got - want).abs().max())}")
    rec = {"bytes": x.numel() * x.element_size(),
           "ms": time_ms(lambda: C.allreduce_int8(x), reps=5),
           "quantize_dequantize_ms": time_ms(lambda: C.dequantize_int8(*C.quantize_int8(x)),
                                             reps=5)}
    log(f"allreduce_int8 on {rec['bytes']} bytes: {rec['ms']:.3f} ms "
        f"(quantize-dequantize {rec['quantize_dequantize_ms']:.3f} ms); equal")
    return rec


def distributed_phase(args, catalog, g, record) -> dict:
    """Phase 7: the distributed paths under an NCCL group of one rank (one
    card): the launcher's analytics at ``CONFIG``'s counts (banded and
    flat PageRank, the scripted failure and re-mesh), ``allreduce_int8``,
    and multi-process extraction on phase 3's catalog; no K1-K3 launch."""
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch.configs.graphgen_paper import CONFIG, SMOKE
    from repro_torch.core import engine
    from repro_torch.distributed.world import init_group, initialized
    from repro_torch.kernels import bitmap_spmm as K
    from repro_torch.launch import distributed_analytics as DA

    cfg = SMOKE if args.quick else CONFIG
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    engine.reset_kernel_dispatch_count()
    t = time.perf_counter()
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    os.makedirs(DIST_DIR)
    init_group("nccl", os.path.join(DIST_DIR, "store"), 0, 1)
    try:
        rec = {"config": cfg.name, "backend": dist.get_backend(),
               "init_s": time.perf_counter() - t}
        rec["analytics"] = DA.analytics(0, 1, cfg, DIST_BANDS, "cuda:0", seed=0, log=log)
        rec["int8"] = int8_part(args.seed)
        rec["multihost"] = multihost_part(catalog, g)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(DIST_DIR, ignore_errors=True)
    if initialized():
        raise AssertionError("the distributed phase left a process group behind")
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    if any(launches.values()) or engine.KERNEL_DISPATCH_COUNT:
        raise AssertionError(f"the distributed phase launched K1-K3: {launches}")
    a = rec["analytics"]
    if not a["banded"]["divides"]:
        raise AssertionError(f"{DIST_BANDS} bands do not divide {cfg.n_real} nodes")
    rec.update(launches=launches, held_bytes_at_start=held,
               peak_device_bytes=torch.cuda.max_memory_allocated(),
               phase_s=time.perf_counter() - t)
    rec["phase_peak_bytes"] = rec["peak_device_bytes"] - held
    log("distributed: max |diff| / bound flat {max_abs_diff:.3e} / {bound:.3e}, ".format(**a["flat"])
        + "banded {max_abs_diff:.3e} / {bound:.3e}, ".format(**a["banded"])
        + "survivors {max_abs_diff:.3e} / {bound:.3e}".format(**a["survivors"]))
    log(f"distributed: PageRank ms/iter engine {a['engine']['ms_per_iter']:.3f}, flat "
        f"{a['flat']['ms_per_iter']:.3f}, banded {a['banded']['ms_per_iter']:.3f}, survivors "
        f"{a['survivors']['ms_per_iter']:.3f}; peak {rec['phase_peak_bytes']} bytes above "
        f"{held} held; K1-K3 launches {launches}")
    log(f"distributed phase: {rec['phase_s']:.1f} s")
    record["distributed"] = rec
    return rec


def graph_phases(args, record) -> list:
    """Phases 2-7: the small oracle check, the served main path with its
    profile, the graph kernels' rows, the analytics phase on the served
    graph, the live graph and tier, and the distributed paths."""
    import numpy as np
    import torch

    from repro_torch.core import engine, extract
    from repro_torch.data.synth import dblp_catalog
    from repro_torch.kernels import bitmap_index as BI
    from repro_torch.kernels import bitmap_spmm as K
    from repro_torch.serve.server import GraphQueryServer

    small_input_check(args.seed)

    # -- main path: setup (host stages) ------------------------------------
    stages = {}
    t = time.perf_counter()
    catalog = dblp_catalog(args.authors, args.pubs, 6.0, seed=args.seed)
    stages["catalog_s"] = time.perf_counter() - t
    t = time.perf_counter()
    res = extract(catalog, QUERY)
    g = res.graph
    stages["extract_s"] = time.perf_counter() - t
    if g.n_virtual == 0:
        raise AssertionError("extraction postponed no join: nothing to pack")
    builds_before = dict(BI.INDEX_BUILDS)
    t = time.perf_counter()
    server = GraphQueryServer.from_condensed(g, packed=True, device="cuda")
    torch.cuda.synchronize()
    stages["correction_pack_upload_s"] = time.perf_counter() - t
    builds = {k: v - builds_before[k] for k, v in BI.INDEX_BUILDS.items()}
    exact, counts = server.graph, server.counts_graph
    stages["index_build_s"] = rebuild_indices((exact, counts))
    held = {"exact": engine.device_graph_bytes(exact),
            "counts": engine.device_graph_bytes(counts),
            "exact_index": index_bytes(exact), "counts_index": index_bytes(counts)}
    log(f"index builds at upload: {json.dumps(builds)} (inside correction_pack_upload_s); "
        f"all of them again: {stages['index_build_s']:.4f} s")
    log(f"graph: {g!r}; plan {res.plans[0].describe()}")
    log(f"correction: {len(server.graph.correction[0])} triples, "
        f"{exact.fused_fwd.planes.shape[1]} planes; fused standdown {exact.fused_standdown!r}")
    log(f"host stages (s): {json.dumps(stages)}")
    log(f"device bytes held: {json.dumps(held)}")

    rng = np.random.default_rng(args.seed)
    nodes = rng.integers(0, g.n_real, args.batch)
    reach_nodes = rng.integers(0, g.n_real, args.batch)

    # -- main path: the run whose launches count ---------------------------
    K.reset_launch_counts()
    engine.reset_kernel_dispatch_count()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    queries, got, reach, stats = serve_queries(server, nodes, reach_nodes)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t
    launches = dict(K.LAUNCHES)
    standdowns = dict(engine.KERNEL_STANDDOWN_COUNT)
    log(f"served {len(queries)} queries in {stats.n_batches} batches + "
        f"reachable_multi({args.batch}) in {serve_s:.3f} s")
    log(f"launches: {json.dumps(launches)}; stand-downs: {json.dumps(standdowns)}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    if (args.authors, args.pubs, args.batch) == FULL_GRAPH and launches != FULL_LAUNCHES:
        raise AssertionError(f"launches {launches}, expected {FULL_LAUNCHES} at this size")
    if standdowns.get("vmem_or_backend"):
        raise AssertionError("the fused kernel stood down for 'vmem_or_backend'")

    seg = GraphQueryServer(
        dataclasses.replace(exact, backend="segment"),
        counts_graph=dataclasses.replace(counts, backend="segment"),
    )
    before = dict(K.LAUNCHES)
    t = time.perf_counter()
    _, ref, reach_ref, _ = serve_queries(seg, nodes, reach_nodes)
    torch.cuda.synchronize()
    segment_s = time.perf_counter() - t
    if K.LAUNCHES != before:
        raise AssertionError("the segment backend launched a kernel")
    compare_answers(queries, got, ref, reach, reach_ref)
    log(f"answers equal the segment path's (segment run {segment_s:.3f} s)")
    for q in queries:
        a = got[q.qid]
        if a.shape != (g.n_real,) or (q.kind != "bfs" and not np.isfinite(a).all()):
            raise AssertionError(f"malformed answer for {q}")

    # each wrapper call is one range kernel and one carry pass, nothing else.
    # Every profiled run must make the counted run's wrapper calls and give
    # its answers.  Only a trace that holds fewer kernel records than those
    # calls launched is taken again, with the records it lacked and the
    # profiler's dropped-record warnings kept
    k12 = sum(launches[f"bitmap_spmm_{op}"] for op in ("sum", "min", "max"))
    want = {"spmm_kernel": k12, "carry_kernel": k12,
            "fused_kernel": launches["bitmap_spmm_fused"],
            "fused_carry_kernel": launches["bitmap_spmm_fused"]}
    short_traces = []
    for attempt in range(1, PROFILE_TRIES + 1):
        prof, (_, got_p, reach_p, _) = profile_serve(server, nodes, reach_nodes)
        prof["attempt"] = attempt
        log(f"profiled serve: {json.dumps(prof)}")
        if prof["wrapper_launches"] != launches:
            raise AssertionError(f"the profiled run's wrappers launched "
                                 f"{prof['wrapper_launches']}, the counted run's {launches}")
        compare_answers(queries, got, got_p, reach, reach_p,
                        what="profiled run != counted run")
        traced = prof["graph_kernel_launches"]
        if prof["device_busy_s"] is None or traced == want:
            break
        missing = {k: want[k] - traced[k] for k in want}
        if any(v < 0 for v in missing.values()):
            raise AssertionError(f"graph kernels launched {traced} times in the profiled "
                                 f"run, more than its wrapper calls make: {want}")
        short_traces.append({"attempt": attempt, "records_missing": missing,
                             "dropped_record_warnings": prof["dropped_record_warnings"]})
        log(f"profiled run {attempt}: its wrappers made every call, its trace lacks "
            f"{json.dumps(missing)} kernel records")
    else:
        raise AssertionError(f"graph kernels launched {prof['graph_kernel_launches']} times "
                             f"in each of {PROFILE_TRIES} profiled runs, expected {want}")
    prof["short_traces"] = short_traces

    rows = kernel_rows(exact, launches, args.reps, args.seed)
    log(f"K3 operands: {json.dumps(rows[-1]['shape'])}")
    rows += index_rows(exact, builds, max(args.reps // 4, 2))
    record["graph_sass_atomics"] = graph_atomic_counts()
    for r in rows:
        chunked = f", {r['chunks']} chunks, {r['gb_per_s']:.1f} GB/s" if "chunks" in r else ""
        log(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']}, layout bound "
            f"{r['layout_bound_ms']:.4f}, library {r['library_ms']}{chunked})")

    t = time.perf_counter()
    record["scale"] = {
        "extraction": sharded_extraction(args, catalog, g, stages["extract_s"]),
        "upload": sharded_upload(args, catalog, g, exact, counts,
                                 (nodes, reach_nodes, got, reach, launches)),
    }
    record["scale"]["phase_s"] = time.perf_counter() - t
    log(f"sharded extraction and upload: {record['scale']['phase_s']:.1f} s")

    analytic_rows, ctx = analytics_phase(args, exact, g, record)
    rows += analytic_rows
    crossover_phase(args, exact, ctx, record)
    tier = live_tier_phase(args, catalog, g, exact, ctx, record)["tier"]
    dist_launches = distributed_phase(args, catalog, g, record)["launches"]
    del catalog
    for r in rows:
        if r["name"] in tier["launches"]:
            r["tier_launches"] = tier["launches"][r["name"]]
        if r["name"] in dist_launches:
            r["distributed_launches"] = dist_launches[r["name"]]

    record.update({
        "stages": stages, "device_bytes": held,
        "serve_s": serve_s, "segment_s": segment_s, "serve_profile": prof,
        "launches": launches, "index_builds": builds,
        "standdowns": standdowns, "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "graph": {"n_real": g.n_real, "n_virtual": g.n_virtual,
                  "edges_condensed": g.n_edges_condensed,
                  "correction_triples": len(server.graph.correction[0])},
    })
    return rows


# ---------------------------------------------------------------------------
# Phase 9: training (the optimizers, the train steps, K4 with lse)
# ---------------------------------------------------------------------------

# K4's lse (float32) against the plain version's, at the training shapes
LSE_ATOL = 1e-3
# the equal batch parts a library call with lse is tried in, fewest first
LIBRARY_PARTS = (1, 2, 4, 8)
# glm4-9b's training cell: CONFIG's widths at 4 of its 40 layers, and
# train_4k's sequence at a global batch of 4 (one sequence per microbatch)
LM_TRAIN_LAYERS = 4
LM_TRAIN_BATCH = 4
TRAIN_STEPS = 3
# a first step's loss and gradient norm through K4 against the plain
# attention (bf16 activations both: different rounding of p and of the
# output, carried through 4 layers), and a GNN's first loss on the card
# (bf16) against the port's on the CPU (float32)
TRAIN_RTOL = 0.05
# SASRec users scored alone against the same users in a bulk call: the
# GEMMs take other shapes, so bf16 states differ by round-off
REC_RTOL = 0.02
# the profiler ranges the port opens around its plain attention backward,
# its optimizer update, an MoE layer and that layer's expert products, and
# the key each one's kernels are counted under (the innermost range wins)
BACKWARD_RANGE = "repro_torch.flash_attention_backward"
OPTIMIZER_RANGE = "repro_torch.optimizer_update"
RANGES = {BACKWARD_RANGE: "attention_backward_s", OPTIMIZER_RANGE: "optimizer_s",
          "repro_torch.moe": "moe_dispatch_s", "repro_torch.moe_experts": "moe_experts_s"}
# kernels (by category and name) listed with their device time in a split
TOP_KERNELS = 12
# K4's backward kernels against the plain backward (float32 products of
# unrounded p and ds) and against their tiled mirror (the kernels'
# rounding points): each gradient's relative L2 error, and its largest
# element error over its largest element.  Rounding p and ds to bf16
# moves each product term by up to 2^-9, the outputs' bf16 cast by as
# much: ~0.002 of a gradient against the plain backward, 1 bf16 step of
# an element at worst; against the mirror only ex2.approx, the order of
# fp32 sums and the flips of a rounding they cause remain
BWD_L2_RTOL = {"plain": 0.01, "mirror": 0.004}
BWD_MAX_RTOL = {"plain": 0.02, "mirror": 0.01}
# the float32 backward kernel (csrc/flash_backward_f32.cu) against the
# plain backward and its own mirror: float32 products on both sides, so
# only the order of the sums (up to Tq G terms) and expf's last bits
# differ, ~3e-7 of a gradient between the mirror and the plain version on
# the CPU (tests/test_torch_flash_backward.py); 30x that here.  A planted
# fault moves a gradient by more than 0.1 of it
BWD_F32_L2_RTOL = {"plain": 1e-5, "mirror": 1e-5}
BWD_F32_MAX_RTOL = {"plain": 1e-5, "mirror": 1e-5}
# the source of the function the backward kernels compute: the
# reference's custom-VJP backward (XLA code; no Pallas kernel)
BWD_REFERENCE = "src/repro/models/layers.py:195"
# faults planted at the backward's launch for one run each, which the
# row's check must refuse: (the module attribute replaced, its wrapper).
# kv_misrouted reverses the kv heads, or with one kv head (SASRec's) moves
# each sequence's keys to the next batch row; delta_zeroed runs the
# kernels on a zero forward output, so that delta = rowsum(do o) is 0
BACKWARD_PLANTS = {
    "no_causal_mask": ("_launch_backward", lambda f: lambda q, k, v, o, lse, do, causal: f(
        q, k, v, o, lse, do, False)),
    "kv_misrouted": ("_launch_backward", lambda f: lambda q, k, v, o, lse, do, causal: f(
        q, *((t.flip(2) if t.shape[2] > 1 else t.roll(1, 0)).contiguous() for t in (k, v)),
        o, lse, do, causal)),
    "delta_zeroed": ("_launch_backward", lambda f: lambda q, k, v, o, lse, do, causal: f(
        q, k, v, o.new_zeros(o.shape), lse, do, causal)),
}


def k4_lse_row(name, q, k, v, launches, reps, atol=None) -> dict:
    """K4's training forward (the kernel with its lse output) at one
    training shape, causal, called through ``flash_attention_op`` as
    ``FlashAttentionFn`` calls it: held to the plain version element by
    element (lse within ``LSE_ATOL``), timed against its bound and against
    one library call that also returns the log-sum-exp (k / v repeated
    over the group, D padded to a multiple of 8 with zeros: scores and
    outputs unchanged).  bfloat16 runs ``flash_prefill.cu``: output
    within ``atol + K4_BF16_RTOL |plain|`` (``atol`` by default
    ``K4_BF16_ATOL``), bound at the tensor cores' bf16 rate, against
    ``aten._scaled_dot_product_flash_attention``.  float32 runs
    ``flash_attention.cu``: output within ``FLASH_TOL['float32']``, bound
    at the CUDA cores' float32 rate, against
    ``aten._scaled_dot_product_efficient_attention``.  Launches made here
    do not count."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA

    f32 = q.dtype == torch.float32
    if f32:
        rtol, atol = 0.0, FLASH_TOL["float32"] if atol is None else atol
        source, peak = f"{CSRC}/flash_attention.cu", F32_OPS_PER_S
        sdpa = "efficient"
    else:
        rtol, atol = K4_BF16_RTOL, K4_BF16_ATOL if atol is None else atol
        source, peak = f"{CSRC}/flash_prefill.cu", BF16_OPS_PER_S
        sdpa = "flash"
    before = dict(FA.LAUNCHES), dict(FA.PLAIN_CUDA_CALLS)
    out, lse = FA.flash_attention_op(q, k, v, None, True, 0, True, 512, 1024)
    want, want_lse = FA.flash_attention_plain(q, k, v, causal=True, return_lse=True)
    diff = (out.float() - want.float()).abs()
    excess = float((diff - rtol * want.float().abs()).max().item())
    lse_err = float((lse - want_lse).abs().max().item())
    log(f"{name}: out max abs err {float(diff.max())}, |err| - {rtol} |plain| "
        f"{excess} (bound {atol}); lse max abs err {lse_err} (bound {LSE_ATOL})")
    if not (excess <= atol and lse_err <= LSE_ATOL):
        raise AssertionError(f"K4 {name}: out excess {excess}, lse err {lse_err}")
    ms = time_ms(lambda: FA._launch(q, k, v, True, 0, None, with_lse=True), reps)
    # the plain version copies a scalar to the card in every call, which
    # waits for the stream: at a small shape its calls run at the host's
    # pace, so this is its time a call on the card with the host's gaps
    plain_ms = time_ms(lambda: FA.flash_attention_plain(q, k, v, causal=True,
                                                        return_lse=True), 2, 1)
    FA.LAUNCHES.update(before[0])
    FA.PLAIN_CUDA_CALLS.update(before[1])
    B, T, H, D = q.shape
    G = H // k.shape[2]
    pad = (-D) % 8
    qs, ks, vs = (F.pad(t.transpose(1, 2), (0, pad)).contiguous() for t in
                  (q, k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)))
    def library(lo, hi):
        if f32:
            return torch.ops.aten._scaled_dot_product_efficient_attention(
                qs[lo:hi], ks[lo:hi], vs[lo:hi], None, True, is_causal=True,
                scale=1.0 / math.sqrt(D))
        return torch.ops.aten._scaled_dot_product_flash_attention(
            qs[lo:hi], ks[lo:hi], vs[lo:hi], 0.0, True, False, scale=1.0 / math.sqrt(D))

    # one call over the batch, or where the op refuses that many rows (the
    # flash op at SASRec's 65,536) the fewest equal parts it takes, timed
    # back to back as one call: the sum of the parts' times
    library_ms, library_note, library_parts = None, None, None
    for parts in LIBRARY_PARTS:
        size = -(-B // parts)
        bounds = [(lo, min(B, lo + size)) for lo in range(0, B, size)]
        try:
            refs = [library(lo, hi) for lo, hi in bounds]
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError) as e:  # the library's own limits
            library_note = str(e).splitlines()[0][:200]
            log(f"{name}: the library call refuses {size} batch rows: {library_note}")
            continue
        lib_out = torch.cat([r[0] for r in refs])
        lib_lse = torch.cat([r[1] for r in refs])
        lib_err = float((lib_out[..., :D].transpose(1, 2).float() - want.float()).abs().max())
        lib_lse_err = float((lib_lse[..., :T].transpose(1, 2) - want_lse).abs().max())
        del refs, lib_out, lib_lse
        library_ms = time_ms(lambda: [library(lo, hi) for lo, hi in bounds], reps)
        library_parts = parts
        log(f"{name}: SDPA {sdpa} with lse {library_ms:.4f} ms in {parts} call(s) of {size} "
            f"batch rows (max abs diff to plain {lib_err}, lse {lib_lse_err})")
        break
    del qs, ks, vs
    n_bytes = nbytes(q, k, v, out, lse)
    n_ops = 4 * D * B * H * FA.causal_pairs(T, T, 0, True)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / peak * 1e3
    b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    log(f"{name}: {ms:.4f} ms (plain {plain_ms:.4f}, bound {b_ms:.6f} by {b_by}), "
        f"{launches} launches in the training runs")
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": FLASH_TPU_KERNEL, "launches": launches,
        "max_abs_err": float(diff.max()), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
        "shape": {"q": list(q.shape), "kv": list(k.shape), "causal": True,
                  "lse_max_abs_err": lse_err, "excess_over_rtol": excess,
                  "rtol": rtol, "atol": atol, "library": f"sdpa_{sdpa}",
                  "library_parts": library_parts, "bytes": n_bytes, "flops": n_ops,
                  "library_note": library_note, "plan": k4_plan(q, k, 0)},
    }


def backward_errors(got, plain, mirror, l2_rtol=BWD_L2_RTOL, max_rtol=BWD_MAX_RTOL) -> dict:
    """Each gradient's relative L2 error and largest element error over its
    largest element, against the plain backward and the tiled mirror, and
    whether every one is within ``l2_rtol`` / ``max_rtol`` (by default the
    bf16 kernels' ``BWD_L2_RTOL`` / ``BWD_MAX_RTOL``)."""
    out = {"ok": True}
    for ref_name, ref in (("plain", plain), ("mirror", mirror)):
        for name, a, b in zip(("dq", "dk", "dv"), got, ref):
            a, b = a.float(), b.float()
            l2 = float((a - b).norm() / b.norm())
            worst = float((a - b).abs().max() / b.abs().max())
            out[f"{name}_{ref_name}"] = [l2, worst]
            out["ok"] &= l2 <= l2_rtol[ref_name] and worst <= max_rtol[ref_name]
    return out


def k4_backward_row(name, q, k, v, launches, per_step, reps) -> dict:
    """K4's training backward at one training shape, causal, called
    through ``flash_attention_backward_op`` as ``FlashAttentionFn`` calls
    it, on K4's own forward output and lse and a random output gradient:
    ``dq``, ``dk``, ``dv`` held to the plain backward and to the tiled
    mirror of the kernel's arithmetic (:func:`backward_errors`), a second
    run equal bit for bit, the same check refusing the gradients under
    each fault of ``BACKWARD_PLANTS``; timed against its bound (10 B H D
    causal pairs FLOPs, or its bytes), the plain backward, and one
    library call on k / v repeated over the group, D padded to a multiple
    of 8 with zeros (scores, outputs and the gradients' first D dims
    unchanged; the library's dK / dV summed back over each group only for
    the logged comparison), in one call over the batch or the fewest equal
    batch parts the op takes (``LIBRARY_PARTS``), timed back to back as
    one call.  bfloat16 runs ``csrc/flash_backward.cu`` (mirror
    ``flash_attention_backward_tiled_plain``, ``BWD_L2_RTOL`` /
    ``BWD_MAX_RTOL``, bound at the bf16 tensor-core rate, library
    ``aten._scaled_dot_product_flash_attention_backward`` on the same
    output and lse); float32 runs ``csrc/flash_backward_f32.cu`` (mirror
    ``flash_attention_backward_f32_tiled_plain``, ``BWD_F32_L2_RTOL`` /
    ``BWD_F32_MAX_RTOL``, bound at the CUDA cores' float32 rate, library
    ``aten._scaled_dot_product_efficient_attention_backward`` on its own
    forward's output and lse).  ``launches`` are the training run's
    backward calls, ``per_step`` a step's.  Launches made here do not
    count."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA

    before = dict(FA.LAUNCHES), dict(FA.PLAIN_CUDA_CALLS)
    B, T, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    f32 = q.dtype == torch.float32
    tol = (BWD_F32_L2_RTOL, BWD_F32_MAX_RTOL) if f32 else (BWD_L2_RTOL, BWD_MAX_RTOL)
    gen = torch.Generator(device="cuda").manual_seed(11)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    out, lse = FA.flash_attention_op(q, k, v, None, True, 0, True, 512, 1024)

    def kernel():
        return FA.flash_attention_backward_op(q, k, v, out, lse, do, True, 512, 1024)[:3]

    got = kernel()
    again = kernel()
    repeats = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    route = FA._backward_kernel(q.dtype, q.shape, k.shape)
    splits = None if f32 else FA.backward_splits(B, T, T, H, KV, n_sm, D)
    plain = FA.flash_attention_backward_plain(q, k, v, out, lse, do, causal=True)
    if f32:
        mirror = FA.flash_attention_backward_f32_tiled_plain(q, k, v, out, lse, do, causal=True)
    else:
        mirror = FA.flash_attention_backward_tiled_plain(q, k, v, out, lse, do, causal=True,
                                                         splits=splits)
    errors = backward_errors(got, plain, mirror, *tol)
    planted = {}
    for plant, (attr, wrap) in BACKWARD_PLANTS.items():
        orig = getattr(FA, attr)
        setattr(FA, attr, wrap(orig))
        try:
            bad = backward_errors(kernel(), plain, mirror, *tol)
        finally:
            setattr(FA, attr, orig)
        planted[plant] = {"refused": not bad["ok"], **bad}
    log(f"{name}: {json.dumps(errors)}; a second run bit for bit: {repeats}; planted "
        f"{json.dumps({p: r['refused'] for p, r in planted.items()})}")
    if not (errors["ok"] and repeats):
        raise AssertionError(f"K4 backward {name}: {errors}, bits repeat {repeats}")
    if not all(r["refused"] for r in planted.values()):
        raise AssertionError(f"K4 backward {name}: the check passes a planted fault: {planted}")
    max_abs_err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, plain))
    del mirror

    ms = time_ms(lambda: FA._launch_backward(q, k, v, out, lse, do, True), reps)
    plain_ms = time_ms(lambda: FA.flash_attention_backward_plain(q, k, v, out, lse, do,
                                                                 causal=True), 2, 1)
    FA.LAUNCHES.update(before[0])
    FA.PLAIN_CUDA_CALLS.update(before[1])

    scale = 1.0 / math.sqrt(D)
    pad = (-D) % 8
    qs, ks, vs, dos, outs = (F.pad(t.transpose(1, 2), (0, pad)).contiguous() for t in (
        q, k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2), do, out))
    lse_t = lse.transpose(1, 2).contiguous()
    library_ms, library_note, library_err, library_parts = None, None, None, None
    for parts in LIBRARY_PARTS:
        size = -(-B // parts)
        bounds = [(lo, min(B, lo + size)) for lo in range(0, B, size)]
        try:
            calls = []
            for lo, hi in bounds:
                if f32:
                    fwd = torch.ops.aten._scaled_dot_product_efficient_attention(
                        qs[lo:hi], ks[lo:hi], vs[lo:hi], None, True, 0.0, True, scale=scale)
                    calls.append((lo, hi, fwd, fwd[0], fwd[1]))
                    continue
                fwd = torch.ops.aten._scaled_dot_product_flash_attention(
                    qs[lo:hi], ks[lo:hi], vs[lo:hi], 0.0, True, False, scale=scale)
                same = tuple(fwd[1].shape) == tuple(lse_t[lo:hi].shape)
                calls.append((lo, hi, fwd, outs[lo:hi] if same else fwd[0],
                              lse_t[lo:hi] if same else fwd[1]))
            library_note = ("the library's own out and lse" if f32 else
                            "K4's out and lse" if same else
                            f"the library's own out and lse {tuple(fwd[1].shape)}")

            def library():
                if f32:
                    return [torch.ops.aten._scaled_dot_product_efficient_attention_backward(
                        dos[lo:hi], qs[lo:hi], ks[lo:hi], vs[lo:hi], None, o_lib, lse_lib, f[2],
                        f[3], 0.0, [True, True, True, False], True, scale=scale)
                        for lo, hi, f, o_lib, lse_lib in calls]
                return [torch.ops.aten._scaled_dot_product_flash_attention_backward(
                    dos[lo:hi], qs[lo:hi], ks[lo:hi], vs[lo:hi], o_lib, lse_lib, f[2], f[3],
                    f[4], f[5], 0.0, True, f[6], f[7], scale=scale)
                    for lo, hi, f, o_lib, lse_lib in calls]

            lib = library()
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError) as e:  # the library's own limits
            library_note = str(e).splitlines()[0][:200]
            log(f"{name}: the library backward refuses {size} batch rows: {library_note}")
            continue
        lib_grads = [torch.cat([r[i] for r in lib])[..., :D].transpose(1, 2) for i in range(3)]
        lib_grads[1:] = [g.reshape(B, T, KV, G, D).float().sum(3) for g in lib_grads[1:]]
        library_err = [float((a.float() - b.float()).abs().max()) for a, b in
                       zip(lib_grads, plain)]
        del lib, lib_grads
        library_ms = time_ms(library, reps)
        library_parts = parts
        del calls
        break
    del qs, ks, vs, dos, outs, lse_t
    n_bytes = nbytes(q, k, v, out, lse, do, *got)
    n_ops = 10 * B * H * D * FA.causal_pairs(T, T, 0, True)
    peak = F32_OPS_PER_S if f32 else BF16_OPS_PER_S
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / peak * 1e3
    b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    library = "sdpa_efficient_backward" if f32 else "sdpa_flash_backward"
    log(f"{name}: {ms:.4f} ms (plain {plain_ms:.4f}, bound {b_ms:.6f} by {b_by}, {library} "
        f"{library_ms} in {library_parts} part(s) on {library_note}, max abs diff "
        f"to plain {library_err}), {splits} splits, {launches} calls in the training runs "
        f"({per_step} a step)")
    return {
        "name": name, "route": "cuda",
        "source": f"{CSRC}/flash_backward_f32.cu" if f32 else f"{CSRC}/flash_backward.cu",
        "replaces": BWD_REFERENCE, "launches": launches, "max_abs_err": max_abs_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": library_ms,
        "shape": {"q": list(q.shape), "kv": list(k.shape), "causal": True, "splits": splits,
                  "launches_per_step": per_step, "errors": errors, "bits_repeat": repeats,
                  "planted": planted, "l2_rtol": tol[0], "max_rtol": tol[1],
                  "library": library, "library_note": library_note,
                  "library_parts": library_parts,
                  "library_max_abs_diff_to_plain": library_err, "bytes": n_bytes,
                  "flops": n_ops, "route": route,
                  "plan": FA.sm90_backward_plan(B, T, T, H, KV, D, n_sm)
                  if route == "long" else None},
    }


def backward_expect(cfg, batch: int, seq: int, calls: int) -> tuple:
    """The K4-backward launches and plain backward calls on the card that
    ``calls`` attention backwards of an LM at ``batch`` x ``seq`` tokens in
    ``cfg.microbatches`` make: ``({LAUNCHES key: count}, plain calls)``.
    The kernels' routes (``backward_route`` of ``cfg.dtype`` and a
    microbatch's attention shapes) launch each of their kernels once a
    call: the long route (glm4-9b's, granite's heads) its row statistics,
    dK / dV and dQ kernels and, only where ``backward_splits`` cuts the dK
    / dV rows, the reduce; the short route and the float32 kernel their
    one kernel; the plain route (a bf16 ``SMOKE`` config's head dim over a
    long sequence) makes plain calls."""
    import torch

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.transformer import torch_dtype

    hd = cfg.resolved_head_dim
    rows = batch // cfg.microbatches
    kernel = FA._backward_kernel(torch_dtype(cfg.dtype), (rows, seq, cfg.n_heads, hd),
                                 (rows, seq, cfg.n_kv_heads, hd))
    if kernel is None:
        return {}, calls
    if kernel in ("short", "f32"):
        return dict.fromkeys(["flash_attention_backward", f"flash_attention_backward_{kernel}"],
                             calls), 0
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    keys = ["flash_attention_backward", "flash_attention_backward_rowstat",
            "flash_attention_backward_dkdv", "flash_attention_backward_dq"]
    if FA.backward_splits(rows, seq, seq, cfg.n_heads, cfg.n_kv_heads, n_sm, hd) > 1:
        keys.append("flash_attention_backward_reduce")
    return dict.fromkeys(keys, calls), 0


def split_device_time(trace: dict) -> dict:
    """Device seconds of a profiled window (its exported Chrome trace) by
    what launched them: kernels launched inside the port's profiler ranges
    (``RANGES``: the plain attention backward, the optimizer update, an MoE
    layer's routing / sorts / gathers / writes, its expert products;
    matched through each kernel's launch call: same thread, inside the
    range, the innermost range counting), then K4, matrix products and the
    rest, with the ``TOP_KERNELS`` kernels that took the most.  Kernels
    whose launch call the trace lacks are counted under ``unmatched_s``."""
    import re
    from collections import defaultdict

    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    ranges = defaultdict(list)
    launches = {}
    for e in events:
        cat = e.get("cat", "")
        if cat == "user_annotation" and e["name"] in RANGES:
            ranges[(e["pid"], e["tid"])].append((e["ts"], e["ts"] + e["dur"], e["name"]))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = ((e["pid"], e["tid"]), e["ts"])
    cats = dict.fromkeys(list(RANGES.values()) + ["k4_s", "gemm_s", "other_s", "unmatched_s"],
                         0.0)
    by_kernel = defaultdict(float)
    for e in events:
        if e.get("cat") != "kernel":
            continue
        sec = e["dur"] / 1e6
        where = launches.get(e.get("args", {}).get("correlation"))
        inside = None
        if where is not None:
            around = [(a, name) for a, b, name in ranges[where[0]] if a <= where[1] <= b]
            inside = max(around)[1] if around else None
        low = e["name"].lower()
        if inside is not None:
            cat = RANGES[inside]
        elif any(k in low for k in ("flash_prefill", "flash_decode", "flash_combine",
                                    "flash_attention_kernel")):
            cat = "k4_s"
        elif re.search(r"gemm|nvjet|cutlass|xmma|sm90_", low):
            cat = "gemm_s"
        else:
            cat = "other_s"
        cats[cat] += sec
        by_kernel[(cat, e["name"][:100])] += sec
        if where is None:
            cats["unmatched_s"] += sec
    cats["device_busy_s"] = sum(v for k, v in cats.items() if k != "unmatched_s")
    cats["n_kernels"] = sum(1 for e in events if e.get("cat") == "kernel")
    cats["top_kernels"] = [[cat, name, sec] for (cat, name), sec in
                           sorted(by_kernel.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]]
    return cats


def lm_training(args, mod, global_batch: int) -> dict:
    """An LM (``mod``: its config module) at full width
    (``LM_TRAIN_LAYERS`` layers; ``SMOKE`` at --quick): float32 params,
    AdamW, ``TRAIN_STEPS`` steps of ``global_batch`` x 4096 tokens in
    ``cfg.microbatches`` microbatches with full remat, every attention
    through K4's training route, an MoE's ``aux`` in the loss."""
    import unittest.mock

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.shapes import LM_SHAPES
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.train import build_lm_training
    from repro_torch.models import transformer
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import steps as steps_lib

    if args.quick:
        cfg, seq, batch = mod.SMOKE, 32, 4
    else:
        cfg = dataclasses.replace(mod.CONFIG, n_layers=LM_TRAIN_LAYERS)
        seq, batch = LM_SHAPES["train_4k"].seq_len, global_batch
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    state, step_fn, pipe = build_lm_training(cfg, smoke_batch=batch, smoke_seq=seq,
                                             device="cuda")
    torch.cuda.synchronize()
    rec = {"config": {"name": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                      "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads, "d_ff": cfg.d_ff,
                      "vocab_size": cfg.vocab_size, "microbatches": cfg.microbatches,
                      "remat_policy": cfg.remat_policy, "n_params": cfg.n_params()},
           "seq_len": seq, "global_batch": batch, "init_s": time.perf_counter() - t}
    batches = [next(pipe) for _ in range(TRAIN_STEPS + 1)]

    # step 0's loss and gradient norm through the plain attention (plain
    # forward with lse, the same plain backward), on the same params and batch
    class PlainAttention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, block_q, block_kv):
            out, lse = FA.flash_attention_plain(q, k, v, causal=causal, block_q=block_q,
                                                block_kv=block_kv, return_lse=True)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.blocks = (causal, block_q, block_kv)
            return out

        @staticmethod
        def backward(ctx, do):
            causal, block_q, block_kv = ctx.blocks
            return (*FA.flash_attention_backward_plain(
                *ctx.saved_tensors, do, causal=causal, block_q=block_q,
                block_kv=block_kv), None, None, None)

    def plain_attention(q, k, v, *, causal=True, block_q=512, block_kv=1024, **kw):
        return PlainAttention.apply(q, k, v, causal, block_q, block_kv)

    grad_fn = steps_lib.make_grad_fn(lambda p, b: steps_lib.lm_loss(p, b, cfg),
                                     cfg.microbatches)
    with unittest.mock.patch.object(transformer, "flash_attention", plain_attention):
        loss_plain, metrics_plain, grads = grad_fn(state["params"], batches[0])
        norm_plain = float(opt_lib.global_norm(grads))
    loss_plain = float(loss_plain)
    if cfg.moe is not None:
        router_norm = float(grads["layers"]["moe"]["router"].norm())
        aux_plain = float(metrics_plain["aux"])
        log(f"{cfg.name}: step 0 (plain attention) router gradient norm {router_norm}, "
            f"aux of the last microbatch {aux_plain}")
        if not (router_norm > 0 and aux_plain > 0):
            raise AssertionError(f"{cfg.name}: router gradient norm {router_norm}, "
                                 f"aux {aux_plain}: the MoE losses reach no gradient")
    del grads
    gc.collect()
    torch.cuda.empty_cache()

    # the counted steps
    torch.cuda.reset_peak_memory_stats()
    ln1 = state["params"]["layers"]["ln1"].clone()
    wq = state["params"]["layers"]["attn"]["wq"][0, :8].clone()
    router = (state["params"]["layers"]["moe"]["router"].clone() if cfg.moe is not None
              else None)
    FA.reset_launch_counts()
    losses, norms, step_s = [], [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step_fn(state, batches[i])
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        step_s.append(time.perf_counter() - t)
        if i == 0:
            unchanged = (torch.equal(ln1, state["params"]["layers"]["ln1"])
                         and torch.equal(wq, state["params"]["layers"]["attn"]["wq"][0, :8]))
        if i == 1:
            moved = not torch.equal(wq, state["params"]["layers"]["attn"]["wq"][0, :8])
            if router is not None:
                moved = moved and not torch.equal(router,
                                                  state["params"]["layers"]["moe"]["router"])
    launches, plain = dict(FA.LAUNCHES), dict(FA.PLAIN_CUDA_CALLS)
    peak = torch.cuda.max_memory_allocated()
    per_step = cfg.n_layers * cfg.microbatches * (2 if cfg.remat_policy != "none" else 1)
    log(f"{cfg.name} training ({cfg.n_layers} layers, {batch} x {seq} tokens, "
        f"{cfg.microbatches} microbatches, remat {cfg.remat_policy}): losses {losses}, "
        f"grad norms {norms}, step s {step_s}; K4 {json.dumps(launches)}; plain "
        f"{json.dumps(plain)}; peak {peak / 1e9:.2f} GB")
    log(f"step 0 through the plain attention: loss {loss_plain}, grad norm {norm_plain} "
        f"(K4: {losses[0]}, {norms[0]}; rtol {TRAIN_RTOL})")
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"{cfg.name}: non-finite loss or norm {losses} {norms}")
    if not (abs(losses[0] - loss_plain) <= TRAIN_RTOL * abs(loss_plain)
            and abs(norms[0] - norm_plain) <= TRAIN_RTOL * abs(norm_plain)):
        raise AssertionError(f"{cfg.name}: step 0 through K4 ({losses[0]}, {norms[0]}) "
                             f"!= plain ({loss_plain}, {norm_plain})")
    backward, plain_backward = backward_expect(
        cfg, batch, seq, TRAIN_STEPS * cfg.n_layers * cfg.microbatches)
    want = dict.fromkeys(launches, 0)
    want.update(flash_attention=TRAIN_STEPS * per_step,
                flash_attention_prefill_lse=TRAIN_STEPS * per_step, **backward)
    if launches != want:
        raise AssertionError(f"K4 launches {launches}, expected {want}")
    if plain != {"flash_attention": 0, "flash_attention_backward": plain_backward}:
        raise AssertionError(f"plain attention calls on the card: {plain}")
    if not (unchanged and moved):
        raise AssertionError(f"the schedule's lr is 0 at step 0: params unchanged after "
                             f"step 0 {unchanged}, moved after step 1 {moved}")

    # one more step under the profiler (its launches do not count)
    before = dict(FA.LAUNCHES), dict(FA.PLAIN_CUDA_CALLS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state, m = step_fn(state, batches[TRAIN_STEPS])
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    FA.LAUNCHES.update(before[0])
    FA.PLAIN_CUDA_CALLS.update(before[1])
    split = trace_split(prof)
    split.update(wall_s=wall, idle_share=1.0 - split["device_busy_s"] / wall)
    log(f"profiled step: {json.dumps(split)}")
    tokens = batch * seq
    rec.update({"losses": losses, "grad_norms": norms, "step_s": step_s,
                "tokens_per_s": [tokens / s_ for s_ in step_s], "peak_memory_bytes": peak,
                "plain_step0": {"loss": loss_plain, "grad_norm": norm_plain},
                "k4_launches": launches, "plain_cuda_calls": plain,
                "k4_launches_per_step": per_step,
                "backward_calls_per_step": cfg.n_layers * cfg.microbatches,
                "profiled_step": split})
    if cfg.moe is not None:
        rec["plain_step0"].update(router_grad_norm=router_norm, aux=aux_plain)
    del state, step_fn, pipe, batches
    return rec


def rec_training(args) -> dict:
    """SASRec (``CONFIG``: 1,000,000 items, d 50; ``SMOKE`` at --quick):
    ``train_batch`` for ``TRAIN_STEPS`` steps, then ``serve_p99``,
    ``serve_bulk`` (in ``batch_chunk`` 4096) and ``retrieval_cand``, with
    their K4 launches; bulk rows scored alone equal their bulk scores, and
    the best of every item as candidates is ``score_all``'s top 1."""
    import numpy as np
    import torch

    from repro_torch.configs import sasrec as sasrec_cfg
    from repro_torch.configs.shapes import REC_SHAPES
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.train import build_sasrec_training
    from repro_torch.models import sasrec

    cfg = sasrec_cfg.SMOKE if args.quick else sasrec_cfg.CONFIG
    scale = 64 if args.quick else 1
    sizes = {k: max(1, v.batch // scale) for k, v in REC_SHAPES.items()}
    torch.cuda.reset_peak_memory_stats()
    state, step_fn, pipe = build_sasrec_training(cfg, batch=sizes["train_batch"],
                                                 device="cuda")
    FA.reset_launch_counts()
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        batch = next(pipe)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t)
    train_launches, train_plain = dict(FA.LAUNCHES), dict(FA.PLAIN_CUDA_CALLS)
    train_routes = dict(FA.PREFILL_ROUTES)
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"SASRec losses {losses}")
    # one forward with lse and one backward through the short route's
    # kernel a block and a step, the plain backward never
    calls = TRAIN_STEPS * cfg.n_blocks
    if (train_launches["flash_attention_prefill_lse"] != calls
            or train_launches["flash_attention_backward"] != calls
            or train_launches["flash_attention_backward_short"] != calls
            or train_plain != {"flash_attention": 0, "flash_attention_backward": 0}):
        raise AssertionError(f"SASRec training K4 launches {train_launches}, plain calls "
                             f"{train_plain}")
    # D = 50, two sequences a block: the mma.sync kernel's re-laid staging
    if train_routes != {"sm90": 0, "mma": 0, "relay": calls}:
        raise AssertionError(f"SASRec training prefill routes {train_routes}: every "
                             f"launch should be 'relay'")
    params = state["params"]
    rng = np.random.default_rng(args.seed)

    def seqs_of(n):
        return torch.from_numpy(rng.integers(1, cfg.n_items, (n, cfg.seq_len))).cuda()

    out = {"train": {"batch": sizes["train_batch"], "losses": losses, "step_s": step_s,
                     "k4_launches": train_launches, "plain_cuda_calls": train_plain,
                     "prefill_routes": train_routes}}
    with torch.no_grad():
        for name, chunk in (("serve_p99", None), ("serve_bulk", 4096)):
            seqs = seqs_of(sizes[name])
            FA.reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            s_all, ids = sasrec.score_all(params, seqs, cfg, top_k=10, batch_chunk=chunk)
            torch.cuda.synchronize()
            out[name] = {"batch": sizes[name], "s": time.perf_counter() - t,
                         "k4_launches": dict(FA.LAUNCHES),
                         "prefill_routes": dict(FA.PREFILL_ROUTES)}
            if FA.LAUNCHES["flash_attention_prefill"] != cfg.n_blocks:
                raise AssertionError(f"{name}: K4 launches {dict(FA.LAUNCHES)}, expected "
                                     f"one prefill launch per block")
            if FA.PREFILL_ROUTES["relay"] != cfg.n_blocks:
                raise AssertionError(f"{name}: prefill routes {dict(FA.PREFILL_ROUTES)}, "
                                     f"expected 'relay' (D = 50)")
            if ids.shape != (sizes[name], 10) or not torch.isfinite(s_all).all():
                raise AssertionError(f"{name}: {tuple(ids.shape)} ids, finite "
                                     f"{bool(torch.isfinite(s_all).all())}")
            # the first and the last 64 users scored alone (other GEMM shapes:
            # bf16 round-off apart, so scores to REC_RTOL and most ids equal)
            n = sizes[name]
            for rows in (slice(0, min(64, n)), slice(max(0, n - 64), n)):
                s1, i1 = sasrec.score_all(params, seqs[rows], cfg, top_k=10)
                same_ids = float((i1 == ids[rows]).float().mean())
                if not (torch.allclose(s1, s_all[rows], rtol=REC_RTOL,
                                       atol=REC_RTOL * float(s1.abs().max()))
                        and same_ids >= 0.9):
                    raise AssertionError(f"{name}: rows {rows} scored alone differ "
                                         f"({same_ids:.3f} of the ids equal)")
        seqs = seqs_of(1)
        cands = torch.from_numpy(rng.permutation(cfg.n_items)[None, :]).cuda()
        torch.cuda.synchronize()
        t = time.perf_counter()
        cs = sasrec.score_candidates(params, seqs, cands, cfg)
        torch.cuda.synchronize()
        out["retrieval_cand"] = {"candidates": cfg.n_items, "s": time.perf_counter() - t}
        top, _ = sasrec.score_all(params, seqs, cfg, top_k=1)
        best = float(cs.max())
        if not abs(best - float(top[0, 0])) <= 1e-5 * abs(float(top[0, 0])):
            raise AssertionError(f"retrieval_cand's best score {best} is not score_all's "
                                 f"top 1 {float(top[0, 0])}")
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    log(f"SASRec ({cfg.name}, {cfg.n_items:,} items): {json.dumps(out)}")
    del state, step_fn, pipe, params
    return out


def padded_graph(shape, kind, d_out, seed, device):
    """A graph at ``shape``'s padded sizes (masks off on the padding): a
    random graph at its raw counts, or 128 molecules with triplets up to
    ``triplet_count(shape, 8)``; and a random regression target."""
    import numpy as np
    import torch

    from repro_torch.configs.shapes import triplet_count
    from repro_torch.data import graphs

    rng = np.random.default_rng(seed)
    if shape.n_graphs > 1:
        atoms, edges = shape.raw_nodes // shape.n_graphs, shape.raw_edges // shape.n_graphs
        g = graphs.batch_molecules(shape.n_graphs, atoms, edges, shape.d_feat, seed=seed,
                                   device="cpu")
        target = rng.standard_normal((shape.n_graphs, d_out)).astype(np.float32)
    else:
        src, dst, feats, pos = graphs.random_graph(shape.raw_nodes, shape.raw_edges,
                                                   shape.d_feat, seed=seed,
                                                   with_positions=True)
        g = graphs.graph_batch_from_numpy(src, dst, feats, positions=pos, device="cpu")
        target = rng.standard_normal((shape.n_nodes, d_out)).astype(np.float32)
    n_pad, e_pad = shape.n_nodes - g.n_nodes, shape.n_edges - g.n_edges

    def pad(t, n, value=0):
        return torch.cat([t, torch.full((n, *t.shape[1:]), value, dtype=t.dtype)])

    g.nodes, g.positions = pad(g.nodes, n_pad), pad(g.positions, n_pad)
    g.node_mask = pad(g.node_mask, n_pad, False)
    g.edge_src, g.edge_dst = pad(g.edge_src, e_pad), pad(g.edge_dst, e_pad)
    g.edge_mask = pad(g.edge_mask, e_pad, False)
    if g.graph_ids is not None:
        g.graph_ids = pad(g.graph_ids, n_pad)
    if kind == "dimenet":
        n_tri = triplet_count(shape, 8)
        g.triplets, g.triplet_mask = g.triplets[:n_tri], g.triplet_mask[:n_tri]
        t_pad = n_tri - g.triplets.shape[0]
        g.triplets, g.triplet_mask = pad(g.triplets, t_pad), pad(g.triplet_mask, t_pad, False)
    else:
        g.triplets = g.triplet_mask = None
    return g, torch.from_numpy(target)


def gnn_training(args) -> dict:
    """Each GNN at its ``CONFIG`` (``SMOKE`` at --quick): meshgraphnet and
    graphcast on ``full_graph_sm``, schnet and dimenet on ``molecule``;
    ``TRAIN_STEPS`` AdamW steps; the first loss on the card equals the
    port's float32 loss on the CPU, same params and batch; step 0 run
    again from the same params gives the same loss, norm and params bit
    for bit (the segment sums add in a fixed order)."""
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.models import gnn
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import steps as steps_lib

    out = {}
    for kind, shape_name in (("meshgraphnet", "full_graph_sm"), ("graphcast", "full_graph_sm"),
                             ("schnet", "molecule"), ("dimenet", "molecule")):
        mod = registry.get_arch(kind)
        cfg = mod.SMOKE if args.quick else mod.CONFIG
        shape = GNN_SHAPES[shape_name]
        g_cpu, target = padded_graph(shape, kind, cfg.d_out, args.seed, "cpu")
        params = gnn.init_params(cfg, torch.Generator(device="cuda").manual_seed(args.seed),
                                 shape.d_feat, device="cuda")
        with torch.no_grad():
            cpu_loss = float(steps_lib.gnn_loss(
                opt_lib.tree_map(lambda t: t.cpu(), params),
                {"graph": g_cpu, "target": target},
                dataclasses.replace(cfg, dtype="float32"))[0])
        optimizer = opt_lib.adamw(1e-3)
        state = steps_lib.init_train_state(params, optimizer)
        step_fn = steps_lib.build_gnn_train_step(cfg, optimizer)
        batch = {"graph": g_cpu.to("cuda"), "target": target.cuda()}
        first = opt_lib.tree_map(torch.clone, params)
        torch.cuda.reset_peak_memory_stats()
        losses, norms, step_s = [], [], []
        for i in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            step_s.append(time.perf_counter() - t)
            if i == 0:
                after_0 = opt_lib.tree_map(torch.clone, state["params"])
        # step 0 again from the same params: the same bits (fixed-order sums)
        again, m = step_fn(steps_lib.init_train_state(first, optimizer), batch)
        repeats = (float(m["loss"]) == losses[0] and float(m["grad_norm"]) == norms[0]
                   and all(torch.equal(a, b) for a, b in zip(
                       opt_lib.tree_leaves(again["params"]), opt_lib.tree_leaves(after_0))))
        del again, first, after_0
        if not repeats:
            raise AssertionError(f"{cfg.name}: step 0 again gives other bits")
        rec = {"shape": shape_name, "nodes": shape.n_nodes, "edges": shape.n_edges,
               "triplets": None if batch["graph"].triplets is None
               else int(batch["graph"].triplets.shape[0]),
               "n_layers": cfg.n_layers, "d_hidden": cfg.d_hidden, "losses": losses,
               "grad_norms": norms, "step0_repeats_bits": repeats,
               "cpu_float32_loss": cpu_loss, "step_s": step_s,
               "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        log(f"{cfg.name} on {shape_name}: {json.dumps(rec)}")
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"{cfg.name}: losses {losses}")
        if abs(losses[0] - cpu_loss) > TRAIN_RTOL * abs(cpu_loss):
            raise AssertionError(f"{cfg.name}: first loss {losses[0]} on the card, "
                                 f"{cpu_loss} on the CPU")
        out[kind] = rec
        del state, step_fn, params, batch
    return out


def recsys_part(args) -> dict:
    """``launch/recsys_serve.run`` at the example's sizes on the card: K1
    and K3 must launch, and the served answers equal the segment path's
    on the same upload."""
    import numpy as np
    import torch

    from repro_torch.core import extract
    from repro_torch.kernels import bitmap_spmm as K
    from repro_torch.launch import recsys_serve
    from repro_torch.models import sasrec
    from repro_torch.serve.server import GraphQueryServer

    params = sasrec.init_params(recsys_serve.DEMO,
                                torch.Generator(device="cuda").manual_seed(args.seed), "cuda")
    K.reset_launch_counts()
    t = time.perf_counter()
    got = recsys_serve.run(recsys_serve.DEMO, params, "cuda", log=lambda _: None)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    launches = dict(K.LAUNCHES)
    catalog, rng = recsys_serve.co_interaction_catalog()
    g = extract(catalog, recsys_serve.GRAPH_QUERY).graph
    seg = GraphQueryServer.from_condensed(g, budget_bytes=2 << 20, max_batch=32, packed=True,
                                          backend="segment", device="cuda")
    # A user who interacted with an item twice makes a repeated user ->
    # item edge; sums over such a layer go to the segment path, as the
    # reference sends them to XLA, so K1 / K3 launch only where no layer
    # repeats an edge.
    repeats = [layer.repeats for chain in seg.graph.chains for layer in chain]
    if not all(repeats) and not (launches["bitmap_spmm_sum"] and launches["bitmap_spmm_fused"]):
        raise AssertionError(f"recsys_serve: K1 / K3 did not launch: {launches}")
    want = seg.run(recsys_serve.example_queries(rng))
    if K.LAUNCHES != launches:
        raise AssertionError("the segment backend launched a kernel")
    for qid, a in want.items():
        if not np.allclose(got["answers"][qid], np.asarray(a), rtol=1e-5, atol=1e-6):
            raise AssertionError(f"recsys_serve: query {qid} differs from the segment path")
    out = {"run_s": run_s, "launches": launches, "layers_with_repeated_edges": repeats,
           "losses": got["losses"][::10], "served": got["served"], "edges": got["edges"]}
    log(f"recsys_serve on the card: {json.dumps(out)}")
    return out


def training_phase(args) -> tuple:
    """Phase 9: K4's training rows, then glm4-9b, SASRec, the GNNs and
    the recsys launcher.  Returns the record and K4's lse rows (their
    launches are the glm4-9b and SASRec training runs')."""
    import torch

    from repro_torch.configs import sasrec as sasrec_cfg

    from repro_torch.configs import glm4_9b

    t0 = time.perf_counter()
    rec = {"lm": lm_training(args, glm4_9b, LM_TRAIN_BATCH)}
    gc.collect()
    torch.cuda.empty_cache()
    rec["sasrec"] = rec_training(args)
    gc.collect()
    torch.cuda.empty_cache()
    rec["gnn"] = gnn_training(args)
    rec["recsys_serve"] = recsys_part(args)
    gc.collect()
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    lm = glm4_9b.CONFIG
    T = 4096
    q, k, v = (randn(1, T, lm.n_heads, 128), randn(1, T, lm.n_kv_heads, 128),
               randn(1, T, lm.n_kv_heads, 128))
    rows = [k4_lse_row("flash_attention_prefill_lse", q, k, v,
                       rec["lm"]["k4_launches"]["flash_attention_prefill_lse"], args.reps),
            k4_backward_row("flash_attention_backward", q, k, v,
                            rec["lm"]["k4_launches"]["flash_attention_backward"],
                            rec["lm"]["backward_calls_per_step"], args.reps)]
    del q, k, v
    rc = sasrec_cfg.CONFIG
    B = 65_536
    q, k, v = (randn(B, rc.seq_len, 1, rc.d) for _ in range(3))
    # A SASRec row averages at most 50 keys, so its output keeps |v|'s
    # size (up to ~6 here) where glm4's late rows average thousands: a p
    # whose bf16 rounding flips between the kernel's exp2 and the plain
    # exp moves the output by up to one bf16 step of p (2^-8 relative)
    # times max |v|, which K4_BF16_ATOL (set at glm4's shape) undercounts.
    # A dropped key tile here changes a whole row by O(|v|).
    sasrec_train = rec["sasrec"]["train"]["k4_launches"]
    rows += [k4_lse_row("flash_attention_prefill_lse_sasrec", q, k, v,
                        sasrec_train["flash_attention_prefill_lse"], args.reps,
                        atol=2.0 ** -8 * float(v.float().abs().max())),
             k4_backward_row("flash_attention_backward_sasrec", q, k, v,
                             sasrec_train["flash_attention_backward"], rc.n_blocks, args.reps)]
    del q, k, v
    # serve_bulk's attention: every user's sequence in one call a block
    # (score_all's batch_chunk cuts only the scoring), no lse
    bulk = rec["sasrec"]["serve_bulk"]
    B = bulk["batch"]
    v = randn(B, rc.seq_len, 1, rc.d)
    rows.append(k4_row("flash_attention_prefill_sasrec_bulk", "flash_prefill.cu",
                       randn(B, rc.seq_len, 1, rc.d), [(randn(B, rc.seq_len, 1, rc.d), v)],
                       dict(causal=True, q_offset=0, kv_length=None),
                       B * rc.seq_len * (rc.seq_len + 1) // 2,
                       bulk["k4_launches"]["flash_attention_prefill"], args.reps,
                       atol=2.0 ** -8 * float(v.float().abs().max()),
                       library_parts=LIBRARY_PARTS))
    del v
    rec["phase_s"] = time.perf_counter() - t0
    log(f"training phase: {rec['phase_s']:.1f} s")
    return rec, rows


# ---------------------------------------------------------------------------
# Phase 10: the MoE LMs and llama3-405b's widths
# ---------------------------------------------------------------------------

# the served runs of phase 10: 8 slots, MOE_EACH long and MOE_EACH short
# prompts (LM_FULL's lengths and new tokens; LM_QUICK's at --quick)
MOE_EACH = 4
# the depths of the two models whose full depth does not fit the card with
# a 4096-token batch beside it (moonshot: 28.06 B params, 56.1 GB in bf16;
# llama3-405b: 405.9 B)
MOONSHOT_LAYERS = 12
LLAMA_LAYERS = 2
# moonshot's one-layer a2a check: a capacity factor at which neither path
# drops a slot on 4096 tokens (sort: C = 1536 a expert; a2a on one rank:
# C = 98,304 and C2 = 6,144), and the tokens' bound against the sort path:
# the two add a token's 6 bf16 contributions in another order (expert id
# against k), each add rounding at 2^-9 of its partial sum
A2A_CAPACITY = 4.0
A2A_TOKENS = 4096
A2A_RTOL = 2.0 ** -6


class DropRecorder:
    """Wraps ``models.moe.moe_apply`` for the duration of a ``with``: the
    token count and drop fraction (a device tensor, read afterwards) of
    every MoE layer call."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.apply, self.calls = moe, moe.moe_apply, []

    def __enter__(self):
        def recorded(params, x, cfg):
            y, metrics = self.apply(params, x, cfg)
            self.calls.append((x.shape[0], metrics["moe_drop_fraction"]))
            return y, metrics

        self.moe.moe_apply = recorded
        return self

    def __exit__(self, *exc):
        self.moe.moe_apply = self.apply

    def prefills(self, n_layers: int, decode_tokens: int) -> list:
        """Per prefill, its layers' drop fractions (calls of more or fewer
        tokens than a decode step's, in groups of ``n_layers``)."""
        drops = [float(d) for t, d in self.calls if t != decode_tokens]
        if len(drops) % n_layers:
            raise AssertionError(f"{len(drops)} prefill MoE calls: not {n_layers} a prefill")
        return [drops[i:i + n_layers] for i in range(0, len(drops), n_layers)]


def serve_model(args, cfg, tag: str, repeat: bool = False, profile: bool = False) -> tuple:
    """``cfg`` in bf16 with random weights from ``--seed`` through
    ``BatchedServer.run`` on 8 slots (``serve_counted``), each prefill's
    MoE drop fractions, the K4-vs-plain logits check; with ``repeat`` the
    same requests again on the same server must give the same tokens bit
    for bit; with ``profile`` one prefill and one decode step are
    profiled.  Returns the record, the params and the served run's K4
    launches (the caller frees the params)."""
    import torch

    from repro_torch.models import transformer
    from repro_torch.serve.server import BatchedServer

    long_len, short_len, new_tokens = LM_QUICK if args.quick else LM_FULL
    max_len = long_len + new_tokens
    rec = {"config": {**{k: v for k, v in dataclasses.asdict(cfg).items()
                         if k != "sharding_rules"}, "n_params": cfg.n_params()}}
    t = time.perf_counter()
    params = transformer.init_params(cfg, torch.Generator(device="cuda").manual_seed(args.seed),
                                     "cuda")
    torch.cuda.synchronize()
    rec.update(init_s=time.perf_counter() - t, weight_bytes=leaf_bytes(params))
    log(f"{tag}: {cfg.name} at {cfg.n_layers} layers, {cfg.n_params():,} parameters, "
        f"{rec['weight_bytes'] / 1e9:.2f} GB of bf16 weights, drawn in {rec['init_s']:.1f} s")
    server = BatchedServer(params, cfg, batch_slots=8, max_len=max_len)
    requests = lm_requests(cfg, args.seed, long_len, short_len, MOE_EACH, new_tokens)
    with DropRecorder() as drops:
        served, launches, out = serve_counted(cfg, server, requests)
    rec.update(served)
    if not args.quick and served["prefill_route"] != "sm90":  # head dims 64 / 128
        raise AssertionError(f"{tag}: prefills went '{served['prefill_route']}', not 'sm90'")
    if cfg.moe is not None:
        per = drops.prefills(cfg.n_layers, len(server.slots))
        rec["prefill_drop_fraction"] = [
            {"tokens": int(r.prompt.size), "mean": sum(d) / len(d), "max": max(d)}
            for r, d in zip(sorted(requests, key=lambda r: -int(r.prompt.size)), per)]
        log(f"{tag}: drop fraction of each prefill (mean / max over its {cfg.n_layers} "
            f"layers): " + ", ".join(f"{d['tokens']} tokens {d['mean']:.5f} / {d['max']:.5f}"
                                     for d in rec["prefill_drop_fraction"]))
    if repeat:
        t = time.perf_counter()
        again = server.run(lm_requests(cfg, args.seed, long_len, short_len, MOE_EACH,
                                       new_tokens))
        torch.cuda.synchronize()
        rec["repeat_run_s"] = time.perf_counter() - t
        same = again == out
        log(f"{tag}: the same requests again in {rec['repeat_run_s']:.2f} s: tokens bit "
            f"for bit the same: {same}")
        if not same:
            raise AssertionError(f"{tag}: a second run of the same requests served other "
                                 f"tokens")
        rec["repeat_identical"] = True
    rec["logits_check"] = logits_check(cfg, params, requests[0].prompt, max_len)
    if profile:
        rec["profile"] = profile_lm(server, lm_requests(
            cfg, args.seed + 1, long_len, short_len, len(server.slots), new_tokens))
        log(f"{tag}: profiled prefill / decode step: {json.dumps(rec['profile'])}")
    del server
    return rec, params, launches


def a2a_check(args, cfg, params) -> dict:
    """One layer's ``moe_apply`` on ``A2A_TOKENS`` tokens through
    ``_moe_a2a`` under a (1, 1) ``DeviceMesh`` on an NCCL group of one rank
    (``make_host_mesh`` over the group, the config's rules), at
    ``A2A_CAPACITY``, against ``_moe_sort`` at the same capacity factor:
    neither drops a slot, and the tokens agree within ``A2A_RTOL`` of the
    largest |y|."""
    import shutil
    import unittest.mock

    import torch
    import torch.distributed as dist

    from repro_torch.distributed.sharding import use_mesh_rules
    from repro_torch.distributed.world import init_group, initialized
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe

    layer = {k: w[0] for k, w in params["layers"]["moe"].items()}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    x = torch.randn((A2A_TOKENS, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    mcfg = dataclasses.replace(cfg.moe, capacity_factor=A2A_CAPACITY, dispatch="a2a")
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    os.makedirs(DIST_DIR)
    init_group("nccl", os.path.join(DIST_DIR, "store"), 0, 1)
    try:
        mesh = make_host_mesh("cuda")
        spy = unittest.mock.patch.object(moe, "_moe_a2a", wraps=moe._moe_a2a)
        with torch.inference_mode(), use_mesh_rules(mesh, dict(cfg.sharding_rules)), \
                spy as a2a:
            y, m = moe.moe_apply(layer, x, mcfg)
            torch.cuda.synchronize()
            t = time.perf_counter()
            moe.moe_apply(layer, x, mcfg)
            torch.cuda.synchronize()
            a2a_s = time.perf_counter() - t
        rec = {"backend": dist.get_backend(), "mesh": list(mesh.shape),
               "mesh_dim_names": list(mesh.mesh_dim_names), "a2a_calls": a2a.call_count}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(DIST_DIR, ignore_errors=True)
    if initialized():
        raise AssertionError("the a2a check left a process group behind")
    with torch.inference_mode():
        want, wm = moe._moe_sort(layer, x, dataclasses.replace(mcfg, dispatch="sort"))
    err = float((y.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    drops = (float(m["moe_drop_fraction"]), float(wm["moe_drop_fraction"]))
    rec.update(tokens=A2A_TOKENS, capacity_factor=A2A_CAPACITY, max_abs_err=err,
               max_abs_y=scale, rtol=A2A_RTOL, drop_fraction=drops, a2a_s=a2a_s)
    log(f"a2a on a (1, 1) mesh over NCCL ({rec['a2a_calls']} calls): max abs err {err} against "
        f"the sort path (largest |y| {scale}, bound {A2A_RTOL} x that), drop fractions "
        f"{drops}, {a2a_s * 1e3:.2f} ms")
    if rec["a2a_calls"] != 2 or rec["backend"] != "nccl":
        raise AssertionError(f"the a2a path did not run under NCCL: {rec}")
    if drops != (0.0, 0.0) or not err <= A2A_RTOL * scale:
        raise AssertionError(f"a2a against sort: drops {drops}, max abs err {err}")
    return rec


def moe_phase(args) -> tuple:
    """Phase 10: granite-moe-3b-a800m served at full width and depth
    (repeat run bit for bit, profiled), then trained at 4 layers;
    moonshot-v1-16b-a3b at ``MOONSHOT_LAYERS`` layers served, with its
    one-layer a2a check; llama3-405b at ``LLAMA_LAYERS`` layers served;
    K4's rows at granite's and moonshot's shapes.  ``SMOKE`` configs at
    --quick.  Returns the record and the K4 rows."""
    import torch

    from repro_torch.configs import granite_moe_3b_a800m as granite
    from repro_torch.configs import llama3_405b as llama
    from repro_torch.configs import moonshot_v1_16b_a3b as moonshot

    t0 = time.perf_counter()
    long_len, _, new_tokens = LM_QUICK if args.quick else LM_FULL
    max_len = long_len + new_tokens
    rec, rows = {}, []

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    cfg = granite.SMOKE if args.quick else granite.CONFIG
    rec["granite"], params, launches = serve_model(args, cfg, "granite", repeat=True,
                                                   profile=True)
    del params
    free()
    rows += k4_rows(long_len, max_len, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                    launches, args.reps, args.seed, tag="_granite")
    free()
    rec["granite_training"] = lm_training(args, granite, granite.CONFIG.microbatches)
    free()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    cfg = granite.CONFIG
    hd, T = cfg.resolved_head_dim, 4096
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
               for shape in ((1, T, cfg.n_heads, hd), (1, T, cfg.n_kv_heads, hd),
                             (1, T, cfg.n_kv_heads, hd)))
    # granite's training forward (K4 with lse, 24 heads over 8 at D = 64)
    # and its backward
    backward_rows = [k4_lse_row(
        "flash_attention_prefill_lse_granite", q, k, v,
        rec["granite_training"]["k4_launches"]["flash_attention_prefill_lse"], args.reps),
        k4_backward_row(
        "flash_attention_backward_granite", q, k, v,
        rec["granite_training"]["k4_launches"]["flash_attention_backward"],
        rec["granite_training"]["backward_calls_per_step"], args.reps)]
    del q, k, v
    free()

    cfg = moonshot.SMOKE if args.quick else dataclasses.replace(
        moonshot.CONFIG, n_layers=MOONSHOT_LAYERS)
    rec["moonshot"], params, launches = serve_model(args, cfg, "moonshot")
    rec["moonshot"]["a2a"] = a2a_check(args, cfg, params)
    del params
    free()
    rows += k4_rows(long_len, max_len, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                    launches, args.reps, args.seed, tag="_moonshot")
    free()

    cfg = llama.SMOKE if args.quick else dataclasses.replace(llama.CONFIG,
                                                             n_layers=LLAMA_LAYERS)
    rec["llama"], params, _ = serve_model(args, cfg, "llama3-405b")
    del params
    free()
    for r in rows:
        log(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']}, SDPA {r['library_ms']:.4f}), "
            f"{r['launches']} launches in the served run")
    rec["phase_s"] = time.perf_counter() - t0
    log(f"MoE phase: {rec['phase_s']:.1f} s")
    return rec, rows + backward_rows


SHARDED_CKPT = os.path.join(ROOT, "build", "ckpt_sharded")
LAUNCH_CKPT = os.path.join(ROOT, "build", "ckpt_launch")
LAUNCH_TIMEOUT_S = 300


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _local_leaves(tree) -> dict:
    from repro_torch.train import optimizer as opt_lib

    return {"/".join(p): v.to_local() for p, v in opt_lib.tree_paths(tree)}


def _state_leaves(state) -> list:
    """The params' and the optimizer state's leaves."""
    from repro_torch.train import optimizer as opt_lib

    return [v for key in ("params", "opt") for _, v in opt_lib.tree_paths(state[key])]


def launcher_run(args) -> dict:
    """``python -m torch.distributed.run --nproc-per-node 1 -m
    repro_torch.launch.train --arch granite-moe-3b-a800m --steps 3`` as a
    subprocess (its own NCCL group of one, on the card): its return code
    and its printed losses."""
    import shutil

    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "1",
           "--master-addr", "127.0.0.1", "--master-port", str(_free_port()),
           "-m", "repro_torch.launch.train", "--arch", "granite-moe-3b-a800m",
           "--steps", "3", "--checkpoint-dir", LAUNCH_CKPT]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    shutil.rmtree(LAUNCH_CKPT, ignore_errors=True)
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT_S)
    seconds = time.perf_counter() - t
    saved = os.listdir(LAUNCH_CKPT) if os.path.isdir(LAUNCH_CKPT) else []
    shutil.rmtree(LAUNCH_CKPT, ignore_errors=True)
    out = proc.stdout.strip().splitlines()
    log(f"torch.distributed.run launcher: rc {proc.returncode} in {seconds:.1f} s: "
        f"{' | '.join(out[-4:])}")
    if proc.returncode != 0 or "done" not in out or "step_0000000003" not in saved:
        raise AssertionError(f"the launcher failed (rc {proc.returncode}, checkpoints "
                             f"{saved}):\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return {"cmd": " ".join(cmd[1:]), "returncode": proc.returncode, "seconds": seconds,
            "stdout_tail": out[-4:], "checkpoints": sorted(saved)}


def sharded_phase(args, plain: dict) -> dict:
    """Phase 11: the sharded train step on the card.  An NCCL group of one
    rank over a ``FileStore`` under ``build/``, a (1, 1) ``DeviceMesh``;
    granite-moe-3b-a800m at ``CONFIG``'s widths and ``LM_TRAIN_LAYERS``
    layers (``SMOKE`` at --quick) with float32 params and AdamW state
    held as DTensors by its rules, the batch a DTensor, in ``CONFIG``'s
    microbatches.  ``plain`` is phase 10's plain-tensor run of the same
    config, seed and batches: step 0's loss and gradient norm must equal
    it bit for bit (within ``TRAIN_RTOL`` at worst, recorded).  K4's lse
    prefill kernel launches layers x microbatches x 2 a step, the plain
    forward never.  The state saved after step 1 and restored with
    ``restore_checkpoint(shardings=)`` gives step 2 bit for bit.  Then the
    ``torch.distributed.run`` launcher (:func:`launcher_run`)."""
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import granite_moe_3b_a800m as granite
    from repro_torch.configs.shapes import LM_SHAPES
    from repro_torch.distributed import sharding
    from repro_torch.distributed.world import init_group, initialized
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.train import build_lm_training
    from repro_torch.models import transformer
    from repro_torch.train import checkpoint

    t0 = time.perf_counter()
    if args.quick:
        cfg, seq, batch = granite.SMOKE, 32, 4
    else:
        cfg = dataclasses.replace(granite.CONFIG, n_layers=LM_TRAIN_LAYERS)
        seq, batch = LM_SHAPES["train_4k"].seq_len, granite.CONFIG.microbatches
    rules = dict(cfg.sharding_rules)
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    shutil.rmtree(SHARDED_CKPT, ignore_errors=True)
    os.makedirs(DIST_DIR)
    init_group("nccl", os.path.join(DIST_DIR, "store"), 0, 1)
    try:
        mesh = DeviceMesh("cuda", torch.zeros((1, 1), dtype=torch.int64),
                          mesh_dim_names=("data", "model"))
        torch.cuda.reset_peak_memory_stats()
        state, step_fn, pipe = build_lm_training(cfg, smoke_batch=batch, smoke_seq=seq,
                                                 device="cuda")
        shardings = sharding.state_placements(state, transformer.logical_axes(cfg), rules, mesh)
        state = sharding.place_tree(state, shardings, mesh, src_data_rank=None)
        rows = sharding.batch_placements(rules, mesh)
        batches = [sharding.place_tree(next(pipe), {"tokens": rows, "labels": rows}, mesh,
                                       src_data_rank=None) for _ in range(TRAIN_STEPS)]
        kinds = {type(v).__name__ for v in _state_leaves(state)}
        if kinds != {"DTensor"}:
            raise AssertionError(f"params and optimizer state are {kinds}, not DTensors")
        placements = sorted({str(tuple(v.placements)) for v in _state_leaves(state)})
        FA.reset_launch_counts()
        losses, norms, step_s = [], [], []
        with sharding.use_mesh_rules(mesh, rules):
            for i in range(TRAIN_STEPS - 1):
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, m = step_fn(state, batches[i])
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                step_s.append(time.perf_counter() - t)
            launches, plain_calls = dict(FA.LAUNCHES), dict(FA.PLAIN_CUDA_CALLS)
            peak = torch.cuda.max_memory_allocated()
            checkpoint.save_checkpoint(SHARDED_CKPT, TRAIN_STEPS - 1, state)
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step_fn(state, batches[-1])
            last = (float(m["loss"]), float(m["grad_norm"]))
            step_s.append(time.perf_counter() - t)
            want_params = _local_leaves(state["params"])
            del state
            gc.collect()
            torch.cuda.empty_cache()
            restored, at = checkpoint.restore_checkpoint(SHARDED_CKPT, shardings=shardings,
                                                         mesh=mesh)
            restored, m = step_fn(restored, batches[-1])
            again = (float(m["loss"]), float(m["grad_norm"]))
            got_params = _local_leaves(restored["params"])
        restored_equal = again == last and all(
            torch.equal(got_params[k], v) for k, v in want_params.items())
        del restored, got_params, want_params, batches, step_fn, pipe
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(DIST_DIR, ignore_errors=True)
        shutil.rmtree(SHARDED_CKPT, ignore_errors=True)
    if initialized():
        raise AssertionError("the sharded phase left a process group behind")
    gc.collect()
    torch.cuda.empty_cache()

    per_step = cfg.n_layers * cfg.microbatches * (2 if cfg.remat_policy != "none" else 1)
    n_counted = TRAIN_STEPS - 1
    step0 = (plain["losses"][0], plain["grad_norms"][0])
    bit_equal = (losses[0], norms[0]) == step0
    log(f"sharded {cfg.name} on a (1, 1) mesh over {backend} ({cfg.n_layers} layers, "
        f"{batch} x {seq} tokens, {cfg.microbatches} microbatches): losses {losses + [last[0]]}"
        f", grad norms {norms + [last[1]]}, step s {step_s} (plain: {plain['step_s']}); "
        f"step 0 {'bit-equal to' if bit_equal else 'differs from'} the plain step {step0}; "
        f"K4 {json.dumps(launches)}; peak {peak / 1e9:.2f} GB (plain "
        f"{plain['peak_memory_bytes'] / 1e9:.2f} GB); restored step 2 {again} "
        f"{'bit-equal' if restored_equal else 'differs'}; placements {placements}")
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"sharded step: non-finite loss or norm {losses} {norms}")
    if not bit_equal and not (
            abs(losses[0] - step0[0]) <= TRAIN_RTOL * abs(step0[0])
            and abs(norms[0] - step0[1]) <= TRAIN_RTOL * abs(step0[1])):
        raise AssertionError(f"sharded step 0 {(losses[0], norms[0])} != plain {step0}")
    backward, plain_backward = backward_expect(
        cfg, batch, seq, n_counted * cfg.n_layers * cfg.microbatches)
    want = dict.fromkeys(launches, 0)
    want.update(flash_attention=n_counted * per_step,
                flash_attention_prefill_lse=n_counted * per_step, **backward)
    if launches != want or plain_calls != {"flash_attention": 0,
                                           "flash_attention_backward": plain_backward}:
        raise AssertionError(f"K4 launches {launches} (expected {want}), plain {plain_calls}")
    if not restored_equal or at != TRAIN_STEPS - 1:
        raise AssertionError(f"restored step {at}: {again} != uninterrupted {last}")
    rec = {"config": {"name": cfg.name, "n_layers": cfg.n_layers,
                      "microbatches": cfg.microbatches, "remat_policy": cfg.remat_policy},
           "mesh": [1, 1], "backend": backend, "seq_len": seq, "global_batch": batch,
           "placements": placements, "losses": losses + [last[0]],
           "grad_norms": norms + [last[1]], "step_s": step_s, "plain_step_s": plain["step_s"],
           "peak_memory_bytes": peak, "plain_peak_memory_bytes": plain["peak_memory_bytes"],
           "step0_bit_equal": bit_equal, "plain_step0": list(step0),
           "k4_launches": launches, "k4_launches_per_step": per_step,
           "restored_step": at, "restored_bit_equal": restored_equal}
    rec["launcher"] = launcher_run(args)
    rec["phase_s"] = time.perf_counter() - t0
    log(f"sharded phase: {rec['phase_s']:.1f} s")
    return rec


# phase 12: the dry-run cells that one card holds, each (arch, shape, depth,
# batch): depth and batch cut, widths never
DRYRUN_HOST_CELLS = [
    ("glm4-9b", "prefill_32k", None, 1),
    ("glm4-9b", "decode_32k", None, 8),
    ("glm4-9b", "train_4k", LM_TRAIN_LAYERS, LM_TRAIN_BATCH),
    ("granite-moe-3b-a800m", "train_4k", LM_TRAIN_LAYERS, 8),
    ("sasrec", "train_batch", None, None),
]
# one production-mesh cell per family and step kind (the 41 take minutes
# of host time; PERF.md records each one's time on the CPU)
DRYRUN_MESH_CELLS = ("glm4-9b:train_4k,glm4-9b:prefill_32k,glm4-9b:decode_32k,"
                     "schnet:molecule,sasrec:train_batch,sasrec:serve_p99,"
                     "graphgen-paper:pagerank:banded")
DRYRUN_TIMEOUT_S = 600
PEAK_RTOL = 0.10            # the predicted peak against max_memory_allocated


def dryrun_host_cell(args, arch, shape, depth, batch) -> dict:
    """One host-mesh cell: the dry-run's prediction over fake tensors, then
    the same ``Cell.fn`` run for real on the card under the same count
    (K4's launches zeroed before, read after), the peak of the allocator
    from just before the arguments are made, and a second, uncounted run
    for the step time."""
    import torch

    from repro_torch.distributed.sharding import use_mesh_rules
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import cells as cells_lib
    from repro_torch.launch import dryrun
    from repro_torch.launch.op_cost import measure

    smoke = args.quick
    if smoke:
        depth, batch = None, (2 if batch is not None else None)
    rec = dryrun.run_cell(arch, shape, "host", verbose=False, smoke=smoke, depth=depth,
                          batch=batch, device_type="cuda")
    predicted_k4 = rec["op_counts"].get("repro_torch.flash_attention", 0)
    predicted_bwd = rec["op_counts"].get("repro_torch.flash_attention_backward", 0)
    mesh = dryrun.make_mesh("host", "cuda")
    cell = cells_lib.build_cell(arch, shape, mesh, smoke=smoke, depth=depth, batch=batch)
    grad = torch.enable_grad if cell.kind == "train" else torch.no_grad
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    real = cells_lib.materialize(cell, "cuda", fill=True, seed=args.seed)
    FA.reset_launch_counts()
    with use_mesh_rules(mesh, cell.rules), grad():
        cost, out = measure(cell.fn, real)
        torch.cuda.synchronize()
    launches = dict(FA.LAUNCHES)
    plain = dict(FA.PLAIN_CUDA_CALLS)
    peak = torch.cuda.max_memory_allocated() - before
    del out
    # the donated state / cache was updated in place: the same arguments run again
    with use_mesh_rules(mesh, cell.rules), grad():
        torch.cuda.synchronize()
        t = time.perf_counter()
        again = cell.fn(*real)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t
    del again, real
    gc.collect()
    torch.cuda.empty_cache()
    roof_s = max(rec["compute_s"], rec["memory_s"], rec["collective_s"])
    row = {"arch": arch, "shape": shape, "depth": depth, "batch": batch,
           "predicted_flops": rec["flops_per_device"], "real_flops": cost.flops,
           "predicted_k4": predicted_k4, "k4_launches": launches["flash_attention"],
           "predicted_k4_backward": predicted_bwd,
           "k4_backward_launches": launches["flash_attention_backward"],
           "k4_kernels": launches, "plain_calls": plain,
           "predicted_peak_bytes": rec["memory_stats"]["peak_bytes_per_device"],
           "tracked_peak_bytes": cost.peak_bytes, "max_memory_allocated": peak,
           "roofline_s": roof_s, "dominant": rec["dominant"], "step_s": step_s,
           "roofline_over_step": roof_s / step_s, "trace_s": rec["lower_s"],
           "bytes_per_device": rec["bytes_per_device"]}
    log(f"dry-run {arch} {shape} (depth {depth}, batch {batch}): FLOPs predicted "
        f"{rec['flops_per_device']:.6e} counted {cost.flops:.6e}; K4 {predicted_k4} predicted, "
        f"{launches['flash_attention']} launched; K4 backward {predicted_bwd} predicted, "
        f"{launches['flash_attention_backward']} launched; peak predicted "
        f"{row['predicted_peak_bytes'] / 1e9:.3f} GB, max_memory_allocated {peak / 1e9:.3f} GB; "
        f"roofline {roof_s * 1e3:.2f} ms ({rec['dominant']}) against {step_s * 1e3:.2f} ms "
        f"measured (ratio {row['roofline_over_step']:.3f})")
    if cost.flops != rec["flops_per_device"]:
        raise AssertionError(f"{arch} {shape}: counted FLOPs {cost.flops} != predicted "
                             f"{rec['flops_per_device']}")
    if (launches["flash_attention"] != predicted_k4 or plain["flash_attention"]
            or launches["flash_attention_backward"] != predicted_bwd):
        raise AssertionError(f"{arch} {shape}: K4 launched {launches} (plain {plain}), "
                             f"predicted {predicted_k4} forward, {predicted_bwd} backward")
    if abs(row["predicted_peak_bytes"] - peak) > PEAK_RTOL * peak:
        raise AssertionError(f"{arch} {shape}: predicted peak {row['predicted_peak_bytes']} "
                             f"not within {PEAK_RTOL} of max_memory_allocated {peak}")
    return row


def dryrun_mesh_cells(args) -> dict:
    """``python -m repro_torch.launch.dryrun --mesh single`` over
    :data:`DRYRUN_MESH_CELLS` in a subprocess (a fake group of 256 ranks
    in its own process): rc 0 and every record ``ok``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", "single",
           "--cells", DRYRUN_MESH_CELLS, "--device", "cuda"]
    cmd += ["--smoke"] if args.quick else []
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=DRYRUN_TIMEOUT_S)
    seconds = time.perf_counter() - t
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(("[", "  "))]
    for ln in lines:
        log(f"  {ln}")
    if proc.returncode != 0 or "all dry-run cells OK" not in proc.stdout:
        raise AssertionError(f"the production-mesh dry-run failed (rc {proc.returncode}):\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    recs = {}
    for cell in DRYRUN_MESH_CELLS.split(","):
        arch, shape, *variant = cell.split(":")
        tag = "__".join(["single"] + variant + (["smoke"] if args.quick else []))
        with open(os.path.join(ROOT, "results", "dryrun_torch",
                               f"{arch}__{shape}__{tag}.json")) as f:
            r = json.load(f)
        if not r["ok"] or r["n_chips"] != 256:
            raise AssertionError(f"{cell}: {r}")
        recs[cell] = {k: r[k] for k in ("flops_per_device", "bytes_per_device", "nvlink_bytes",
                                        "network_bytes", "compute_s", "memory_s",
                                        "collective_s", "dominant", "lower_s")}
        recs[cell]["peak_bytes"] = r["memory_stats"]["peak_bytes_per_device"]
    log(f"production-mesh dry-run: {len(recs)} cells ok in {seconds:.1f} s")
    return {"cells": recs, "seconds": seconds, "cmd": " ".join(cmd[1:])}


def dryrun_phase(args) -> dict:
    """Phase 12: the dry-run.  (a) Each of :data:`DRYRUN_HOST_CELLS` on a
    one-rank host mesh: predicted over fake tensors, then run for real on
    the card through K4 (:func:`dryrun_host_cell`): the FLOPs counted on
    the real run must equal the prediction, K4's launches the op count the
    dry-run traced, and the predicted peak be within ``PEAK_RTOL`` of
    ``max_memory_allocated``; the roofline's time beside the measured step
    time is printed, not gated.  (b) :func:`dryrun_mesh_cells` on the
    production mesh of 256 ranks.  ``--quick`` runs the ``SMOKE``
    configs."""
    import torch

    t0 = time.perf_counter()
    # the first GEMM on a stream allocates cuBLAS's workspace (32 MiB on
    # Hopper) through the caching allocator: let that happen before a peak
    # is read, as the earlier phases do in the full run
    torch.ones(8, 8, device="cuda") @ torch.ones(8, 8, device="cuda")
    torch.cuda.synchronize()
    rec = {"host": [dryrun_host_cell(args, *c) for c in DRYRUN_HOST_CELLS]}
    rec["production"] = dryrun_mesh_cells(args)
    rec["phase_s"] = time.perf_counter() - t0
    log(f"dry-run phase: {rec['phase_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# Phase 13: examples/train_lm.py's lm-100m through launch/train_lm.py
# ---------------------------------------------------------------------------

TRAIN_LM_CKPT = os.path.join(ROOT, "build", "ckpt_lm100m")
# (steps, resumed to) of the launcher's two runs; --quick takes the second
TRAIN_LM_STEPS = {False: (300, 350), True: (30, 35)}
TRAIN_LM_BATCH, TRAIN_LM_SEQ = 4, 128            # the example's defaults
# step 0 on the card against the port's step 0 on the CPU: float32 on
# both sides (no TF32), so only the order of float32 sums differs: ~10
# float32 units of the loss, ~1e-5 of the norm (the gaps measured are 0
# and 6.6e-8)
LM100M_LOSS_RTOL = 1e-6
LM100M_NORM_RTOL = 1e-5
# faults planted in K4's forward kernel for one step 0 on the card each,
# which the gate above must refuse: (q, k, v, causal) as the kernel is
# launched; BACKWARD_PLANTS are planted in its backward kernel's launch the
# same way
LM100M_PLANTS = {
    "no_causal_mask": lambda q, k, v, causal: (q, k, v, False),
    "kv_heads_reversed": lambda q, k, v, causal: (q, k.flip(2).contiguous(),
                                                  v.flip(2).contiguous(), causal),
}


def _window_step_s(log_times) -> tuple:
    """Seconds a step over each window between two of the launcher's log
    lines (each read a loss: a synchronise), and the windows that neither
    start a checkpoint nor follow one that did (the writer thread shares
    the host's cores with the steps)."""
    from repro_torch.launch.train_lm import SAVE_EVERY

    windows = list(zip(log_times, log_times[1:]))
    saves = [any((i + 1) % SAVE_EVERY == 0 for i in range(i0, i1))
             for (i0, _), (i1, _) in windows]
    per_step = [(t1 - t0) / (i1 - i0) for (i0, t0), (i1, t1) in windows]
    steady = [w for j, w in enumerate(per_step) if not saves[j] and not (j and saves[j - 1])]
    return per_step, steady


def train_lm_phase(args) -> tuple:
    """Phase 13: ``repro_torch.launch.train_lm`` on ``lm-100m`` at the
    example's full width, depth and defaults.  Returns the record and K4's
    float32 rows, the forward with lse and the backward (their launches
    are the 300-step run's)."""
    import shutil
    import statistics

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import train_lm
    from repro_torch.models import transformer
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import steps as steps_lib
    from repro_torch.train.checkpoint import restore_checkpoint

    t0 = time.perf_counter()
    steps, resume_to = TRAIN_LM_STEPS[args.quick]
    B, T = TRAIN_LM_BATCH, TRAIN_LM_SEQ
    tf32 = {"matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}
    log(f"lm-100m: TF32 settings {json.dumps(tf32)}")
    cfg = train_lm.model_100m(log=log)
    per_step = cfg.n_layers      # one K4 forward and backward a layer: no remat, one microbatch

    # step 0 on the CPU: the launcher's params (seed 0, drawn on the card)
    # and its first batch, through the same loss and gradients
    params = transformer.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                     "cuda", dtype=transformer.torch_dtype(cfg.param_dtype))
    cpu_params = opt_lib.tree_map(lambda t: t.cpu(), params)
    first = {k: torch.from_numpy(v) for k, v in
             next(iter(TokenPipeline(cfg.vocab_size, T, B))).items()}
    t = time.perf_counter()
    grad_fn = steps_lib.make_grad_fn(lambda p, b: steps_lib.lm_loss(p, b, cfg))
    cpu_loss, _, grads = grad_fn(cpu_params, first)
    cpu_loss, cpu_norm = float(cpu_loss), float(opt_lib.global_norm(grads))
    cpu_s = time.perf_counter() - t
    del cpu_params, grads

    def gaps(loss, norm):
        return abs(loss - cpu_loss) / abs(cpu_loss), abs(norm - cpu_norm) / abs(cpu_norm)

    def passes(loss, norm):
        loss_gap, norm_gap = gaps(loss, norm)
        return loss_gap <= LM100M_LOSS_RTOL and norm_gap <= LM100M_NORM_RTOL

    # the same step 0 on the card with each planted fault in K4's forward
    # kernel, then in its backward kernel (flash_attention_op and
    # flash_attention_backward_op look _launch / _launch_backward up when
    # they run): the gate must refuse every one
    card_first = {k: v.cuda() for k, v in first.items()}
    plants = [(name, "_launch", lambda f, plant=plant: lambda q, k, v, causal, *rest: f(
        *plant(q, k, v, causal), *rest)) for name, plant in LM100M_PLANTS.items()]
    plants += [(f"backward_{name}", attr, wrap) for name, (attr, wrap) in BACKWARD_PLANTS.items()]
    planted = {}
    for name, attr, wrap in plants:
        orig = getattr(FA, attr)
        setattr(FA, attr, wrap(orig))
        try:
            loss, _, grads = grad_fn(params, card_first)
            loss, norm = float(loss), float(opt_lib.global_norm(grads))
        finally:
            setattr(FA, attr, orig)
        planted[name] = {"loss": loss, "grad_norm": norm, "rel_gaps": gaps(loss, norm),
                         "refused": not passes(loss, norm)}
        del grads
    del params, card_first
    log(f"lm-100m: step 0 on the card under planted K4 faults: {json.dumps(planted)}")

    # the example's run: launches zeroed just before, read just after
    shutil.rmtree(TRAIN_LM_CKPT, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launch_counts()
    t = time.perf_counter()
    run = train_lm.train(cfg, steps=steps, batch=B, seq=T, checkpoint_dir=TRAIN_LM_CKPT,
                         device="cuda", log=lambda line: log(f"  {line}"))
    run_s = time.perf_counter() - t
    launches, plain = dict(FA.LAUNCHES), dict(FA.PLAIN_CUDA_CALLS)
    peak = torch.cuda.max_memory_allocated()
    losses, norms = run["losses"], run["grad_norms"]
    windows, steady = _window_step_s(run["log_times"])
    step_s = statistics.median(windows)
    steady_s = statistics.median(steady)
    loss_gap, norm_gap = gaps(losses[0], norms[0])
    rec = {"config": dataclasses.asdict(cfg), "n_params": cfg.n_params(), "tf32": tf32,
           "steps": steps, "batch": B, "seq": T,
           "step0": {"card": {"loss": losses[0], "grad_norm": norms[0]},
                     "cpu": {"loss": cpu_loss, "grad_norm": cpu_norm, "s": cpu_s},
                     "loss_rel_gap": loss_gap, "norm_rel_gap": norm_gap,
                     "rtol": [LM100M_LOSS_RTOL, LM100M_NORM_RTOL], "planted": planted},
           "losses_every_10": losses[::10] + [losses[-1]], "grad_norms_every_10": norms[::10],
           "run_s": run_s, "run_step_s": run_s / steps, "run_tokens_per_s": steps * B * T / run_s,
           "window_step_s": windows, "median_step_s": step_s,
           "tokens_per_s": B * T / step_s, "steady_median_step_s": steady_s,
           "steady_tokens_per_s": B * T / steady_s, "peak_memory_bytes": peak,
           "k4_launches": launches, "plain_cuda_calls": plain}
    log(f"lm-100m: step 0 loss {losses[0]} / grad norm {norms[0]} on the card, {cpu_loss} / "
        f"{cpu_norm} on the CPU (relative gaps {loss_gap:.3e} / {norm_gap:.3e}; rtol "
        f"{LM100M_LOSS_RTOL} / {LM100M_NORM_RTOL})")
    log(f"lm-100m: {steps} steps in {run_s:.3f} s, {rec['run_step_s'] * 1e3:.2f} ms a step "
        f"({rec['run_tokens_per_s']:,.0f} tokens / s) with the checkpoint writes; median of "
        f"the log windows {step_s * 1e3:.2f} ms, {steady_s * 1e3:.2f} ms away from the "
        f"writes; peak {peak / 1e9:.3f} GB; K4 {json.dumps(launches)}; plain "
        f"{json.dumps(plain)}")
    if not passes(losses[0], norms[0]):
        raise AssertionError(f"lm-100m step 0: card ({losses[0]}, {norms[0]}) against CPU "
                             f"({cpu_loss}, {cpu_norm})")
    if not all(p["refused"] for p in planted.values()):
        raise AssertionError(f"lm-100m step 0: the gate passes a planted K4 fault: {planted}")
    want = dict.fromkeys(launches, 0)
    want.update(flash_attention=steps * per_step, flash_attention_f32_lse=steps * per_step,
                flash_attention_backward=steps * per_step,
                flash_attention_backward_f32=steps * per_step)
    if launches != want:
        raise AssertionError(f"lm-100m K4 launches {launches}, expected {want}")
    if plain != {"flash_attention": 0, "flash_attention_backward": 0}:
        raise AssertionError(f"lm-100m plain attention calls on the card: {plain}")
    if len(losses) != steps or not np.all(np.isfinite(losses + norms)):
        raise AssertionError(f"lm-100m: {len(losses)} losses, finite "
                             f"{bool(np.all(np.isfinite(losses + norms)))}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"lm-100m: loss at step {steps - 1} {losses[-1]} is not below "
                             f"step 0's {losses[0]}")

    # the checkpoint at the last step, read back: the run's final state bit for bit
    state = run.pop("state")
    restored, at = restore_checkpoint(TRAIN_LM_CKPT, device="cuda")
    pairs = [(p, v, opt_lib.tree_get(restored[key], p)) for key in ("params", "opt")
             for p, v in opt_lib.tree_paths(state[key])]
    same = (at == steps and int(restored["step"]) == int(state["step"]) == steps
            and all(torch.equal(v, r) for _, v, r in pairs))
    rec["checkpoint"] = {"step": at, "leaves": len(pairs), "equal_bits": same,
                         "dir": sorted(os.listdir(TRAIN_LM_CKPT))}
    del restored, pairs
    if not same:
        raise AssertionError(f"lm-100m: the checkpoint at step {at} is not the final state")

    # --resume --steps resume_to
    lines = []

    def keep(line):
        lines.append(line)
        log(f"  {line}")

    FA.reset_launch_counts()
    t = time.perf_counter()
    again = train_lm.train(cfg, steps=resume_to, batch=B, seq=T,
                           checkpoint_dir=TRAIN_LM_CKPT, resume=True, device="cuda", log=keep)
    rec["resume"] = {"s": time.perf_counter() - t, "start": again["start"],
                     "losses": again["losses"], "k4_launches": dict(FA.LAUNCHES),
                     "plain_cuda_calls": dict(FA.PLAIN_CUDA_CALLS),
                     "first_line": lines[0], "dir": sorted(os.listdir(TRAIN_LM_CKPT))}
    resumed = (resume_to - steps) * per_step
    if (lines[0] != f"resumed from step {steps}" or again["start"] != steps
            or len(again["losses"]) != resume_to - steps
            or not np.all(np.isfinite(again["losses"]))
            or FA.LAUNCHES["flash_attention_f32_lse"] != resumed
            or FA.LAUNCHES["flash_attention_backward_f32"] != resumed
            or FA.PLAIN_CUDA_CALLS["flash_attention_backward"] != 0):
        raise AssertionError(f"lm-100m resume: {json.dumps(rec['resume'])}")
    shutil.rmtree(TRAIN_LM_CKPT, ignore_errors=True)

    # one more step under the profiler (its launches do not count)
    state = again.pop("state")
    step_fn = steps_lib.build_lm_train_step(
        cfg, opt_lib.adamw(opt_lib.cosine_schedule(3e-4, 50, resume_to)))
    batch = next(TokenPipeline(cfg.vocab_size, T, B).device_iter("cuda"))
    before = dict(FA.LAUNCHES), dict(FA.PLAIN_CUDA_CALLS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state, m = step_fn(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    FA.LAUNCHES.update(before[0])
    FA.PLAIN_CUDA_CALLS.update(before[1])
    split = trace_split(prof)
    # idle against the profiled step's wall (the profiler slows the host)
    # and against the run's unprofiled steady step
    split.update(wall_s=wall, idle_share=1.0 - split["device_busy_s"] / wall,
                 idle_share_of_steady_step=1.0 - split["device_busy_s"] / steady_s)
    rec["profiled_step"] = split
    log(f"lm-100m profiled step: {json.dumps(split)}")
    log(f"lm-100m step: median {step_s * 1e3:.2f} ms over the log windows, "
        f"{steady_s * 1e3:.2f} ms away from the writes; profiled step "
        f"{split['n_kernels']} kernels, busy {split['device_busy_s'] * 1e3:.3f} ms "
        f"(attention backward {split['attention_backward_s'] * 1e3:.3f} ms), idle share "
        f"{split['idle_share']:.3f} of its wall, {split['idle_share_of_steady_step']:.3f} of "
        f"the steady step")
    del state, step_fn, again, run

    # K4's float32 row at the step's attention shape
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    hd = cfg.resolved_head_dim
    q = torch.randn((B, T, cfg.n_heads, hd), generator=gen, device="cuda")
    k = torch.randn((B, T, cfg.n_kv_heads, hd), generator=gen, device="cuda")
    v = torch.randn((B, T, cfg.n_kv_heads, hd), generator=gen, device="cuda")
    rows = [k4_lse_row("flash_attention_f32_lse", q, k, v,
                       launches["flash_attention_f32_lse"], args.reps),
            k4_backward_row("flash_attention_backward_f32", q, k, v,
                            launches["flash_attention_backward_f32"], per_step, args.reps)]
    rec["phase_s"] = time.perf_counter() - t0
    log(f"lm-100m phase: {rec['phase_s']:.1f} s")
    return rec, rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--authors", type=int, default=50_000)
    ap.add_argument("--pubs", type=int, default=100_000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--quick", action="store_true",
                    help="a first check of changed kernels: DBLP 3000 authors / 6000 "
                         "pubs, layered_1 at 600 nodes, DEDUP-1 at 300 / 600, "
                         "256 / 64-token prompts with 4 new tokens, and lm-100m "
                         "trained 30 steps")
    ap.add_argument("--only-dryrun", action="store_true",
                    help="build the kernels and run phase 12 alone (a first check of "
                         "the dry-run; prints no result line)")
    args = ap.parse_args()
    if args.quick:
        args.authors, args.pubs = 3000, 6000

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from repro_torch.kernels import build

    record = {}
    t0 = time.perf_counter()
    build.build_all()
    record["build_s"] = time.perf_counter() - t0
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} cc {torch.cuda.get_device_capability(0)}")
    log(f"kernels built in {record['build_s']:.1f} s")
    for name in build.LIBRARIES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    if args.only_dryrun:
        record["dryrun"] = dryrun_phase(args)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_dryrun.json"), "w") as f:
            json.dump(record, f, indent=1)
        log("phase 12 alone: no result line")
        return 0

    rows = graph_phases(args, record)
    # a tier and its tenants form a reference cycle (each tenant's version
    # listener closes over the tier): collect it, so that the LM phase
    # starts with the graph phases' uploads freed
    gc.collect()
    torch.cuda.empty_cache()
    lm = lm_phase(args)
    rows += lm.pop("kernels")
    gc.collect()
    torch.cuda.empty_cache()
    training, train_rows = training_phase(args)
    rows += train_rows
    gc.collect()
    torch.cuda.empty_cache()
    moe_rec, moe_rows = moe_phase(args)
    rows += moe_rows
    gc.collect()
    torch.cuda.empty_cache()
    sharded = sharded_phase(args, moe_rec["granite_training"])
    gc.collect()
    torch.cuda.empty_cache()
    dry = dryrun_phase(args)
    gc.collect()
    torch.cuda.empty_cache()
    train_lm_rec, train_lm_rows = train_lm_phase(args)
    rows += train_lm_rows
    record.update({"card": card, "lm": lm, "training": training, "moe": moe_rec,
                   "sharded": sharded, "dryrun": dry, "train_lm": train_lm_rec,
                   "args": vars(args), "kernels": rows})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("layout_bound_ms", "tier_launches", "distributed_launches", "chunks", "gb_per_s")
    print(json.dumps({"kernels": [{k: r[k] for k in keys + extra if k in r} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
