"""Continuous-batching multi-tenant graph serving tier (DESIGN.md §10).

:class:`~repro_torch.serve.server.GraphQueryServer` is a synchronous
flush-the-queue loop over one graph: every flush is a barrier (a query
arriving just after a round starts waits for the *whole* round, every
kind's batches included) and one process serves one graph.  This module
rebuilds serving around the economics that matter at scale:

* **Continuous batching** — queries are admitted into per-``(tenant,
  kind)`` queues and executed one bucket-padded batch at a time; after
  every batch the scheduler re-admits whatever arrived in the meantime
  and picks the queue with the oldest waiting request.  There is no
  flush barrier: the worst-case wait is one batch, not one round.  (The
  lockstep-invariant machinery from ``BatchedServer.step`` generalizes:
  a batch slot is a fixed compiled width, admission fills it from the
  live queue, and freeing it re-opens admission immediately.)
* **Multi-graph tenancy under a residency budget** — one process serves
  many extracted graphs.  Host graphs (plus their DEDUP-C corrections)
  stay resident; *device* operands are uploaded lazily and LRU-evicted
  under a byte budget (:class:`~repro_torch.core.engine.ResidencyBudget`,
  the serving twin of ``ExtractionBudget``'s assembly account, charged
  with every byte the card holds for the tenant, the K1-K3 row indices
  included).  Eviction is loss-free: a re-upload from the same host
  arrays is byte-identical, so an evicted tenant's next query answers
  with the exact same bytes.
* **Executable cache** — propagation callables are keyed on ``(kind,
  bucket width, graph shape signature)`` with warm LRU eviction, as the
  JAX package keys its compiled executables.  The port traces nothing:
  an entry holds the plain callable the JAX package would have traced,
  and its ``traces`` count counts builds (and, for the host-driven kinds,
  calls, as the JAX package's untraced host kinds do), so hits, misses
  and evictions equal the JAX package's for the same request stream.
  The signature (:func:`~repro_torch.core.engine.graph_shape_signature`)
  excludes ``graph_version``, and dispatch normalizes the version to 0,
  so bucket churn, version churn, and distinct tenants whose graphs
  share a shape all reuse one entry.
* **Result cache keyed on GraphVersion** — queries are idempotent reads
  of one graph version, so ``(tenant, kind, node, version)`` fully
  determines the answer.  A version bump (from
  :meth:`~repro_torch.core.delta.LiveGraph.apply_delta`, via the registered
  version listener) invalidates exactly that tenant's entries; other
  tenants keep serving from cache.

Version handoff follows the quiesce protocol (see
:meth:`~repro_torch.serve.server.GraphQueryServer.update_graph`): admissions
for the bumped tenant close, its in-flight queries drain against the old
graph (they were validated against the old node space and are owed an
old-version answer), then the host graph, correction, and version swap
and admission reopens.

Uploads go to the tier's ``device`` (default ``"cuda"``; the CPU only
when asked).  A packed tenant on a CUDA device runs its batched steps
through the K1-K3 wrappers under ``backend='auto'``, as
:class:`~repro_torch.serve.server.GraphQueryServer` does.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core import algorithms
from ..core import dedup as _dedup
from ..core import engine as _engine
from ..core.condensed import CondensedGraph
from ..core.engine import (
    DeviceGraph,
    ResidencyBudget,
    ResidencyError,
    device_graph_bytes,
    graph_shape_signature,
    with_graph_version,
)
from .server import ServerStats

__all__ = [
    "ServeRequest",
    "ServeResult",
    "ExecutableCacheStats",
    "ResultCacheStats",
    "GraphServingTier",
    "KINDS",
    "HOST_KINDS",
    "WEIGHTED_KINDS",
]

KINDS = (
    "bfs",
    "ppr",
    "common_neighbors",
    "shortest",
    "widest",
    "scc",
    "triangles",
)

# Host-driven analytics (DESIGN.md §11): computed by a Python-side sweep
# of batched propagations rather than one (n, B) call.  The whole
# batch shares one sweep, and the per-(tenant, kind, node, version)
# result cache absorbs repeats.
HOST_KINDS = frozenset({"scc", "triangles"})

# Kinds whose executables take the tenant's per-virtual-layer weights as
# a call argument — weights are tenant state, but executables are shared
# across tenants by (kind, width, shape signature), so they must never be
# closed over.
WEIGHTED_KINDS = frozenset({"shortest", "widest"})


@dataclasses.dataclass
class ServeRequest:
    """One tenant-addressed analytics request.

    ``graph_version`` pins the version the client resolved ``node``
    against (``None`` = whatever the tenant currently serves); a mismatch
    with the tenant's live version is rejected at submit.
    ``arrival_time`` is the load-generator timestamp (seconds, virtual)
    used by :meth:`GraphServingTier.run_load` for latency accounting."""

    qid: int
    tenant: str
    kind: str
    node: int
    graph_version: Optional[int] = None
    arrival_time: float = 0.0


@dataclasses.dataclass
class ServeResult:
    """One answered request: the ``(n,)`` result vector plus how it was
    served — from the result cache or inside a batch of ``batch_fill``
    real queries padded to ``batch_width`` slots — and when (virtual
    clock seconds; ``latency = done_time - arrival_time``)."""

    qid: int
    tenant: str
    kind: str
    node: int
    value: np.ndarray
    graph_version: int
    cached: bool
    arrival_time: float
    done_time: float
    batch_width: int = 0
    batch_fill: int = 0

    @property
    def latency(self) -> float:
        return self.done_time - self.arrival_time


@dataclasses.dataclass
class ExecutableCacheStats:
    hits: int = 0
    misses: int = 0          # = executables built
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


@dataclasses.dataclass
class ResultCacheStats:
    hits: int = 0
    misses: int = 0
    invalidated: int = 0     # entries dropped by version bumps

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


@dataclasses.dataclass
class _Executable:
    """One propagation entry: the plain callable plus its build evidence
    (``traces[0]`` is 1 from the build on for the propagating kinds — the
    count the JAX package's one trace per entry gives — and counts calls
    for the host-driven kinds, which the JAX package never traces)."""

    fn: object
    traces: List[int]


class _Tenant:
    """One served graph: host state (authoritative, never evicted) plus
    lazily uploaded device operands (evictable)."""

    def __init__(
        self,
        name: str,
        host: CondensedGraph,
        correction,
        version: int,
        *,
        packed: bool,
        with_counts: bool,
        drop_self_loops: bool,
        pin: bool,
        live=None,
        layer_weights=None,
        layer_capacities=None,
    ):
        self.name = name
        self.host = host
        self.correction = correction
        self.version = int(version)
        self.packed = packed
        self.with_counts = with_counts
        self.drop_self_loops = drop_self_loops
        self.pin = pin
        self.live = live
        self.layer_weights = layer_weights
        self.layer_capacities = layer_capacities
        self.quiescing = False
        # device residency (None = evicted / never uploaded)
        self.device: Optional[DeviceGraph] = None
        self.counts_device: Optional[DeviceGraph] = None
        self.resident_bytes = 0
        self.last_used = 0
        self.n_uploads = 0

    @property
    def n_nodes(self) -> int:
        return self.host.n_real

    def graph_for(self, kind: str) -> DeviceGraph:
        if kind == "common_neighbors" and self.counts_device is not None:
            return self.counts_device
        return self.device

    def weights_for(self, kind: str):
        """Per-virtual-layer weight tensors passed to weighted executables
        at call time (None = unweighted: hop-count distances /
        reachability widths)."""
        return self.layer_weights if kind == "shortest" else self.layer_capacities


class GraphServingTier:
    """Continuous-batching serving front-end over many tenant graphs.

    Two driving modes share one scheduler:

    * :meth:`submit` + :meth:`step`/:meth:`drain` — event-style: submit
      admits (answering result-cache hits immediately), each step
      executes exactly one bucket-padded batch for the queue with the
      oldest waiting request, then control returns so new arrivals can be
      admitted before the next batch.  ``serve(requests)`` is the
      submit-all-then-drain convenience.
    * :meth:`run_load` — the load-generator loop: requests carry virtual
      ``arrival_time`` stamps; the clock advances by each batch's *real*
      measured execution time, so the per-request latencies are honest
      service times under the offered schedule.

    ``budget`` caps device residency across all tenants; ``None`` means
    unbounded.  ``max_executables`` caps the warm executable cache.
    ``device`` receives every upload; a CUDA device without a card
    raises.
    """

    def __init__(
        self,
        *,
        max_batch: int = 32,
        bucket_widths: Tuple[int, ...] = (8, 16, 32),
        budget: Optional[ResidencyBudget] = None,
        max_executables: int = 64,
        ppr_iters: int = 20,
        damping: float = 0.85,
        bfs_max_iters: Optional[int] = None,
        result_cache: bool = True,
        device="cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "GraphServingTier(device='cuda') needs a CUDA device; pass "
                "device='cpu' to serve on the host"
            )
        self.max_batch = int(max_batch)
        widths = sorted(
            {int(w) for w in bucket_widths if 0 < int(w) < self.max_batch}
        )
        self.bucket_widths: Tuple[int, ...] = tuple(widths) + (self.max_batch,)
        self.budget = budget if budget is not None else ResidencyBudget()
        self.max_executables = int(max_executables)
        self.ppr_iters = int(ppr_iters)
        self.damping = float(damping)
        self.bfs_max_iters = bfs_max_iters
        self.result_cache_enabled = bool(result_cache)

        self.tenants: Dict[str, _Tenant] = {}
        # per-(tenant, kind) FIFO queues — the continuous-batching slots
        # fill from these, oldest head first
        self._queues: "collections.OrderedDict[Tuple[str, str], List[ServeRequest]]" = (
            collections.OrderedDict()
        )
        self._pending_qids: set = set()
        self.now = 0.0
        self._tick = 0
        # caches
        self._executables: "collections.OrderedDict[Tuple[str, int, str], _Executable]" = (
            collections.OrderedDict()
        )
        self.exec_stats = ExecutableCacheStats()
        self._results: Dict[Tuple[str, str, int, int], np.ndarray] = {}
        self.result_stats = ResultCacheStats()
        # batching efficiency (occupancy / padding waste / width census)
        self.stats = ServerStats()
        # results produced out-of-band by a version-bump drain handoff
        self._handoff: List[ServeResult] = []

    # -- tenancy --------------------------------------------------------------

    def add_tenant(
        self,
        name: str,
        source: Union[CondensedGraph, "object"],
        *,
        correction=None,
        packed: bool = False,
        with_counts: bool = True,
        drop_self_loops: bool = True,
        pin: bool = False,
        budget_triples: Optional[int] = None,
        layer_weights=None,
        layer_capacities=None,
    ) -> None:
        """Register one graph for serving.  ``source`` is a host
        :class:`CondensedGraph` or a live
        :class:`~repro_torch.core.delta.LiveGraph` — for a live source the tier
        registers a version listener, so every ``apply_delta`` drives the
        quiesce-drain-swap handoff and result-cache invalidation
        automatically.  ``correction`` defaults to a fresh streamed
        DEDUP-C build (under ``budget_triples`` when given); ``packed``
        uploads bit-packed SpMM operands
        (:func:`~repro_torch.core.engine.to_device_packed`).  ``pin``
        exempts the tenant from LRU eviction.  ``layer_weights`` /
        ``layer_capacities`` carry the tenant's per-virtual-layer edge
        properties for the ``shortest`` / ``widest`` kinds (see
        :func:`~repro_torch.core.engine.propagate`); they are tenant
        state, held on the tier's device and handed to the shared
        executables as call arguments."""
        if name in self.tenants:
            raise ValueError(f"tenant {name!r} already registered")
        live = None
        if hasattr(source, "apply_delta") and hasattr(source, "graph"):
            live = source
            host = live.graph
            version = int(live.version)
        else:
            host = source
            version = 0
        if correction is None:
            correction = _dedup.build_correction_streaming(
                host,
                budget_triples=budget_triples,
                drop_self_loops=drop_self_loops,
            )
        def _as_weight_pytree(lw, what):
            if lw is None:
                return None
            # Validate against the host chain structure here, at admission,
            # so a mismatch fails with the tenant's name instead of deep
            # inside a serve step.
            if len(lw) != len(host.chains):
                raise ValueError(
                    f"tenant {name!r}: {what} must cover all "
                    f"{len(host.chains)} chains; got {len(lw)}"
                )
            for ci, (cw, chain) in enumerate(zip(lw, host.chains)):
                n_virt = len(chain.edges) - 1
                if len(cw) != n_virt:
                    raise ValueError(
                        f"tenant {name!r}: chain {ci} has {n_virt} virtual "
                        f"layers; got {len(cw)} {what} arrays"
                    )
            return tuple(
                tuple(
                    torch.as_tensor(
                        np.asarray(w, dtype=np.float32), device=self.device
                    )
                    for w in chain_w
                )
                for chain_w in lw
            )

        tenant = _Tenant(
            name, host, correction, version,
            packed=packed, with_counts=with_counts,
            drop_self_loops=drop_self_loops, pin=pin, live=live,
            layer_weights=_as_weight_pytree(layer_weights, "layer_weights"),
            layer_capacities=_as_weight_pytree(
                layer_capacities, "layer_capacities"
            ),
        )
        self.tenants[name] = tenant
        if live is not None:
            def _listener(graph, new_version, _name=name):
                self._refresh_tenant(_name, graph, int(new_version))

            live.add_version_listener(_listener)
            tenant._listener = _listener

    def update_tenant(self, name: str, graph: CondensedGraph, version: int) -> List[ServeResult]:
        """Manual version handoff for tenants not backed by a
        :class:`LiveGraph`: quiesce, drain in-flight against the old
        graph, swap host state, invalidate the result cache.  Returns the
        drained results (old-version answers)."""
        return self._refresh_tenant(name, graph, version)

    def _refresh_tenant(self, name: str, graph: CondensedGraph, version: int) -> List[ServeResult]:
        tenant = self.tenants[name]
        if version <= tenant.version:
            raise ValueError(
                f"tenant {name!r} version must increase: {version} <= "
                f"{tenant.version}"
            )
        tenant.quiescing = True
        try:
            drained = self._drain_tenant(name)
            self._evict_device(tenant, invalidation=True)
            tenant.host = graph
            tenant.correction = _dedup.build_correction_streaming(
                graph, drop_self_loops=tenant.drop_self_loops
            )
            tenant.version = int(version)
            self.invalidate_results(name)
        finally:
            tenant.quiescing = False
        self._handoff.extend(drained)
        return drained

    def _drain_tenant(self, name: str) -> List[ServeResult]:
        out: List[ServeResult] = []
        while any(t == name and q for (t, _), q in self._queues.items()):
            out.extend(self.step(tenant=name))
        return out

    # -- residency ------------------------------------------------------------

    def _ensure_resident(self, tenant: _Tenant) -> None:
        self._tick += 1
        tenant.last_used = self._tick
        if tenant.device is not None:
            return
        to_dev = _engine.to_device_packed if tenant.packed else _engine.to_device
        exact = to_dev(
            tenant.host,
            correction=tenant.correction,
            drop_self_loops=tenant.drop_self_loops,
            graph_version=tenant.version,
            device=self.device,
        )
        counts = None
        nbytes = device_graph_bytes(exact)
        if tenant.with_counts:
            counts = to_dev(
                tenant.host, drop_self_loops=False,
                graph_version=tenant.version, device=self.device,
            )
            nbytes += device_graph_bytes(counts)
        while not self.budget.would_fit(nbytes):
            if not self._evict_lru(exclude=tenant.name):
                break   # nothing left to evict: charge() raises below
        self.budget.charge(nbytes, f"tenant {tenant.name!r}")
        tenant.device = exact
        tenant.counts_device = counts
        tenant.resident_bytes = nbytes
        tenant.n_uploads += 1

    def _evict_device(self, tenant: _Tenant, invalidation: bool = False) -> None:
        if tenant.device is None:
            return
        self.budget.release(tenant.resident_bytes, evicted=not invalidation)
        tenant.device = None
        tenant.counts_device = None
        tenant.resident_bytes = 0

    def _evict_lru(self, exclude: Optional[str] = None) -> bool:
        """Evict the least-recently-used unpinned resident tenant;
        returns False when there is nothing left to evict."""
        candidates = [
            t for t in self.tenants.values()
            if t.device is not None and not t.pin and t.name != exclude
        ]
        if not candidates:
            return False
        victim = min(candidates, key=lambda t: t.last_used)
        self._evict_device(victim)
        return True

    def evict_tenant(self, name: str) -> None:
        """Explicitly drop one tenant's device operands (host state and
        caches stay; the next query re-uploads byte-identically)."""
        self._evict_device(self.tenants[name])

    # -- caches ---------------------------------------------------------------

    def invalidate_results(self, tenant: Optional[str] = None) -> int:
        """Drop cached results — one tenant's (a version bump: its old
        version's answers are unreachable anyway, reclaim the memory) or
        everyone's.  Returns the number of entries dropped."""
        if tenant is None:
            n = len(self._results)
            self._results.clear()
        else:
            keys = [k for k in self._results if k[0] == tenant]
            for k in keys:
                del self._results[k]
            n = len(keys)
        self.result_stats.invalidated += n
        return n

    def _executable(self, kind: str, width: int, signature: str) -> _Executable:
        key = (kind, width, signature)
        entry = self._executables.get(key)
        if entry is not None:
            self._executables.move_to_end(key)
            self.exec_stats.hits += 1
            return entry
        entry = self._build_executable(kind)
        self._executables[key] = entry
        self.exec_stats.misses += 1
        while len(self._executables) > self.max_executables:
            self._executables.popitem(last=False)
            self.exec_stats.evictions += 1
        return entry

    def _build_executable(self, kind: str) -> _Executable:
        # traces[0]: 1 per build for the propagating kinds, 1 per call for
        # the host-driven ones — the JAX package's trace counts
        traces = [0 if kind in HOST_KINDS else 1]
        if kind == "bfs":
            max_iters = self.bfs_max_iters

            def raw(graph, sources):
                return algorithms.bfs_multi(graph, sources, max_iters=max_iters)

        elif kind == "ppr":
            damping, iters = self.damping, self.ppr_iters

            def raw(graph, sources):
                seeds = algorithms.one_hot_frontier(
                    algorithms.n_nodes(graph), sources, device=graph.device
                )
                return algorithms.personalized_pagerank(
                    graph, seeds, damping=damping, num_iters=iters
                )

        elif kind == "common_neighbors":

            def raw(graph, sources):
                return algorithms.common_neighbors_multi(graph, sources)

        elif kind == "shortest":

            def raw(graph, sources, layer_weights):
                return algorithms.shortest_paths_multi(
                    graph, sources, layer_weights=layer_weights
                )

        elif kind == "widest":

            def raw(graph, sources, layer_capacities):
                return algorithms.widest_paths_multi(
                    graph, sources, layer_capacities=layer_capacities
                )

        elif kind == "scc":
            # host-driven: one pivot sweep answers the whole batch — each
            # column is the queried node's SCC membership indicator
            def raw(graph, sources):
                traces[0] += 1
                labels = algorithms.scc_labels(graph)
                cols = labels[np.asarray(sources)]
                return (labels[:, None] == cols[None, :]).astype(np.float32)

        else:  # triangles
            # host-driven whole-graph analytic: every column is the full
            # per-node triangle-count vector (the node is a handle, the
            # batch shares one blocked sweep)
            def raw(graph, sources):
                traces[0] += 1
                t = algorithms.triangle_counts(graph).astype(np.float32)
                return np.tile(t[:, None], (1, int(np.asarray(sources).size)))

        return _Executable(fn=raw, traces=traces)

    # -- admission ------------------------------------------------------------

    def _validate(self, req: ServeRequest) -> _Tenant:
        tenant = self.tenants.get(req.tenant)
        if tenant is None:
            raise ValueError(
                f"unknown tenant {req.tenant!r}; serving "
                f"{sorted(self.tenants)}"
            )
        if tenant.quiescing:
            raise ValueError(
                f"tenant {req.tenant!r} is quiescing for a version "
                f"handoff; resubmit after the swap"
            )
        if req.kind not in KINDS:
            raise ValueError(f"unknown query kind {req.kind!r}")
        if (
            req.graph_version is not None
            and int(req.graph_version) != tenant.version
        ):
            raise ValueError(
                f"stale graph_version {int(req.graph_version)} for tenant "
                f"{req.tenant!r}: serving version {tenant.version}; "
                f"re-resolve the node id and resubmit"
            )
        if not 0 <= req.node < tenant.n_nodes:
            raise ValueError(
                f"node {req.node} out of range for tenant {req.tenant!r} "
                f"with {tenant.n_nodes} nodes"
            )
        if req.qid in self._pending_qids:
            raise ValueError(
                f"qid {req.qid} already pending; answers are keyed by qid"
            )
        return tenant

    def submit(self, req: ServeRequest) -> Optional[ServeResult]:
        """Admit one request.  A result-cache hit completes immediately
        (the returned :class:`ServeResult`); otherwise the request joins
        its ``(tenant, kind)`` queue and ``None`` is returned — the
        answer arrives from a later :meth:`step`."""
        tenant = self._validate(req)
        self.now = max(self.now, req.arrival_time)
        key = (req.tenant, req.kind, int(req.node), tenant.version)
        if self.result_cache_enabled:
            hit = self._results.get(key)
            if hit is not None:
                self.result_stats.hits += 1
                self.stats.n_queries += 1
                return ServeResult(
                    qid=req.qid, tenant=req.tenant, kind=req.kind,
                    node=req.node, value=hit, graph_version=tenant.version,
                    cached=True, arrival_time=req.arrival_time,
                    done_time=self.now,
                )
            self.result_stats.misses += 1
        qkey = (req.tenant, req.kind)
        self._queues.setdefault(qkey, []).append(req)
        self._pending_qids.add(req.qid)
        return None

    @property
    def n_pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _bucket_width(self, b: int) -> int:
        for w in self.bucket_widths:
            if b <= w:
                return w
        return self.max_batch

    # -- execution ------------------------------------------------------------

    def _pick_queue(self, tenant: Optional[str] = None) -> Optional[Tuple[str, str]]:
        best = None
        best_t = None
        for key, queue in self._queues.items():
            if not queue or (tenant is not None and key[0] != tenant):
                continue
            head = queue[0].arrival_time
            if best is None or head < best_t:
                best, best_t = key, head
        return best

    def step(self, tenant: Optional[str] = None) -> List[ServeResult]:
        """Execute one batch: the queue with the oldest waiting request
        (optionally restricted to one tenant), up to ``max_batch``
        requests, padded to its bucket width.  Advances the virtual
        clock by the batch's measured execution time and returns the
        completed results."""
        key = self._pick_queue(tenant)
        if key is None:
            return []
        tname, kind = key
        queue = self._queues[key]
        group, rest = queue[: self.max_batch], queue[self.max_batch :]
        self._queues[key] = rest
        t = self.tenants[tname]
        t0 = time.perf_counter()
        self._ensure_resident(t)
        graph = t.graph_for(kind)
        width = self._bucket_width(len(group))
        nodes = [int(q.node) for q in group]
        nodes += [nodes[0]] * (width - len(nodes))
        entry = self._executable(
            kind, width, graph_shape_signature(graph)
        )
        call = (with_graph_version(graph, 0), np.asarray(nodes, dtype=np.int64))
        if kind in WEIGHTED_KINDS:
            res = entry.fn(*call, t.weights_for(kind))
        else:
            res = entry.fn(*call)
        if isinstance(res, torch.Tensor):
            res = res.cpu().numpy()
        dt = time.perf_counter() - t0
        self.now += dt
        self.stats.record_batch(len(group), width)
        out: List[ServeResult] = []
        for i, q in enumerate(group):
            value = res[:, i]
            ckey = (tname, kind, int(q.node), t.version)
            if self.result_cache_enabled:
                self._results[ckey] = value
            self._pending_qids.discard(q.qid)
            self.stats.n_queries += 1
            out.append(ServeResult(
                qid=q.qid, tenant=tname, kind=kind, node=q.node,
                value=value, graph_version=t.version, cached=False,
                arrival_time=q.arrival_time, done_time=self.now,
                batch_width=width, batch_fill=len(group),
            ))
        return out

    def take_handoff(self) -> List[ServeResult]:
        """Results drained out-of-band by a version handoff (the bumped
        tenant's in-flight queries, answered at the superseded version)."""
        out, self._handoff = self._handoff, []
        return out

    def drain(self) -> List[ServeResult]:
        """Run :meth:`step` until every queue is empty."""
        out = self.take_handoff()
        while self.n_pending:
            out.extend(self.step())
        return out

    def serve(self, requests: Sequence[ServeRequest]) -> Dict[int, np.ndarray]:
        """Submit-then-drain convenience: ``{qid: (n,) answer}``."""
        out: Dict[int, np.ndarray] = {}
        for req in requests:
            res = self.submit(req)
            if res is not None:
                out[res.qid] = res.value
        for res in self.drain():
            out[res.qid] = res.value
        return out

    def run_load(self, requests: Sequence[ServeRequest]) -> List[ServeResult]:
        """Load-generator loop: admit requests at their virtual arrival
        times, execute batches continuously, advance the clock by real
        measured batch times.  Returns every completion (cache hits
        included) with honest latencies under the offered schedule."""
        reqs = sorted(requests, key=lambda r: r.arrival_time)
        results: List[ServeResult] = []
        i = 0
        while i < len(reqs) or self.n_pending:
            while i < len(reqs) and reqs[i].arrival_time <= self.now + 1e-12:
                res = self.submit(reqs[i])
                i += 1
                if res is not None:
                    results.append(res)
            if self.n_pending == 0:
                if i < len(reqs):
                    self.now = reqs[i].arrival_time
                    continue
                break
            results.extend(self.step())
        results.extend(self.take_handoff())
        return results
