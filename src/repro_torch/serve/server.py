"""Batched serving loops: LM decode over a KV cache, and graph analytics
over a condensed graph.

* :class:`BatchedServer` — fixed-slot LM batch, each slot an independent
  request; prefill admits new requests into free slots; decode advances
  all active slots one token per step (attention through K4 on the card).
* :class:`GraphQueryServer` — the micro-batching front end for
  multi-source graph analytics: queued per-node queries of the same kind
  are fused into one ``(n, B)`` frontier and answered by a single batched
  algorithm call instead of ``B`` serial traversals.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import TransformerConfig
from ..core import algorithms
from ..core.engine import DeviceGraph
from ..models import transformer

__all__ = [
    "Request",
    "BatchedServer",
    "GraphQuery",
    "GraphQueryServer",
    "ServerStats",
]


@dataclasses.dataclass
class ServerStats:
    """Batching efficiency of one flush (or an accumulation of many).

    ``queries_batched`` counts real queries answered by propagation
    batches; ``slots_compiled`` counts the padded bucket slots those
    batches occupied.  Their ratio is the **occupancy** and its complement
    the bucket-padding waste.  ``batch_widths_used`` maps padded width ->
    batches answered at that width."""

    n_queries: int = 0           # queries answered
    n_batches: int = 0           # propagation batches launched
    queries_batched: int = 0     # real queries inside those batches
    slots_compiled: int = 0      # padded slots (sum of bucket widths used)
    batch_widths_used: Dict[int, int] = dataclasses.field(default_factory=dict)

    @property
    def occupancy(self) -> float:
        """Real queries per padded slot in [0, 1]; 1.0 when idle."""
        if self.slots_compiled == 0:
            return 1.0
        return self.queries_batched / self.slots_compiled

    @property
    def padding_waste(self) -> float:
        """Fraction of padded slots that were bucket padding."""
        return 1.0 - self.occupancy

    def record_batch(self, n_real: int, width: int) -> None:
        self.n_batches += 1
        self.queries_batched += int(n_real)
        self.slots_compiled += int(width)
        self.batch_widths_used[width] = (
            self.batch_widths_used.get(width, 0) + 1
        )

    def merge(self, other: "ServerStats") -> None:
        """Fold another flush's stats into this accumulator."""
        self.n_queries += other.n_queries
        self.n_batches += other.n_batches
        self.queries_batched += other.queries_batched
        self.slots_compiled += other.slots_compiled
        for w, c in other.batch_widths_used.items():
            self.batch_widths_used[w] = self.batch_widths_used.get(w, 0) + c


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (T,) integer token ids
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class BatchedServer:
    """Greedy-decode batched server over fixed slots (one card).

    The slot semantics are the JAX package's: :meth:`admit` prefills one
    request into a free slot, :meth:`step` decodes one token for every
    slot at the active slots' common length, :meth:`run` admits every
    pending request whose prompt length matches the active batch and
    defers the rest until the batch drains.

    The batch cache is spliced in place: :meth:`admit` zeroes the slot's
    rows of the batch cache and prefills the prompt straight into them
    (the reference prefills a one-slot cache and copies it in; the slot
    ends up with the same contents).  Prefill and decode run under
    ``torch.inference_mode()``."""

    def __init__(
        self,
        params,
        cfg: TransformerConfig,
        batch_slots: int = 4,
        max_len: int = 256,
    ):
        self.params = params
        self.cfg = cfg
        self.device = params["embed"].device
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.max_len = max_len
        self.cache = transformer.init_cache(cfg, batch_slots, max_len, self.device)
        self.lengths = np.zeros(batch_slots, dtype=np.int64)

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _active_length(self) -> Optional[int]:
        """Common sequence length of the active slots, or None if idle.

        The batch cache has one ``length``, so every active slot must sit
        at the same position; admission enforces that invariant and
        decode preserves it (all active slots advance one token per
        step)."""
        for i, s in enumerate(self.slots):
            if s is not None:
                return int(self.lengths[i])
        return None

    def can_admit(self, req: Request) -> bool:
        """True iff ``admit(req)`` would succeed right now: a slot is free
        and the prompt length matches the active batch (or the batch is
        idle)."""
        if self._free_slot() is None:
            return False
        active = self._active_length()
        return active is None or int(req.prompt.size) == active

    def admit(self, req: Request) -> bool:
        """Prefill a request into a free slot; False when none is free.

        Raises ``ValueError`` on ragged admission — a prompt whose length
        differs from the active slots'.  Use :meth:`can_admit` to defer
        instead."""
        slot = self._free_slot()
        if slot is None:
            return False
        active = self._active_length()
        if active is not None and int(req.prompt.size) != active:
            raise ValueError(
                f"ragged admission: prompt length {int(req.prompt.size)} != "
                f"active batch length {active}; the shared KV cache has one "
                f"scalar length, so all active slots must decode in lockstep. "
                f"Use can_admit() to defer this request until the batch "
                f"drains."
            )
        with torch.inference_mode():
            prompt = torch.as_tensor(
                np.asarray(req.prompt, dtype=np.int64), device=self.device
            )[None, :]
            k = self.cache.k[:, slot:slot + 1]
            v = self.cache.v[:, slot:slot + 1]
            k.zero_()
            v.zero_()
            logits, _, _ = transformer.forward(
                self.params, prompt, self.cfg, transformer.KVCache(k=k, v=v, length=0)
            )
            first = int(torch.argmax(logits[0, -1]))
        req.generated.append(first)
        self.lengths[slot] = req.prompt.size
        self.slots[slot] = req
        return True

    def step(self) -> None:
        """One decode step for every slot (idle slots decode token 0 and
        their answers are dropped, as in the reference)."""
        if all(s is None for s in self.slots):
            return
        tokens = np.zeros((len(self.slots), 1), dtype=np.int64)
        for i, s in enumerate(self.slots):
            if s is not None and s.generated:
                tokens[i, 0] = s.generated[-1]
        # The common active length is the batch position: max() over all
        # slots would let a freed slot's stale length shift every other
        # slot's attention window.
        cache = transformer.KVCache(
            k=self.cache.k, v=self.cache.v, length=self._active_length()
        )
        with torch.inference_mode():
            logits, _, _ = transformer.forward(
                self.params, torch.from_numpy(tokens).to(self.device), self.cfg, cache
            )
            nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            s.generated.append(int(nxt[i]))
            self.lengths[i] += 1
            if len(s.generated) >= s.max_new_tokens:
                s.done = True
                self.slots[i] = None
                self.lengths[i] = 0

    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Serve every request; returns ``{rid: generated tokens}``."""
        pending = list(requests)
        out: Dict[int, List[int]] = {}
        active: List[Request] = []
        while pending or any(self.slots):
            # Admit every pending request whose prompt length matches the
            # active batch (all of them when idle); ragged ones wait.  No
            # livelock: with all slots free any request is admissible, and
            # with active slots step() always makes progress.
            admitted = True
            while admitted:
                admitted = False
                for j, r in enumerate(pending):
                    if self.can_admit(r):
                        self.admit(pending.pop(j))
                        active.append(r)
                        admitted = True
                        break
            self.step()
            for r in active:
                if r.done:
                    out[r.rid] = r.generated
            active = [r for r in active if not r.done]
        for r in requests:
            out.setdefault(r.rid, r.generated)
        return out


@dataclasses.dataclass
class GraphQuery:
    """One node-seeded analytics request.

    ``kind``: ``'bfs'`` (hop distances), ``'ppr'`` (personalized PageRank
    from a one-hot restart at ``node``), or ``'common_neighbors'``
    (path-multiplicity scores; answered from a duplicate-counting graph).

    ``graph_version``: the graph version the client computed ``node``
    against.  ``None`` means "whatever the server holds"; a mismatch with
    the server's current version is rejected at submit time.
    """

    qid: int
    kind: str
    node: int
    graph_version: Optional[int] = None


class GraphQueryServer:
    """Micro-batching graph-analytics server over one device graph.

    Incoming queries are queued with :meth:`submit`; :meth:`flush` groups
    them by kind, packs up to ``max_batch`` sources into one ``(n, B)``
    frontier, and answers the whole group with a single batched algorithm
    call (:func:`~repro_torch.core.algorithms.bfs_multi` & friends).
    """

    def __init__(
        self,
        graph: DeviceGraph,
        max_batch: int = 32,
        ppr_iters: int = 20,
        damping: float = 0.85,
        bfs_max_iters: Optional[int] = None,
        counts_graph: Optional[DeviceGraph] = None,
        bucket_widths: Tuple[int, ...] = (8, 16, 32),
        graph_version: Optional[int] = None,
    ):
        """``graph`` must be duplicate-exact (EXP / DEDUP-C / DEDUP-1) for
        ``'ppr'`` queries; ``'common_neighbors'`` queries are answered from
        ``counts_graph`` (a raw C-DUP, typically kept *with* self loops so
        the multiplicity signal survives), defaulting to ``graph``.

        ``bucket_widths``: flush groups are padded up to the smallest of
        these fixed widths (capped by ``max_batch``), so the batched
        propagations see a bounded set of shapes.

        ``graph_version``: the version this server's graph was extracted
        at; defaults to the device graph's own ``graph_version`` field."""
        self.graph = graph
        self.counts_graph = counts_graph if counts_graph is not None else graph
        if graph_version is None:
            graph_version = int(getattr(graph, "graph_version", 0))
        self.graph_version = int(graph_version)
        self.max_batch = int(max_batch)
        self.ppr_iters = int(ppr_iters)
        self.damping = float(damping)
        self.bfs_max_iters = bfs_max_iters
        widths = sorted({int(w) for w in bucket_widths if 0 < int(w) < self.max_batch})
        self.bucket_widths: Tuple[int, ...] = tuple(widths) + (self.max_batch,)
        self.pending: List[GraphQuery] = []
        self._pending_qids: set = set()
        self.n_queries = 0
        self.n_propagation_batches = 0
        # {padded width: batches answered}
        self.batch_widths_used: Dict[int, int] = {}
        self.stats = ServerStats()
        self.last_flush_stats = ServerStats()
        # admission gate: True while an update_graph handoff is draining
        # in-flight queries — submits are rejected, flush still runs
        self.quiescing = False
        # set by from_condensed: streaming-correction build evidence
        self.correction_accounting = None

    def _bucket_width(self, b: int) -> int:
        """Smallest fixed width >= b (groups are pre-chunked to max_batch)."""
        for w in self.bucket_widths:
            if b <= w:
                return w
        return self.max_batch

    @classmethod
    def from_condensed(
        cls,
        graph,
        *,
        budget_bytes: Optional[int] = None,
        budget_triples: Optional[int] = None,
        packed: bool = False,
        drop_self_loops: bool = True,
        graph_version: int = 0,
        backend: str = "auto",
        device="cuda",
        **kwargs,
    ) -> "GraphQueryServer":
        """Load a host ``CondensedGraph`` for serving on ``device``.

        Builds the DEDUP-C correction with
        :func:`~repro_torch.core.dedup.build_correction_streaming` under
        the given expansion budget and wires the duplicate-exact graph for
        ``bfs``/``ppr`` next to a raw C-DUP ``counts_graph`` (self loops
        kept) for ``common_neighbors``.  ``packed=True`` uploads both with
        :func:`~repro_torch.core.engine.to_device_packed` (dispatch policy
        ``backend``) so batched steps run on the CUDA kernels.  The
        build's accounting is kept on ``server.correction_accounting``.
        """
        from ..core import dedup as _dedup
        from ..core import engine as _engine

        correction = _dedup.build_correction_streaming(
            graph,
            budget_bytes=budget_bytes,
            budget_triples=budget_triples,
            drop_self_loops=drop_self_loops,
        )
        if packed:
            def to_dev(g, **kw):
                return _engine.to_device_packed(g, backend=backend, device=device, **kw)
        else:
            def to_dev(g, **kw):
                return _engine.to_device(g, device=device, **kw)
        exact = to_dev(
            graph, correction=correction, drop_self_loops=drop_self_loops,
            graph_version=graph_version,
        )
        counts = to_dev(
            graph, drop_self_loops=False, graph_version=graph_version
        )
        server = cls(exact, counts_graph=counts, **kwargs)
        server.correction_accounting = correction.accounting
        return server

    def _validate(self, query: GraphQuery, extra_qids: set) -> None:
        if query.kind not in ("bfs", "ppr", "common_neighbors"):
            raise ValueError(f"unknown query kind {query.kind!r}")
        # Node ids are positions in one version's node space; a query
        # stamped against another version would be answered about a
        # different node entirely.  Reject instead of guessing.
        if (
            query.graph_version is not None
            and int(query.graph_version) != self.graph_version
        ):
            raise ValueError(
                f"stale graph_version {int(query.graph_version)}: server "
                f"is serving version {self.graph_version}; re-resolve the "
                f"node id against the current graph and resubmit"
            )
        if query.qid in self._pending_qids or query.qid in extra_qids:
            raise ValueError(
                f"qid {query.qid} already pending; answers are keyed by qid"
            )
        target = (
            self.counts_graph if query.kind == "common_neighbors" else self.graph
        )
        n = algorithms.n_nodes(target)
        if not 0 <= query.node < n:
            raise ValueError(
                f"node {query.node} out of range for graph with {n} nodes"
            )

    def submit(self, query: GraphQuery) -> None:
        if self.quiescing:
            raise ValueError(
                "server is quiescing for update_graph(): new admissions "
                "are rejected while in-flight queries drain against "
                f"version {self.graph_version}; resubmit after the swap"
            )
        self._validate(query, set())
        self.pending.append(query)
        self._pending_qids.add(query.qid)

    def begin_quiesce(self) -> None:
        """Stop admitting new queries (submits raise) while keeping
        :meth:`flush` available to drain the in-flight queue."""
        self.quiescing = True

    def end_quiesce(self) -> None:
        self.quiescing = False

    def update_graph(
        self,
        graph: DeviceGraph,
        counts_graph: Optional[DeviceGraph] = None,
        graph_version: Optional[int] = None,
    ) -> Dict[int, np.ndarray]:
        """Swap in a freshly extracted device graph and bump
        ``graph_version``.  Quiesces new admissions, drains the in-flight
        queue against the old graph, then swaps and reopens.  Returns the
        drained answers, keyed by qid, computed at the superseded
        version."""
        if graph_version is None:
            graph_version = int(getattr(graph, "graph_version", 0))
            if graph_version == self.graph_version:
                graph_version = self.graph_version + 1
        if int(graph_version) <= self.graph_version:
            raise ValueError(
                f"graph_version must increase: {int(graph_version)} <= "
                f"current {self.graph_version}"
            )
        self.begin_quiesce()
        try:
            # A mid-drain failure leaves the queue intact and the server
            # still quiesced on the old graph — retryable.
            drained = self.flush() if self.pending else {}
            self.graph = graph
            self.counts_graph = (
                counts_graph if counts_graph is not None else graph
            )
            self.graph_version = int(graph_version)
        finally:
            self.end_quiesce()
        return drained

    def _answer_group(
        self, kind: str, group: List[GraphQuery]
    ) -> Tuple[Dict[int, np.ndarray], int]:
        """Returns (answers, padded width)."""
        # pad the frontier to a fixed bucket width (repeating the first
        # source — columns are independent, extras are sliced off)
        width = self._bucket_width(len(group))
        nodes = [q.node for q in group]
        nodes += [nodes[0]] * (width - len(nodes))
        if kind == "bfs":
            res = algorithms.bfs_multi(
                self.graph, nodes, max_iters=self.bfs_max_iters
            )
        elif kind == "ppr":
            n = algorithms.n_nodes(self.graph)
            seeds = algorithms.one_hot_frontier(n, nodes, device=self.graph.device)
            res = algorithms.personalized_pagerank(
                self.graph, seeds, damping=self.damping,
                num_iters=self.ppr_iters,
            )
        else:  # common_neighbors
            res = algorithms.common_neighbors_multi(self.counts_graph, nodes)
        res = res.cpu().numpy()
        return {q.qid: res[:, i] for i, q in enumerate(group)}, width

    def flush(self, with_stats: bool = False):
        """Answer everything queued; returns ``{qid: (n,) result}``, or
        ``(answers, ServerStats)`` for this flush with
        ``with_stats=True``."""
        out: Dict[int, np.ndarray] = {}
        by_kind: Dict[str, List[GraphQuery]] = {}
        for q in self.pending:
            by_kind.setdefault(q.kind, []).append(q)
        flush_stats = ServerStats()
        batches: List[Tuple[int, int]] = []   # (real queries, padded width)
        for kind, group in by_kind.items():
            for i in range(0, len(group), self.max_batch):
                chunk = group[i : i + self.max_batch]
                answers, width = self._answer_group(kind, chunk)
                out.update(answers)
                batches.append((len(chunk), width))
        # queue and counters committed only once every group answered, so
        # a failure mid-flush leaves pending intact for a retry
        flush_stats.n_queries = len(self.pending)
        for n_real, w in batches:
            flush_stats.record_batch(n_real, w)
        self.n_propagation_batches += flush_stats.n_batches
        self.n_queries += flush_stats.n_queries
        for w, c in flush_stats.batch_widths_used.items():
            self.batch_widths_used[w] = self.batch_widths_used.get(w, 0) + c
        self.last_flush_stats = flush_stats
        self.stats.merge(flush_stats)
        self.pending = []
        self._pending_qids = set()
        return (out, flush_stats) if with_stats else out

    def run(self, queries: List[GraphQuery], with_stats: bool = False):
        if self.quiescing:
            raise ValueError(
                "server is quiescing for update_graph(); resubmit after "
                "the swap"
            )
        # validate the whole batch before enqueuing any of it
        seen: set = set()
        for q in queries:
            self._validate(q, seen)
            seen.add(q.qid)
        for q in queries:
            self.pending.append(q)
            self._pending_qids.add(q.qid)
        return self.flush(with_stats=with_stats)
