"""Device-side propagation engine over graph representations (PyTorch).

One call to :func:`propagate` computes, for every vertex at once,

    y[v] = ⊕_{u -> v}  x[u] ⊗ w(u, v)

on any representation:

* ``DeviceExpanded``   — EXP: one segment-reduce over the expanded edges.
* ``DeviceCondensed``  — C-DUP / DEDUP-1: one segment-reduce per condensed
  layer (the 2-hop factorized SpMV, ``y = B_out^T (B_in^T x)``); path
  multiplicity is counted by ring semirings and ignored by idempotent ones.
* ``DevicePacked``     — the same condensed semantics with each layer also
  carried as a bit-packed block-sparse incidence, so batched steps run on
  the hand-written CUDA SpMM kernels (:mod:`repro_torch.kernels.bitmap_spmm`).
* correction structure — DEDUP-C: C-DUP propagation minus a sparse
  correction term makes ring propagation exact without rewriting edges.

``x`` may be a single ``(n,)`` vector or an ``(n, B)`` matrix of ``B``
independent frontiers; every semiring step then runs as one factorized
SpMM and per-column results equal ``B`` single-vector calls.

Containers are plain dataclasses of tensors.  Every upload takes an
explicit ``device`` and defaults to ``"cuda"``; the CPU is used only when
the caller asks for it.  Dispatch follows the JAX package's
``repro/core/engine.py`` step for step, with ``backend`` ``'cuda'`` |
``'segment'`` | ``'auto'`` in place of ``'pallas'`` | ``'xla'`` |
``'auto'``: ``'auto'`` takes the kernel exactly when the frontier is a
CUDA tensor on an sm_90 device.  The segment path (a fixed-order segment
sum, :func:`~repro_torch.core.semiring.segment_plan`, / ``scatter_reduce``)
serves what the JAX package sends to XLA — 1-D
frontiers, ring steps over layers with repeated edges, non-kernel
semirings — and never stands in for a kernel that failed.  One dispatch
differs from the JAX package's, never an answer: a layer whose edge list
repeats an edge (App. C's random layers) cannot be one bitmap, so the JAX
package leaves it to XLA; the port packs its distinct edges instead and
serves idempotent semirings (⊕ = min / max, to which a repeat adds
nothing) through the kernels, while ring steps over it, which count the
repeats, stay on the segment path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .condensed import BipartiteEdges, CondensedGraph, ExpandedGraph
from .semiring import PLUS_TIMES, Semiring, kernelizable, segment_plan, segment_reduce
from ..distributed.world import all_reduce

__all__ = [
    "DeviceBipartite",
    "DeviceExpanded",
    "DeviceCondensed",
    "PackedOperands",
    "FusedOperands",
    "PACKED_TABLES",
    "FUSED_TABLES",
    "packed_operands",
    "fused_operands",
    "DevicePackedLayer",
    "DevicePacked",
    "DeviceGraph",
    "BACKENDS",
    "device_graph_bytes",
    "with_graph_version",
    "graph_shape_signature",
    "ResidencyBudget",
    "ResidencyError",
    "self_path_counts",
    "to_device",
    "to_device_packed",
    "propagate",
    "propagate_wedge",
    "KERNEL_DISPATCH_COUNT",
    "KERNEL_STANDDOWN_COUNT",
    "reset_kernel_dispatch_count",
]

BACKENDS = ("cuda", "segment", "auto")

# Evidence that propagation steps dispatched to a kernel wrapper instead
# of the segment path: one per layer step (CPU frontiers included, where
# the wrapper runs its plain version).
KERNEL_DISPATCH_COUNT = 0

# Fused-epilogue stand-downs: every time a ring propagation over a
# corrected DevicePacked considers the fused DEDUP-C path and declines,
# the reason from :func:`_fused_applicable` is counted here, under the JAX
# package's reason strings.
KERNEL_STANDDOWN_COUNT: dict = {}


def reset_kernel_dispatch_count() -> None:
    global KERNEL_DISPATCH_COUNT
    KERNEL_DISPATCH_COUNT = 0
    KERNEL_STANDDOWN_COUNT.clear()


def _plans() -> dict:
    """The field that caches a container's segment-sum orders
    (:class:`~repro_torch.core.semiring.SegmentPlan`), built on first use
    and held beside the tensors they index; not counted by
    :func:`device_graph_bytes`."""
    return dataclasses.field(default_factory=dict, repr=False, compare=False)


@dataclasses.dataclass
class DeviceBipartite:
    src: torch.Tensor  # (E,) int64
    dst: torch.Tensor  # (E,) int64
    n_src: int
    n_dst: int
    plans: dict = _plans()  # reverse -> SegmentPlan


@dataclasses.dataclass
class DeviceExpanded:
    """EXP: unique edges with multiplicity weights (1 after dedup)."""

    src: torch.Tensor
    dst: torch.Tensor
    weight: torch.Tensor  # float32 multiplicities; all-ones when deduplicated
    n: int
    graph_version: int = 0
    device: torch.device = torch.device("cpu")
    plans: dict = _plans()  # reverse -> SegmentPlan


@dataclasses.dataclass
class DeviceCondensed:
    """C-DUP / DEDUP-1 / DEDUP-C on device.

    ``chains``      list of chains; each chain a tuple of DeviceBipartite.
    ``direct``      optional real->real edges (may repeat = multiplicity).
    ``correction``  optional (src, dst, count) triple; when present, ring
                    propagation subtracts it (DEDUP-C).
    ``diag_mult``   per-node count of self paths (subtracted by ring
                    propagation so self-loops never contribute).
    ``deduplicated``True when path multiplicity is structurally 1.
    ``graph_version`` source graph's delta version (a plain int).
    ``edge_slices`` 0 for a whole graph; on this rank's share of an
                    edge-sharded graph (:func:`repro_torch.distributed.
                    sharding.shard_condensed`) the number ``k`` of slices
                    it holds: every layer's ``src`` / ``dst`` and the
                    correction's tensors are then ``(k, E / S)``, and each
                    hop is all-reduced over ``group``.
    """

    chains: Tuple[Tuple[DeviceBipartite, ...], ...]
    direct: Optional[DeviceBipartite]
    correction: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    diag_mult: Optional[torch.Tensor]
    n_real: int
    deduplicated: bool
    graph_version: int = 0
    device: torch.device = torch.device("cpu")
    correction_plans: dict = _plans()
    group: object = None
    edge_slices: int = 0


@dataclasses.dataclass
class PackedOperands:
    """One direction's packed operands (layout of
    :class:`repro_torch.kernels.pack.BlockSparseBitmap`; ``bitmaps`` is the
    int32 view of the uint32 words) and the row index the K1/K2 kernels
    read, built from them on the device by
    :func:`repro_torch.kernels.bitmap_index.bitmap_index`.

    ``crossover`` is the measured-crossover dispatch table recorded at
    pack time (``to_device_packed(..., measure=True)``; a frozen
    :class:`~repro_torch.kernels.autotune.CrossoverTable`); ``None``
    means unmeasured."""

    slot_src: torch.Tensor   # (n_slots,) int32
    slot_row: torch.Tensor   # (n_slots,) int32
    row_start: torch.Tensor  # (n_rt,) int32
    row_count: torch.Tensor  # (n_rt,) int32
    bitmaps: torch.Tensor    # (n_slots, TILE, WORDS) int32
    row_ptr: torch.Tensor    # (n_rt * TILE + 1,) int32
    col: torch.Tensor        # (nnz,) int32 — source row of each set bit
    crossover: Optional["CrossoverTable"] = None


@dataclasses.dataclass
class FusedOperands:
    """Operands of the fused last-layer SpMM + DEDUP-C epilogue: the
    interleaved main/correction slot stream of
    :func:`repro_torch.kernels.correction.build_fused_stream`, the main
    layer's bitmaps and the correction's bit-planes, and the row index the
    K3 kernel (:func:`repro_torch.kernels.bitmap_spmm.bitmap_spmm_fused`)
    reads, built from them on the device by
    :func:`repro_torch.kernels.bitmap_index.bitmap_index_fused`.
    ``crossover`` is the table measured on the fused main layer's
    direction (its ``'sum'`` cells), when the pack was measured."""

    kind: torch.Tensor       # (n_slots,) int32 — 0 main, 1 correction
    main_src: torch.Tensor   # (n_slots,) int32
    corr_src: torch.Tensor   # (n_slots,) int32
    main_idx: torch.Tensor   # (n_slots,) int32
    corr_idx: torch.Tensor   # (n_slots,) int32
    slot_row: torch.Tensor   # (n_slots,) int32
    row_start: torch.Tensor  # (n_rt,) int32
    row_count: torch.Tensor  # (n_rt,) int32
    bitmaps: torch.Tensor    # (n_main, TILE, WORDS) int32
    planes: torch.Tensor     # (n_corr, P, TILE, WORDS) int32
    plane_weights: Tuple[float, ...]
    n_out: int
    row_ptr: torch.Tensor    # (n_rt * TILE + 1,) int32
    col: torch.Tensor        # (nnz,) int32 — h row (main) or x row (correction)
    weight: torch.Tensor     # (nnz,) int32 — 0 main, else the correction count
    crossover: Optional["CrossoverTable"] = None


@dataclasses.dataclass
class DevicePackedLayer:
    """One condensed layer in COO plus bit-packed slot-stream form.

    ``src``/``dst`` drive the segment path (any semiring, any direction);
    ``fwd`` is the dst-major packed incidence and ``rev`` its transpose,
    so reverse steps dispatch to the kernels too.  ``repeats`` marks a
    layer whose edge list repeats an edge: its operands hold each distinct
    edge once and serve idempotent semirings only."""

    src: torch.Tensor
    dst: torch.Tensor
    fwd: Optional[PackedOperands]
    rev: Optional[PackedOperands]
    n_src: int
    n_dst: int
    repeats: bool = False
    plans: dict = _plans()  # reverse -> SegmentPlan


@dataclasses.dataclass
class DevicePacked:
    """A :class:`DeviceCondensed` whose layers carry packed SpMM operands.

    Identical propagation semantics; batched (``(n, B)``) steps under any
    kernelizable semiring, in either direction, dispatch per layer to the
    K1/K2 kernel when ``backend`` resolves to the kernels (``'cuda'``
    always, ``'segment'`` never, ``'auto'`` for CUDA frontiers on sm_90).

    ``fused_fwd`` / ``fused_rev`` carry the fused last-layer +
    DEDUP-C-epilogue operands (K3) when the graph has a correction;
    ``fused_standdown`` records why they were not built (``''`` when
    built)."""

    chains: Tuple[Tuple[DevicePackedLayer, ...], ...]
    direct: Optional[DevicePackedLayer]
    correction: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    diag_mult: Optional[torch.Tensor]
    n_real: int
    deduplicated: bool
    backend: str
    fused_fwd: Optional[FusedOperands] = None
    fused_rev: Optional[FusedOperands] = None
    graph_version: int = 0
    fused_standdown: str = ""
    device: torch.device = torch.device("cpu")
    correction_plans: dict = _plans()


DeviceGraph = Union[DeviceExpanded, DeviceCondensed, DevicePacked]


# ---------------------------------------------------------------------------
# Residency accounting and version-keyed dispatch (DESIGN.md §10)
# ---------------------------------------------------------------------------

def with_graph_version(graph: DeviceGraph, version: int) -> DeviceGraph:
    """The same device graph (the same tensors, not copies) stamped with
    another delta version.  The serving tier re-stamps an upload after
    :meth:`~repro_torch.core.delta.LiveGraph.apply_delta`, and normalizes
    the version to 0 before it calls a cached executable: staleness is
    enforced by the version-keyed result cache at admission, so one
    executable serves every version (and every tenant) of one shape."""
    return dataclasses.replace(graph, graph_version=int(version))


def device_graph_bytes(graph) -> int:
    """Device bytes held by one uploaded graph: every tensor reachable
    from the container (edge arrays, packed bitmaps, row indices, fused
    streams, correction triples).  This is the unit the serving tier's
    :class:`ResidencyBudget` charges per resident tenant; unlike the JAX
    package's count it includes the row indices K1-K3 read, which the
    card holds too."""
    if isinstance(graph, torch.Tensor):
        return graph.numel() * graph.element_size()
    if dataclasses.is_dataclass(graph):
        return sum(
            device_graph_bytes(getattr(graph, f.name))
            for f in dataclasses.fields(graph)
        )
    if isinstance(graph, (tuple, list)):
        return sum(device_graph_bytes(g) for g in graph)
    return 0


# Fields a shape signature leaves out: the version (churned by every
# delta), the device, the segment-order caches built on first use, and a
# sharded graph's process group.
_UNSIGNED_FIELDS = frozenset({"graph_version", "device", "plans", "correction_plans",
                              "group"})


def _signature_parts(obj, name: str, parts: list) -> None:
    if isinstance(obj, torch.Tensor):
        parts.append(f"{name}:{tuple(obj.shape)}:{obj.dtype}")
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        parts.append(f"{name}:{type(obj).__name__}")
        for f in dataclasses.fields(obj):
            if f.name not in _UNSIGNED_FIELDS:
                _signature_parts(getattr(obj, f.name), f"{name}.{f.name}", parts)
    elif isinstance(obj, (tuple, list)):
        parts.append(f"{name}:{type(obj).__name__}[{len(obj)}]")
        for i, v in enumerate(obj):
            _signature_parts(v, f"{name}[{i}]", parts)
    else:
        parts.append(f"{name}={obj!r}")


def graph_shape_signature(graph: DeviceGraph) -> str:
    """Hashable signature of a device graph's shape: the container's
    structure, every tensor field's name, shape and dtype, and its
    non-tensor fields (node counts, flags, dispatch policy, a measured
    crossover table), with ``graph_version`` left out.

    Two graphs with equal signatures are served by one entry of the
    serving tier's executable cache ``(kind, bucket, signature)``
    (DESIGN.md §10); version churn under a live delta stream does not
    churn that cache (staleness lives in the result cache).  Two graphs
    share a signature exactly when the JAX package's graphs built from
    the same host graphs share theirs."""
    import hashlib

    parts: list = []
    _signature_parts(graph, "", parts)
    return hashlib.sha1("|".join(parts).encode()).hexdigest()


class ResidencyError(RuntimeError):
    """A device-graph upload cannot fit the residency budget even after
    every evictable tenant has been evicted (a single graph larger than
    ``max_device_bytes`` is unsatisfiable — raise, never thrash)."""


@dataclasses.dataclass
class ResidencyBudget:
    """Device-byte accounting for multi-graph serving residency.

    The serving twin of :class:`repro_torch.core.planner.ExtractionBudget`'s
    assembly account (same charge/release discipline, bytes not rows):
    every resident tenant's device tensors are charged while on device
    (:func:`device_graph_bytes`, row indices included),
    ``peak_resident_bytes`` bounds what the device ever held at once, and
    the LRU eviction traffic is recorded so tests can assert the budget
    actually did work (``n_evictions > 0`` under pressure).

    :meth:`charge` raises :class:`ResidencyError` on a violating upload;
    the serving tier evicts least-recently-used tenants *before* charging,
    so a raise here means a single graph exceeds the whole budget."""

    max_device_bytes: Optional[int] = None
    resident_bytes: int = 0          # live: bytes currently on device
    peak_resident_bytes: int = 0     # max resident_bytes ever observed
    uploaded_bytes: int = 0          # total bytes ever uploaded
    evicted_bytes: int = 0           # total bytes freed by eviction
    n_uploads: int = 0
    n_evictions: int = 0

    def would_fit(self, nbytes: int) -> bool:
        return (
            self.max_device_bytes is None
            or self.resident_bytes + int(nbytes) <= self.max_device_bytes
        )

    def charge(self, nbytes: int, what: str = "device graph") -> None:
        nbytes = int(nbytes)
        if not self.would_fit(nbytes):
            raise ResidencyError(
                f"residency budget exceeded: {self.resident_bytes} resident "
                f"+ {nbytes} uploading ({what}) > max_device_bytes="
                f"{self.max_device_bytes}; evict a tenant or raise the budget"
            )
        self.resident_bytes += nbytes
        self.uploaded_bytes += nbytes
        self.n_uploads += 1
        if self.resident_bytes > self.peak_resident_bytes:
            self.peak_resident_bytes = self.resident_bytes

    def release(self, nbytes: int, evicted: bool = False) -> None:
        self.resident_bytes -= int(nbytes)
        if self.resident_bytes < 0:
            raise AssertionError("released more bytes than charged")
        if evicted:
            self.evicted_bytes += int(nbytes)
            self.n_evictions += 1


# ---------------------------------------------------------------------------
# Host -> device conversion
# ---------------------------------------------------------------------------

def _tensor(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


def _words(a: np.ndarray, device) -> torch.Tensor:
    """uint32 bitmap words as an int32 view on ``device`` (same bits)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


def _dev_edges(e: BipartiteEdges, device) -> DeviceBipartite:
    return DeviceBipartite(
        _tensor(e.src, torch.int64, device),
        _tensor(e.dst, torch.int64, device),
        e.n_src,
        e.n_dst,
    )


def self_path_counts(graph: CondensedGraph) -> np.ndarray:
    """Host: number of closed u->u paths per real node (diagonal of M)."""
    diag = np.zeros(graph.n_real, dtype=np.int64)
    for chain in graph.chains:
        if chain.n_layers == 1:
            e_in, e_out = chain.edges
            # Join (u, V) with (V, u): count matching (V, u) occurrences.
            key_in = e_in.dst.astype(np.int64) * graph.n_real + e_in.src
            key_out = e_out.src.astype(np.int64) * graph.n_real + e_out.dst
            key_out_sorted = np.sort(key_out)
            lo = np.searchsorted(key_out_sorted, key_in, side="left")
            hi = np.searchsorted(key_out_sorted, key_in, side="right")
            np.add.at(diag, e_in.src, (hi - lo))
        else:
            s, d, m = chain.path_pairs()
            mask = s == d
            np.add.at(diag, s[mask], m[mask])
    if graph.direct is not None and graph.direct.n_edges:
        mask = graph.direct.src == graph.direct.dst
        np.add.at(diag, graph.direct.src[mask], 1)
    return diag


def to_device(
    graph: Union[CondensedGraph, ExpandedGraph],
    correction=None,
    deduplicated: bool = False,
    drop_self_loops: bool = True,
    graph_version: int = 0,
    device="cuda",
) -> DeviceGraph:
    """Build the device representation on ``device``.

    For ``CondensedGraph`` inputs, pass ``correction`` (the triples from
    :func:`repro_torch.core.dedup.build_correction`, or the
    :class:`~repro_torch.core.dedup.StreamedCorrection` of
    :func:`~repro_torch.core.dedup.build_correction_streaming`) to get
    DEDUP-C semantics, or ``deduplicated=True`` for DEDUP-1 output.
    Without either, ring propagation counts duplicate paths (C-DUP
    semantics).  Indices are int64; weights, counts and frontiers float32.
    """
    device = torch.device(device)
    if isinstance(graph, ExpandedGraph):
        g = graph.without_self_loops() if drop_self_loops else graph
        return DeviceExpanded(
            _tensor(g.src, torch.int64, device),
            _tensor(g.dst, torch.int64, device),
            torch.clamp(_tensor(g.multiplicity, torch.float32, device), max=1.0),
            g.n,
            graph_version=int(graph_version),
            device=device,
        )
    chains = tuple(
        tuple(_dev_edges(e, device) for e in c.edges) for c in graph.chains
    )
    direct = _dev_edges(graph.direct, device) if graph.direct is not None else None
    corr = None
    if correction is not None:
        cs, cd, cm = correction
        corr = (
            _tensor(cs, torch.int64, device),
            _tensor(cd, torch.int64, device),
            _tensor(cm, torch.float32, device),
        )
    diag = None
    if drop_self_loops and corr is None:
        # Full self-path multiplicity: u reaches itself once per
        # containing virtual node, and all of those must be subtracted.
        diag = _tensor(self_path_counts(graph), torch.float32, device)
    return DeviceCondensed(
        chains=chains,
        direct=direct,
        correction=corr,
        diag_mult=diag,
        n_real=graph.n_real,
        deduplicated=deduplicated,
        graph_version=int(graph_version),
        device=device,
    )


# the tables each index builder reads, in its argument order
PACKED_TABLES = ("slot_src", "slot_row", "row_start", "row_count", "bitmaps")
FUSED_TABLES = ("kind", "main_src", "corr_src", "main_idx", "corr_idx", "slot_row",
                 "row_start", "row_count", "bitmaps", "planes")


def packed_operands(**tables: torch.Tensor) -> PackedOperands:
    """:class:`PackedOperands` from uploaded tables and bitmaps, with the
    row index built from them on their device."""
    from ..kernels.bitmap_index import bitmap_index

    row_ptr, col = bitmap_index(*(tables[k] for k in PACKED_TABLES))
    return PackedOperands(**tables, row_ptr=row_ptr, col=col)


def fused_operands(plane_weights, n_out: int, **tables: torch.Tensor) -> FusedOperands:
    """:class:`FusedOperands` from an uploaded fused stream, bitmaps and
    planes, with the row index built from them on their device."""
    from ..kernels.bitmap_index import bitmap_index_fused

    plane_weights = tuple(float(w) for w in plane_weights)
    row_ptr, col, weight = bitmap_index_fused(
        *(tables[k] for k in FUSED_TABLES), plane_weights
    )
    return FusedOperands(**tables, plane_weights=plane_weights, n_out=int(n_out),
                         row_ptr=row_ptr, col=col, weight=weight)


def _upload_operands(bsb, device) -> PackedOperands:
    return packed_operands(
        slot_src=_tensor(bsb.slot_src, torch.int32, device),
        slot_row=_tensor(bsb.slot_row, torch.int32, device),
        row_start=_tensor(bsb.row_start, torch.int32, device),
        row_count=_tensor(bsb.row_count, torch.int32, device),
        bitmaps=_words(bsb.bitmaps, device),
    )


def _distinct_edges(e: BipartiteEdges) -> BipartiteEdges:
    key = np.unique(e.src * np.int64(e.n_dst) + e.dst)
    return BipartiteEdges(key // e.n_dst, key % e.n_dst, e.n_src, e.n_dst)


def _measure_direction(bsb, ops: PackedOperands, plans: dict, key, src, dst,
                       n_src: int, n_dst: int, measure_kwargs) -> "CrossoverTable":
    """Record a crossover table for one packed direction by racing the
    kernel (autotuned) against the segment path on this device.  The
    direction's segment-sum order is built here once and shared with the
    uploaded layer's ``plans``."""
    from ..kernels.autotune import measure_crossover
    from ..kernels.ops import PackedLayer

    layer = PackedLayer(bsb=bsb, bsb_rev=None, fwd=ops, rev=None, src=src, dst=dst,
                        n_src=n_src, n_dst=n_dst)
    layer.plans[False] = _edge_plan(plans, src, dst, n_dst, key)
    return measure_crossover(layer, **measure_kwargs)


def _pack_edges(
    e: BipartiteEdges,
    dev: DeviceBipartite,
    device,
    shard_edges: Optional[int] = None,
    measure: bool = False,
    measure_kwargs: Optional[dict] = None,
    pack_method: str = "reduceat",
):
    """``dev`` is the already-uploaded COO layer from :func:`to_device`,
    reused so the edge arrays cross to the device only once.  Packs both
    directions: the forward incidence and its transpose (reverse steps).
    A layer that repeats an edge packs its distinct edges (``repeats``).
    ``shard_edges`` routes the packing through the shard-at-a-time path
    (:func:`repro_torch.kernels.pack.pack_bipartite` slices + OR-merge,
    DESIGN.md §7): the same bytes, with packing transients bounded.
    ``measure`` additionally races each direction against the segment
    path and stores the crossover table on the uploaded operands.

    Returns ``(DevicePackedLayer, fwd_bsb, rev_bsb)`` — the host-side
    packings ride along so :func:`to_device_packed` can build the fused
    correction stream without re-packing; they are ``None`` for a layer
    with repeats, which cannot carry the ring's fused epilogue."""
    from ..kernels.pack import pack_bipartite

    kw = dict(method=pack_method, shard_edges=shard_edges)
    try:
        fwd_bsb = pack_bipartite(e, **kw)
        rev_bsb = pack_bipartite(e.reversed(), **kw)
        fwd, rev, repeats = fwd_bsb, rev_bsb, False
    except ValueError:  # repeated edges: pack each distinct edge once
        fwd_bsb = rev_bsb = None
        distinct = _distinct_edges(e)
        fwd, rev, repeats = (pack_bipartite(distinct, **kw),
                             pack_bipartite(distinct.reversed(), **kw), True)
    fwd_ops, rev_ops = _upload_operands(fwd, device), _upload_operands(rev, device)
    layer = DevicePackedLayer(
        src=dev.src,
        dst=dev.dst,
        fwd=fwd_ops,
        rev=rev_ops,
        n_src=e.n_src,
        n_dst=e.n_dst,
        repeats=repeats,
        plans=dev.plans,
    )
    if measure:
        mk = measure_kwargs or {}
        layer.fwd = dataclasses.replace(fwd_ops, crossover=_measure_direction(
            fwd, fwd_ops, layer.plans, False, dev.src, dev.dst, e.n_src, e.n_dst, mk))
        layer.rev = dataclasses.replace(rev_ops, crossover=_measure_direction(
            rev, rev_ops, layer.plans, True, dev.dst, dev.src, e.n_dst, e.n_src, mk))
    return layer, fwd_bsb, rev_bsb


def _upload_fused(stream, main_bsb, corr_planes, device, crossover=None) -> FusedOperands:
    def t(a):
        return _tensor(a, torch.int32, device)

    fused = fused_operands(
        kind=t(stream.kind),
        main_src=t(stream.main_src),
        corr_src=t(stream.corr_src),
        main_idx=t(stream.main_idx),
        corr_idx=t(stream.corr_idx),
        slot_row=t(stream.slot_row),
        row_start=t(stream.row_start),
        row_count=t(stream.row_count),
        bitmaps=_words(main_bsb.bitmaps, device),
        planes=_words(corr_planes.planes, device),
        plane_weights=corr_planes.plane_weights,
        n_out=main_bsb.n_dst,
    )
    return dataclasses.replace(fused, crossover=crossover)


def _build_fused(
    graph: CondensedGraph,
    chains_host,
    triples: Tuple[np.ndarray, np.ndarray, np.ndarray],
    device,
) -> Tuple[Optional[FusedOperands], Optional[FusedOperands], str]:
    """Build the fused (last layer + DEDUP-C epilogue) operands for both
    directions.  Forward fuses into the last chain's final layer; reverse
    propagation walks each chain backwards, so its final step is the same
    chain's *first* layer transposed.

    Returns ``(fused_fwd, fused_rev, standdown_reason)`` with the JAX
    package's reasons: ``''`` when built, else
    ``'no_chains_or_empty_correction'``, ``'unpackable_last_layer'`` or
    ``'endpoint_mismatch'``."""
    from ..kernels.correction import build_fused_stream, pack_correction

    cs, cd, cm = triples
    if not graph.chains or cs.size == 0:
        return None, None, "no_chains_or_empty_correction"
    _, last_fwd_bsb, _ = chains_host[-1][-1]
    _, _, first_rev_bsb = chains_host[-1][0]
    if last_fwd_bsb is None or first_rev_bsb is None:
        return None, None, "unpackable_last_layer"
    n = graph.n_real
    if last_fwd_bsb.n_dst != n or first_rev_bsb.n_dst != n:
        return None, None, "endpoint_mismatch"
    corr_fwd = pack_correction(cs, cd, cm, n_src=n, n_dst=n)
    corr_rev = pack_correction(cd, cs, cm, n_src=n, n_dst=n)
    fused_fwd = _upload_fused(
        build_fused_stream(last_fwd_bsb, corr_fwd), last_fwd_bsb, corr_fwd, device,
        chains_host[-1][-1][0].fwd.crossover,
    )
    fused_rev = _upload_fused(
        build_fused_stream(first_rev_bsb, corr_rev), first_rev_bsb, corr_rev, device,
        chains_host[-1][0][0].rev.crossover,
    )
    return fused_fwd, fused_rev, ""


def to_device_packed(
    graph: CondensedGraph,
    correction=None,
    deduplicated: bool = False,
    drop_self_loops: bool = True,
    backend: str = "auto",
    fuse_correction: bool = True,
    pack_shard_edges: Optional[int] = None,
    measure: bool = False,
    measure_kwargs: Optional[dict] = None,
    pack_method: str = "reduceat",
    graph_version: int = 0,
    device="cuda",
) -> DevicePacked:
    """Like :func:`to_device`, additionally packing every condensed layer
    into bit-packed block-sparse operands (both directions) so batched
    steps run on the CUDA kernels.  ``fuse_correction`` (default on) also
    builds the fused last-layer + DEDUP-C-epilogue operands when a
    correction is present.  ``pack_shard_edges`` packs each layer
    ``pack_shard_edges`` edges at a time and OR-merges the slices
    (DESIGN.md §7): the uploaded bitmaps, and the row indices built from
    them, are byte-identical to an unsharded pack.  ``measure=True``
    races each packed direction against the segment path at pack time
    and records the crossover table on the operands, so ``'auto'``
    dispatch follows the measurement; ``measure_kwargs`` forwards to
    :func:`~repro_torch.kernels.autotune.measure_crossover` (batch sizes,
    ops).  ``pack_method`` is ``'reduceat'`` or ``'scatter'``, the same
    bytes (:func:`~repro_torch.kernels.pack.pack_bipartite`)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    device = torch.device(device)
    base = to_device(
        graph,
        correction=correction,
        deduplicated=deduplicated,
        drop_self_loops=drop_self_loops,
        device=device,
    )
    pack = dict(shard_edges=pack_shard_edges, measure=measure,
                measure_kwargs=measure_kwargs, pack_method=pack_method)
    chains_host = tuple(
        tuple(_pack_edges(e, d, device, **pack) for e, d in zip(c.edges, dc))
        for c, dc in zip(graph.chains, base.chains)
    )
    chains = tuple(tuple(t[0] for t in c) for c in chains_host)
    direct = (
        _pack_edges(graph.direct, base.direct, device, **pack)[0]
        if graph.direct is not None
        else None
    )
    fused_fwd = fused_rev = None
    if correction is None:
        standdown = "no_correction"
    elif not fuse_correction:
        standdown = "fuse_correction_disabled"
    else:
        cs, cd, cm = correction
        fused_fwd, fused_rev, standdown = _build_fused(
            graph,
            chains_host,
            (np.asarray(cs), np.asarray(cd), np.asarray(cm)),
            device,
        )
    return DevicePacked(
        chains=chains,
        direct=direct,
        correction=base.correction,
        diag_mult=base.diag_mult,
        n_real=graph.n_real,
        deduplicated=deduplicated,
        backend=backend,
        fused_fwd=fused_fwd,
        fused_rev=fused_rev,
        graph_version=int(graph_version),
        fused_standdown=standdown,
        device=device,
    )


# ---------------------------------------------------------------------------
# Propagation
# ---------------------------------------------------------------------------

def _edge_propagate(
    sr: Semiring,
    edges,
    x: torch.Tensor,
    reverse: bool,
) -> torch.Tensor:
    """One hop along ``edges`` as a fixed-order segment reduce.  A layer of
    an edge-sharded graph holds this rank's ``k`` slices as ``(k, E / S)``
    rows; their partial results are ⊕-added in slice order."""
    src, dst = (edges.dst, edges.src) if reverse else (edges.src, edges.dst)
    n_out = edges.n_src if reverse else edges.n_dst
    sliced = src.ndim == 2
    y = None
    for i, (s, d) in enumerate(zip(src, dst) if sliced else [(src, dst)]):
        key = (reverse, i) if sliced else reverse
        plan = _edge_plan(edges.plans, s, d, n_out, key) if sr.add_kind == "sum" else None
        part = segment_reduce(sr, x.index_select(0, s), d, n_out, plan=plan)
        y = part if y is None else sr.add(y, part)
    return y


def _edge_plan(plans: dict, src, dst, n_out: int, key):
    """The fixed summation order of one direction's edges: by destination,
    then by source, so it depends on the edge set alone (not its order);
    built once and kept in ``plans`` under ``key``."""
    plan = plans.get(key)
    if plan is None:
        plan = plans[key] = segment_plan(dst, n_out, tiebreak=src)
    return plan


def _on_hopper(x: torch.Tensor) -> bool:
    """The 'auto' policy: the kernels serve CUDA frontiers on sm_90."""
    return x.is_cuda and torch.cuda.get_device_capability(x.device) == (9, 0)


def _kernel_applicable(
    graph: DevicePacked,
    layer: DevicePackedLayer,
    x: torch.Tensor,
    semiring: Semiring,
    reverse: bool,
) -> bool:
    """Dispatch: batched kernelizable steps, both directions, when the
    layer was packed (for a layer with repeated edges: under an
    idempotent semiring only) and the backend resolves to the kernels.
    Under ``'auto'`` a crossover table measured at pack time decides
    first, as in the JAX package: a measured ``'segment'`` cell never
    launches a kernel, and a measured ``'cuda'`` cell runs the kernel
    wrappers whatever the frontier's device (on a CPU frontier they run
    their plain mirrors).  Without a table, the kernels serve CUDA
    frontiers on sm_90.  The kernels keep no per-slot state in shared
    memory, so no size test applies."""
    if x.ndim != 2 or not kernelizable(semiring):
        return False
    if layer.repeats and not semiring.idempotent:
        return False
    packed = layer.rev if reverse else layer.fwd
    if packed is None:
        return False
    if graph.backend == "cuda":
        return True
    if graph.backend == "segment":
        return False
    entry = _measured(packed.crossover, semiring.add_kind,
                      layer.n_dst if reverse else layer.n_src, x)
    if entry is not None:
        return entry.backend == "cuda"
    return _on_hopper(x)


def _measured(table, op: str, n_src: int, x: torch.Tensor):
    """The crossover entry for this cell, or None when unmeasured."""
    return None if table is None else table.lookup(op, n_src, x.shape[1])


def _packed_layer_spmm(
    layer: DevicePackedLayer,
    x: torch.Tensor,
    semiring: Semiring,
    reverse: bool,
) -> torch.Tensor:
    """One layer of the factorized SpMM ``Y = B ⊕ X`` on the K1/K2 kernel."""
    from ..kernels.bitmap_spmm import bitmap_spmm

    global KERNEL_DISPATCH_COUNT
    KERNEL_DISPATCH_COUNT += 1
    ops = layer.rev if reverse else layer.fwd
    n_out = layer.n_src if reverse else layer.n_dst
    entry = _measured(ops.crossover, semiring.add_kind,
                      layer.n_dst if reverse else layer.n_src, x)
    return bitmap_spmm(
        ops.row_ptr,
        ops.col,
        x.contiguous(),
        n_out,
        op=semiring.add_kind,
        zero=float(semiring.zero),
        range_items=entry.range_items if entry is not None else None,
    )


def _layer_propagate(
    graph: DeviceGraph,
    sr: Semiring,
    edges,
    x: torch.Tensor,
    reverse: bool,
) -> torch.Tensor:
    if isinstance(graph, DevicePacked) and _kernel_applicable(
        graph, edges, x, sr, reverse
    ):
        return _packed_layer_spmm(edges, x, sr, reverse)
    return _edge_propagate(sr, edges, x, reverse)


def _fused_applicable(
    graph: DevicePacked,
    fused: Optional[FusedOperands],
    x: torch.Tensor,
    semiring: Semiring,
    hop_weight: Optional[float],
) -> Tuple[bool, str]:
    """Fused-epilogue dispatch: batched plus-times steps only, no per-hop
    weighting, and the backend policy of the per-layer kernels.

    Returns ``(dispatch, reason)`` with the JAX package's reason strings:
    the pack-time :attr:`DevicePacked.fused_standdown` when the operands
    were never built, else ``'frontier_1d'`` / ``'semiring_<name>'`` /
    ``'hop_weight'`` / ``'backend_xla'`` (the ``'segment'`` backend) /
    ``'vmem_or_backend'`` (``'auto'`` off an sm_90 CUDA frontier), and the
    port's ``'measured_segment'``: under ``'auto'`` a measured table on the
    fused main layer whose ``'sum'`` cell says the segment path is faster
    (a measured ``'cuda'`` cell dispatches, as for the per-layer kernels)."""
    if fused is None:
        return False, graph.fused_standdown or "not_built"
    if x.ndim != 2:
        return False, "frontier_1d"
    if semiring.name != "plus_times":
        return False, f"semiring_{semiring.name}"
    if hop_weight is not None:
        return False, "hop_weight"
    if graph.backend == "cuda":
        return True, ""
    if graph.backend == "segment":
        return False, "backend_xla"
    # the fused main layer: the last layer forward, the first one reversed
    main = graph.chains[-1][-1].n_src if fused is graph.fused_fwd else graph.chains[-1][0].n_dst
    entry = _measured(fused.crossover, "sum", main, x)
    if entry is not None:
        return (True, "") if entry.backend == "cuda" else (False, "measured_segment")
    if _on_hopper(x):
        return True, ""
    return False, "vmem_or_backend"


def _fused_layer_spmm(
    fused: FusedOperands,
    h: torch.Tensor,
    x: torch.Tensor,
) -> torch.Tensor:
    """The last layer of the last chain with the DEDUP-C subtraction in
    the kernel epilogue: ``y = B h − D x`` in one launch (K3)."""
    from ..kernels.bitmap_spmm import bitmap_spmm_fused

    global KERNEL_DISPATCH_COUNT
    KERNEL_DISPATCH_COUNT += 1
    return bitmap_spmm_fused(
        fused.row_ptr,
        fused.col,
        fused.weight,
        h.contiguous(),
        x.contiguous(),
        fused.n_out,
    )


def _apply_hop(sr: Semiring, y: torch.Tensor, hop_weight: Optional[float]) -> torch.Tensor:
    if hop_weight is None:
        return y
    return sr.mul(y, torch.tensor(hop_weight, dtype=y.dtype, device=y.device))


def _bcast(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast per-edge/per-node weight against feature matrices."""
    w = w.to(like.dtype)
    if like.ndim == w.ndim:
        return w
    return w.reshape(tuple(w.shape) + (1,) * (like.ndim - w.ndim))


def propagate(
    graph: DeviceGraph,
    x: torch.Tensor,
    semiring: Semiring = PLUS_TIMES,
    *,
    reverse: bool = False,
    hop_weight: Optional[float] = None,
    allow_duplicates: bool = False,
    layer_weights: Optional[Sequence[Sequence[torch.Tensor]]] = None,
) -> torch.Tensor:
    """One superstep: ⊕-combine ⊗-weighted messages along all edges.

    ``x`` is one frontier ``(n,)`` or a batch of ``B`` frontiers ``(n, B)``
    processed in a single factorized SpMM; per-column results equal ``B``
    independent single-frontier calls.  ``hop_weight`` is applied once
    per *logical* (real->real) hop, not per condensed layer, so BFS hop
    counting matches the expanded graph.

    ``layer_weights`` carries edge properties on condensed chains: one
    sequence per chain, one ``(layer_size,)`` tensor per *virtual* layer,
    ⊗-applied to the hidden frontier (broadcast over the ``B`` columns)
    while it occupies that layer.  A condensed path's weight is then the
    ⊗-product of its virtual-node properties (min-plus: path cost = Σ
    weights; max-min: path width = min capacity), while every incidence
    step stays an unweighted SpMM, so kernel dispatch is unaffected.
    Direct edges carry no virtual node, hence the weight identity.  Only
    idempotent semirings are supported (the DEDUP-C correction algebra is
    multiplicity-based and has no weighted analogue).  Validation and
    error texts are the JAX package's.
    """
    n_in = graph.n if isinstance(graph, DeviceExpanded) else graph.n_real
    if x.ndim not in (1, 2) or x.shape[0] != n_in:
        raise ValueError(
            f"frontier must be ({n_in},) or ({n_in}, B); got shape {tuple(x.shape)}"
        )
    if layer_weights is not None:
        if isinstance(graph, DeviceExpanded):
            raise ValueError(
                "layer_weights are condensed-chain edge properties; the "
                "expanded representation needs them folded into a dense "
                "weighted matrix instead (tests/oracle.py does exactly that)"
            )
        if not semiring.idempotent:
            raise ValueError(
                "layer_weights require an idempotent semiring: the ring "
                "correction (DEDUP-C) subtracts path multiplicities and "
                "has no weighted analogue"
            )
        if len(layer_weights) != len(graph.chains):
            raise ValueError(
                f"layer_weights must cover all {len(graph.chains)} chains; "
                f"got {len(layer_weights)}"
            )
        for ci, (cw, chain) in enumerate(zip(layer_weights, graph.chains)):
            if len(cw) != len(chain) - 1:
                raise ValueError(
                    f"chain {ci} has {len(chain) - 1} virtual layers; got "
                    f"{len(cw)} weight arrays"
                )
    if isinstance(graph, DeviceExpanded):
        src, dst = (graph.dst, graph.src) if reverse else (graph.src, graph.dst)
        msgs = x.index_select(0, src)
        plan = None
        if semiring.name == "plus_times":
            msgs = msgs * _bcast(graph.weight, msgs)
        if semiring.add_kind == "sum":
            plan = _edge_plan(graph.plans, src, dst, graph.n, reverse)
        y = segment_reduce(semiring, msgs, dst, graph.n, plan=plan)
        return _apply_hop(semiring, y, hop_weight)

    exact = (
        semiring.idempotent
        or graph.deduplicated
        or graph.correction is not None
    )
    if not exact and not allow_duplicates:
        raise ValueError(
            "ring propagation on C-DUP counts duplicate paths; pass a "
            "correction (DEDUP-C), a deduplicated graph (DEDUP-1), or "
            "allow_duplicates=True (paper §4.1 duplication problem)"
        )

    # On this rank's slices of an edge-sharded graph every hop yields a
    # partial sum: ``h`` is all-reduced after each inner hop, and ``y``
    # less the correction's partial after the last -- the collectives
    # GSPMD inserts for the JAX package's edge-sharded graph.
    sharded = bool(getattr(graph, "edge_slices", 0))

    # Fused DEDUP-C epilogue: the last chain's final layer and the
    # correction subtraction run as one kernel launch; the trailing
    # segment correction below is then skipped.
    fused = None
    if isinstance(graph, DevicePacked) and graph.correction is not None:
        cand = graph.fused_rev if reverse else graph.fused_fwd
        ok, reason = _fused_applicable(graph, cand, x, semiring, hop_weight)
        if ok:
            fused = cand
        else:
            KERNEL_STANDDOWN_COUNT[reason] = (
                KERNEL_STANDDOWN_COUNT.get(reason, 0) + 1
            )

    y = None
    for ci, chain in enumerate(graph.chains):
        seq = chain[::-1] if reverse else chain
        w_seq = None
        if layer_weights is not None:
            # weight i lives on virtual layer i; walking the chain
            # backwards visits the layers in reverse order
            cw = layer_weights[ci]
            w_seq = cw[::-1] if reverse else cw
        h = x
        fuse_here = fused is not None and ci == len(graph.chains) - 1
        for si, e in enumerate(seq[:-1] if fuse_here else seq):
            h = _layer_propagate(graph, semiring, e, h, reverse)
            if sharded and si < len(seq) - 1:
                h = all_reduce(h, semiring.add_kind, graph.group)
            if w_seq is not None and si < len(seq) - 1:
                h = semiring.mul(h, _bcast(torch.as_tensor(w_seq[si], device=h.device), h))
        if fuse_here:
            h = _fused_layer_spmm(fused, h, x)
        h = _apply_hop(semiring, h, hop_weight)
        y = h if y is None else semiring.add(y, h)
    if graph.direct is not None:
        h = _layer_propagate(graph, semiring, graph.direct, x, reverse)
        h = _apply_hop(semiring, h, hop_weight)
        y = h if y is None else semiring.add(y, h)
    if y is None:
        zero_shape = (graph.n_real,) + tuple(x.shape[1:])
        y = torch.full(zero_shape, semiring.zero, dtype=x.dtype, device=x.device)

    # Exactness corrections only make sense in the ring; a fused kernel
    # has already subtracted the correction in its epilogue.
    ring = semiring.name == "plus_times"
    if ring and graph.correction is not None and fused is None:
        corr = _correction_apply(graph.correction, x, graph.n_real, reverse,
                                 graph.correction_plans)
        y = y - _apply_hop(semiring, corr, hop_weight)
    if sharded:
        y = all_reduce(y, semiring.add_kind, graph.group)
    if ring and graph.correction is None and graph.diag_mult is not None:
        y = y - _apply_hop(
            semiring, x * _bcast(graph.diag_mult, x), hop_weight
        )
    return y


def _correction_apply(
    triples: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    x: torch.Tensor,
    n_real: int,
    reverse: bool,
    plans: Optional[dict] = None,
) -> torch.Tensor:
    """``D·x`` (or ``Dᵀ·x``) for a sparse (src, dst, count) triple set,
    summed in the triples' fixed order.  ``plans`` (the graph's
    ``correction_plans``) keeps that order for the graph's own triples,
    keyed by the tensors' identities; the tensors are held beside it so an
    identity is never reused while its key lives.  An edge-sharded graph's
    ``(k, E / S)`` triples are summed slice by slice in slice order."""
    cs, cd, cm = triples
    src, dst = (cd, cs) if reverse else (cs, cd)
    sliced = src.ndim == 2
    y = None
    for i, (s, d, m) in enumerate(zip(src, dst, cm) if sliced else [(src, dst, cm)]):
        msgs = x.index_select(0, s)
        if plans is None:
            plan = segment_plan(d, n_real, tiebreak=s)
        else:
            key = (id(cs), id(cd), reverse) + ((i,) if sliced else ())
            if key not in plans:
                plans[key] = (cs, cd, segment_plan(d, n_real, tiebreak=s))
            plan = plans[key][2]
        part = segment_reduce(PLUS_TIMES, msgs * _bcast(m, msgs), d, n_real, plan=plan)
        y = part if y is None else y + part
    return y


def propagate_wedge(
    graph: DeviceGraph,
    x: torch.Tensor,
    *,
    reverse: bool = False,
    wedge: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Exact two-hop ring propagation ``y = Aᵀ(Aᵀx)`` on a DEDUP-C graph
    from *uncorrected* C-DUP hops.

    The linear DEDUP-C identity ``A = M − D`` composes quadratically:

        ``A² = (M − D)² = M² − (MD + DM − D²)``

    so the exact wedge count is two raw multiplicity hops (each a plain
    kernel-path SpMM — no per-step correction subtraction, no fused
    epilogue) minus the *wedge correction* ``W = MD + DM − D²``.  With
    ``wedge`` triples on the graph's device, precomputed by
    :func:`repro_torch.core.dedup.build_wedge_correction`, the correction
    is one sparse pass (``y = M(Mx) − Wx``); without them it is assembled
    on the fly from the graph's own ``D`` triples
    (``y = M(Mx) − M(Dx) − D(Mx) + D(Dx)``).  Byte-identical to two
    per-step-corrected :func:`propagate` calls on integer frontiers.
    On a :class:`DevicePacked` the raw graph keeps its packed layers and
    row indices and drops only the correction, so every raw hop is K1.
    """
    if isinstance(graph, DeviceExpanded):
        y = propagate(graph, x, PLUS_TIMES, reverse=reverse)
        return propagate(graph, y, PLUS_TIMES, reverse=reverse)
    if graph.correction is None:
        if graph.deduplicated:
            y = propagate(graph, x, PLUS_TIMES, reverse=reverse)
            return propagate(graph, y, PLUS_TIMES, reverse=reverse)
        raise ValueError(
            "propagate_wedge needs a DEDUP-C correction: the quadratic "
            "wedge correction is built from the linear D triples"
        )
    raw = dataclasses.replace(graph, correction=None, diag_mult=None)
    mx = propagate(raw, x, PLUS_TIMES, reverse=reverse, allow_duplicates=True)
    mmx = propagate(raw, mx, PLUS_TIMES, reverse=reverse, allow_duplicates=True)
    if wedge is not None:
        return mmx - _correction_apply(wedge, x, graph.n_real, reverse)
    plans = graph.correction_plans
    dx = _correction_apply(graph.correction, x, graph.n_real, reverse, plans)
    mdx = propagate(raw, dx, PLUS_TIMES, reverse=reverse, allow_duplicates=True)
    dmx = _correction_apply(graph.correction, mx, graph.n_real, reverse, plans)
    ddx = _correction_apply(graph.correction, dx, graph.n_real, reverse, plans)
    return mmx - mdx - dmx + ddx
