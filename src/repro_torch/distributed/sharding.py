"""Graph sharding across processes (the graph half of the JAX package's
``distributed/sharding.py``).

The JAX package annotates frontiers with logical axes and lets GSPMD
place the work; the port makes the same placements explicit over a
``torch.distributed`` process group (:mod:`.world`):

* :data:`GRAPH_RULES` and :func:`shard_frontier` — a propagation batch
  ``(n, B)`` is data-parallel over its columns: each rank owns a
  contiguous block of the sources, every rank the full node axis;
* :func:`extraction_shard_range`, :func:`merge_schedule` and
  :class:`MultihostSpillExtraction` — sharded extraction across
  processes, exchanging partials through a shared spill directory and
  merging them in a log-depth tree (DESIGN.md §8);
* :func:`shard_condensed` — a condensed graph's edges split into equal
  slices over the ranks, which
  :func:`repro_torch.core.engine.propagate` sums with one all-reduce per
  hop (the collectives GSPMD inserts for the JAX package's edge-sharded
  graph).

Where the JAX package reads ``jax.process_index()`` /
``jax.process_count()``, the port reads the group's rank and size, ``0``
and ``1`` when no group is initialised.

The model half: logical-axis rules (MaxText-style, as in the JAX
package).  Model code names tensor dims logically (``"batch"``,
``"experts"``, ...); a rules mapping (each arch config's
``sharding_rules``) resolves them to the dims of a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``::

    with use_mesh_rules(mesh, cfg.sharding_rules):
        state, metrics = step(state, batch)

    # inside model code
    x = shard(x, "batch", "seq", "embed")

:func:`logical_spec`, :func:`_dedup_axes` and :func:`specs_for_tree`
read the mesh's dim names alone and return a :class:`Spec` (one entry per
tensor dim: a mesh-dim name, a tuple of names, or ``None``, as a JAX
``PartitionSpec`` holds); :func:`named_sharding` turns one into DTensor
placements.  :func:`shard` returns a plain tensor unchanged and
redistributes a DTensor: the reference's ``with_sharding_constraint``.

The sharded train step's state is laid out as the reference's
``in_shardings`` lay it out (``launch/cells.py``): :func:`distribute_tree`
makes each param a DTensor placed by its logical axes,
:func:`opt_placements` gives the optimizer state's placements from the
params' (``cells._opt_shardings``), :func:`state_placements` those of a
whole train state, which :func:`distribute_state` (or
``train.checkpoint.restore_checkpoint(shardings=)``) places, and
:func:`batch_placements` is the batch's ``("batch", None)``.
"""
from __future__ import annotations

import contextlib
import sys
import threading
import time
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from .world import initialized, rank_world

__all__ = [
    "Spec",
    "is_dtensor",
    "use_mesh_rules",
    "current_mesh",
    "shard",
    "logical_spec",
    "named_sharding",
    "specs_for_tree",
    "placements_for",
    "placements_for_tree",
    "distribute_tree",
    "opt_placements",
    "state_placements",
    "place_tree",
    "distribute_state",
    "batch_placements",
    "GRAPH_RULES",
    "shard_frontier",
    "extraction_shard_range",
    "merge_schedule",
    "MultihostSpillExtraction",
    "shard_condensed",
]

# ---------------------------------------------------------------------------
# Logical-axis rules for models
# ---------------------------------------------------------------------------

class Spec(tuple):
    """A tensor's placement on a mesh: one entry per tensor dim, each a
    mesh-dim name, a tuple of names (the dim split over several mesh dims,
    major first) or ``None`` (replicated); ``Spec()`` replicates every
    dim.  The port's counterpart of a JAX ``PartitionSpec``, which it
    equals entry for entry (a one-name tuple is stored as the name, as
    ``PartitionSpec`` stores it)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor, without importing DTensor's module (a
    tensor can be one only once that module is loaded; importing it takes
    about a second, which plain paths do not pay)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


_state = threading.local()


def _ctx() -> Tuple[Optional[object], Optional[Mapping]]:
    return getattr(_state, "mesh", None), getattr(_state, "rules", None)


@contextlib.contextmanager
def use_mesh_rules(mesh, rules: Optional[Mapping]):
    """Activate a (mesh, logical-axis rules) context for :func:`shard` /
    :func:`logical_spec` calls in the dynamic scope (thread-local,
    re-entrant).  ``None`` for either disables annotations: the same
    model code then runs unconstrained."""
    old = _ctx()
    _state.mesh, _state.rules = mesh, rules
    try:
        yield
    finally:
        _state.mesh, _state.rules = old


def current_mesh():
    """The mesh of the innermost :func:`use_mesh_rules` context, if any."""
    return _ctx()[0]


def _resolve(axis: Optional[str], rules: Mapping, mesh):
    """Logical axis -> mesh-dim name (or tuple), filtered to the mesh's
    dims."""
    if axis is None:
        return None
    target = rules.get(axis, None)
    if target is None:
        return None
    names = mesh.mesh_dim_names
    if isinstance(target, (tuple, list)):
        present = tuple(t for t in target if t in names)
        return present if present else None
    return target if target in names else None


def logical_spec(
    logical_axes: Sequence[Optional[str]],
    rules: Optional[Mapping] = None,
    mesh=None,
) -> Spec:
    """Resolve logical axis names to a :class:`Spec` under the given (or
    ambient) rules and mesh; ``Spec()`` outside any context."""
    m, r = _ctx()
    mesh = mesh or m
    rules = rules or r
    if mesh is None or rules is None:
        return Spec()
    return Spec(*[_resolve(a, rules, mesh) for a in logical_axes])


def named_sharding(
    logical_axes: Sequence[Optional[str]],
    rules: Optional[Mapping] = None,
    mesh=None,
):
    """The DTensor placements of :func:`logical_spec`, one per mesh dim
    (``Shard(i)`` where tensor dim ``i`` names that mesh dim, else
    ``Replicate()``), for ``distribute_tensor`` / ``redistribute``;
    ``None`` outside a context."""
    m, r = _ctx()
    mesh = mesh or m
    rules = rules or r
    if mesh is None or rules is None:
        return None
    return _placements(logical_spec(logical_axes, rules, mesh), mesh)


def _placements(spec: Spec, mesh) -> tuple:
    """``Shard(i)`` for each mesh dim that tensor dim ``i`` of ``spec``
    names, ``Replicate()`` for the rest (a tuple entry shards its dim over
    its mesh dims in the mesh's order)."""
    from torch.distributed.tensor import Replicate, Shard

    dims = {}
    for i, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                dims.setdefault(name, i)
    return tuple(Shard(dims[n]) if n in dims else Replicate() for n in mesh.mesh_dim_names)


def _dedup_axes(spec: Spec) -> Spec:
    """Drop later duplicate mesh-dim uses (keep-first priority): lets
    model code annotate e.g. ("batch", "act_seq", "vocab") and stay legal
    when an arch maps act_seq and vocab to the same mesh dim (SP)."""
    seen = set()
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept = tuple(a for a in axes if a not in seen)
        seen.update(kept)
        out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
    return Spec(*out)


def shard(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Place ``x`` by its logical axes if a mesh context is active.

    A no-op outside a context or on a one-device mesh.  Otherwise the
    rank is checked; a plain tensor is returned unchanged (the port's
    layouts are explicit: each rank already holds its part) and a DTensor
    is redistributed to the placements the rules give."""
    mesh, rules = _ctx()
    if mesh is None or rules is None or mesh.size() == 1:
        return x
    if x.ndim != len(logical_axes):
        raise ValueError(f"rank {x.ndim} tensor got {len(logical_axes)} logical axes")
    if not is_dtensor(x):
        return x
    spec = _dedup_axes(logical_spec(logical_axes, rules, mesh))
    return x.redistribute(mesh, _placements(spec, mesh))


def _is_axes(v) -> bool:
    return isinstance(v, tuple) and all(isinstance(a, str) or a is None for a in v)


def specs_for_tree(axes_tree, rules: Mapping, mesh):
    """Nested dict of logical-axis tuples -> the same structure of
    :class:`Spec`."""
    if _is_axes(axes_tree):
        return logical_spec(axes_tree, rules, mesh)
    return {k: specs_for_tree(v, rules, mesh) for k, v in axes_tree.items()}


def placements_for(logical_axes: Sequence[Optional[str]], rules: Mapping, mesh) -> tuple:
    """The DTensor placements of a tensor with these logical axes:
    ``_placements(_dedup_axes(logical_spec(...)))``."""
    return _placements(_dedup_axes(logical_spec(logical_axes, rules, mesh)), mesh)


def placements_for_tree(axes_tree, rules: Mapping, mesh):
    """Nested dict of logical-axis tuples -> the same structure of
    placements (:func:`placements_for`)."""
    if _is_axes(axes_tree):
        return placements_for(axes_tree, rules, mesh)
    return {k: placements_for_tree(v, rules, mesh) for k, v in axes_tree.items()}


def distribute_tree(tree, axes_tree, rules: Mapping, mesh):
    """Each leaf of ``tree`` (plain tensors, the same on every rank) as a
    DTensor on ``mesh`` placed by its logical axes in ``axes_tree``: the
    reference's params ``in_shardings``,
    ``specs_for_tree(logical_axes(cfg), rules, mesh)``, with a mesh dim
    named twice kept on its first tensor dim."""
    return place_tree(tree, placements_for_tree(axes_tree, rules, mesh), mesh)


def _factored(placements: tuple, ndim: int, drop: int) -> tuple:
    """The placements of a param's moment with tensor dim ``drop`` (``-1``
    or ``-2``) reduced away: a split of that dim is replicated, a split of
    a later dim moves down one."""
    from torch.distributed.tensor import Replicate, Shard

    gone = ndim + drop
    out = []
    for p in placements:
        if isinstance(p, Shard) and p.dim == gone:
            out.append(Replicate())
        elif isinstance(p, Shard) and p.dim > gone:
            out.append(Shard(p.dim - 1))
        else:
            out.append(p)
    return tuple(out)


def opt_placements(opt_state, param_placements, mesh):
    """The optimizer state's placements from the params' (the port of the
    reference's ``cells._opt_shardings``): adamw / sgdm ``m``, ``v``,
    ``mom`` mirror the params; adafactor's ``f`` keeps ``v`` as its param,
    ``r`` without the param's last dim and ``c`` without its second to
    last; any other entry is replicated."""
    from torch.distributed.tensor import Replicate

    def factored(sub, placements):
        if any(isinstance(v, dict) for v in sub.values()):     # an inner node
            return {k: factored(sub[k], placements[k]) for k in sub}
        if "v" in sub:
            return {"v": placements}
        ndim = sub["r"].ndim + 1
        return {"r": _factored(placements, ndim, -1), "c": _factored(placements, ndim, -2)}

    def replicated(sub):
        if isinstance(sub, dict):
            return {k: replicated(v) for k, v in sub.items()}
        return (Replicate(),) * mesh.ndim

    out = {}
    for key, sub in opt_state.items():
        if key in ("m", "v", "mom"):
            out[key] = param_placements
        elif key == "f":
            out[key] = factored(sub, param_placements)
        else:
            out[key] = replicated(sub)
    return out


def state_placements(state, param_axes, rules: Mapping, mesh) -> Dict:
    """The placements of a train state ``{"params", "opt", "step", ...}``
    (its structure is read, not its values): the params by their logical
    axes, the optimizer state by :func:`opt_placements`, ``grad_err``
    (int8 compression's residuals) as the params; any other entry
    (``step``) ``None``: a plain tensor, the same on every rank, as the
    reference replicates it."""
    pp = placements_for_tree(param_axes, rules, mesh)
    out = {k: None for k in state}
    out["params"] = pp
    out["opt"] = opt_placements(state["opt"], pp, mesh)
    if state.get("grad_err") is not None:
        out["grad_err"] = pp
    return out


def place_tree(tree, placements, mesh, src_data_rank: Optional[int] = 0):
    """Each leaf of ``tree`` as a DTensor on ``mesh`` with the placements
    at its path in ``placements`` (a leaf whose placements are ``None``,
    or missing, stays as it is).  ``src_data_rank=None`` keeps each
    rank's own copy (every rank holds the same values) instead of
    broadcasting rank 0's."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        placements = placements or {}
        return {k: place_tree(v, placements.get(k), mesh, src_data_rank)
                for k, v in tree.items()}
    if placements is None:
        return tree
    return distribute_tensor(tree, mesh, list(placements), src_data_rank=src_data_rank)


def distribute_state(state, param_axes, rules: Mapping, mesh):
    """A train state of plain tensors (the same on every rank) as the
    sharded step holds it, placed by :func:`state_placements`."""
    return place_tree(state, state_placements(state, param_axes, rules, mesh), mesh)


def batch_placements(rules: Mapping, mesh) -> tuple:
    """The placements of a ``(B, T)`` batch: ``("batch", None)``."""
    return placements_for(("batch", None), rules, mesh)


# ---------------------------------------------------------------------------
# Graph sharding
# ---------------------------------------------------------------------------

# Logical-axis rules for the condensed-graph engine (DESIGN.md §3/§5):
# frontier matrices are (graph_nodes, graph_batch); the *batch* axis is the
# data-parallel one — every rank holds the full node axis (edge arrays are
# replicated or banded separately) and owns a slice of the sources.
GRAPH_RULES = {
    "graph_nodes": None,
    "graph_batch": ("data", "model"),
}


def shard_frontier(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's part of a propagation frontier: an ``(n,)`` vector
    whole (the node axis is replicated), the rank's contiguous block of
    columns of an ``(n, B)`` batch (trailing ranks one column fewer when
    the ranks do not divide ``B``).  The identity without a group."""
    if x.ndim not in (1, 2):
        raise ValueError(f"frontier must be (n,) or (n, B); got rank {x.ndim}")
    rank, world = rank_world(group)
    if x.ndim == 1 or world == 1:
        return x
    cols = extraction_shard_range(x.shape[1], rank, world)
    return x[:, cols.start:cols.stop]


def extraction_shard_range(
    n_shards: int,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> range:
    """The contiguous extraction-shard ids this process owns (DESIGN.md
    §8).

    Ragged-safe both ways: trailing processes get one fewer shard when
    ``n_shards % process_count != 0``, and empty ranges when ``n_shards <
    process_count`` (they spill nothing and sit out the reduce).  Ranges
    are contiguous and ascending in ``process_index``, which lets the
    pairwise reduce concatenate partner partials in shard order and stay
    byte-identical.  ``process_index`` / ``process_count`` default to the
    default group's rank and size (``0`` / ``1`` without a group)."""
    rank, world = rank_world()
    if process_index is None:
        process_index = rank
    if process_count is None:
        process_count = world
    if not 0 <= process_index < process_count:
        raise ValueError(
            f"process_index {process_index} out of range [0, {process_count})"
        )
    base, extra = divmod(n_shards, process_count)
    lo = process_index * base + min(process_index, extra)
    hi = lo + base + (1 if process_index < extra else 0)
    return range(lo, hi)


def merge_schedule(n_partials: int) -> list:
    """Log-depth pairwise reduce schedule over ``n_partials`` contiguous
    partials (DESIGN.md §8).

    A list of rounds, each a list of independent ``(dst, src)`` pairs:
    ``dst`` absorbs ``src``, whose accumulated shard range always directly
    follows ``dst``'s, so the final partial at index 0 concatenates every
    shard in order.  Depth ``ceil(log2(n_partials))``; a partial with no
    partner in a round carries to the next unchanged."""
    if n_partials < 0:
        raise ValueError(f"n_partials must be >= 0, got {n_partials}")
    rounds = []
    stride = 1
    while stride < n_partials:
        rounds.append([
            (i, i + stride)
            for i in range(0, n_partials, 2 * stride)
            if i + stride < n_partials
        ])
        stride *= 2
    return rounds


def _sync_barrier(process_count: int, group=None):
    """Default cross-phase barrier: ``torch.distributed.barrier(group)``
    whenever a process group is initialised (a world of one included), a
    no-op for one process without a group."""

    def barrier(name: str) -> None:
        if process_count == 1 and not initialized():
            return
        torch.distributed.barrier(group)

    return barrier


class MultihostSpillExtraction:
    """Sharded extraction across processes with spill-to-disk assembly and
    a log-depth tree-reduce merge (DESIGN.md §8).

    Every process runs the same program against the same catalog and a
    *shared* spill directory, the exchange medium: no array crosses
    processes in memory.

    1. :meth:`phase_nodes` — each process spills node-space candidate
       records for its own shards (:func:`extraction_shard_range`).
    2. :meth:`phase_shards` — after a barrier, each process merges every
       node record into the global ``NodeSpace`` (the same everywhere),
       extracts and spills its shard assemblies, and pre-merges them into
       one partial (``partial_p<index>``).
    3. :meth:`phase_merge_round` — ``ceil(log2(P'))`` rounds of pairwise
       merges per :func:`merge_schedule` over the ``P'`` processes that
       own shards; one barrier per round.
    4. :meth:`phase_finish` — every process loads the root partial and
       builds the same ``CondensedGraph``; the root finalises the spill
       manifest, so the directory is a valid
       :func:`repro_torch.core.extract.merge_spilled_graph` input.

    :meth:`run` drives every phase with the default barrier
    (``torch.distributed.barrier`` over ``group`` whenever a group is
    initialised).  Tests drive the phases one by one for simulated
    ``process_index`` / ``process_count`` with a no-op barrier, which is
    the same run: every dependency between processes goes through the
    spill directory at a phase boundary.  The graph is byte-identical to
    ``extract(catalog, dsl_text)``.

    Use a fresh spill directory per run: only the stale closing manifest
    of a reused one is invalidated (a concurrent wipe would race other
    processes' fresh records), so an earlier run's records would be
    certified into the new manifest.
    """

    def __init__(
        self,
        catalog,
        dsl_text: str,
        n_shards: int,
        spill_dir: str,
        mode: str = "auto",
        preprocess: bool = False,
        max_resident_rows: Optional[int] = None,
        max_assembly_bytes: Optional[int] = None,
        merge_arity: int = 2,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        barrier=None,
        group=None,
    ) -> None:
        from ..core.dsl import parse
        from ..core.planner import ExtractionBudget
        from ..core.serialize import ShardSpillStore

        rank, world = rank_world(group)
        self.catalog = catalog
        self.query = parse(dsl_text)
        self.n_shards = int(n_shards)
        self.mode = mode
        self.preprocess = preprocess
        self.merge_arity = int(merge_arity)
        self.process_index = rank if process_index is None else int(process_index)
        self.process_count = world if process_count is None else int(process_count)
        self.my_shards = extraction_shard_range(
            self.n_shards, self.process_index, self.process_count
        )
        # processes that own shards: the partial owners the reduce runs over
        self.active = [
            p for p in range(self.process_count)
            if len(extraction_shard_range(self.n_shards, p, self.process_count))
        ]
        self.schedule = merge_schedule(len(self.active))
        self.root = self.active[0]
        self.barrier = barrier or _sync_barrier(self.process_count, group)
        self.budget = ExtractionBudget(
            max_resident_rows=max_resident_rows,
            max_assembly_bytes=max_assembly_bytes,
            spill_enabled=True,
        )
        self.store = ShardSpillStore(spill_dir)
        self.nodes = None
        self.props = None
        self._plans = None
        self._seconds = 0.0

    def _partial_name(self, process_index: int) -> str:
        return f"partial_p{process_index:05d}"

    # -- phases ---------------------------------------------------------------
    def phase_nodes(self) -> None:
        """Spill node-space candidate records for my shard range."""
        from ..core.extract import _spill_node_shards

        t0 = time.perf_counter()
        _spill_node_shards(
            self.catalog, self.query.nodes_rules, self.n_shards,
            self.my_shards, self.store, self.budget,
        )
        self._seconds += time.perf_counter() - t0

    def phase_shards(self) -> None:
        """Global node space from every process's records, then extract,
        spill, and pre-merge my shards into ``partial_p<me>``."""
        from ..core.extract import (
            _node_space_from_spill,
            _plans_info,
            _spill_chain_shards,
            _write_nodespace_record,
        )
        from ..core.serialize import tree_merge_records

        t0 = time.perf_counter()
        self.nodes, self.props = _node_space_from_spill(
            self.store, self.query.nodes_rules, self.n_shards, self.budget
        )
        self._plans = _plans_info(self.catalog, self.query, self.mode)
        names = _spill_chain_shards(
            self.catalog, self._plans, self.nodes, self.n_shards,
            self.my_shards, self.store, self.budget,
        )
        if names:
            reduced, _ = tree_merge_records(
                self.store, names, arity=self.merge_arity,
                out_prefix=f"pre_p{self.process_index:05d}_",
                budget=self.budget,
            )
            canonical = self._partial_name(self.process_index)
            if reduced != canonical:
                if reduced.startswith("pre_p"):
                    # an intermediate partial: move it (no payload rewrite)
                    self.store.rename_record(reduced, canonical)
                else:
                    # a leaf shard record (a one-shard range): keep the
                    # leaf, copy it to the canonical partial name
                    assembly, _ = self.store.read_assembly(reduced)
                    self.store.write_assembly(canonical, assembly)
        if self.process_index == self.root:
            _write_nodespace_record(self.store, self.nodes, self.props)
        self._seconds += time.perf_counter() - t0

    def phase_merge_round(self, round_index: int) -> None:
        """My pair (if any) of reduce round ``round_index``: load the
        partner's partial, merge it after mine, write the result back over
        my partial."""
        from ..core.serialize import merge_assemblies

        t0 = time.perf_counter()
        for dst, src in self.schedule[round_index]:
            if self.active[dst] != self.process_index:
                continue
            mine, nb_dst = self.store.read_assembly(self._partial_name(self.active[dst]))
            theirs, nb_src = self.store.read_assembly(self._partial_name(self.active[src]))
            merged = merge_assemblies([mine, theirs])
            out_bytes = self.store.write_assembly(
                self._partial_name(self.active[dst]), merged
            )
            self.budget.note_merge(nb_dst + nb_src + out_bytes)
        self.budget.n_merge_rounds += 1
        self._seconds += time.perf_counter() - t0

    def phase_finish(self):
        """Load the root partial, finalise the manifest (root process
        only), and return the
        :class:`~repro_torch.core.extract.ExtractionResult`, the same on
        every process."""
        from ..core.extract import ExtractionResult, _graph_from_assembly

        t0 = time.perf_counter()
        merged, _ = self.store.read_assembly(self._partial_name(self.root))
        if self.process_index == self.root:
            self.store.finalize(meta={
                "kind": "extraction_spill",
                "n_shards": self.n_shards,
                "n_rules": len(self._plans or []),
                "mode": self.mode,
                "preprocess": self.preprocess,
                "final_record": self._partial_name(self.root),
                "process_count": self.process_count,
            })
        graph = _graph_from_assembly(
            self.nodes, self.props, merged, self.preprocess
        )
        self._seconds += time.perf_counter() - t0
        return ExtractionResult(
            graph=graph,
            nodes=self.nodes,
            plans=[p for p, _, _ in (self._plans or [])],
            seconds=self._seconds,
            dropped_endpoints=merged.dropped,
            mode=self.mode,
            n_shards=self.n_shards,
            budget=self.budget,
        )

    def run(self):
        """Every phase with barriers between; for one process, the plain
        spilled pipeline (no barriers, the full shard range)."""
        self.phase_nodes()
        self.barrier("spill:nodes")
        self.phase_shards()
        self.barrier("spill:shards")
        for r in range(len(self.schedule)):
            self.phase_merge_round(r)
            self.barrier(f"spill:merge{r}")
        return self.phase_finish()


# ---------------------------------------------------------------------------
# Edge-sharded condensed graphs
# ---------------------------------------------------------------------------

def _slices(a: torch.Tensor, fill, n_slices: int, first: int, k: int) -> torch.Tensor:
    """``a`` padded with ``fill`` to a multiple of ``n_slices``, cut into
    equal contiguous slices, and slices ``first .. first + k - 1`` kept
    as a ``(k, len / n_slices)`` tensor."""
    pad = (-a.shape[0]) % n_slices
    if pad:
        a = torch.cat([a, torch.full((pad,), fill, dtype=a.dtype, device=a.device)])
    return a.reshape(n_slices, -1)[first:first + k].contiguous()


def shard_condensed(dev_graph, group=None, slices_per_rank: int = 1):
    """This rank's share of an edge-sharded condensed graph.

    Every layer's edges and the DEDUP-C correction are cut into
    ``world × slices_per_rank`` equal contiguous slices; the rank keeps
    its ``slices_per_rank`` consecutive ones (rank ``r`` slices ``r·k ..
    r·k + k − 1``).  Ragged lists are padded with the JAX example's inert
    entries (``examples/graph_analytics_distributed.py``, ``shard_graph``):
    every virtual level grows by two dummies, padded in-edges write dummy
    A (which no edge reads) and padded out-edges read dummy B (which no
    edge writes), so no complete path and no mass is added; padded
    correction rows have count 0.  ``diag_mult`` stays whole on every rank.

    :func:`repro_torch.core.engine.propagate` runs such a graph on its
    segment path: each hop's slices are summed in slice order, then
    all-reduced over ``group`` (``h`` after every inner hop, ``y`` less
    the correction's partial after the last).  The bitmap kernels (K1–K3)
    need whole layers, so a packed graph whose backend is ``'cuda'``
    raises here rather than quietly taking the segment path.  Direct
    edges have no virtual node to pad into and are refused."""
    from ..core.engine import DeviceBipartite, DeviceCondensed, DevicePacked

    if isinstance(dev_graph, DevicePacked):
        if dev_graph.backend == "cuda":
            raise ValueError(
                "backend='cuda' cannot run an edge-sharded graph: the bitmap "
                "kernels (K1-K3) need whole layers; shard a DeviceCondensed or "
                "a packed graph on the 'segment' / 'auto' backend"
            )
    elif not isinstance(dev_graph, DeviceCondensed):
        raise TypeError(f"shard_condensed takes a condensed device graph, "
                        f"not {type(dev_graph).__name__}")
    if dev_graph.direct is not None:
        raise ValueError("edge sharding pads condensed chains through dummy "
                         "virtual nodes; a graph with direct edges has none")
    if getattr(dev_graph, "edge_slices", 0):
        raise ValueError("the graph is edge-sharded already")
    k = int(slices_per_rank)
    if k < 1:
        raise ValueError(f"slices_per_rank must be >= 1, got {k}")
    rank, world = rank_world(group)
    n_slices, first = world * k, rank * k

    chains = []
    for chain in dev_graph.chains:
        last = len(chain) - 1
        layers = []
        for li, e in enumerate(chain):
            # grow every virtual level by 2 dummies: dummy A (index n) has
            # only in-edges, dummy B (index n + 1) only out-edges
            n_src = e.n_src + (2 if li > 0 else 0)
            n_dst = e.n_dst + (2 if li < last else 0)
            dummy_dst = e.n_dst if li < last else 0
            dummy_src = e.n_src + 1 if li > 0 else 0
            layers.append(DeviceBipartite(
                _slices(e.src, dummy_src, n_slices, first, k),
                _slices(e.dst, dummy_dst, n_slices, first, k),
                n_src, n_dst,
            ))
        chains.append(tuple(layers))
    corr = None
    if dev_graph.correction is not None:
        cs, cd, cm = dev_graph.correction
        corr = tuple(_slices(t, 0, n_slices, first, k) for t in (cs, cd, cm))
    return DeviceCondensed(
        chains=tuple(chains),
        direct=None,
        correction=corr,
        diag_mult=dev_graph.diag_mult,
        n_real=dev_graph.n_real,
        deduplicated=dev_graph.deduplicated,
        graph_version=dev_graph.graph_version,
        device=dev_graph.device,
        group=group,
        edge_slices=k,
    )
