"""Per-rank cost of one step from the ops it dispatches: FLOPs, HBM bytes,
collective bytes, peak bytes and op counts.

The port's counterpart of the JAX package's ``launch/hlo_cost.py``.  The
reference walks compiled HLO text; the port has no compiled program, so
:func:`measure` runs the step once under a dispatch mode
(:class:`CostMode`) and counts what one rank dispatches.  Over fake
tensors (``FakeTensorMode``) and a fake process group the step allocates
nothing and moves no data, so a cell of a 256 / 512-rank mesh is measured
in one process; over real tensors the same count runs beside the real
step, which is how the smoke holds a prediction to the card.

* **FLOPs** from ``torch.utils.flop_counter``'s formulas (K4's op
  registers its own).  Only plain-tensor ops are counted: an op on
  DTensors is handed back to DTensor, whose local ops on this rank's
  shards come through the mode again, so a sharded product counts as
  its local product.  The ops DTensor's sharding propagation runs on fake
  tensors at global shapes (to learn an output's shape) are skipped.
* **HBM bytes**: operand + result bytes of each op that is not a view
  or a metadata query, the eager counterpart of the reference's bytes at
  fusion boundaries (every eager op reads and writes HBM).
* **Collective bytes**: the operand bytes of each ``c10d`` /
  ``_c10d_functional`` collective, as the reference sums operands.  Each
  group is decoded to its global ranks: ``ici`` / ``dci`` keep the
  reference's split (inside, or across, a pod of
  :data:`~repro_torch.launch.mesh.POD_SIZE` ranks); ``nvlink`` /
  ``network`` are the H100 split (inside, or across, a node of
  :data:`~repro_torch.launch.mesh.NODE_SIZE`).
* **Peak bytes**: the storages alive at once, each rounded up to the CUDA
  caching allocator's 512 bytes: the arguments' storages at the start,
  then every storage an op creates, until it is freed.  A donated
  argument (``Cell.donate``) is updated in place by the step (a train
  state leaf by leaf, a KV cache's buffers), so its old leaves are freed
  as they are replaced, which is what ``jit(donate_argnums=)`` lets XLA
  do.
* **Op counts** of the port's registered ops (``repro_torch.*``: K4).

Trip counts: the reference multiplies ``while`` bodies by their trip
count.  The port's steps are Python loops, so a full trace walks every
layer and microbatch; :func:`extrapolate` fits a cost that is quadratic in
the layer count and affine in the microbatch count from six small traces,
which is exact for the counts and close for the peak
(``tests/test_torch_dryrun.py`` holds both to a full trace).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import weakref
from typing import Callable, Dict, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .mesh import NODE_SIZE, POD_SIZE

__all__ = ["OpCost", "CostMode", "measure", "extrapolate", "LINEAR_FIELDS"]

ALIGN = 512                           # the CUDA caching allocator's rounding

# ops that move no data
_NO_BYTES = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "detach",
    "alias", "lift_fresh", "lift_fresh_copy", "_local_scalar_dense", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size", "_to_copy_meta",
    "device", "layout", "dim", "stride", "size", "wait_tensor", "set_",
}
LINEAR_FIELDS = ("flops", "bytes", "ici_bytes", "dci_bytes", "nvlink_bytes", "network_bytes",
                 "n_collectives")


@dataclasses.dataclass
class OpCost:
    """One rank's cost of one step (see the module docstring)."""

    flops: float = 0.0
    bytes: float = 0.0
    ici_bytes: float = 0.0
    dci_bytes: float = 0.0
    nvlink_bytes: float = 0.0
    network_bytes: float = 0.0
    n_collectives: float = 0.0
    by_collective: Dict[str, float] = dataclasses.field(default_factory=dict)
    op_counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    peak_bytes: float = 0.0
    largest_bytes: float = 0.0       # the largest storage an op made

    @property
    def temp_bytes(self) -> float:
        return max(self.peak_bytes - self.argument_bytes, 0.0)

    def memory_stats(self) -> Dict[str, float]:
        """The reference's ``memory_stats`` keys."""
        return {
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "alias_bytes": 0.0,
            "peak_bytes_per_device": self.peak_bytes,
            "largest_buffer_bytes": self.largest_bytes,
        }


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _group_ranks(args) -> Optional[Sequence[int]]:
    """The global ranks of the process group among a collective's args:
    a ``ProcessGroup`` (``c10d`` ops) or a group name (``_c10d_functional``)."""
    import torch.distributed as dist

    for a in args:
        try:
            if isinstance(a, torch.ScriptObject):
                return dist.get_process_group_ranks(dist.ProcessGroup.unbox(a))
            if isinstance(a, str):
                from torch._C._distributed_c10d import _resolve_process_group

                return dist.get_process_group_ranks(_resolve_process_group(a))
        except (RuntimeError, ValueError):
            continue
    return None


# which argument holds a c10d collective's operand
_C10D_OPERAND = {
    "allreduce_": 0, "allreduce_coalesced_": 0, "broadcast_": 0, "_allgather_base_": 1,
    "allgather_": 1, "allgather_into_tensor_coalesced_": 1, "_reduce_scatter_base_": 1,
    "reduce_scatter_": 1, "reduce_scatter_tensor_coalesced_": 1, "alltoall_base_": 1,
    "alltoall_": 1,
}
_KIND = (("all_gather", "all-gather"), ("allgather", "all-gather"),
         ("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
         ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
         ("alltoall", "all-to-all"), ("broadcast", "broadcast"))


def _collective(func) -> Optional[str]:
    ns = func.namespace
    if ns not in ("c10d", "_c10d_functional"):
        return None
    name = func._opname
    if name in ("wait_tensor", "barrier", "monitored_barrier_"):
        return None
    for key, kind in _KIND:
        if key in name:
            return kind
    return name


class CostMode(TorchDispatchMode):
    """Counts one rank's ops (see the module docstring).  Ops dispatched
    while DTensor's sharding propagation computes an output's global shape
    are not counted (:func:`_dtensor_guard` marks them)."""

    def __init__(self):
        super().__init__()
        self.in_propagation = 0
        self.cost = OpCost()
        self.live = 0
        self._seen = weakref.WeakValueDictionary()     # storage key -> storage (to dedupe)
        from torch.utils.flop_counter import flop_registry

        self._flops = flop_registry

    # -- memory ----------------------------------------------------------
    def track(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage as alive until it is freed; returns the
        bytes it adds (0 if the storage is counted already)."""
        st = t.untyped_storage()
        key = id(st)
        if self._seen.get(key) is st:
            return 0
        n = -(-st.nbytes() // ALIGN) * ALIGN
        self._seen[key] = st
        self.live += n
        weakref.finalize(st, self._free, n)
        self.cost.peak_bytes = max(self.cost.peak_bytes, self.live)
        return n

    def _free(self, n: int) -> None:
        self.live -= n

    # -- dispatch --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = tree_flatten((args, kwargs))[0]
        from ..distributed.sharding import is_dtensor

        if any(is_dtensor(a) for a in flat):
            return NotImplemented          # DTensor runs its local ops through this mode
        out = func(*args, **kwargs)
        if self.in_propagation:
            return out
        ins = [a for a in flat if isinstance(a, torch.Tensor)]
        c = self.cost
        pkt = func._overloadpacket
        if func.namespace == "repro_torch":
            c.op_counts[str(pkt)] = c.op_counts.get(str(pkt), 0) + 1
        formula = self._flops.get(pkt)
        if formula is not None:
            c.flops += float(_flops_of(formula, args, kwargs, out))
        outs = _tensors(out)
        kind = _collective(func)
        if kind is not None:
            self._count_collective(func, kind, args, ins, outs)
        elif func._opname not in _NO_BYTES and func.namespace != "prim" and not _is_view(func):
            c.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        for t in outs:
            c.largest_bytes = max(c.largest_bytes, self.track(t))
        return out

    def _count_collective(self, func, kind, args, ins, outs) -> None:
        c = self.cost
        if func.namespace == "c10d":
            operand = _tensors(args[_C10D_OPERAND.get(func._opname, 0)])
        else:
            operand = _tensors(args[0])
        nbytes = float(sum(_nbytes(t) for t in operand))
        ranks = _group_ranks(args) or [0]
        pods = {r // POD_SIZE for r in ranks}
        nodes = {r // NODE_SIZE for r in ranks}
        if len(pods) > 1:
            c.dci_bytes += nbytes
        else:
            c.ici_bytes += nbytes
        if len(nodes) > 1:
            c.network_bytes += nbytes
        else:
            c.nvlink_bytes += nbytes
        c.n_collectives += 1
        c.by_collective[kind] = c.by_collective.get(kind, 0.0) + nbytes
        c.bytes += nbytes + sum(_nbytes(t) for t in outs)


def _flops_of(formula, args, kwargs, out) -> float:
    """``formula``'s count for one op.  An overload with a trailing
    non-tensor argument the formula does not name (``bmm.dtype``'s
    ``out_dtype``) is counted from its tensor arguments."""
    try:
        return formula(*args, **kwargs, out_val=out)
    except TypeError:
        n = 0
        while n < len(args) and isinstance(args[n], torch.Tensor):
            n += 1
        return formula(*args[:n], out_val=out)


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


def _local(t: torch.Tensor) -> torch.Tensor:
    from ..distributed.sharding import is_dtensor

    return t.to_local() if is_dtensor(t) else t


def _wrap(owner, names, wrapper, patches) -> None:
    """Replace the first of ``names`` that ``owner`` has by
    ``wrapper(original)``, recording it in ``patches`` for restoring."""
    for name in names:
        raw = vars(owner).get(name) if isinstance(owner, type) else getattr(owner, name, None)
        if raw is None:
            continue
        kind = type(raw) if isinstance(raw, (staticmethod, classmethod)) else None
        orig = raw.__func__ if kind is not None else raw
        new = functools.wraps(orig)(wrapper(orig))
        patches.append((owner, name, raw))
        setattr(owner, name, kind(new) if kind is not None else new)
        return


@contextlib.contextmanager
def _dtensor_guard(mode: CostMode):
    """Around DTensor's planning while ``mode`` counts: its shape
    propagation (which runs the op on fake tensors at global shapes) is
    marked so that ``mode`` skips those ops, and its sharding and
    redistribution planning (index arithmetic it does with small tensors)
    runs outside any ambient ``FakeTensorMode``, which would make those
    tensors fake and their values unreadable."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _redistribute, placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    def marked(orig):
        def run(*a, **k):
            mode.in_propagation += 1
            try:
                return orig(*a, **k)
            finally:
                mode.in_propagation -= 1
        return run

    def real(orig):
        def run(*a, **k):
            with unset_fake_temporarily():
                return orig(*a, **k)
        return run

    patches: list = []
    try:
        _wrap(ShardingPropagator, ("_propagate_tensor_meta_non_cached",
                                   "_propagate_tensor_meta"), marked, patches)
        _wrap(ShardingPropagator, ("propagate_op_sharding_non_cached",), real, patches)
        _wrap(_redistribute, ("_gen_transform_infos_non_cached",), real, patches)
        strided = getattr(placement_types, "_StridedShard", None)
        if strided is not None:
            _wrap(strided, ("local_shard_size_and_offset",), real, patches)
        yield
    finally:
        for owner, name, orig in reversed(patches):
            setattr(owner, name, orig)


def measure(fn: Callable, args: Sequence) -> tuple:
    """Run ``fn(*args)`` once under :class:`CostMode`: ``(OpCost, outputs)``.

    The arguments' storages count from the start.  A donated argument (a
    train state, a KV cache) needs no release here: the port's steps update
    it in place (a state dict leaf by leaf, a cache's buffers), so an old
    leaf is freed as soon as the step replaces it."""
    mode = CostMode()
    for t in _tensors(list(args)):
        mode.cost.argument_bytes += mode.track(_local(t))
    with _dtensor_guard(mode), mode:
        out = fn(*args)
    c = mode.cost
    c.output_bytes = float(sum(-(-_local(t).untyped_storage().nbytes() // ALIGN) * ALIGN
                               for t in _tensors(out)))
    return c, out


def _lagrange(xs, x) -> list:
    """The Lagrange weights of the points ``xs`` at ``x``."""
    out = []
    for i, xi in enumerate(xs):
        w = 1.0
        for j, xj in enumerate(xs):
            if j != i:
                w *= (x - xj) / (xi - xj)
        out.append(w)
    return out


def extrapolate(costs: Dict[tuple, OpCost], target: tuple) -> OpCost:
    """The :class:`OpCost` at ``target = (layers, microbatches)`` from the
    costs traced on a grid of small ``(layers, microbatches)`` points: a
    polynomial through the grid in each (its degree one less than the
    points in that direction).  Three layer counts fit a cost quadratic in
    the layers (the eager backward of a stacked param's layer slice writes
    a whole stacked gradient, so its bytes grow with the square), two
    microbatch counts one affine in them; the fit is exact for counts of
    that form.  The bytes held (arguments, outputs, the peak) grow by a
    layer's state and activations per layer: they are fitted affine in the
    layers through the two deepest traces, and the peak is at least the
    largest traced one (a loop that frees each trip's tensors, such as
    PageRank's, peaks early)."""
    ls = sorted({k[0] for k in costs})
    ms = sorted({k[1] for k in costs})

    def fit(get, ls=ls):
        wl, wm = _lagrange(ls, target[0]), _lagrange(ms, target[1])
        return sum(wl[i] * wm[j] * get(costs[l, m])
                   for i, l in enumerate(ls) for j, m in enumerate(ms))

    out = OpCost()
    for f in LINEAR_FIELDS:
        setattr(out, f, fit(lambda c, f=f: getattr(c, f)))
    for f in ("argument_bytes", "output_bytes", "peak_bytes"):     # affine in the layers
        setattr(out, f, fit(lambda c, f=f: getattr(c, f), ls[-2:]))
    out.largest_bytes = max(c.largest_bytes for c in costs.values())
    # a loop that frees what each trip made peaks at its first trips
    out.peak_bytes = max(out.peak_bytes, max(c.peak_bytes for c in costs.values()))
    for name in ("by_collective", "op_counts"):
        keys = set().union(*(getattr(c, name) for c in costs.values()))
        setattr(out, name, {k: fit(lambda c, k=k, name=name: getattr(c, name).get(k, 0.0))
                            for k in sorted(keys)})
    return out
