"""Cell builders: (arch, shape, mesh) -> (fn, argument specs, shardings),
and serving replica placement (DESIGN.md §10).

The port of the JAX package's ``launch/cells.py``.  One *cell* is an
assigned (architecture x input-shape) pair.  :func:`build_cell` returns
its step function, its arguments as :class:`ArgSpec` trees (shape and
dtype at global size: the counterpart of ``jax.ShapeDtypeStruct``) and
their shardings as :class:`~repro_torch.distributed.sharding.Spec` trees
(entry for entry the reference's ``PartitionSpec``).  :func:`materialize`
turns the specs into tensors on a mesh: fake ones under a
``FakeTensorMode`` (the dry-run: no memory is touched, so the 40
full-size cells fit one host), or real ones on the card (the smoke's
host-mesh cells).  On a mesh of more than one rank each argument is a
DTensor holding this rank's shard; on a one-rank mesh it is a plain
tensor, and the step runs as it runs unsharded.

Step run per shape kind, as in the reference:
  train   -> train_step(state, batch)     (params + optimizer included)
  prefill -> prefill(params, tokens)      (serve dtype: bf16 params)
  decode  -> decode(params, cache, token) (a KV cache full but for one slot)
  score_* -> sasrec scoring functions
  graphgen pagerank -> PageRank over the COO condensed graph, edge-sharded
                       (variant 'banded': the band-partitioned PageRank)

Where the port's trees differ from the reference's: a decode cache's
``length`` is a Python int in the port (the reference traces an int32
scalar); the graphgen cells' functions take their arrays as the
reference's do.  ``depth`` and ``microbatches`` cut a cell for the
dry-run's trip-count fit (:func:`repro_torch.launch.op_cost.extrapolate`):
an LM cell with ``depth`` layers, and ``microbatches`` of the config's rows
each (the global batch scaled with them); a GNN cell with ``depth``
layers; a graphgen cell with ``depth`` PageRank iterations.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs import registry
from ..configs import shapes as shp
from ..configs.base import GNNConfig, RecsysConfig, TransformerConfig
from ..distributed.sharding import (Spec, _dedup_axes, _placements, local_shape_and_offset,
                                    logical_spec, specs_for_tree)
from ..models import gnn, sasrec, transformer
from ..train import optimizer as opt_lib
from ..train import steps

__all__ = [
    "ArgSpec", "Cell", "build_cell", "all_cells", "materialize", "cell_leaves",
    "ReplicaPlacement", "place_serving_replicas",
]


@dataclasses.dataclass(frozen=True)
class ArgSpec:
    """A tensor argument's global shape and dtype (``jax.ShapeDtypeStruct``),
    and how a real run fills it: ``"param"`` N(0, 0.02), ``"normal"``
    N(0, 1), ``"zeros"``, ``"true"`` or ``"randint"`` in ``[0, high)``."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: str = "normal"
    high: int = 0


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    fn: Callable
    args: Tuple[Any, ...]
    in_shardings: Any
    rules: Dict
    cfg: Any
    flops_note: str = ""
    donate: Tuple[int, ...] = ()   # donated arg indices (state / KV cache)
    mesh: Any = None


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _map(fn, tree, *others):
    """``fn`` over the ArgSpec leaves of ``tree`` (dicts, tuples, the
    GraphBatch / KVCache dataclasses), zipped with ``others`` of the same
    structure; other leaves (ints, ``None``) are kept."""
    if isinstance(tree, ArgSpec):
        return fn(tree, *others)
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(o[k] for o in others)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v, *(o[i] for o in others)) for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name), *(getattr(o, f.name) for o in others))
            for f in dataclasses.fields(tree)})
    return tree


def cell_leaves(cell: Cell) -> Dict[str, Tuple[ArgSpec, Spec]]:
    """Every tensor argument of ``cell`` by its path (``"0/params/embed"``,
    ``"1/graph/edge_src"``): ``(ArgSpec, Spec)``."""
    out: Dict[str, Tuple[ArgSpec, Spec]] = {}

    def walk(tree, sh, path):
        if isinstance(tree, ArgSpec):
            out[path] = (tree, sh)
        elif isinstance(tree, dict):
            for k in tree:
                walk(tree[k], sh[k], f"{path}/{k}")
        elif isinstance(tree, (tuple, list)):
            for i, v in enumerate(tree):
                walk(v, sh[i], f"{path}/{i}")
        elif dataclasses.is_dataclass(tree):
            for f in dataclasses.fields(tree):
                walk(getattr(tree, f.name), getattr(sh, f.name), f"{path}/{f.name}")

    for i, (a, s) in enumerate(zip(cell.args, cell.in_shardings)):
        walk(a, s, str(i))
    return out


def _specs_of(tree, init: str = "param"):
    """A tree of tensors (on the meta device) -> the same tree of ArgSpecs."""
    if isinstance(tree, torch.Tensor):
        return ArgSpec(tuple(tree.shape), tree.dtype, init)
    if isinstance(tree, dict):
        return {k: _specs_of(v, init) for k, v in tree.items()}
    raise TypeError(type(tree))


def _fill(spec: ArgSpec, device, gen: torch.Generator, shape) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=spec.dtype, device=device)
    if spec.init == "true":
        return torch.ones(shape, dtype=spec.dtype, device=device)
    if spec.init == "randint":
        return torch.randint(0, spec.high, shape, generator=gen, device=device, dtype=spec.dtype)
    scale = 0.02 if spec.init == "param" else 1.0
    return (torch.randn(shape, generator=gen, device=device) * scale).to(spec.dtype)


def materialize(cell: Cell, device, fill: bool = False, seed: int = 0):
    """The cell's arguments as tensors on ``device`` (a list, one per
    argument): each rank's shard as a DTensor on ``cell.mesh`` when it has
    more than one rank, a plain tensor on a one-rank mesh.  Inside a
    ``FakeTensorMode`` they are fake; with ``fill`` real ones are drawn
    from ``seed`` by each spec's ``init`` (else left empty)."""
    mesh = cell.mesh
    gen = torch.Generator(device=device).manual_seed(seed) if fill else None

    def make(spec: ArgSpec, sh) -> torch.Tensor:
        if mesh is None or mesh.size() == 1:
            shape = spec.shape
            pl = None
        else:
            pl = _placements(_dedup_axes(sh if sh is not None else Spec()), mesh)
            shape, _ = local_shape_and_offset(spec.shape, mesh, pl)
        t = (_fill(spec, device, gen, tuple(shape)) if fill
             else torch.empty(tuple(shape), dtype=spec.dtype, device=device))
        if pl is None:
            return t
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(t, mesh, pl, run_check=False, shape=torch.Size(spec.shape),
                                  stride=_strides(spec.shape))

    return [_map(make, a, s) for a, s in zip(cell.args, cell.in_shardings)]


def _strides(shape) -> Tuple[int, ...]:
    out, acc = [], 1
    for s in reversed(shape):
        out.append(acc)
        acc *= s
    return tuple(reversed(out))


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------

def _ns(mesh, rules, axes) -> Spec:
    # keep-first duplicate resolution (e.g. cache_seq and kv_heads both on
    # 'model' for MHA-style archs: the seq dim wins, heads replicate)
    return _dedup_axes(logical_spec(axes, rules, mesh))


def _replicated_tree(tree):
    return _map(lambda _: Spec(), tree)


def _opt_specs(opt_struct, param_specs):
    """Optimizer-state specs derived from param specs (the reference's
    ``_opt_shardings``): adamw / sgdm moments mirror params; adafactor's
    factored ``r`` / ``c`` drop the last / second-to-last axis of the
    param spec."""
    def factored(spec, sub):
        if isinstance(spec, dict):
            return {k: factored(spec[k], sub[k]) for k in sub}
        out = {}
        for k in sub:
            if k == "v":
                out[k] = Spec(*spec)
            elif k == "r":
                out[k] = Spec(*spec[:-1])
            elif k == "c":
                out[k] = Spec(*(tuple(spec[:-2]) + tuple(spec[-1:])))
        return out

    out = {}
    for key, sub in opt_struct.items():
        if key in ("m", "v", "mom"):
            out[key] = param_specs
        elif key == "f":
            out[key] = factored(param_specs, sub)
        else:
            out[key] = _replicated_tree(sub)
    return out


def _choose_optimizer(arch_mod):
    name = getattr(arch_mod, "OPTIMIZER", "adamw")
    if name == "adafactor":
        return opt_lib.adafactor(1e-2)
    moment_dtype = getattr(arch_mod.CONFIG, "opt_state_dtype", "float32")
    return opt_lib.adamw(3e-4, moment_dtype=moment_dtype)


def _step_spec() -> ArgSpec:
    return ArgSpec((), torch.int32, "zeros")


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_cell(arch, arch_mod, cfg: TransformerConfig, shape: shp.LMShape, mesh,
             microbatches: Optional[int] = None) -> Cell:
    rules = dict(cfg.sharding_rules)
    V = cfg.vocab_size

    if shape.kind == "train":
        batch = shape.global_batch
        if microbatches is not None:       # the config's rows per microbatch, scaled
            batch = shape.global_batch // cfg.microbatches * microbatches
            cfg = dataclasses.replace(cfg, microbatches=microbatches)
        optimizer = _choose_optimizer(arch_mod)
        step = steps.build_lm_train_step(cfg, optimizer)
        params = transformer.init_params(cfg, None, "meta",
                                         dtype=transformer.torch_dtype(cfg.param_dtype))
        params_s = _specs_of(params)
        opt_s = _specs_of(optimizer.init(params), "zeros")
        state_s = {"params": params_s, "opt": opt_s, "step": _step_spec()}
        tok = ArgSpec((batch, shape.seq_len), torch.int32, "randint", V)
        batch_s = {"tokens": tok, "labels": tok}
        param_specs = specs_for_tree(transformer.logical_axes(cfg), rules, mesh)
        state_sh = {"params": param_specs, "opt": _opt_specs(opt_s, param_specs),
                    "step": Spec()}
        rows = _ns(mesh, rules, ("batch", None))
        return Cell(arch, shape.name, "train", step, (state_s, batch_s),
                    (state_sh, {"tokens": rows, "labels": rows}), rules, cfg, donate=(0,),
                    mesh=mesh)

    scfg = dataclasses.replace(cfg, param_dtype="bfloat16", remat_policy="none",
                               microbatches=1)
    params_s = _specs_of(transformer.init_params(scfg, None, "meta", dtype=torch.bfloat16))
    param_specs = specs_for_tree(transformer.logical_axes(scfg), rules, mesh)

    if shape.kind == "prefill":
        fn = steps.build_lm_prefill_step(scfg, max_len=shape.seq_len)
        tokens_s = ArgSpec((shape.global_batch, shape.seq_len), torch.int32, "randint", V)
        return Cell(arch, shape.name, "prefill", fn, (params_s, tokens_s),
                    (param_specs, _ns(mesh, rules, ("batch", None))), rules, scfg, mesh=mesh)

    # decode: one new token against a full cache.  The cache sequence dim
    # carries the model axis (the batch dim cannot absorb 256-512 ranks),
    # and the cache is donated (updated in place).
    if shape.name == "long_500k":
        rules = {**rules, "cache_batch": None, "cache_seq": ("pod", "data", "model")}
    else:
        rules = {**rules, "cache_seq": "model"}
    fn = steps.build_lm_decode_step(scfg)
    kv = ArgSpec((scfg.n_layers, shape.global_batch, shape.seq_len, scfg.n_kv_heads,
                  scfg.resolved_head_dim), torch.bfloat16, "zeros")
    cache_s = transformer.KVCache(k=kv, v=kv, length=shape.seq_len - 1)
    kv_sh = _ns(mesh, rules, transformer.cache_logical_axes())
    cache_sh = transformer.KVCache(k=kv_sh, v=kv_sh, length=None)
    token_s = ArgSpec((shape.global_batch, 1), torch.int32, "randint", V)
    token_sh = _ns(mesh, rules, ("cache_batch", None))
    return Cell(arch, shape.name, "decode", fn, (params_s, cache_s, token_s),
                (param_specs, cache_sh, token_sh), rules, scfg, donate=(1,), mesh=mesh)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _gnn_graph_struct(cfg: GNNConfig, shape: shp.GNNShape) -> gnn.GraphBatch:
    N, E = shape.n_nodes, shape.n_edges
    needs_pos = cfg.kind in ("schnet", "dimenet", "meshgraphnet", "graphcast")
    tri = tri_mask = None
    if cfg.kind == "dimenet":
        T = shp.triplet_count(shape, cfg.triplet_factor)
        tri = ArgSpec((T, 2), torch.int32, "randint", E)
        tri_mask = ArgSpec((T,), torch.bool, "true")
    return gnn.GraphBatch(
        nodes=ArgSpec((N, shape.d_feat), torch.float32),
        edge_src=ArgSpec((E,), torch.int32, "randint", N),
        edge_dst=ArgSpec((E,), torch.int32, "randint", N),
        node_mask=ArgSpec((N,), torch.bool, "true"),
        edge_mask=ArgSpec((E,), torch.bool, "true"),
        positions=ArgSpec((N, 3), torch.float32) if needs_pos else None,
        edge_feat=None,
        graph_ids=(ArgSpec((N,), torch.int32, "randint", shape.n_graphs)
                   if shape.n_graphs > 1 else None),
        triplets=tri,
        triplet_mask=tri_mask,
        n_graphs=shape.n_graphs,
    )


def _gnn_graph_shardings(cfg, shape, mesh, rules) -> gnn.GraphBatch:
    n_ax, e_ax = ("nodes",), ("edges",)
    pos = cfg.kind in ("schnet", "dimenet", "meshgraphnet", "graphcast")
    return gnn.GraphBatch(
        nodes=_ns(mesh, rules, n_ax + (None,)),
        edge_src=_ns(mesh, rules, e_ax),
        edge_dst=_ns(mesh, rules, e_ax),
        node_mask=_ns(mesh, rules, n_ax),
        edge_mask=_ns(mesh, rules, e_ax),
        positions=_ns(mesh, rules, n_ax + (None,)) if pos else None,
        edge_feat=None,
        graph_ids=_ns(mesh, rules, n_ax) if shape.n_graphs > 1 else None,
        triplets=_ns(mesh, rules, e_ax + (None,)) if cfg.kind == "dimenet" else None,
        triplet_mask=_ns(mesh, rules, e_ax) if cfg.kind == "dimenet" else None,
        n_graphs=shape.n_graphs,
    )


def _gnn_cell(arch, arch_mod, cfg: GNNConfig, shape: shp.GNNShape, mesh) -> Cell:
    rules = dict(cfg.sharding_rules)
    optimizer = opt_lib.adamw(3e-4)
    step = steps.build_gnn_train_step(cfg, optimizer)
    params = gnn.init_params(cfg, None, d_in=shape.d_feat, d_edge_in=4, device="meta")
    params_s = _specs_of(params)
    opt_s = _specs_of(optimizer.init(params), "zeros")
    state_s = {"params": params_s, "opt": opt_s, "step": _step_spec()}
    graph_s = _gnn_graph_struct(cfg, shape)
    graph_level = cfg.kind in ("schnet", "dimenet") and shape.n_graphs > 1
    target_s = ArgSpec((shape.n_graphs if graph_level else shape.n_nodes, cfg.d_out),
                       torch.float32)
    state_sh = {"params": _replicated_tree(params_s),   # GNN weights are tiny
                "opt": _replicated_tree(opt_s), "step": Spec()}
    graph_sh = _gnn_graph_shardings(cfg, shape, mesh, rules)
    target_sh = _ns(mesh, rules, ("batch", None) if graph_level else ("nodes", None))
    return Cell(arch, shape.name, "train", step,
                (state_s, {"graph": graph_s, "target": target_s}),
                (state_sh, {"graph": graph_sh, "target": target_sh}), rules, cfg,
                donate=(0,), mesh=mesh)


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------

def _rec_cell(arch, arch_mod, cfg: RecsysConfig, shape: shp.RecShape, mesh) -> Cell:
    rules = dict(cfg.sharding_rules)
    params = sasrec.init_params(cfg, None, "meta")
    params_s = _specs_of(params)
    param_specs = specs_for_tree(sasrec.logical_axes(cfg), rules, mesh)
    ids = lambda *s: ArgSpec(s, torch.int32, "randint", cfg.n_items)  # noqa: E731

    if shape.kind == "train":
        optimizer = opt_lib.adamw(1e-3)
        step = steps.build_sasrec_train_step(cfg, optimizer)
        opt_s = _specs_of(optimizer.init(params), "zeros")
        state_s = {"params": params_s, "opt": opt_s, "step": _step_spec()}
        batch_s = {k: ids(shape.batch, cfg.seq_len) for k in ("seqs", "pos", "neg")}
        state_sh = {"params": param_specs, "opt": _opt_specs(opt_s, param_specs),
                    "step": Spec()}
        batch_sh = {k: _ns(mesh, rules, ("batch", None)) for k in batch_s}
        return Cell(arch, shape.name, "train", step, (state_s, batch_s),
                    (state_sh, batch_sh), rules, cfg, donate=(0,), mesh=mesh)

    seqs_s = ids(shape.batch, cfg.seq_len)
    # batch=1 retrieval cannot shard the batch dim; parallelism lives on
    # the candidate/item axis instead.
    seqs_sh = _ns(mesh, rules, ("batch", None) if shape.batch > 1 else (None, None))
    if shape.kind == "score_all":
        # offline bulk scoring tiles the batch so logits stay bounded
        bc = 4096 if shape.batch > 8192 else None
        fn = lambda p, s: sasrec.score_all(p, s, cfg, top_k=10, batch_chunk=bc)  # noqa: E731
        return Cell(arch, shape.name, "score_all", fn, (params_s, seqs_s),
                    (param_specs, seqs_sh), rules, cfg, mesh=mesh)
    cand_s = ids(shape.batch, shape.n_candidates)
    cand_sh = _ns(mesh, rules, (None, "items"))
    fn = lambda p, s, c: sasrec.score_candidates(p, s, c, cfg)  # noqa: E731
    return Cell(arch, shape.name, "score_cand", fn, (params_s, seqs_s, cand_s),
                (param_specs, seqs_sh, cand_sh), rules, cfg, mesh=mesh)


# ---------------------------------------------------------------------------
# GraphGen (paper) cells
# ---------------------------------------------------------------------------

def _mesh_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data", "model") if a in mesh.mesh_dim_names)


def _local(t: torch.Tensor) -> torch.Tensor:
    from ..distributed.sharding import is_dtensor

    return t.to_local() if is_dtensor(t) else t


def _graphgen_banded_cell(arch, cfg, shape_name, mesh) -> Cell:
    """§Perf variant 'banded': the band-partitioned PageRank of
    :mod:`repro_torch.core.banding` — one all-gather + one reduce-scatter
    per iteration instead of per-hop all-reduces.  Each rank holds one
    band of every array (their flat ``P(axes)`` split)."""
    from ..core.banding import make_banded_pagerank

    rules = dict(cfg.sharding_rules)
    axes = _mesh_axes(mesh)
    n_sh = mesh.size()
    vb_pad = cfg.n_virtual // n_sh + 2          # +2 inert pad slots per band
    pagerank = make_banded_pagerank(None, cfg.n_real, n_sh * vb_pad, n_sh,
                                    iters=cfg.pagerank_iters)

    def fn(args):
        # one band per rank: the (1, width) rows make_banded_pagerank reads
        local = {k: _local(v) for k, v in args.items()}
        return pagerank({k: (v if k == "deg" else v.reshape(1, -1)) for k, v in local.items()})

    E, C = cfg.n_in_edges, cfg.n_correction
    args_s = {
        "in_src": ArgSpec((E,), torch.int32, "randint", cfg.n_real),
        "in_dst": ArgSpec((E,), torch.int32, "randint", vb_pad),
        "out_src": ArgSpec((E,), torch.int32, "randint", vb_pad),
        "out_dst": ArgSpec((E,), torch.int32, "randint", cfg.n_real),
        "corr_src": ArgSpec((C,), torch.int32, "randint", cfg.n_real),
        "corr_dst": ArgSpec((C,), torch.int32, "randint", cfg.n_real // n_sh),
        "corr_cnt": ArgSpec((C,), torch.float32, "zeros"),
        "deg": ArgSpec((cfg.n_real,), torch.float32, "true"),
    }
    sh = Spec(axes)
    return Cell(arch, shape_name, "analytics", fn, (args_s,), ({k: sh for k in args_s},),
                rules, cfg, mesh=mesh)


def _graphgen_cell(arch, arch_mod, cfg, shape_name, mesh) -> Cell:
    """PageRank over the COO condensed graph (one author -> pub -> author
    chain and the DEDUP-C correction) on the segment path, its edges and
    correction split over every mesh dim: each rank holds one slice of each
    (an edge-sharded :class:`~repro_torch.core.engine.DeviceCondensed`,
    whose hops are all-reduced over the group), as the reference's cell
    splits its arrays over ``"edges"``."""
    from ..core import algorithms, engine

    rules = dict(cfg.sharding_rules)
    sliced = mesh.size() > 1

    def pagerank_step(args):
        a = {k: _local(v) for k, v in args.items()}
        if sliced:
            a = {k: (v if k == "diag" else v.reshape(1, -1)) for k, v in a.items()}
        fwd = engine.DeviceBipartite(a["in_src"], a["in_dst"], cfg.n_real, cfg.n_virtual)
        rev = engine.DeviceBipartite(a["in_dst"], a["in_src"], cfg.n_virtual, cfg.n_real)
        g = engine.DeviceCondensed(
            chains=((fwd, rev),), direct=None,
            correction=(a["corr_src"], a["corr_dst"], a["corr_cnt"]), diag_mult=None,
            n_real=cfg.n_real, deduplicated=False, device=a["diag"].device,
            group=None, edge_slices=1 if sliced else 0,
        )
        return algorithms.pagerank(g, num_iters=cfg.pagerank_iters)

    E, C = cfg.n_in_edges, cfg.n_correction
    args_s = {
        "in_src": ArgSpec((E,), torch.int32, "randint", cfg.n_real),
        "in_dst": ArgSpec((E,), torch.int32, "randint", cfg.n_virtual),
        "corr_src": ArgSpec((C,), torch.int32, "randint", cfg.n_real),
        "corr_dst": ArgSpec((C,), torch.int32, "randint", cfg.n_real),
        "corr_cnt": ArgSpec((C,), torch.float32, "zeros"),
        "diag": ArgSpec((cfg.n_real,), torch.float32, "zeros"),
    }
    e_sh = _ns(mesh, rules, ("edges",))
    args_sh = {k: e_sh for k in args_s}
    args_sh["diag"] = _ns(mesh, rules, ("nodes",))
    return Cell(arch, shape_name, "analytics", pagerank_step, (args_s,), (args_sh,), rules,
                cfg, mesh=mesh)


# ---------------------------------------------------------------------------
# Serving replica placement (DESIGN.md §10)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReplicaPlacement:
    """One serving replica pinned to a contiguous device group."""

    tenant: str
    replica: int
    devices: Tuple[int, ...]


def place_serving_replicas(
    tenants,
    n_devices: int,
    *,
    group_size: int = 1,
    replicas: int = 1,
) -> list:
    """Place ``replicas`` serving replicas per tenant over ``n_devices``.

    Devices are carved into contiguous groups of ``group_size`` (a group
    is one :class:`~repro_torch.serve.tier.GraphServingTier` process's
    devices); tenant replicas go round-robin over the groups, so group
    load is balanced to within one replica and two replicas of the same
    tenant never share a group (they exist to survive that group).  Pure
    planning — no devices are touched; launchers consume the returned
    :class:`ReplicaPlacement` list.
    """
    tenants = list(tenants)
    if group_size <= 0 or n_devices < group_size:
        raise ValueError(
            f"need at least one group of {group_size} devices, have "
            f"{n_devices}"
        )
    groups = [
        tuple(range(g * group_size, (g + 1) * group_size))
        for g in range(n_devices // group_size)
    ]
    if replicas > len(groups):
        raise ValueError(
            f"{replicas} replicas per tenant need {replicas} distinct "
            f"device groups, have {len(groups)}"
        )
    # consecutive slots per tenant: replicas land on consecutive groups
    # (mod G), so with replicas <= len(groups) a tenant's replicas are
    # always disjoint, and sequential slot assignment keeps group load
    # balanced to within one replica
    out = []
    slot = 0
    for tenant in tenants:
        for r in range(replicas):
            out.append(ReplicaPlacement(
                tenant=tenant, replica=r,
                devices=groups[slot % len(groups)],
            ))
            slot += 1
    return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def build_cell(
    arch: str, shape: str, mesh, smoke: bool = False, variant: Optional[str] = None,
    *, depth: Optional[int] = None, microbatches: Optional[int] = None,
    batch: Optional[int] = None,
) -> Cell:
    """``variant`` applies a documented beyond-baseline tweak:
    'a2a'      — MoE expert-parallel all-to-all dispatch
    'zero3'    — parameters sharded over the pod axis as well (DCI FSDP)
    'banded'   — graphgen band-partitioned propagation
    ``depth`` / ``microbatches`` cut the cell for the trip-count fit (see
    the module docstring); ``batch`` replaces an LM shape's global batch
    (a host-mesh cell that one card holds)."""
    mod = registry.get_arch(arch)
    cfg = mod.SMOKE if smoke else mod.CONFIG
    if variant == "a2a":
        if getattr(cfg, "moe", None) is None:
            raise ValueError(f"variant 'a2a' needs a MoE arch, got {arch}")
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch="a2a"))
    elif variant == "zero3":
        # params (and optimizer state) sharded over the pod axis too:
        # ZeRO-3 across DCI — the memory prescription for 405B-class train
        cfg = dataclasses.replace(
            cfg, sharding_rules={**cfg.sharding_rules, "embed_param": ("pod", "data")})
    elif variant == "banded":
        if mod.SHAPE_FAMILY != "graphgen":
            raise ValueError("variant 'banded' applies to graphgen-paper")
        if depth is not None:
            cfg = dataclasses.replace(cfg, pagerank_iters=depth)
        return _graphgen_banded_cell(arch, cfg, shape, mesh)
    elif variant is not None:
        raise ValueError(f"unknown variant {variant!r}")
    fam = mod.SHAPE_FAMILY
    if depth is not None:
        field = "pagerank_iters" if fam == "graphgen" else "n_layers"
        cfg = dataclasses.replace(cfg, **{field: depth})
    if fam == "lm":
        lm_shape = shp.LM_SHAPES[shape]
        if batch is not None:
            lm_shape = dataclasses.replace(lm_shape, global_batch=batch)
        return _lm_cell(arch, mod, cfg, lm_shape, mesh, microbatches)
    if fam == "gnn":
        return _gnn_cell(arch, mod, cfg, shp.GNN_SHAPES[shape], mesh)
    if fam == "recsys":
        return _rec_cell(arch, mod, cfg, shp.REC_SHAPES[shape], mesh)
    if fam == "graphgen":
        return _graphgen_cell(arch, mod, cfg, shape, mesh)
    raise ValueError(fam)


def all_cells() -> list:
    """The 40 assigned (arch x shape) pairs."""
    out = []
    for arch in registry.list_archs(assigned_only=True):
        for shape in registry.shapes_for(arch):
            out.append((arch, shape))
    return out
