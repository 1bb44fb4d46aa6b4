"""Public wrappers around the K1/K2 kernels for one packed layer, with the
segment path beside them.

``bitmap_spmm``       one condensed layer:  y = B ⊕ x (any kernel semiring)
``condensed_two_hop`` the paper's hot loop: y = B_out @ (B_in @ x)

Backend selection: ``backend='cuda'`` runs the K1/K2 wrapper
(:func:`repro_torch.kernels.bitmap_spmm.bitmap_spmm`: the kernel on a CUDA
frontier, its plain mirror on a CPU one); ``'segment'`` the gather /
segment-reduce path; ``'auto'`` the kernel when the layer is packed, the
semiring is kernelizable and the frontier is a CUDA tensor on an sm_90
device — the engine's policy — unless a crossover table measured at pack
time (:mod:`repro_torch.kernels.autotune`) covers the cell: then the
measured winner.  ``reverse=True`` propagates along transposed edges
using the reverse packing carried by :class:`PackedLayer`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.condensed import BipartiteEdges
from ..core.engine import PackedOperands, _edge_plan, _on_hopper, _tensor, _upload_operands
from ..core.semiring import PLUS_TIMES, Semiring, kernelizable, segment_reduce
from .autotune import CrossoverTable, KernelConfig
from .pack import BlockSparseBitmap, pack_bipartite

__all__ = [
    "PackedLayer",
    "pack_layer",
    "bitmap_spmm",
    "condensed_two_hop",
    "resolve_backend",
]

@dataclasses.dataclass
class PackedLayer:
    """Both kernel operands for one bipartite layer, in both directions.

    ``bsb`` is the dst-major forward packing (``y = B @ x``) and ``fwd``
    its upload with the row index the kernels read; ``bsb_rev`` / ``rev``
    pack the transposed incidence so ``reverse=True`` dispatches to the
    kernel too.  ``src`` / ``dst`` drive the segment path (its fixed
    summation orders cached in ``plans``).  ``crossover`` is the optional
    measured-crossover table recorded at pack time
    (``from_edges(..., measure=True)``); when present, 'auto' dispatch
    follows the measurement."""

    bsb: BlockSparseBitmap
    bsb_rev: Optional[BlockSparseBitmap]
    fwd: PackedOperands
    rev: Optional[PackedOperands]
    src: torch.Tensor
    dst: torch.Tensor
    n_src: int
    n_dst: int
    crossover: Optional[CrossoverTable] = None
    plans: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @classmethod
    def from_edges(
        cls,
        edges: BipartiteEdges,
        with_reverse: bool = True,
        measure: bool = False,
        measure_batch_sizes: "tuple[int, ...]" = (128,),
        measure_ops: "tuple[str, ...]" = ("sum",),
        device="cuda",
    ) -> "PackedLayer":
        device = torch.device(device)
        bsb = pack_bipartite(edges)
        bsb_rev = pack_bipartite(edges.reversed()) if with_reverse else None
        layer = cls(
            bsb=bsb,
            bsb_rev=bsb_rev,
            fwd=_upload_operands(bsb, device),
            rev=_upload_operands(bsb_rev, device) if bsb_rev is not None else None,
            src=_tensor(edges.src, torch.int64, device),
            dst=_tensor(edges.dst, torch.int64, device),
            n_src=edges.n_src,
            n_dst=edges.n_dst,
        )
        if measure:
            from .autotune import measure_crossover

            layer.crossover = measure_crossover(
                layer, ops=measure_ops, batch_sizes=measure_batch_sizes
            )
        return layer


def pack_layer(edges: BipartiteEdges, device="cuda") -> PackedLayer:
    return PackedLayer.from_edges(edges, device=device)


def resolve_backend(
    backend: str,
    x: torch.Tensor,
    semiring: Semiring = PLUS_TIMES,
    packable: bool = True,
    table: Optional[CrossoverTable] = None,
    n_src: Optional[int] = None,
) -> str:
    """The one 'auto' resolution both dispatch sites agree on.

    Precedence: (1) a measured crossover entry, when a ``table`` recorded
    at pack time covers this (op, n_src, B) cell — 'auto' never selects a
    backend the measurement says is slower, and a measured ``'cuda'``
    cell dispatches the kernel wrapper even for a CPU frontier (which
    then runs its plain mirror); (2) ``'cuda'`` when the layer is packed,
    the semiring is kernelizable and ``x`` is a CUDA tensor on sm_90;
    ``'segment'`` otherwise.  An explicit ``'cuda'`` / ``'segment'`` is
    returned as given.  Exposed so tests can assert dispatch without
    running a kernel."""
    if backend != "auto":
        return backend
    if not packable or not kernelizable(semiring):
        return "segment"
    if table is not None and n_src is not None:
        decision = table.decide(semiring.add_kind, n_src, x.shape[-1] if x.ndim > 1 else 1)
        if decision is not None:
            return decision
    return "cuda" if _on_hopper(x) else "segment"


def bitmap_spmm(
    layer: PackedLayer,
    x: torch.Tensor,
    backend: str = "auto",
    semiring: Semiring = PLUS_TIMES,
    reverse: bool = False,
    config: Optional[KernelConfig] = None,
) -> torch.Tensor:
    """y[dst] = ⊕ over edges of x[src]; x may be (n_src,) or (n_src, F).

    ``reverse=True`` flips the edge direction (x indexed by dst, output
    over src) using the transposed packing.  ``semiring`` selects the
    ⊕-reduction: K1 for the sum, K2 for min / max.  ``config`` pins the
    kernel's ``range_items``; left None, the layer's crossover table
    supplies the measured-fastest one for this cell."""
    from . import bitmap_spmm as K

    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    ops = layer.rev if reverse else layer.fwd
    # n_src of the dispatched direction: the rows the kernel gathers from
    n_src_dir = layer.n_dst if reverse else layer.n_src
    backend = resolve_backend(backend, x, semiring=semiring, packable=ops is not None,
                              table=layer.crossover, n_src=n_src_dir)
    n_out = layer.n_src if reverse else layer.n_dst
    if backend == "segment":
        src, dst = (layer.dst, layer.src) if reverse else (layer.src, layer.dst)
        plan = (_edge_plan(layer.plans, src, dst, n_out, reverse)
                if semiring.add_kind == "sum" else None)
        y = segment_reduce(semiring, x.index_select(0, src), dst, n_out, plan=plan)
    elif backend == "cuda":
        if ops is None:
            raise ValueError(
                "reverse=True needs the transposed packing; build the "
                "layer with PackedLayer.from_edges(..., with_reverse=True)"
                if reverse
                else "layer has no packing"
            )
        if not kernelizable(semiring):
            raise ValueError(f"semiring {semiring.name!r} has no kernel")
        if config is None and layer.crossover is not None:
            config = layer.crossover.config_for(semiring.add_kind, n_src_dir, x.shape[1])
        y = K.bitmap_spmm(ops.row_ptr, ops.col, x.contiguous(), n_out,
                          op=semiring.add_kind, zero=float(semiring.zero),
                          range_items=None if config is None else config.range_items)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return y[:, 0] if squeeze else y


def condensed_two_hop(
    layer_in: PackedLayer,
    layer_out: PackedLayer,
    x: torch.Tensor,
    backend: str = "auto",
) -> torch.Tensor:
    """The condensed hot loop: y = B_out @ (B_in @ x) (plus-times)."""
    h = bitmap_spmm(layer_in, x, backend)
    return bitmap_spmm(layer_out, h, backend)
