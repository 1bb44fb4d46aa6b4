"""Public wrappers around the K1/K2 kernels for one packed layer, with the
segment path beside them.

``bitmap_spmm``       one condensed layer:  y = B ⊕ x (any kernel semiring)
``condensed_two_hop`` the paper's hot loop: y = B_out @ (B_in @ x)

Backend selection: ``backend='cuda'`` runs the K1/K2 wrapper
(:func:`repro_torch.kernels.bitmap_spmm.bitmap_spmm`: the kernel on a CUDA
frontier, its plain mirror on a CPU one); ``'segment'`` the gather /
segment-reduce path; ``'auto'`` the kernel when the layer is packed, the
semiring is kernelizable and the frontier is a CUDA tensor on an sm_90
device — the engine's policy.  ``reverse=True`` propagates along
transposed edges using the reverse packing carried by
:class:`PackedLayer`.

The JAX package's measured-crossover arguments (``measure=`` at pack
time, ``table=`` / ``config=`` at dispatch) belong to
``kernels/autotune.py``, which the port does not have yet (ROADMAP.md,
Queue 1): they raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.condensed import BipartiteEdges
from ..core.engine import PackedOperands, _on_hopper, _tensor, _upload_operands
from ..core.semiring import PLUS_TIMES, Semiring, kernelizable
from .pack import BlockSparseBitmap, pack_bipartite
from .ref import segment_semiring_ref

__all__ = [
    "PackedLayer",
    "pack_layer",
    "bitmap_spmm",
    "condensed_two_hop",
    "resolve_backend",
]

_AUTOTUNE = (
    "measured-crossover dispatch is not ported yet (ROADMAP.md, Queue 1: "
    "kernels/autotune.py)"
)


@dataclasses.dataclass
class PackedLayer:
    """Both kernel operands for one bipartite layer, in both directions.

    ``bsb`` is the dst-major forward packing (``y = B @ x``) and ``fwd``
    its upload with the row index the kernels read; ``bsb_rev`` / ``rev``
    pack the transposed incidence so ``reverse=True`` dispatches to the
    kernel too.  ``src`` / ``dst`` drive the segment path."""

    bsb: BlockSparseBitmap
    bsb_rev: Optional[BlockSparseBitmap]
    fwd: PackedOperands
    rev: Optional[PackedOperands]
    src: torch.Tensor
    dst: torch.Tensor
    n_src: int
    n_dst: int

    @classmethod
    def from_edges(
        cls,
        edges: BipartiteEdges,
        with_reverse: bool = True,
        measure: bool = False,
        device="cuda",
    ) -> "PackedLayer":
        if measure:
            raise NotImplementedError(_AUTOTUNE)
        device = torch.device(device)
        bsb = pack_bipartite(edges)
        bsb_rev = pack_bipartite(edges.reversed()) if with_reverse else None
        return cls(
            bsb=bsb,
            bsb_rev=bsb_rev,
            fwd=_upload_operands(bsb, device),
            rev=_upload_operands(bsb_rev, device) if bsb_rev is not None else None,
            src=_tensor(edges.src, torch.int64, device),
            dst=_tensor(edges.dst, torch.int64, device),
            n_src=edges.n_src,
            n_dst=edges.n_dst,
        )


def pack_layer(edges: BipartiteEdges, device="cuda") -> PackedLayer:
    return PackedLayer.from_edges(edges, device=device)


def resolve_backend(
    backend: str,
    x: torch.Tensor,
    semiring: Semiring = PLUS_TIMES,
    packable: bool = True,
    table=None,
) -> str:
    """The one 'auto' resolution: ``'cuda'`` when the layer is packed,
    the semiring is kernelizable and ``x`` is a CUDA tensor on sm_90;
    ``'segment'`` otherwise.  An explicit ``'cuda'`` / ``'segment'`` is
    returned as given.  Exposed so tests can assert dispatch without
    running a kernel."""
    if table is not None:
        raise NotImplementedError(_AUTOTUNE)
    if backend != "auto":
        return backend
    if not packable or not kernelizable(semiring):
        return "segment"
    return "cuda" if _on_hopper(x) else "segment"


def bitmap_spmm(
    layer: PackedLayer,
    x: torch.Tensor,
    backend: str = "auto",
    semiring: Semiring = PLUS_TIMES,
    reverse: bool = False,
    config=None,
) -> torch.Tensor:
    """y[dst] = ⊕ over edges of x[src]; x may be (n_src,) or (n_src, F).

    ``reverse=True`` flips the edge direction (x indexed by dst, output
    over src) using the transposed packing.  ``semiring`` selects the
    ⊕-reduction: K1 for the sum, K2 for min / max."""
    from . import bitmap_spmm as K

    if config is not None:
        raise NotImplementedError(_AUTOTUNE)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    ops = layer.rev if reverse else layer.fwd
    backend = resolve_backend(backend, x, semiring=semiring, packable=ops is not None)
    n_out = layer.n_src if reverse else layer.n_dst
    if backend == "segment":
        src, dst = (layer.dst, layer.src) if reverse else (layer.src, layer.dst)
        y = segment_semiring_ref(src, dst, x, n_out, semiring=semiring)
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
        y = K.bitmap_spmm(ops.row_ptr, ops.col, x.contiguous(), n_out,
                          op=semiring.add_kind, zero=float(semiring.zero))
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
