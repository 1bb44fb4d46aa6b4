"""Oracles for the kernels package (the correctness ground truth the tests
hold the kernels' plain versions and the engine against)."""
from __future__ import annotations

import numpy as np
import torch

from ..core.semiring import PLUS_TIMES, Semiring, segment_reduce
from .pack import BlockSparseBitmap

__all__ = [
    "bitmap_spmm_ref",
    "segment_spmm_ref",
    "segment_semiring_ref",
    "two_hop_ref",
]


def bitmap_spmm_ref(bsb: BlockSparseBitmap, x: np.ndarray) -> np.ndarray:
    """Dense oracle: unpack every block and matmul in float64 (small
    inputs only); returns ``(n_dst, F)``."""
    dense = bsb.to_dense()
    n_src_pad = dense.shape[1]
    xp = np.zeros((n_src_pad, x.shape[1]), dtype=np.float64)
    xp[: x.shape[0]] = x
    return (dense.astype(np.float64) @ xp)[: bsb.n_dst]


def segment_spmm_ref(
    src: torch.Tensor, dst: torch.Tensor, x: torch.Tensor, n_dst: int
) -> torch.Tensor:
    """Edge-list oracle: ``y[dst] += x[src]``, a segment sum of the
    gathered rows (``(n_dst, F)``, 0 where no edge lands)."""
    rows = x.index_select(0, src.to(torch.int64))
    out = torch.zeros((n_dst,) + tuple(rows.shape[1:]), dtype=rows.dtype, device=rows.device)
    return out.index_add_(0, dst.to(torch.int64), rows)


def segment_semiring_ref(
    src: torch.Tensor,
    dst: torch.Tensor,
    x: torch.Tensor,
    n_dst: int,
    semiring: Semiring = PLUS_TIMES,
) -> torch.Tensor:
    """Edge-list oracle under any semiring: y[dst] = ⊕ x[src] (the segment
    path the kernels must agree with, for min/max too)."""
    return segment_reduce(semiring, x.index_select(0, src.to(torch.int64)), dst, n_dst)


def two_hop_ref(
    in_src: torch.Tensor,
    in_dst: torch.Tensor,
    n_virtual: int,
    out_src: torch.Tensor,
    out_dst: torch.Tensor,
    n_real: int,
    x: torch.Tensor,
) -> torch.Tensor:
    """Condensed 2-hop oracle: y = B_out (B_in x) in the ring."""
    h = segment_semiring_ref(in_src, in_dst, x, n_virtual)
    return segment_semiring_ref(out_src, out_dst, h, n_real)
