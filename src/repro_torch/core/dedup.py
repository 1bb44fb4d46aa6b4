"""DEDUP-C: the counting correction that makes ring propagation exact.

Input: a C-DUP :class:`~repro_torch.core.condensed.CondensedGraph`.
Output: sparse correction triples ``(src, dst, count)`` with ``A = M − D``
(``A = min(M, 1)``, minus the diagonal when self loops are dropped), so
ring propagation over the condensed graph subtracts ``D x`` and counts
every expanded edge once.  Host-side NumPy like the JAX package's module
of the same name; the optional device fold runs on torch.

The other dedup structures of the JAX package (DEDUP-1/2, BITMAP-1/2, the
wedge correction) are not ported yet (ROADMAP.md, Queue 1 item 7).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .condensed import (
    CondensedGraph,
    ExpansionAccounting,
    _aggregate_pairs,
    fold_path_pairs,
    split_expansion_budget,
)

__all__ = [
    "build_correction",
    "build_correction_streaming",
    "StreamedCorrection",
    "TRIPLE_BYTES",
]


def build_correction(
    graph: CondensedGraph, drop_self_loops: bool = True
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sparse D with  A = M - D,  A = min(M, 1) (minus diag if requested).

    Returns (src, dst, count) triples: count = multiplicity-1 for
    duplicated off-diagonal pairs, plus full multiplicity on the diagonal
    when ``drop_self_loops``.
    """
    s, d, m = graph.multiplicities()
    return _correction_from_multiplicities(s, d, m, drop_self_loops)


def _correction_from_multiplicities(
    s: np.ndarray, d: np.ndarray, m: np.ndarray, drop_self_loops: bool
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    diag = s == d
    if drop_self_loops:
        corr = np.where(diag, m, m - 1)
    else:
        corr = m - 1
    keep = corr > 0
    return s[keep], d[keep], corr[keep]


# Host accounting unit for one resident (src, dst, mult) int64 triple.
TRIPLE_BYTES = 24


@dataclasses.dataclass
class StreamedCorrection:
    """DEDUP-C correction triples plus the accounting that built them.

    Unpacks like the plain ``(src, dst, count)`` tuple from
    :func:`build_correction`, so ``engine.to_device(..., correction=...)``
    accepts either; ``accounting`` carries the streaming-budget evidence
    (peak resident triples, chunk/merge counts).
    """

    src: np.ndarray
    dst: np.ndarray
    count: np.ndarray
    accounting: ExpansionAccounting

    def __iter__(self):
        return iter((self.src, self.dst, self.count))

    def __len__(self) -> int:
        return 3

    def __getitem__(self, i):
        return (self.src, self.dst, self.count)[i]

    def nbytes(self) -> int:
        return int(self.src.nbytes + self.dst.nbytes + self.count.nbytes)


def _device_aggregator(device):
    """The multiplicity fold on ``device``: sort the pair keys, then one
    segment sum over runs of equal keys, so the host only receives
    already-aggregated triples.  Keys and sums are int64 on the device, so
    no size limit applies beyond int64's."""

    def aggregate(
        src: np.ndarray, dst: np.ndarray, mult: np.ndarray, n_dst: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if src.size == 0:
            return _aggregate_pairs(src, dst, mult, n_dst)
        key = torch.from_numpy(
            np.asarray(src, np.int64) * np.int64(n_dst) + np.asarray(dst, np.int64)
        ).to(device)
        ks, order = torch.sort(key)
        ms = torch.from_numpy(np.asarray(mult, np.int64)).to(device)[order]
        is_new = torch.ones_like(ks, dtype=torch.bool)
        is_new[1:] = ks[1:] != ks[:-1]
        seg = torch.cumsum(is_new.to(torch.int64), 0) - 1
        n_uniq = int(seg[-1].item()) + 1
        sums = torch.zeros(n_uniq, dtype=torch.int64, device=ks.device)
        sums.index_add_(0, seg, ms)
        uniq = ks[is_new].cpu().numpy()
        summed = sums.cpu().numpy()
        return uniq // n_dst, uniq % n_dst, summed

    return aggregate


def build_correction_streaming(
    graph: CondensedGraph,
    budget_bytes: Optional[int] = None,
    *,
    budget_triples: Optional[int] = None,
    chunk_rows: Optional[int] = None,
    drop_self_loops: bool = True,
    device_fold: bool = False,
    device="cuda",
) -> StreamedCorrection:
    """DEDUP-C correction identical to :func:`build_correction`, built
    without ever materializing the full expansion on the host.

    The graph's chunked expansion iterator walks leading rows in bounded
    blocks and a sorted-run fold consolidates duplicate (u, v) keys
    whenever residency crosses the budget — half of which bounds per-chunk
    composition and half run residency.  ``budget_bytes`` is the same
    budget in host bytes (:data:`TRIPLE_BYTES` per triple);
    ``budget_triples`` takes precedence.  ``device_fold`` runs the run
    consolidation on ``device`` (a torch sort plus a segment sum).
    """
    if budget_triples is None and budget_bytes is not None:
        budget_triples = max(int(budget_bytes) // TRIPLE_BYTES, 1)
    accounting = ExpansionAccounting(budget_triples=budget_triples)
    half = split_expansion_budget(budget_triples)
    s, d, m = fold_path_pairs(
        graph.iter_path_pairs(
            chunk_rows=chunk_rows,
            budget_triples=half,
            accounting=accounting,
        ),
        graph.n_real,
        budget_triples=half,
        accounting=accounting,
        aggregate=_device_aggregator(device) if device_fold else None,
    )
    cs, cd, cm = _correction_from_multiplicities(s, d, m, drop_self_loops)
    return StreamedCorrection(cs, cd, cm, accounting)
