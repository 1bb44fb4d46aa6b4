"""Band partitioning for the distributed condensed engine (§Perf
'banded'), and the banded PageRank over a process group.

:func:`band_partition` splits a symmetric single-layer condensed graph
into ``n_shards`` contiguous virtual-node bands (for the fused 2-hop)
and real-node bands (for the correction), padding every band to equal
length with inert entries so the arrays divide evenly.  Its arrays equal
the JAX package's ``repro/core/banding.py`` byte for byte, padding
included; they are built with a stable sort by band instead of a Python
loop over the edges.

The padding grows ``n_real`` to a multiple of ``n_shards``, and the
padded nodes take part in PageRank's ``(1 − d) / n`` and ``dangling / n``
terms.  So :func:`make_banded_pagerank` equals the engine's PageRank
only when ``n_shards`` divides ``n_real`` — a property of the JAX
package's banding that the port keeps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from .condensed import CondensedGraph
from .semiring import PLUS_TIMES, segment_plan, segment_reduce

__all__ = ["BandedGraph", "band_partition", "make_banded_pagerank"]

BAND_FIELDS = ("in_src", "in_dst", "out_src", "out_dst", "corr_src", "corr_dst", "corr_cnt")


@dataclasses.dataclass
class BandedGraph:
    """Flat arrays whose equal n_shards-slices are per-band locals."""

    in_src: np.ndarray    # (S*eb,) global real ids
    in_dst: np.ndarray    # (S*eb,) band-local virtual ids
    out_src: np.ndarray   # (S*eb,) band-local virtual ids
    out_dst: np.ndarray   # (S*eb,) global real ids
    corr_src: np.ndarray  # (S*cb,) global real ids
    corr_dst: np.ndarray  # (S*cb,) band-local real ids
    corr_cnt: np.ndarray  # (S*cb,) float32 (0 = padding)
    deg: np.ndarray       # (n_real,) deduplicated out-degree
    n_real: int
    n_virtual: int
    n_shards: int

    @property
    def virt_band(self) -> int:
        return self.n_virtual // self.n_shards

    @property
    def real_band(self) -> int:
        return self.n_real // self.n_shards

    def local(self, rank: int, bands_per_rank: int, device="cuda") -> Dict[str, torch.Tensor]:
        """The arrays of bands ``rank·k .. rank·k + k − 1`` on ``device``:
        each edge array ``(k, width)``, ``deg`` the rank's ``(k · rb,)``
        real nodes — what :func:`make_banded_pagerank`'s function takes."""
        k, lo = bands_per_rank, rank * bands_per_rank
        if (rank + 1) * k > self.n_shards:
            raise ValueError(f"bands {lo}..{lo + k - 1} exceed {self.n_shards} bands")
        out = {
            name: torch.from_numpy(
                np.ascontiguousarray(getattr(self, name).reshape(self.n_shards, -1)[lo:lo + k])
            ).to(device)
            for name in BAND_FIELDS
        }
        rb = self.real_band
        out["deg"] = torch.from_numpy(self.deg[lo * rb:(lo + k) * rb].copy()).to(device)
        return out


def _by_band(band: np.ndarray, n_shards: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stable grouping by band: the entry order, each entry's slot within
    its band, and the band sizes (entries keep their input order)."""
    order = np.argsort(band, kind="stable")
    counts = np.bincount(band, minlength=n_shards)
    starts = np.cumsum(counts) - counts
    slot = np.arange(band.size, dtype=np.int64) - np.repeat(starts, counts)
    return order, slot, counts


def _fill(shape, fill, dtype, band, slot, values) -> np.ndarray:
    out = np.full(shape, fill, dtype=dtype)
    out[band, slot] = values
    return out


def band_partition(
    graph: CondensedGraph,
    correction: Tuple[np.ndarray, np.ndarray, np.ndarray],
    n_shards: int,
    deg: np.ndarray,
) -> BandedGraph:
    if len(graph.chains) != 1 or graph.chains[0].n_layers != 1:
        raise ValueError("banding implemented for single-layer chains")
    chain = graph.chains[0]
    e_in, e_out = chain.edges
    n_real = -(-graph.n_real // n_shards) * n_shards
    n_virt = -(-e_in.n_dst // n_shards) * n_shards
    vb, rb = n_virt // n_shards, n_real // n_shards

    in_dst = np.asarray(e_in.dst, np.int64)
    out_src = np.asarray(e_out.src, np.int64)
    in_order, in_slot, in_counts = _by_band(in_dst // vb, n_shards)
    out_order, out_slot, out_counts = _by_band(out_src // vb, n_shards)
    width = int(max(in_counts.max(initial=0), out_counts.max(initial=0)))
    in_band = (in_dst // vb)[in_order]
    out_band = (out_src // vb)[out_order]
    # Two dedicated inert virtual slots per band: in-edge padding WRITES
    # slot vb (which no out-edge reads), out-edge padding READS slot vb+1
    # (which no in-edge writes) — so padding moves zero mass.
    vb_pad = vb + 2
    shape = (n_shards, width)
    in_src_a = _fill(shape, 0, np.int32, in_band, in_slot, np.asarray(e_in.src)[in_order])
    in_dst_a = _fill(shape, vb, np.int32, in_band, in_slot, (in_dst % vb)[in_order])
    out_src_a = _fill(shape, vb + 1, np.int32, out_band, out_slot, (out_src % vb)[out_order])
    out_dst_a = _fill(shape, 0, np.int32, out_band, out_slot, np.asarray(e_out.dst)[out_order])

    cs, cd, cm = (np.asarray(a) for a in correction)
    c_order, c_slot, c_counts = _by_band(cd.astype(np.int64) // rb, n_shards)
    cw = max(int(c_counts.max(initial=0)), 1)
    c_band = (cd.astype(np.int64) // rb)[c_order]
    cshape = (n_shards, cw)
    corr_src = _fill(cshape, 0, np.int32, c_band, c_slot, cs[c_order])
    corr_dst = _fill(cshape, 0, np.int32, c_band, c_slot, (cd.astype(np.int64) % rb)[c_order])
    corr_cnt = _fill(cshape, 0, np.float32, c_band, c_slot, cm[c_order])

    deg_pad = np.zeros(n_real, np.float32)
    deg_pad[: deg.size] = deg
    return BandedGraph(
        in_src=in_src_a.reshape(-1),
        in_dst=in_dst_a.reshape(-1),
        out_src=out_src_a.reshape(-1),
        out_dst=out_dst_a.reshape(-1),
        corr_src=corr_src.reshape(-1),
        corr_dst=corr_dst.reshape(-1),
        corr_cnt=corr_cnt.reshape(-1),
        deg=deg_pad,
        n_real=n_real,
        n_virtual=n_shards * vb_pad,
        n_shards=n_shards,
    )


def make_banded_pagerank(
    group,
    n_real: int,
    n_virt_banded: int,     # n_shards * (vb_pad)
    n_shards: int,
    iters: int = 20,
    damping: float = 0.85,
):
    """PageRank over band-partitioned arrays (see :class:`BandedGraph`)
    on the ranks of ``group`` (one process alone without a group).

    Each rank owns ``k = n_shards / world`` contiguous bands and the
    matching block of ``k · rb`` real nodes.  Per iteration: an
    all-reduce of the dangling mass, an all-gather of ``contrib``,
    band-local fixed-order segment sums (one
    :func:`~repro_torch.core.semiring.segment_plan` per band and hop,
    built on the first call), the rank's band partials added in band
    order, one reduce-scatter of ``y_partial``, and the band-local
    correction (§Perf 'banded': no all-reduce of the rank vector).

    Returns ``pagerank_banded(args)``: ``args`` is
    :meth:`BandedGraph.local` of this rank; the result is the whole
    ``(n_real,)`` vector (padded nodes included), gathered on every rank.
    """
    from ..distributed.world import all_gather_into, all_reduce, rank_world, reduce_scatter_into

    _, world = rank_world(group)
    if n_shards % world:
        raise ValueError(f"{n_shards} bands do not divide over {world} ranks")
    k = n_shards // world
    vb = n_virt_banded // n_shards
    rb = n_real // n_shards
    plans: Dict[str, tuple] = {}

    def plans_of(hop, ids, ties, n):
        # one plan per band, kept while the caller passes the same (k, width)
        # array (held beside the plans, so its identity is not reused)
        if hop not in plans or plans[hop][0] is not ids:
            plans[hop] = (ids, [segment_plan(ids[b], n, tiebreak=ties[b]) for b in range(k)])
        return plans[hop][1]

    def band_sum(values, ids, p):
        return segment_reduce(PLUS_TIMES, values, ids, p.num_segments, plan=p)

    def pagerank_banded(args):
        in_src, in_dst = args["in_src"], args["in_dst"]
        out_src, out_dst = args["out_src"], args["out_dst"]
        c_src, c_dst, c_cnt, deg = args["corr_src"], args["corr_dst"], args["corr_cnt"], args["deg"]
        if in_src.shape[0] != k or deg.shape[0] != k * rb:
            raise ValueError(f"expected the arrays of {k} bands, got {in_src.shape[0]}")
        p_in = plans_of("in", in_dst, in_src, vb)
        p_out = plans_of("out", out_dst, out_src, n_real)
        p_c = plans_of("corr", c_dst, c_src, rb)
        live = deg > 0
        x = torch.full((k * rb,), 1.0 / n_real, dtype=torch.float32, device=deg.device)
        x_full = torch.empty(n_real, dtype=torch.float32, device=deg.device)
        y_loc = torch.empty_like(x)
        for _ in range(iters):
            contrib = torch.where(live, x / torch.clamp(deg, min=1.0), 0.0)
            dangling = all_reduce(torch.sum(torch.where(live, 0.0, x)).reshape(1), "sum", group)
            all_gather_into(x_full, contrib, group)
            y_partial = None
            for b in range(k):
                h_band = band_sum(x_full.index_select(0, in_src[b]), in_dst[b], p_in[b])
                y_b = band_sum(h_band.index_select(0, out_src[b]), out_dst[b], p_out[b])
                y_partial = y_b if y_partial is None else y_partial + y_b
            reduce_scatter_into(y_loc, y_partial, group)
            corr = torch.cat([
                band_sum(x_full.index_select(0, c_src[b]) * c_cnt[b], c_dst[b], p_c[b])
                for b in range(k)
            ])
            y = y_loc - corr + dangling / n_real
            x = (1.0 - damping) / n_real + damping * y
        return all_gather_into(torch.empty_like(x_full), x, group)

    return pagerank_banded
