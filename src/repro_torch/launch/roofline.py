"""Roofline of a dry-run cell on H100s (no hardware needed).

The port of the JAX package's ``launch/roofline.py``.  Three terms per
(arch x shape x mesh), in seconds, from one rank's
:class:`~repro_torch.launch.op_cost.OpCost` and the H100 SXM datasheet
figures of :mod:`repro_torch.launch.mesh`::

    compute    = FLOPs per rank / 989e12
    memory     = HBM bytes per rank / 3.35e12
    collective = nvlink_bytes / 450e9  +  network_bytes / 50e9

``ici_bytes`` / ``dci_bytes`` keep the reference's split (a pod of 256
ranks) beside the H100 split (a node of 8 GPUs on NVLink).
:func:`model_flops` is the reference's analytic count, copied.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..core.cost import HOST_DISK_BW, HOST_MEM_BW
from .mesh import HBM_BW, NETWORK_BW, NVLINK_BW, PEAK_FLOPS_BF16
from .op_cost import OpCost

__all__ = ["roofline_terms", "model_flops", "RooflineReport", "HOST_MEM_BW", "HOST_DISK_BW"]


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    flops_per_device: float
    bytes_per_device: float
    ici_bytes: float
    dci_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float
    memory_stats: Dict[str, float]
    n_collectives: int = 0
    by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    nvlink_bytes: float = 0.0
    network_bytes: float = 0.0

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


def roofline_terms(arch: str, shape: str, mesh_name: str, n_chips: int, cost: OpCost,
                   model_total_flops: float) -> RooflineReport:
    """The roofline of one rank's ``cost`` on an H100 (see the module
    docstring); ``useful_ratio`` is the model's FLOPs over all ranks'."""
    compute_s = cost.flops / PEAK_FLOPS_BF16
    memory_s = cost.bytes / HBM_BW
    collective_s = cost.nvlink_bytes / NVLINK_BW + cost.network_bytes / NETWORK_BW
    dominant = max(
        [("compute", compute_s), ("memory", memory_s), ("collective", collective_s)],
        key=lambda kv: kv[1],
    )[0]
    return RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        flops_per_device=cost.flops,
        bytes_per_device=cost.bytes,
        ici_bytes=cost.ici_bytes,
        dci_bytes=cost.dci_bytes,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=model_total_flops,
        useful_ratio=model_total_flops / max(cost.flops * n_chips, 1.0),
        memory_stats=cost.memory_stats(),
        n_collectives=int(round(cost.n_collectives)),
        by_op=dict(cost.by_collective),
        nvlink_bytes=cost.nvlink_bytes,
        network_bytes=cost.network_bytes,
    )


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS per cell (global, not per-device)
# ---------------------------------------------------------------------------

def model_flops(arch: str, shape: str) -> float:
    from ..configs import registry
    from ..configs import shapes as shp

    mod = registry.get_arch(arch)
    cfg = mod.CONFIG
    fam = mod.SHAPE_FAMILY
    if fam == "lm":
        s = shp.LM_SHAPES[shape]
        n_active = cfg.n_active_params()
        if s.kind == "train":
            tokens = s.seq_len * s.global_batch
            return 6.0 * n_active * tokens
        if s.kind == "prefill":
            tokens = s.seq_len * s.global_batch
            return 2.0 * n_active * tokens
        # decode: one token per sequence + attention over the KV cache
        hd = cfg.resolved_head_dim
        attn_kv = (
            4.0 * cfg.n_layers * cfg.n_heads * hd * s.seq_len * s.global_batch
        )
        return 2.0 * n_active * s.global_batch + attn_kv
    if fam == "gnn":
        s = shp.GNN_SHAPES[shape]
        h = cfg.d_hidden
        mult = 3.0 if s.kind == "train" else 1.0  # fwd + 2x bwd
        if cfg.kind in ("meshgraphnet", "graphcast"):
            per_layer = 2.0 * (s.raw_edges * 3 * h * h * cfg.mlp_layers
                               + s.raw_nodes * 2 * h * h * cfg.mlp_layers)
            enc = 2.0 * s.raw_nodes * s.d_feat * h + 2.0 * s.raw_edges * 4 * h
            return mult * (cfg.n_layers * per_layer + enc)
        if cfg.kind == "schnet":
            per_block = 2.0 * (s.raw_edges * cfg.n_rbf * h + s.raw_edges * h
                               + s.raw_nodes * 2 * h * h)
            return mult * (cfg.n_layers * per_block + 2.0 * s.raw_nodes * s.d_feat * h)
        if cfg.kind == "dimenet":
            tri = shp.triplet_count(s, cfg.triplet_factor)
            per_block = 2.0 * tri * (cfg.n_bilinear * h * h / max(h, 1) + cfg.n_bilinear * h) \
                + 2.0 * tri * cfg.n_radial * cfg.n_spherical * cfg.n_bilinear \
                + 2.0 * s.raw_edges * 2 * h * h
            return mult * (cfg.n_layers * per_block + 2.0 * s.raw_edges * 3 * h)
    if fam == "recsys":
        s = shp.REC_SHAPES[shape]
        d = cfg.d
        L = cfg.seq_len
        blocks = 2.0 * cfg.n_blocks * (4 * L * d * d + 2 * L * L * d) * s.batch
        if s.kind == "train":
            return 3.0 * (blocks + 2.0 * s.batch * L * d)  # + embedding dots
        if s.kind == "score_all":
            return blocks + 2.0 * s.batch * cfg.n_items * d
        return blocks + 2.0 * s.batch * s.n_candidates * d
    if fam == "graphgen":
        cfg2 = mod.CONFIG
        return 2.0 * (2 * cfg2.n_in_edges + cfg2.n_correction) * cfg2.pagerank_iters
    raise ValueError(fam)
