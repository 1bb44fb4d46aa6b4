"""Bit-packed block-sparse SpMM for the port: host packing, the CUDA
kernels (sources in ``csrc/``), their wrappers and plain versions, and the
per-layer public wrappers of ``ops.py`` under the JAX package's names.

The JAX package also exports ``ops.bitmap_spmm`` here; in the port
``repro_torch.kernels.bitmap_spmm`` is the kernel module (K1–K3's
wrappers), so the per-layer function stays ``repro_torch.kernels.ops.
bitmap_spmm``."""
from .autotune import (
    CANDIDATES,
    DEFAULT_CONFIG,
    CrossoverEntry,
    CrossoverTable,
    KernelConfig,
    autotune_spmm,
    measure_crossover,
)
from .ops import PackedLayer, condensed_two_hop, pack_layer, resolve_backend

__all__ = [
    "PackedLayer",
    "condensed_two_hop",
    "pack_layer",
    "resolve_backend",
    "KernelConfig",
    "DEFAULT_CONFIG",
    "CANDIDATES",
    "CrossoverEntry",
    "CrossoverTable",
    "autotune_spmm",
    "measure_crossover",
]
