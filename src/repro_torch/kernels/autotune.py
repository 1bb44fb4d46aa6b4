"""Autotuned kernel configurations + the measured-crossover dispatch table.

The port's counterpart of the JAX package's ``kernels/autotune.py``, for
the CUDA kernels K1/K2 (:func:`repro_torch.kernels.bitmap_spmm.bitmap_spmm`):

* :func:`autotune_spmm` sweeps ``CANDIDATES`` against a layer's real
  packed operands and returns the fastest :class:`KernelConfig` plus the
  per-candidate timings.
* :func:`measure_crossover` races the winning kernel configuration
  against the segment path per (op, n_src-bucket, B-bucket) cell and
  records the result in a :class:`CrossoverTable` — a small frozen table
  carried by the pack (``ops.PackedLayer.crossover`` /
  ``engine.PackedOperands.crossover``) and consulted by
  ``ops.resolve_backend`` / ``engine._kernel_applicable``, so ``'auto'``
  never selects a backend the recording says is slower.

The one knob is ``range_items``: the merged items (row ends + entries) a
group of lanes walks in K1/K2 (and K3), which
:func:`~repro_torch.kernels.bitmap_spmm.default_range_items` picks from
the shapes when none is given (:data:`DEFAULT_CONFIG`).  The JAX
package's ``row_window`` / ``feature_block`` have no counterpart: the
CUDA kernels walk merge-path ranges of a row index in 32-column feature
blocks, not streamed source windows.  Nor do its ``fits_vmem`` /
``_viable``: the kernels keep no per-slot state in shared memory, so
every candidate is admissible at every size, and a measured ``'cuda'``
cell dispatches unconditionally.

Buckets are power-of-two (``bit_length``) so a handful of measured cells
covers the whole size axis; lookups fall back to the nearest measured
bucket (deterministically) and, with no table at all, to the unmeasured
rule — packs that skip measurement behave exactly as before.

Timing defaults to CUDA events on a CUDA layer (best of N after one
warm-up, each run ending in an event sync; the host's launch gaps count,
as they do in use) and to the wall clock on a CPU layer, where the
wrappers run their plain mirrors; ``time_fn`` is injectable.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

__all__ = [
    "KernelConfig",
    "DEFAULT_CONFIG",
    "CANDIDATES",
    "CrossoverEntry",
    "CrossoverTable",
    "src_bucket",
    "batch_bucket",
    "autotune_spmm",
    "measure_crossover",
]


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One point of the autotune sweep: the kernels' range length.

    ``range_items`` — merged items per range (one range per group of
    lanes); ``None`` leaves it to ``default_range_items``.
    """

    range_items: Optional[int] = None

    def __post_init__(self) -> None:
        if self.range_items is not None and (
            not isinstance(self.range_items, int) or self.range_items <= 0
        ):
            raise ValueError(
                f"range_items must be a positive int or None, got {self.range_items!r}"
            )


DEFAULT_CONFIG = KernelConfig()

# The sweep space: the values default_range_items picks among.  Each is
# held bit for bit against the plain mirror (tests/test_torch_autotune.py,
# and on the card by chip_smoke.py).
CANDIDATES: Tuple[KernelConfig, ...] = tuple(KernelConfig(n) for n in (64, 128, 256, 512))


def src_bucket(n_src: int) -> int:
    """Power-of-two bucket of a source count: ``ceil(log2(n_src))``."""
    return max(int(n_src) - 1, 0).bit_length()


def batch_bucket(n_features: int) -> int:
    """Power-of-two bucket of a feature/batch width."""
    return max(int(n_features) - 1, 0).bit_length()


@dataclasses.dataclass(frozen=True)
class CrossoverEntry:
    """One measured cell: both backends' times and the winning config."""

    cuda_us: float
    segment_us: float
    range_items: Optional[int] = None

    @property
    def backend(self) -> str:
        return "cuda" if self.cuda_us <= self.segment_us else "segment"

    @property
    def config(self) -> KernelConfig:
        return KernelConfig(self.range_items)


# (op, src_bucket, batch_bucket) — op is the semiring add_kind
Key = Tuple[str, int, int]


@dataclasses.dataclass(frozen=True)
class CrossoverTable:
    """Measured crossover decisions, frozen and hashable: entries are a
    sorted tuple of (key, entry) pairs, not a dict.  Use
    :meth:`from_entries` to build one."""

    entries: Tuple[Tuple[Key, CrossoverEntry], ...] = ()

    @classmethod
    def from_entries(cls, entries: Dict[Key, CrossoverEntry]) -> "CrossoverTable":
        return cls(entries=tuple(sorted(entries.items())))

    def __len__(self) -> int:
        return len(self.entries)

    def lookup(
        self, op: str, n_src: int, n_features: int
    ) -> Optional[CrossoverEntry]:
        """The entry for (op, n_src, B) — exact bucket, else the nearest
        measured bucket for the same op (deterministic: minimal bucket
        distance, ties broken by the sorted key order), else None."""
        if not self.entries:
            return None
        sb, bb = src_bucket(n_src), batch_bucket(n_features)
        best: Optional[Tuple[Tuple[int, int, int], CrossoverEntry]] = None
        for (eop, esb, ebb), entry in self.entries:
            if eop != op:
                continue
            rank = (abs(esb - sb) + abs(ebb - bb), esb, ebb)
            if best is None or rank < best[0]:
                best = (rank, entry)
        return None if best is None else best[1]

    def decide(self, op: str, n_src: int, n_features: int) -> Optional[str]:
        """'cuda' / 'segment' per the measurement, or None when unmeasured."""
        entry = self.lookup(op, n_src, n_features)
        return None if entry is None else entry.backend

    def config_for(
        self, op: str, n_src: int, n_features: int
    ) -> KernelConfig:
        """The measured-fastest kernel config for this cell (the default
        config when the op is unmeasured)."""
        entry = self.lookup(op, n_src, n_features)
        return DEFAULT_CONFIG if entry is None else entry.config

    # -- persistence: the JAX package's canonical layout, fields renamed --

    def to_json(self) -> str:
        cells = [
            {
                "op": op,
                "src_bucket": sb,
                "batch_bucket": bb,
                "cuda_us": e.cuda_us,
                "segment_us": e.segment_us,
                "range_items": e.range_items,
            }
            for (op, sb, bb), e in self.entries
        ]
        return json.dumps({"version": 1, "cells": cells}, indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "CrossoverTable":
        doc = json.loads(text)
        if doc.get("version") != 1:
            raise ValueError(f"unknown crossover table version {doc.get('version')!r}")
        entries: Dict[Key, CrossoverEntry] = {}
        for c in doc["cells"]:
            key = (str(c["op"]), int(c["src_bucket"]), int(c["batch_bucket"]))
            items = c["range_items"]
            entries[key] = CrossoverEntry(
                cuda_us=float(c["cuda_us"]),
                segment_us=float(c["segment_us"]),
                range_items=None if items is None else int(items),
            )
        return cls.from_entries(entries)


# -- measurement ------------------------------------------------------------

TimeFn = Callable[[Callable[[], object]], float]


def _op_semiring(op: str):
    """Representative semiring for a kernel op (add_kind)."""
    from ..core.semiring import MAX_TIMES, MIN_PLUS, PLUS_TIMES

    try:
        return {"sum": PLUS_TIMES, "min": MIN_PLUS, "max": MAX_TIMES}[op]
    except KeyError:
        raise ValueError(f"unknown kernel op {op!r}") from None


def _event_time(fn: Callable[[], object], repeats: int = 5) -> float:
    """Best-of-N seconds between two CUDA events around ``fn`` on the
    current stream, after one warm-up call."""
    import torch

    fn()
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def _wall_time(fn: Callable[[], object], repeats: int = 3) -> float:
    """Best-of-N wall seconds after one warm-up call (a CPU layer)."""
    fn()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _timer(layer, time_fn: Optional[TimeFn]) -> TimeFn:
    if time_fn is not None:
        return time_fn
    return _event_time if layer.src.is_cuda else _wall_time


def autotune_spmm(
    layer,
    n_features: int,
    op: str = "sum",
    candidates: Sequence[KernelConfig] = CANDIDATES,
    reverse: bool = False,
    time_fn: Optional[TimeFn] = None,
) -> Tuple[KernelConfig, Dict[KernelConfig, float]]:
    """Sweep ``candidates`` on a real packed layer
    (:class:`repro_torch.kernels.ops.PackedLayer`); return (best,
    timings).  Ties go to the smaller ``range_items``."""
    import torch

    from . import ops as _ops

    semiring = _op_semiring(op)
    packed = layer.rev if reverse else layer.fwd
    if packed is None:
        raise ValueError("autotune_spmm needs a packed direction")
    timer = _timer(layer, time_fn)
    n_in = layer.n_dst if reverse else layer.n_src
    x = torch.ones((n_in, max(n_features, 1)), dtype=torch.float32,
                   device=layer.src.device)
    timings: Dict[KernelConfig, float] = {}
    for cfg in candidates:

        def run(cfg=cfg):
            return _ops.bitmap_spmm(layer, x, backend="cuda", semiring=semiring,
                                    reverse=reverse, config=cfg)

        timings[cfg] = timer(run)
    if not timings:
        return DEFAULT_CONFIG, timings
    best = min(timings.items(), key=lambda kv: (kv[1], kv[0].range_items or 0))
    return best[0], timings


def measure_crossover(
    layer,
    ops: Sequence[str] = ("sum",),
    batch_sizes: Sequence[int] = (128,),
    candidates: Sequence[KernelConfig] = CANDIDATES,
    time_fn: Optional[TimeFn] = None,
) -> CrossoverTable:
    """Race the kernel (autotuned per cell) against the segment path on
    ``layer``'s forward direction and record the winners.  Called at pack
    time when measurement is requested
    (``PackedLayer.from_edges(..., measure=True)`` /
    ``engine.to_device_packed(..., measure=True)``, which measures each
    direction as a layer of its own)."""
    import torch

    from . import ops as _ops

    timer = _timer(layer, time_fn)
    entries: Dict[Key, CrossoverEntry] = {}
    for op in ops:
        semiring = _op_semiring(op)
        for b in batch_sizes:
            best_cfg, timings = autotune_spmm(
                layer, b, op=op, candidates=candidates, time_fn=time_fn,
            )
            x = torch.ones((layer.n_src, b), dtype=torch.float32,
                           device=layer.src.device)

            def run_segment():
                return _ops.bitmap_spmm(layer, x, backend="segment", semiring=semiring)

            t_segment = timer(run_segment)
            t_cuda = timings.get(best_cfg, float("inf"))
            key = (op, src_bucket(layer.n_src), batch_bucket(b))
            entries[key] = CrossoverEntry(
                cuda_us=t_cuda * 1e6,
                segment_us=t_segment * 1e6,
                range_items=best_cfg.range_items,
            )
    return CrossoverTable.from_entries(entries)
