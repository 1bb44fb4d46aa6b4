"""Build the port's device containers from another package's operands.

:func:`packed_arrays` flattens any tree of dataclasses, tuples and
array-likes — the JAX package's ``DevicePacked`` as well as the port's —
into ``(arrays, meta)``: a flat dict of numpy arrays keyed by path
(``"chains/0/1/fwd/bitmaps"``) and a nested meta structure that mirrors
the tree, with ``{"array": key}`` where an array sat.
:func:`device_packed_from_arrays` rebuilds the port's
:class:`~repro_torch.core.engine.DevicePacked` from them.  Tests use the
pair to hold the port's device half against the JAX package's on
identical operands, independently of either host half.  Nothing here
imports the other package: the caller hands the arrays over.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from .engine import (
    FUSED_TABLES,
    PACKED_TABLES,
    DevicePacked,
    DevicePackedLayer,
    fused_operands,
    packed_operands,
)

__all__ = ["packed_arrays", "device_packed_from_arrays"]

# the JAX package's backend names -> the port's
_BACKENDS = {"pallas": "cuda", "xla": "segment"}


def packed_arrays(tree) -> Tuple[Dict[str, np.ndarray], object]:
    """``(arrays, meta)`` for a tree of dataclasses / tuples / arrays."""
    arrays: Dict[str, np.ndarray] = {}

    def walk(obj, path: str):
        if obj is None or isinstance(obj, (bool, int, float, str)):
            return obj
        if dataclasses.is_dataclass(obj):
            return {
                f.name: walk(getattr(obj, f.name), f"{path}{f.name}/")
                for f in dataclasses.fields(obj)
            }
        if isinstance(obj, (tuple, list)):
            if all(isinstance(o, (int, float)) for o in obj):
                return list(obj)
            return [walk(o, f"{path}{i}/") for i, o in enumerate(obj)]
        if isinstance(obj, torch.device):
            return str(obj)
        if isinstance(obj, torch.Tensor):
            obj = obj.detach().cpu()
        key = path.rstrip("/")
        arrays[key] = np.asarray(obj)
        return {"array": key}

    return arrays, walk(tree, "")


def device_packed_from_arrays(
    arrays: Dict[str, np.ndarray], meta: dict, device="cuda"
) -> DevicePacked:
    """The port's ``DevicePacked`` on ``device`` from :func:`packed_arrays`
    output (slot tables, bitmaps, planes, correction triples,
    ``diag_mult``).  Indices become int64, tables int32, bitmap words
    int32 views of the uint32 words, weights and counts float32; each
    packed direction's row index is built anew from its operands (other
    packages carry none, and the port's is derived); the
    backend names ``'pallas'`` / ``'xla'`` map to ``'cuda'`` /
    ``'segment'``."""
    device = torch.device(device)

    def arr(ref, dtype: torch.dtype) -> torch.Tensor:
        a = np.ascontiguousarray(arrays[ref["array"]])
        if not a.flags.writeable:  # e.g. a read-only view of a JAX buffer
            a = a.copy()
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    def ops(m):
        if m is None:
            return None
        return packed_operands(**{k: arr(m[k], torch.int32) for k in PACKED_TABLES})

    def layer(m):
        if m is None:
            return None
        return DevicePackedLayer(
            src=arr(m["src"], torch.int64),
            dst=arr(m["dst"], torch.int64),
            fwd=ops(m["fwd"]),
            rev=ops(m["rev"]),
            n_src=int(m["n_src"]),
            n_dst=int(m["n_dst"]),
        )

    def fused(m):
        if m is None:
            return None
        t = {k: arr(m[k], torch.int32) for k in FUSED_TABLES}
        return fused_operands(m["plane_weights"], int(m["n_out"]), **t)

    corr = meta["correction"]
    return DevicePacked(
        chains=tuple(tuple(layer(l) for l in c) for c in meta["chains"]),
        direct=layer(meta["direct"]),
        correction=None if corr is None else (
            arr(corr[0], torch.int64),
            arr(corr[1], torch.int64),
            arr(corr[2], torch.float32),
        ),
        diag_mult=None if meta["diag_mult"] is None
        else arr(meta["diag_mult"], torch.float32),
        n_real=int(meta["n_real"]),
        deduplicated=bool(meta["deduplicated"]),
        backend=_BACKENDS.get(meta["backend"], meta["backend"]),
        fused_fwd=fused(meta["fused_fwd"]),
        fused_rev=fused(meta["fused_rev"]),
        graph_version=int(meta.get("graph_version", 0)),
        fused_standdown=meta.get("fused_standdown", ""),
        device=device,
    )
