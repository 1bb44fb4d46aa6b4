"""Fault-tolerant checkpointing of nested dicts of tensors.

The JAX package's ``train/checkpoint.py`` layout, file for file, so a
checkpoint written by either package restores in the other::

    <dir>/step_0000001230/        # atomic: written as .tmp then renamed
        manifest.json             # {path: {file, dtype, shape}}, step, ts
        0000.bin, 0001.bin, ...   # raw little-endian buffers
    <dir>/LATEST                  # text file: last committed step

Guarantees:

* step-atomic commits (tmp dir + rename; LATEST written after rename);
* restart safety: restore ignores uncommitted ``.tmp`` dirs;
* keep-last-k retention;
* async saves on a background thread (snapshot taken synchronously);
* a torn or corrupt buffer raises ``IOError``.

Dtypes are named as NumPy / ``ml_dtypes`` name them (``float32``,
``int32``, ``bfloat16``, ...), written from torch dtypes without
``ml_dtypes``; a ``bfloat16`` buffer is read through an ``int16`` view.
Leaves are torch tensors (NumPy arrays are accepted on save); restore
returns CPU tensors unless a ``device`` is given.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint", "latest_step"]

_DTYPES = {
    "float64": torch.float64, "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int64": torch.int64, "int32": torch.int32,
    "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _flatten(tree, prefix="") -> List[Tuple[str, Any]]:
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.extend(_flatten(tree[k], f"{prefix}{k}/"))
    else:
        out.append((prefix.rstrip("/"), tree))
    return out


def _unflatten(items: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for path, val in items.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _host_tensor(leaf) -> torch.Tensor:
    """A CPU copy of a leaf (a tensor or anything NumPy takes)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).contiguous()
    return torch.from_numpy(np.array(leaf, copy=True))


def _leaf_bytes(t: torch.Tensor) -> Tuple[bytes, str]:
    if t.dtype not in _NAMES:
        raise TypeError(f"no checkpoint dtype name for {t.dtype}")
    t = t.detach().cpu().contiguous()
    view = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return view.numpy().tobytes(), _NAMES[t.dtype]


def save_checkpoint(directory: str, step: int, state) -> str:
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:010d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest: Dict[str, Any] = {"step": int(step), "ts": time.time(), "arrays": {}}
    for i, (path, leaf) in enumerate(_flatten(state)):
        t = _host_tensor(leaf)
        data, dtype = _leaf_bytes(t)
        fname = f"{i:04d}.bin"
        with open(os.path.join(tmp, fname), "wb") as f:
            f.write(data)
        manifest["arrays"][path] = {
            "file": fname,
            "dtype": dtype,
            "shape": list(t.shape),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # the commit point
    with open(os.path.join(directory, "LATEST"), "w") as f:
        f.write(str(step))
    return final


def latest_step(directory: str) -> Optional[int]:
    latest = os.path.join(directory, "LATEST")
    if not os.path.exists(latest):
        # scan for committed dirs (LATEST may have been lost)
        steps = [
            int(d.split("_")[1])
            for d in os.listdir(directory)
            if d.startswith("step_") and not d.endswith(".tmp")
            and os.path.exists(os.path.join(directory, d, "manifest.json"))
        ] if os.path.isdir(directory) else []
        return max(steps) if steps else None
    with open(latest) as f:
        return int(f.read().strip())


def _read_leaf(d: str, path: str, meta: dict) -> torch.Tensor:
    name = meta["dtype"]
    if name not in _DTYPES:
        raise IOError(f"checkpoint {d}: {path} has dtype {name!r}, which the port does not read")
    dtype = _DTYPES[name]
    np_dtype = np.dtype("int16" if dtype == torch.bfloat16 else name)
    with open(os.path.join(d, meta["file"]), "rb") as f:
        buf = f.read()
    expected = int(np.prod(meta["shape"])) * np_dtype.itemsize if meta["shape"] else np_dtype.itemsize
    if len(buf) != expected:
        raise IOError(
            f"corrupt checkpoint {d}: {meta['file']} has {len(buf)} bytes, "
            f"expected {expected} for {path}"
        )
    t = torch.from_numpy(np.frombuffer(bytearray(buf), dtype=np_dtype).reshape(meta["shape"]))
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


def restore_checkpoint(
    directory: str,
    step: Optional[int] = None,
    device=None,
):
    """Restore a state tree of tensors (on ``device`` when given) and its
    step; the latest committed step unless ``step`` is given."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    items = {path: _read_leaf(d, path, meta) for path, meta in manifest["arrays"].items()}
    tree = _unflatten(items)
    if device is not None:
        tree = _map(lambda t: t.to(device), tree)
    return tree, step


class CheckpointManager:
    """Retention + async writes + restart discovery."""

    def __init__(
        self,
        directory: str,
        keep_last: int = 3,
        async_save: bool = True,
    ):
        self.directory = directory
        self.keep_last = keep_last
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state) -> None:
        self.wait()
        # snapshot on the caller thread (values may be mutated after)
        snapshot = _map(_host_tensor, state)
        if not self.async_save:
            self._commit(step, snapshot)
            return
        self._thread = threading.Thread(
            target=self._commit, args=(step, snapshot), daemon=True
        )
        self._thread.start()

    def _commit(self, step: int, snapshot) -> None:
        try:
            save_checkpoint(self.directory, step, snapshot)
            self._gc()
        except BaseException as e:  # surfaced on next wait()
            self._error = e

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(
            int(d.split("_")[1])
            for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp")
        )
        for s in steps[: -self.keep_last]:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s:010d}"), ignore_errors=True
            )

    # -- restore --------------------------------------------------------------
    def restore_latest(self, device=None):
        self.wait()
        return restore_checkpoint(self.directory, device=device)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)
