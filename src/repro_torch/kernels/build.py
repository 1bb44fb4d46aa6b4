"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``.  The
build runs at first use, into ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``); a library's file name carries a hash
of its sources and flags, so an edited source rebuilds and an unchanged
one loads straight away.  :func:`build_all` compiles every library at
once, one ``nvcc`` per source, all started together.

Nothing here runs at import time: the CPU-only test environment has no
``nvcc`` and imports this module all the same.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

__all__ = ["BUILD_DIR", "build_all", "load", "build_log", "library_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float

# library -> (source, {C function: argtypes})
LIBRARIES = {
    "bitmap_index": (
        "bitmap_index.cu",
        {
            "bitmap_index_count_launch": [_P] * 9 + [_I] + [_P] * 2 + [_I] * 3 + [_P] * 2
            + [_I, _P],
            "bitmap_index_fill_launch": [_P] * 9 + [_I] + [_P] * 2 + [_I] * 3 + [_P] * 2 + [_I]
            + [_P] * 3 + [_I, _P],
        },
    ),
    "bitmap_spmm": (
        "bitmap_spmm.cu",
        {"bitmap_spmm_launch": [_P] * 4 + [_I] * 3 + [_F] + [_I] * 4 + [_P] * 2 + [_I, _P]},
    ),
    "bitmap_spmm_fused": (
        "bitmap_spmm_fused.cu",
        {"bitmap_spmm_fused_launch": [_P] * 6 + [_I] * 6 + [_P] * 2 + [_I, _P]},
    ),
    "flash_attention": (
        "flash_attention.cu",
        {"flash_attention_launch": [_P] * 6 + [_I] * 9 + [_F, _I, _P]},
    ),
    "flash_prefill": (
        "flash_prefill.cu",
        {"flash_prefill_launch": [_P] * 6 + [_I] * 9 + [_F, _I, _P]},
    ),
    "flash_decode": (
        "flash_decode.cu",
        {
            "flash_decode_launch": [_P] * 7 + [_I] * 9 + [_F, _I, _P],
            "flash_combine_launch": [_P] * 4 + [_I] * 4 + [_P],
        },
    ),
    "flash_backward": (
        "flash_backward.cu",
        {
            "flash_backward_short_launch": [_P] * 9 + [_L] + [_I] * 4 + [_F, _I, _P],
            "flash_backward_rowstat_launch": [_P] * 5 + [_I] * 6 + [_P],
            "flash_backward_dkdv_launch": [_P] * 10 + [_I] * 8 + [_F, _I, _P],
            "flash_backward_dq_launch": [_P] * 7 + [_I] * 7 + [_F, _I, _P],
            "flash_backward_reduce_launch": [_P] * 4 + [_L, _I, _F, _I, _P],
        },
    ),
    "flash_backward_f32": (
        "flash_backward_f32.cu",
        {"flash_backward_f32_launch": [_P] * 9 + [_I] * 7 + [_F, _I, _P]},
    ),
}

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and under CUDA_HOME): the CUDA "
            "kernels are built from source on a machine with the CUDA toolkit"
        )
    return str(path)


def library_path(name: str) -> Path:
    source, _ = LIBRARIES[name]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler's output for library ``name`` (registers, spills and
    shared memory per kernel, from ``-Xptxas -v``); empty if not built
    here."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all() -> List[Path]:
    """Compile every library that is not built yet, all ``nvcc`` processes
    at once; returns the library paths.  Raises with the compiler output
    if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = []
    for name, (source, _) in LIBRARIES.items():
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.tmp-{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        pending.append((name, out, tmp, proc))
    failures = []
    for name, out, tmp, proc in pending:
        text, _ = proc.communicate()
        out.with_suffix(".log").write_text(text)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name} (exit {proc.returncode}):\n{text}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return [library_path(name) for name in LIBRARIES]


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed, with every C
    function's ``argtypes`` and ``restype`` declared."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not path.exists():
        build_all()
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in LIBRARIES[name][1].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _LOADED[name] = lib
    return lib
