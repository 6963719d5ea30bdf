"""Build the CUDA kernels at first use and bind them with ctypes.

``nvcc`` compiles ``repro_torch/csrc/tree_traverse.cu`` into a shared
library with a plain C interface, under ``build/repro_torch/`` in the
checkout, named by a hash of the source and the flags so an edit rebuilds.
Nothing here runs at import: the library is built and loaded by the first
kernel launch.  A failed build raises ``BackendUnavailable`` with the
compiler's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from repro_torch.backends.base import BackendUnavailable

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "tree_traverse.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_SIGNATURES = {
    # x, quads, internal_counts, leaf, out,
    # B, F, T, N, C, rows_per_cta, trees_per_cta, walks, stage_x, stream
    "intreeger_leaf_major": [_PTR] * 5 + [_INT] * 9 + [_PTR],
    # x, quads, leaf, out,
    # B, F, T, N, C, depth, rows_per_cta, trees_per_cta, walks, stage_x, stream
    "intreeger_gather": [_PTR] * 4 + [_INT] * 10 + [_PTR],
    # as intreeger_gather
    "intreeger_onehot": [_PTR] * 4 + [_INT] * 10 + [_PTR],
}

_lock = threading.Lock()
_lib = None
#: what the build that produced the loaded library printed, and its seconds
BUILD_INFO: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise BackendUnavailable(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the cuda "
            "backend's kernels are built from repro_torch/csrc at first use")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"tree_traverse-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of this source already exists."""
    target = library_path()
    if target.exists():
        BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO.setdefault("log", "(cached)")
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BackendUnavailable(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, target)  # atomic: a concurrent build never sees half a file
    BUILD_INFO.update(seconds=seconds, log=log, command=" ".join(cmd))
    return target


def load_library() -> ctypes.CDLL:
    """The bound kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
