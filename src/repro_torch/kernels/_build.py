"""Build the CUDA kernels at first use and bind them with ctypes.

``nvcc`` compiles every source of ``repro_torch/csrc`` (``tree_traverse.cu``:
K1, K2, K3; ``bitvector.cu``: K5) into one shared library with a plain C
interface, under ``build/repro_torch/`` in the checkout, named by a hash of
the sources and the flags so an edit rebuilds.  The sources compile side by
side, one ``nvcc`` each, all started together, and one more ``nvcc`` links
them.  Nothing here runs at import: the library is built and loaded by the
first kernel launch.  A failed build raises ``BackendUnavailable`` with the
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-lineinfo", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    # x, records, word_start, init_mask, leaf_off, leaf, out,
    # B, F, T, W32, R, L, C, rows_per_cta, trees_per_cta, splits,
    # rows_per_thread, rec_cap, stage_x, stream
    "intreeger_bitvector": [_PTR] * 7 + [_INT] * 13 + [_PTR],
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


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"intreeger-{digest.hexdigest()[:16]}.so"


def _run(cmds: list) -> list:
    """Start every command at once; wait for all; (cmd, exit code, output)."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    return [(cmd, proc.returncode, out) for cmd, proc, out in zip(cmds, procs, outs)]


def build() -> Path:
    """Compile the kernels unless a library of these sources already exists."""
    target = library_path()
    if target.exists():
        BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO.setdefault("log", "(cached)")
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources()]
    compile_cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(sources(), objs)]
    link_cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
    t0 = time.perf_counter()
    try:
        results = _run(compile_cmds)
        if all(rc == 0 for _, rc, _ in results):
            results += _run([link_cmd])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log = "\n".join(f"== {' '.join(cmd)}\n{out}" for cmd, _, out in results)
    failed = [(cmd, rc) for cmd, rc, _ in results if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        cmd, rc = failed[0]
        raise BackendUnavailable(f"nvcc failed (exit {rc}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, target)  # atomic: a concurrent build never sees half a file
    BUILD_INFO.update(seconds=seconds, log=log,
                      command="\n".join(" ".join(cmd) for cmd, _, _ in results))
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
