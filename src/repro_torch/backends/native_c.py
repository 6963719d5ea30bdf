"""Compiled-C backends: the paper's if-else deliverable, served through ctypes.

``CompiledCBackend`` owns everything shared by native-code execution — build a
C source string, compile it *once per (model, mode)* into a shared library
(`gcc -O2 -shared -fPIC`), and call the batched entry point through ctypes —
so a native backend is just an ``_emit_source`` hook over its layout artifact.
Three concrete backends ride on it:

  * ``native_c`` (this module): InTreeger's actual artifact — the
    freestanding if-else C of ``codegen/c_emitter.emit_c`` over the padded
    node tables, forest-in-the-instruction-stream.
  * ``native_c_table`` (``backends/native_c_table.py``): the ragged-layout
    data-as-arrays table walk of ``codegen/table_emitter.emit_table_walk_c``.
  * ``native_c_bitvector`` (``backends/native_c_bitvector.py``): the
    QuickScorer scorer of ``codegen/bitvector_emitter.emit_bitvector_c``.

Where they run: on the host CPU, always.  The emitted C is host code in the
JAX package too, where it never touches the TPU.  So these backends do not
resolve a device: ``self.device`` is ``cpu``, the ``device`` a caller or a
plan passes is accepted and not used, and they build and serve on a host
without a card.  This is no fallback: the route names the backend, and a
route that names ``cuda`` never reaches C.  A plan such as
``cuda|native_c_table+tree_parallel:2`` puts half the trees on the card (K1)
and half on the host's C walk, and merges their exact partials.

Shape-oblivious: the C loops take any row count, so ``compiles_per_shape`` is
False and the serving layer skips bucket padding entirely.  Both
deterministic modes (flint/integer) compile the *integer* translation unit:
the C accumulates uint32 partials at the same scale and in the same tree
order as the reference — exact, associative, and mergeable across tree
shards — and the shared numpy finalize
(``repro_torch.core.ensemble.finalize_partials``) turns them into
mode-typed scores, so bit-identity needs no compiler float guarantees at
all.  Float mode still compiles the float32 translation unit; gcc (without
-ffast-math) preserves the emitted operation order, matching the reference
walk's sequential per-tree adds and its reciprocal multiply.

Without gcc, or when gcc refuses the source, the backend raises
``BackendUnavailable`` with the compiler's message; nothing falls back to
another walk.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.backends.base import (
    BackendCapabilities,
    BackendUnavailable,
    TreeBackend,
    register_backend,
)
from repro_torch.core.flint import float_to_key_np


def have_c_toolchain(cc: str = "gcc") -> bool:
    return shutil.which(cc) is not None


class CompiledCBackend(TreeBackend):
    """Shared compile-and-serve machinery for emitted-C backends.

    Subclasses implement :meth:`_emit_source` returning a translation unit
    that defines ``predict_batch(data, n_rows, scores, preds)`` (usually the
    mode-specific ``predict`` plus ``codegen.c_emitter.emit_batch_entry``).
    """

    def __init__(self, packed, mode: str = "integer", *, device=None,
                 cc: str = "gcc", cflags: tuple = ("-O2",)):
        super().__init__(packed, mode, device=device)
        self._cc = cc
        self._cflags = tuple(cflags)
        self._lib = None
        self._tmpdir = None  # owns the .so for the backend's lifetime
        self._compile_lock = threading.Lock()
        #: the build's source bytes and seconds (emit, compile), once built
        self.build_info: dict = {}

    @classmethod
    def placement(cls, device=None):
        """Emitted C runs on the host CPU, whatever device is passed."""
        return torch.device("cpu")

    def _emit_source(self) -> str:
        raise NotImplementedError

    @property
    def _exec_mode(self) -> str:
        """The mode the compiled translation unit executes.  Deterministic
        modes (flint/integer) both run the integer accumulation — the library
        produces uint32 partials and finalize happens in shared numpy — so
        one emitted source serves both."""
        return "float" if self.mode == "float" else "integer"

    # ------------------------------------------------------------- compile
    def _ensure_lib(self):
        # double-checked locking: engines are shared across executor threads,
        # and a concurrent first predict must not compile twice (the loser's
        # tmpdir assignment would delete the winner's .so out from under it)
        if self._lib is not None:
            return self._lib
        with self._compile_lock:
            if self._lib is not None:
                return self._lib
            return self._build_lib()

    @property
    def _effective_cflags(self) -> tuple:
        """Constructor cflags + ``REPRO_CC_EXTRA_FLAGS`` from the environment
        (the CI degradation job's hook).  ``-mno-avx2`` defines no feature
        macro and cannot disable per-function ``target("avx2")`` attributes,
        so its intent is translated to ``-DREPRO_NO_SIMD`` as well — one env
        var degrades every emitted TU to the scalar paths."""
        extra = tuple(os.environ.get("REPRO_CC_EXTRA_FLAGS", "").split())
        flags = self._cflags + extra
        if "-mno-avx2" in extra and "-DREPRO_NO_SIMD" not in flags:
            flags += ("-DREPRO_NO_SIMD",)
        return flags

    def _build_lib(self):
        if not have_c_toolchain(self._cc):
            raise BackendUnavailable(
                f"{self.name} backend needs a C compiler; {self._cc!r} not on PATH"
            )
        t0 = time.perf_counter()
        src = self._emit_source()
        t1 = time.perf_counter()
        self._tmpdir = tempfile.TemporaryDirectory(prefix=f"repro_torch_{self.name}_")
        d = Path(self._tmpdir.name)
        c_file, so_file = d / "model.c", d / "model.so"
        c_file.write_text(src)
        proc = subprocess.run(
            [self._cc, *self._effective_cflags, "-shared", "-fPIC",
             "-o", str(so_file), str(c_file)],
            capture_output=True,
        )
        if proc.returncode != 0:
            raise BackendUnavailable(
                f"{self._cc} failed to build the {self.name} backend:\n"
                + proc.stderr.decode(errors="replace")[:2000]
            )
        self.build_info = {"source_bytes": len(src), "emit_s": t1 - t0,
                           "compile_s": time.perf_counter() - t1}
        lib = ctypes.CDLL(str(so_file))  # RTLD_LOCAL: symbols stay per-model
        exec_mode = self._exec_mode
        data_ct = ctypes.c_float if exec_mode == "float" else ctypes.c_int32
        score_ct = ctypes.c_uint32 if exec_mode == "integer" else ctypes.c_float
        lib.predict_batch.restype = None
        lib.predict_batch.argtypes = [
            ctypes.POINTER(data_ct),
            ctypes.c_long,
            ctypes.POINTER(score_ct),
            ctypes.POINTER(ctypes.c_int32),
        ]
        self._score_dtype = np.uint32 if exec_mode == "integer" else np.float32
        self._lib = lib
        return lib

    # ------------------------------------------------------------- predict
    def _run_batch(self, X):
        """One ``predict_batch`` call: (exec-mode scores, C-side preds)."""
        lib = self._ensure_lib()
        X = np.ascontiguousarray(np.asarray(X, np.float32))
        if X.ndim != 2 or X.shape[1] != self.packed.n_features:
            raise ValueError(
                f"expected (B, {self.packed.n_features}) features, got {X.shape}"
            )
        if self._exec_mode == "float":
            data = X
        else:
            data = np.ascontiguousarray(float_to_key_np(X))
        b = X.shape[0]
        scores = np.empty((b, self.packed.n_classes), self._score_dtype)
        preds = np.empty(b, np.int32)
        lib.predict_batch(
            data.ctypes.data_as(lib.predict_batch.argtypes[0]),
            ctypes.c_long(b),
            scores.ctypes.data_as(lib.predict_batch.argtypes[2]),
            preds.ctypes.data_as(lib.predict_batch.argtypes[3]),
        )
        return scores, preds

    def predict_partials(self, X):
        if not self.deterministic:
            return super().predict_partials(X)  # raises with the shared message
        scores, _ = self._run_batch(X)  # integer exec: scores ARE the partials
        return scores

    def predict_scores(self, X):
        if self.deterministic:
            return super().predict_scores(X)  # shared finalize(partials)
        return self._run_batch(X)

    # ---------------------------------------------------------------- SIMD
    def simd_isa(self):
        """The ISA the compiled library's batch walk dispatches to on this
        host: ``"avx2"`` | ``"neon"`` | ``"scalar"`` for the table walk,
        ``"avx512-k8"``-style variant names for the bitvector scorer (TUs
        without a runtime dispatcher — the if-else cascade — are scalar by
        construction), or ``None`` when the library cannot build here.
        Builds on first call like every other entry point."""
        try:
            lib = self._ensure_lib()
        except BackendUnavailable:
            return None
        try:
            fn = lib.simd_isa
        except AttributeError:
            return "scalar"
        fn.restype = ctypes.c_char_p
        fn.argtypes = []
        return fn().decode("ascii")


@register_backend
class NativeCBackend(CompiledCBackend):
    """The paper's literal deliverable — if-else C — as a servable backend."""

    name = "native_c"
    capabilities = BackendCapabilities(
        modes=("float", "flint", "integer"),
        deterministic_modes=("flint", "integer"),
        preferred_block_rows=None,
        compiles_per_shape=False,
        # the if-else emitter reads (T, N) node tables from the root down;
        # node order within a tree does not change the emitted cascade's
        # semantics, so both node-table layouts are accepted
        supported_layouts=("padded", "leaf_major"),
        preferred_layout="padded",
    )

    def _emit_source(self) -> str:
        from repro_torch.codegen.c_emitter import emit_batch_entry, emit_c

        return emit_c(self.packed, mode=self._exec_mode) + emit_batch_entry(
            self.packed, mode=self._exec_mode
        )
