"""Execution backends for materialized tree ensembles.

One protocol (:class:`TreeBackend`: ``predict_partials(X) -> uint32
accumulators``, ``predict_scores(X) -> (scores, preds)``, declared
:class:`BackendCapabilities`) behind six implementations:

  * ``reference``          — the torch node-table walk (all three modes),
                             any device,
  * ``cuda``               — the hand-written CUDA walks K1, K2, K3 (flint +
                             integer),
  * ``bitvector``          — QuickScorer scoring of the ``bitvector`` layout
                             through the hand-written CUDA kernel K5 (flint +
                             integer),
  * ``native_c``           — the paper's emitted if-else C, compiled once per
                             model into a shared library, called via ctypes,
  * ``native_c_table``     — the ragged-layout table-walk C (row-blocked,
                             SIMD-dispatched), same shared-library contract,
  * ``native_c_bitvector`` — the bitvector tables as emitted C, streaming
                             each feature's sorted thresholds with early exit.

The three C backends run on the host CPU whatever device they are given
(``backends/native_c.py``); the others on the device they are given.
"""
from repro_torch.backends.base import (
    BackendCapabilities,
    BackendUnavailable,
    TreeBackend,
    available_backends,
    backend_class,
    create_backend,
    register_backend,
)
from repro_torch.backends.bitvector import BitvectorBackend
from repro_torch.backends.cuda import CudaBackend
from repro_torch.backends.native_c import CompiledCBackend, NativeCBackend, have_c_toolchain
from repro_torch.backends.native_c_bitvector import NativeCBitvectorBackend
from repro_torch.backends.native_c_table import NativeCTableBackend
from repro_torch.backends.reference import ReferenceBackend

__all__ = [
    "BackendCapabilities",
    "BackendUnavailable",
    "BitvectorBackend",
    "CompiledCBackend",
    "CudaBackend",
    "NativeCBackend",
    "NativeCBitvectorBackend",
    "NativeCTableBackend",
    "ReferenceBackend",
    "TreeBackend",
    "available_backends",
    "backend_class",
    "create_backend",
    "have_c_toolchain",
    "register_backend",
]
