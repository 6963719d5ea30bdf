"""Execution backends for materialized tree ensembles.

One protocol (:class:`TreeBackend`: ``predict_partials(X) -> uint32
accumulators``, ``predict_scores(X) -> (scores, preds)``, declared
:class:`BackendCapabilities`) behind three implementations:

  * ``reference`` — the torch node-table walk (all three modes), any device,
  * ``cuda``      — the hand-written CUDA walks K1, K2, K3 (flint + integer),
  * ``bitvector`` — QuickScorer scoring of the ``bitvector`` layout through
                    the hand-written CUDA kernel K5 (flint + integer).
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
from repro_torch.backends.reference import ReferenceBackend

__all__ = [
    "BackendCapabilities",
    "BackendUnavailable",
    "BitvectorBackend",
    "CudaBackend",
    "ReferenceBackend",
    "TreeBackend",
    "available_backends",
    "backend_class",
    "create_backend",
    "register_backend",
]
