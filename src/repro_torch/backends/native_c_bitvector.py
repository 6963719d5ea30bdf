"""NativeCBitvectorBackend: the emitted-C QuickScorer bitvector scorer.

The sequential host-C sibling of the ``bitvector`` backend (K5), riding
the shared ``CompiledCBackend`` gcc/ctypes machinery: ``codegen/bitvector_emitter``
compiles the bitvector layout's per-feature ascending threshold streams and
false-node leaf masks as static data, and scoring is one linear pass over
sorted keys per feature (first true compare breaks the stream) followed by a
lowest-set-bit scan per tree — no per-row tree traversal at all, which is
where the QuickScorer line of work wins on large-T shallow forests.

``interleave=K`` is the v-QuickScorer multi-tree blocking knob (default 8):
the emitter pads each feature's ascending stream to K-entry groups and every
block variant runs one early-exit test + K unrolled mask applies per group —
the warm-time autotuner sweeps this grid and pins the measured winner.
``simd=False`` pins the scalar blocked path per instance (same macro as the
degradation CI job, scoped to this build) so one process can measure
dispatch variants against each other on identical artifacts.

Deterministic modes only, and both compile the same integer translation unit
(uint32 partials out, shared numpy finalize), so scores are bit-identical to
every other backend across every execution plan — including multi-word
(>64-leaf) trees, which just widen the per-tree uint64 state — and across
every interleave width, since padding entries are inert and grouping never
reorders any real mask application.
"""
from __future__ import annotations

from repro_torch.backends.base import BackendCapabilities, register_backend
from repro_torch.backends.native_c import CompiledCBackend

_DEFAULT_INTERLEAVE = 8


@register_backend
class NativeCBitvectorBackend(CompiledCBackend):
    name = "native_c_bitvector"
    capabilities = BackendCapabilities(
        modes=("flint", "integer"),
        deterministic_modes=("flint", "integer"),
        preferred_block_rows=None,
        compiles_per_shape=False,
        supported_layouts=("bitvector",),
        preferred_layout="bitvector",
    )

    def __init__(self, packed, mode: str = "integer", *,
                 interleave: int = None, simd: bool = True, **kwargs):
        super().__init__(packed, mode, **kwargs)
        self.interleave = (_DEFAULT_INTERLEAVE if interleave is None
                           else int(interleave))
        if self.interleave < 1:
            raise ValueError(f"interleave must be >= 1, got {interleave}")
        self.simd = bool(simd)
        if not self.simd:
            self._cflags = self._cflags + ("-DREPRO_NO_SIMD",)

    def _emit_source(self) -> str:
        from repro_torch.codegen.bitvector_emitter import emit_bitvector_c

        # flint and integer share the integer unit (partials + numpy finalize);
        # the emitter's TU is complete (blocked predict_batch included)
        return emit_bitvector_c(
            self.packed, mode="integer", interleave=self.interleave
        )
